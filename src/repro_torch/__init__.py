"""PyTorch/CUDA port of the cuSZ-Hi reproduction (the JAX package ``repro``
is the reference it is tested against). See ``repro_torch.core``."""
