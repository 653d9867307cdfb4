"""repro_torch.testing — deterministic fault injection + adversarial inputs
for the chaos suite: the JAX package's ``repro.testing`` (the same damage
and the same fields for the same seed), with the encoder-fault hook armed
on the port's compressor."""
from .adversarial import CORPUS, corpus_field  # noqa: F401
from .faults import (  # noqa: F401
    FlakyFile,
    bit_flip,
    corrupt_frame,
    drop_frame,
    fault_rng,
    fault_seed,
    perturb_quant_codes,
    torn_tail,
    truncate_fraction,
)
