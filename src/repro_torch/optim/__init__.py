"""repro_torch.optim — the gradient quantizer and its packer, on the card."""
from .grad_compress import (pack_quantized, pack_quantized_sharded, quantize_shard,  # noqa: F401
                            unpack_quantized, unpack_quantized_sharded)
