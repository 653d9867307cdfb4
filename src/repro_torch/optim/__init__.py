"""repro_torch.optim — AdamW and its schedule, the gradient quantizer, its
packer and the compressed cross-pod all-reduce, on the card."""
from .adamw import OptState, adamw_update, clip_by_global_norm, init_opt  # noqa: F401
from .grad_compress import (pack_quantized, pack_quantized_sharded, pod_allreduce_compressed,  # noqa: F401
                            quantize_shard, unpack_quantized, unpack_quantized_sharded)
from .schedule import cosine_with_warmup  # noqa: F401
