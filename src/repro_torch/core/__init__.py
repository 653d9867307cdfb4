from .autotune import PredictorPlan, autotune_plan, plan_signature, stats_bucket  # noqa: F401
from .compressor import Compressor, CompressorSpec  # noqa: F401
from .compressor import (cusz_hi_auto, cusz_hi_autoplan, cusz_hi_cr, cusz_hi_crz, cusz_hi_tp, cusz_i,  # noqa: F401
                         cusz_l, cuszp2_like, fzgpu_like)
from .distributed import chunk_compress, default_devices, shard_compress, shard_decompress  # noqa: F401
from .errors import (BoundViolationError, CheckpointDamageError, ContainerError, DamageReport,  # noqa: F401
                     FrameCRCError, FrameSyncError, SpecError, TruncatedContainerError)
from .frames import FrameReader, FrameWriter, scan_frames  # noqa: F401
from .metrics import (bit_rate, compression_ratio, max_abs_err, max_rel_err, nonfinite_count, psnr,  # noqa: F401
                      quality_report, spectral_error, ssim)
from .plancache import PlanCache  # noqa: F401
from .retry import RetryingWriter, RetryPolicy, retry_call  # noqa: F401
