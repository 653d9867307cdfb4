from .autotune import PredictorPlan, autotune_plan, plan_signature, stats_bucket  # noqa: F401
from .compressor import Compressor, CompressorSpec  # noqa: F401
from .compressor import (cusz_hi_auto, cusz_hi_autoplan, cusz_hi_cr, cusz_hi_crz, cusz_hi_tp, cusz_i,  # noqa: F401
                         cusz_l, cuszp2_like, fzgpu_like)
from .errors import BoundViolationError, ContainerError, NotPortedError, SpecError  # noqa: F401
from .plancache import PlanCache  # noqa: F401
