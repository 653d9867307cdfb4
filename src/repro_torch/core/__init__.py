from .compressor import Compressor, CompressorSpec  # noqa: F401
from .compressor import cusz_hi_cr, cusz_hi_tp, cusz_i, cusz_l, fzgpu_like  # noqa: F401
from .errors import BoundViolationError, ContainerError, NotPortedError, SpecError  # noqa: F401
