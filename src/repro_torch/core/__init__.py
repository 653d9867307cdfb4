from .compressor import Compressor, CompressorSpec  # noqa: F401
from .errors import BoundViolationError, ContainerError, NotPortedError, SpecError  # noqa: F401
