from .ops import LAUNCHES, lorenzo_encode  # noqa: F401
