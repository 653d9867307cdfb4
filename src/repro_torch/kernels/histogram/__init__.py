from .ops import LAUNCHES, histogram256, histogram256_plain  # noqa: F401
