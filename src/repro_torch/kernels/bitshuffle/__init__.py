from .ops import BLOCK, LAUNCHES, bitshuffle, bitshuffle_plain, bitunshuffle, bitunshuffle_plain  # noqa: F401
