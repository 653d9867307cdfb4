from .ops import LAUNCHES, compress_blocks, decompress_blocks, pack_steps  # noqa: F401
