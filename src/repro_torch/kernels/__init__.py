"""Hand-written CUDA kernels of the port and their launch counters.

Sources live in ``repro_torch/csrc``; :mod:`.build` compiles them with
``nvcc`` at first use. Importing this package builds nothing.
"""
from __future__ import annotations

from .build import COUNT_LOCK
from .bitshuffle import ops as _bit
from .histogram import ops as _hist
from .huffman import ops as _hf
from .interp3d import ops as _interp
from .lorenzo3d import ops as _lor

_TABLES = (_interp.LAUNCHES, _hist.LAUNCHES, _bit.LAUNCHES, _lor.LAUNCHES, _hf.LAUNCHES)


def launch_counts() -> dict[str, int]:
    """Kernel launches per kernel since the last reset."""
    with COUNT_LOCK:
        return {k: v for table in _TABLES for k, v in table.items()}


def reset_launch_counts() -> None:
    with COUNT_LOCK:
        for table in _TABLES:
            for key in table:
                table[key] = 0
