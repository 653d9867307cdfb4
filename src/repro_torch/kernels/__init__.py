"""Hand-written CUDA kernels of the port and their launch counters.

Sources live in ``repro_torch/csrc``; :mod:`.build` compiles them with
``nvcc`` at first use. Importing this package builds nothing.
"""
from __future__ import annotations

from .histogram import ops as _hist
from .interp3d import ops as _interp


def launch_counts() -> dict[str, int]:
    """Kernel launches per kernel since the last reset."""
    return {**_interp.LAUNCHES, **_hist.LAUNCHES}


def reset_launch_counts() -> None:
    for table in (_interp.LAUNCHES, _hist.LAUNCHES):
        for key in table:
            table[key] = 0
