"""Published peaks of the card, and the roofline share of a kernel's work.

NVIDIA H100 SXM (data sheet, dense rates, at the full 700 W power limit):
80 GB of HBM3 at 3.35 TB/s, 67 TFLOP/s float32 outside the tensor cores.
A card set below 700 W runs slower under load: the harness prints the
card's power limit beside every share.
"""
from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS_PER_S = 67e12


def roofline(nbytes: float, flops: float, kernel_s: float) -> tuple[float, str]:
    """(share of the roofline in %, what bounds it): the least time the card
    needs for the work, the larger of its bytes over the bandwidth and its
    operations over the float32 rate, over the kernels' measured time."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / FP32_FLOPS_PER_S
    least = max(t_bytes, t_ops)
    return 100.0 * least / kernel_s, ("bytes" if t_bytes >= t_ops else "flops")
