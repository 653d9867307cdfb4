"""Roofline share of the interp encode kernel (the cuSZ-Hi predictor and quantizer, csrc/interp3d.cu).

Work, counted from what the algorithm needs (never from the launch geometry): the field read once (4 B a point) and its codes written once (1 B a point) for each
encode of a field; 12 flop a point (one 4-tap cubic prediction, 7, and the quantization, 5), so the bytes bound it.
Time: the device time of every trace row whose name holds ``PATTERN``, trial launches of the planner and of autotune included: they count in the time, not in the work."""
from portbench.peaks import roofline

UNIT = "%"
BETTER = "higher"
SOURCE = "device_trace"
LAYER = "Predictor kernels (kernels/interp3d, csrc/interp3d.cu)"
MOVES = "compress_GBps"
PATTERN = "interp_encode_kernel"


def work(run) -> tuple[float, float]:
    """(bytes, flops) of the window's encodes: every compress, and each of its repairs."""
    n = sum(c.points * (1 + c.repairs) for c in run.of("compress"))
    return 5.0 * n, 12.0 * n


def read(run):
    if run.trace is None:
        return None
    kernel_s, rows = run.trace.kernel_s(PATTERN)
    nbytes, flops = work(run)
    if not rows or kernel_s <= 0 or nbytes <= 0:
        return None
    share, bound = roofline(nbytes, flops, kernel_s)
    run.note(f"{PATTERN}: {rows} rows, {kernel_s * 1e3:.4f} ms, {nbytes:.0f} B, {flops:.0f} flop, "
             f"bound by {bound}, {share:.3f} % of the roofline ({run.power_limit})")
    return share
