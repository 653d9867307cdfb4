"""Roofline share of the Huffman encode kernel (csrc/huffman.cu).

Work, counted from what the algorithm needs (never from the launch geometry): the hf stage's symbols read once (1 B each) and its payload written once,
as the container's section headers state them; no floating-point work, so the bytes bound it.
Time: the device time of every trace row whose name holds ``PATTERN``, the planner's trial encodes included: they count in the time, not in the work."""
from portbench.peaks import roofline

UNIT = "%"
BETTER = "higher"
SOURCE = "device_trace"
LAYER = "Entropy kernels (kernels/huffman, csrc/huffman.cu)"
MOVES = "compress_GBps"
PATTERN = "hf_encode_kernel"


def work(run) -> tuple[float, float]:
    """(bytes, flops) of the window's hf encodes: every compress, and each of its repairs."""
    return float(sum(sum(c.hf) * (1 + c.repairs) for c in run.of("compress"))), 0.0


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
