"""Roofline share of the interp decode kernel (csrc/interp3d.cu).

Work, counted from what the algorithm needs (never from the launch geometry): the codes read once (1 B a point) and the field written once (4 B a point) for each
full decode of a field; 9 flop a point (the 4-tap cubic, 7, and the dequantization, 2), so the bytes bound it.
Time: the device time of every trace row whose name holds ``PATTERN``."""
from portbench.peaks import roofline

UNIT = "%"
BETTER = "higher"
SOURCE = "device_trace"
LAYER = "Predictor kernels (kernels/interp3d, csrc/interp3d.cu)"
MOVES = "decompress_GBps"
PATTERN = "interp_decode_kernel"


def work(run) -> tuple[float, float]:
    """(bytes, flops) of the window's full decodes: every decompress, and the decode that verify makes of each fresh container."""
    verify = run.config["spec"].get("verify", "sample") != "off"
    n = sum(c.points for c in run.of("decompress"))
    if verify:  # the compress's own decode of its fresh container, once per encode
        n += sum(c.points * (1 + c.repairs) for c in run.of("compress"))
    return 5.0 * n, 9.0 * n


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
