"""Roofline share of the Huffman decode kernel (csrc/huffman.cu).

Work, counted from what the algorithm needs (never from the launch geometry): the hf payload read once and its symbols written once (1 B each), as the
container's section headers state them, for each full decode; no floating-point work, so the bytes bound it.
Time: the device time of every trace row whose name holds ``PATTERN``."""
from portbench.peaks import roofline

UNIT = "%"
BETTER = "higher"
SOURCE = "device_trace"
LAYER = "Entropy kernels (kernels/huffman, csrc/huffman.cu)"
MOVES = "decompress_GBps"
PATTERN = "hf_decode_kernel"


def work(run) -> tuple[float, float]:
    """(bytes, flops) of the window's hf decodes: every decompress, and the decode that verify makes of each fresh container."""
    verify = run.config["spec"].get("verify", "sample") != "off"
    per = [sum(c.hf) for c in run.of("decompress")]
    if verify:  # the compress's own decode of its fresh container
        per += [sum(c.hf) * (1 + c.repairs) for c in run.of("compress")]
    return float(sum(per)), 0.0


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
