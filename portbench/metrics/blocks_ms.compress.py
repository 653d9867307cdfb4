"""Host ms per compressed field in the spans compress.blocks (pad and gather into 17^3 blocks)
and compress.scatter_reorder (the codes scattered back, outliers, anchors, the level reorder)."""
UNIT = "ms"
BETTER = "lower"
SOURCE = "program_span"
LAYER = "Blocks and reorder (core/blocks.py, core/reorder.py)"
MOVES = "compress_GBps"
SIDE = "compress"
NAMES = ("compress.blocks", "compress.scatter_reorder")


def read(run):
    tr = run.trace
    if tr is None or not tr.n_calls(SIDE):
        return None
    return tr.span_ms(SIDE, lambda n: n in NAMES) / tr.n_calls(SIDE)
