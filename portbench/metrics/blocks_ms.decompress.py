"""Host ms per decoded field in the spans decompress.blocks (codes restored and gathered,
anchors and outliers to blocks) and decompress.scatter, inside the timed decompress calls."""
UNIT = "ms"
BETTER = "lower"
SOURCE = "program_span"
LAYER = "Blocks and reorder (core/blocks.py, core/reorder.py)"
MOVES = "decompress_GBps"
SIDE = "decompress"
NAMES = ("decompress.blocks", "decompress.scatter")


def read(run):
    tr = run.trace
    if tr is None or not tr.n_calls(SIDE):
        return None
    return tr.span_ms(SIDE, lambda n: n in NAMES) / tr.n_calls(SIDE)
