"""Host ms per decoded field in every <stage>.decode span of the lossless engine inside the
timed decompress calls (the decode inside compress.verify counts on the compress side)."""
UNIT = "ms"
BETTER = "lower"
SOURCE = "program_span"
LAYER = "Lossless engine (core/lossless/)"
MOVES = "decompress_GBps"
SIDE = "decompress"


def read(run):
    tr = run.trace
    if tr is None or not tr.n_calls(SIDE):
        return None
    return tr.span_ms(SIDE, lambda n: n.endswith(".decode")) / tr.n_calls(SIDE)
