"""Host ms per compressed field in the program's span compress.verify (the decode of the fresh
container and the sampled bound check)."""
UNIT = "ms"
BETTER = "lower"
SOURCE = "program_span"
LAYER = "Compressor (core/compressor.py)"
MOVES = "compress_GBps"
SIDE = "compress"
NAMES = ("compress.verify",)


def read(run):
    tr = run.trace
    if tr is None or not tr.n_calls(SIDE):
        return None
    return tr.span_ms(SIDE, lambda n: n in NAMES) / tr.n_calls(SIDE)
