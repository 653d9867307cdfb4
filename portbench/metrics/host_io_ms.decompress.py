"""Host ms per decoded field in the program's container and transfer spans inside the timed
decompress calls: the container's and the stream's parse, the stream's upload and the anchor and
outlier uploads (verify's decode counts on the compress side). None where the program has no such
span."""
UNIT = "ms"
BETTER = "lower"
SOURCE = "program_span"
LAYER = "Container and transfers (core/compressor.py, core/lossless/pipelines.py)"
MOVES = "decompress_GBps"
SIDE = "decompress"
NAMES = ("decompress.parse", "lossless.parse", "lossless.upload", "decompress.upload")


def read(run):
    tr = run.trace
    if tr is None or not tr.n_calls(SIDE):
        return None
    if not any(n in NAMES and tr.side_of(s) == SIDE for n, s, _ in tr.spans):
        return None
    return tr.span_ms(SIDE, lambda n: n in NAMES) / tr.n_calls(SIDE)
