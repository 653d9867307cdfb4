"""Host ms per compressed field in the program's container and transfer spans: the field's ingest,
the container's and the stream's packing, and in verify's decode the parse and the uploads. Those
inside the planner's and the orchestrator's spans are left out (their layers' time). None where the
program has no such span."""
UNIT = "ms"
BETTER = "lower"
SOURCE = "program_span"
LAYER = "Container and transfers (core/compressor.py, core/lossless/pipelines.py)"
MOVES = "compress_GBps"
SIDE = "compress"
NAMES = ("compress.ingest", "compress.pack", "lossless.pack", "decompress.parse", "lossless.parse",
         "lossless.upload", "decompress.upload")
TUNERS = ("compress.plan", "compress.autotune", "compress.orchestrate")


def read(run):
    tr = run.trace
    if tr is None or not tr.n_calls(SIDE):
        return None
    if not any(n in NAMES and tr.side_of(s) == SIDE for n, s, _ in tr.spans):
        return None
    return tr.span_ms(SIDE, lambda n: n in NAMES, outside=TUNERS) / tr.n_calls(SIDE)
