"""Host ms per compressed field in every <stage>.encode span of the lossless engine, leaving
out the trial encodes inside the planner's and the orchestrator's spans (their layers' time)."""
UNIT = "ms"
BETTER = "lower"
SOURCE = "program_span"
LAYER = "Lossless engine (core/lossless/)"
MOVES = "compress_GBps"
SIDE = "compress"
TUNERS = ("compress.plan", "compress.autotune", "compress.orchestrate")


def read(run):
    tr = run.trace
    if tr is None or not tr.n_calls(SIDE):
        return None
    return tr.span_ms(SIDE, lambda n: n.endswith(".encode"), outside=TUNERS) / tr.n_calls(SIDE)
