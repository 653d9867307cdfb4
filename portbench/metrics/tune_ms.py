"""Host ms per compressed field in the planner's spans, compress.autotune (the spline autotune)
and compress.plan (the per-level planner)."""
UNIT = "ms"
BETTER = "lower"
SOURCE = "program_span"
LAYER = "Planner (core/autotune.py, core/plancache.py)"
MOVES = "compress_GBps"
SIDE = "compress"
NAMES = ("compress.autotune", "compress.plan")


def read(run):
    tr = run.trace
    if tr is None or not tr.n_calls(SIDE):
        return None
    return tr.span_ms(SIDE, lambda n: n in NAMES) / tr.n_calls(SIDE)
