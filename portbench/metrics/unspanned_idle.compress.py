"""Device idle under no program span over the compress calls: the idle time inside the calls whose
innermost open host span is the harness's own bench.compress / the calls' summed walls, in %."""
UNIT = "%"
BETTER = "lower"
SOURCE = "device_trace"
LAYER = "Device (H100)"
MOVES = "compress_GBps"
SIDE = "compress"


def read(run):
    tr = run.trace
    if tr is None or not tr.n_calls(SIDE) or tr.wall_s(SIDE) <= 0 or not tr.device_ops:
        return None
    idle = dict(tr.breakdown(top=len(tr.spans))["idle_gaps"])
    return 100.0 * idle.get("bench." + SIDE, 0.0) / tr.wall_s(SIDE)
