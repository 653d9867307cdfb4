"""Device idle share over the decompress calls: 1 - (the union of the device's kernel, copy and set
intervals inside the calls) / (the calls' summed walls), in %."""
UNIT = "%"
BETTER = "lower"
SOURCE = "device_trace"
LAYER = "Device (H100)"
MOVES = "decompress_GBps"
SIDE = "decompress"


def read(run):
    tr = run.trace
    if tr is None or not tr.n_calls(SIDE) or tr.wall_s(SIDE) <= 0 or not tr.device_ops:
        return None
    return 100.0 * (1.0 - tr.busy_s(SIDE) / tr.wall_s(SIDE))
