"""Peak device memory: the most that ``torch.cuda.max_memory_allocated`` read over any call
of the window, each call's peak reset at its start; the cell's resident fields included."""
UNIT = "GiB"
BETTER = "lower"
SOURCE = "host_clock"


def read(run):
    if run.device["platform"] != "gpu" or not run.device["memory_peak_bytes"]:
        return None
    return run.device["memory_peak_bytes"] / 2**30
