"""Set-up time: from the start of the process to the start of the window (the fields made
on the card, the program built and its kernels loaded, the traffic's own set-up, the warm-up)."""
UNIT = "s"
BETTER = "lower"
SOURCE = "host_clock"


def read(run):
    return run.setup_s
