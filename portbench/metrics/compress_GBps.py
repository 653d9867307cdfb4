"""Compression rate: every input byte compressed in the window (1 GB = 1e9 B) over the sum
of the walls of the compress calls, each ending when the container's bytes are on the host."""
UNIT = "GB/s"
BETTER = "higher"
SOURCE = "host_clock"


def read(run):
    calls = run.of("compress")
    wall = sum(c.wall_s for c in calls)
    if not calls or wall <= 0:
        return None
    return sum(4 * c.points for c in calls) / wall / 1e9
