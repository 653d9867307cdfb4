"""Decompression rate: every field byte decoded onto the card in the window over the sum of
the walls of the decompress calls, each ending in a device synchronisation."""
UNIT = "GB/s"
BETTER = "higher"
SOURCE = "host_clock"


def read(run):
    calls = run.of("decompress")
    wall = sum(c.wall_s for c in calls)
    if not calls or wall <= 0:
        return None
    return sum(4 * c.points for c in calls) / wall / 1e9
