"""Compression ratio: every input byte of the fields handled in the window over the bytes of
their containers."""
UNIT = "x"
BETTER = "higher"
SOURCE = "host_clock"


def read(run):
    calls = [c for c in run.of("decompress") if c.container_bytes > 0]
    if not calls:
        return None
    return sum(4 * c.points for c in calls) / sum(c.container_bytes for c in calls)
