"""The reduction from a profiler trace to the numbers the per-layer metrics read.

A trace here is two lists of ``(name, start_ns, end_ns)``: host spans (the
harness's ``bench.compress`` / ``bench.decompress`` around each timed call,
and the program's own ``record_function`` spans inside them) and device
operations (kernels, copies and sets; not the profiler's annotations).

- A call is a harness span. A program span belongs to the side of the call
  whose interval holds its start, so the sample decode inside
  ``compress.verify`` counts on the compress side.
- Busy time is the union of the device operations' intervals, so operations
  that overlap on several streams count once, clipped to the calls. The
  traced window is the calls themselves: the reference's checks between
  calls are neither busy nor idle time.
- Kernel time is the sum of the rows whose name holds a pattern.
"""
from __future__ import annotations

import bisect
from collections import defaultdict

SIDES = ("compress", "decompress")
CALL_PREFIX = "bench."


def union(intervals) -> list[tuple[int, int]]:
    """Disjoint, sorted union of ``(start, end)`` intervals."""
    out: list[list[int]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def overlap(a, b) -> int:
    """Total length of the intersection of two disjoint sorted interval lists."""
    i = j = total = 0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        if hi > lo:
            total += hi - lo
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


class Trace:
    def __init__(self, spans, device_ops):
        self.spans = sorted(spans, key=lambda r: r[1])
        self.device_ops = list(device_ops)
        self.calls = {side: [] for side in SIDES}
        for name, s, e in self.spans:
            if name.startswith(CALL_PREFIX) and name[len(CALL_PREFIX):] in self.calls:
                self.calls[name[len(CALL_PREFIX):]].append((s, e))
        self._starts = {side: [s for s, _ in self.calls[side]] for side in SIDES}
        self._busy = union((s, e) for _, s, e in self.device_ops)

    @classmethod
    def from_profiler(cls, prof) -> "Trace":
        """The spans and device operations of a finished ``torch.profiler.profile``."""
        from torch.autograd import DeviceType

        spans, ops = [], []
        for ev in prof.profiler.kineto_results.events():
            dt, ann = ev.device_type(), ev.is_user_annotation()
            if dt == DeviceType.CPU and ann:
                spans.append((ev.name(), ev.start_ns(), ev.end_ns()))
            elif dt == DeviceType.CUDA and not ann:
                ops.append((ev.name(), ev.start_ns(), ev.end_ns()))
        return cls(spans, ops)

    def side_of(self, t: int):
        """The side of the call whose interval holds time ``t``, or None."""
        for side in SIDES:
            k = bisect.bisect_right(self._starts[side], t) - 1
            if k >= 0 and self.calls[side][k][1] >= t:
                return side
        return None

    def n_calls(self, side: str) -> int:
        return len(self.calls[side])

    def wall_s(self, side: str | None = None) -> float:
        sides = SIDES if side is None else (side,)
        return sum(e - s for sd in sides for s, e in self.calls[sd]) / 1e9

    def busy_s(self, side: str | None = None) -> float:
        sides = SIDES if side is None else (side,)
        windows = union(iv for sd in sides for iv in self.calls[sd])
        return overlap(self._busy, windows) / 1e9

    def span_ms(self, side: str, match, outside=()) -> float:
        """Host ms of the program spans on ``side`` whose name ``match``
        accepts, leaving out those inside a span named in ``outside``."""
        skip = union((s, e) for n, s, e in self.spans if n in outside)
        skip_starts = [s for s, _ in skip]
        total = 0
        for name, s, e in self.spans:
            if name.startswith(CALL_PREFIX) or not match(name) or self.side_of(s) != side:
                continue
            k = bisect.bisect_right(skip_starts, s) - 1
            if k >= 0 and skip[k][1] >= e and (skip[k][0], skip[k][1]) != (s, e):
                continue
            total += e - s
        return total / 1e6

    def kernel_s(self, pattern: str) -> tuple[float, int]:
        """(seconds, rows) of the device operations whose name holds ``pattern``."""
        rows = [(e - s) for n, s, e in self.device_ops if pattern in n]
        return sum(rows) / 1e9, len(rows)

    def breakdown(self, top: int = 10, width: int = 120) -> dict:
        """The device operations that took most time, and the idle time
        inside the calls summed by the innermost host span open over it."""
        by_op = defaultdict(int)
        for n, s, e in self.device_ops:
            by_op[n[:width]] += e - s
        windows = union(iv for sd in SIDES for iv in self.calls[sd])
        ends = [be for _, be in self._busy]
        gaps = []
        for ws, we in windows:
            cur = ws
            k = bisect.bisect_right(ends, ws)
            while k < len(self._busy) and self._busy[k][0] < we:
                bs, be = self._busy[k]
                if bs > cur:
                    gaps.append((cur, bs))
                cur = max(cur, be)
                k += 1
            if cur < we:
                gaps.append((cur, we))
        by_host = defaultdict(int)
        segs = self._segments()
        k = 0
        for gs, ge in gaps:  # each part of a gap goes to the span innermost over that part
            while k < len(segs) and segs[k][1] <= gs:
                k += 1
            j = k
            while j < len(segs) and segs[j][0] < ge:
                lo, hi = max(gs, segs[j][0]), min(ge, segs[j][1])
                if hi > lo:
                    by_host[segs[j][2]] += hi - lo
                j += 1
        rank = lambda d: [[k, v / 1e9] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:top]]
        return {"device_ops": rank(by_op), "idle_gaps": rank(by_host)}

    def _segments(self) -> list[tuple[int, int, str]]:
        """Time cut at every span boundary, each piece named by the innermost
        span open over it (spans nest on one thread)."""
        events = sorted([(s, 1, i) for i, (_, s, _) in enumerate(self.spans)]
                        + [(e, 0, i) for i, (_, _, e) in enumerate(self.spans)])
        out, stack, last = [], [], None
        for t, kind, i in events:
            if stack and last is not None and t > last:
                out.append((last, t, self.spans[stack[-1]][0]))
            if kind:
                stack.append(i)
            elif i in stack:
                stack.remove(i)
            last = t
        return out
