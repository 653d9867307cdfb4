#!/usr/bin/env python3
"""Time the decode's host-to-device uploads on one NVIDIA card.

    python3 staging_bench.py [--src DIR] [--out FILE]

Sections of a container's ``bytes`` go to the card several ways, each call
timed to the end of ``torch.cuda.synchronize()`` (the median of two rounds
of repeats, the ways taken in turn):

- ``pageable``: the slice of the ``bytes`` (a fresh copy), ``arr.copy()``
  and ``.to(device)``, as decodes did before the staging ring;
- ``upload``: ``repro_torch.core.staging.upload`` of a view of the
  ``bytes``, the program's ring.

From 1 KiB to 64 MiB; at the two largest sizes of a container's stream in
the benchmark (Nyx's ~58 MB, Miranda's ~11 MB) also every ring of 2-16 MiB
chunks and 2-4 slots, and at 58 MB the two bounds of a ring: the host's
copy into pinned memory alone and the DMA of a pinned buffer alone.
``--src`` names the ``src`` directory whose ``repro_torch`` is timed
(default: this checkout's). Prints one JSON line.
"""
from __future__ import annotations

import argparse
import json
import pathlib
import statistics
import subprocess
import sys
import time

import numpy as np

SIZES = [1 << 10, 4 << 10, 16 << 10, 64 << 10, 256 << 10, 1 << 20, 4 << 20, 11_000_000, 58_000_000, 64 << 20]
SWEEP_SIZES = [11_000_000, 58_000_000]
CHUNKS = [2 << 20, 4 << 20, 8 << 20, 16 << 20]
SLOTS = [2, 3, 4]
ROUNDS = 2


def _walls(fn, reps: int) -> list:
    import torch

    walls = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    return walls


def _compare(fns: dict, reps: int) -> dict:
    """Median ms of each way, over ``ROUNDS`` rounds that take the ways in turn."""
    import torch

    walls = {k: [] for k in fns}
    for fn in fns.values():
        fn()
    torch.cuda.synchronize()
    for _ in range(ROUNDS):
        for k, fn in fns.items():
            walls[k] += _walls(fn, reps)
    return {k: statistics.median(w) * 1e3 for k, w in walls.items()}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", default=str(pathlib.Path(__file__).resolve().parent / "src"))
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    sys.path.insert(0, args.src)
    import torch

    from repro_torch.core import staging

    dev = torch.device("cuda")
    buf = np.random.default_rng(0).integers(0, 256, max(SIZES) + 4096, np.uint8).tobytes()
    off = 13  # a section's offset in its container is arbitrary
    mv = memoryview(buf)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    out = {"card": card, "torch": torch.__version__, "chunk": staging.CHUNK, "slots": staging.SLOTS,
           "ms": {}, "sweep_ms": {}, "bounds_ms": {}}

    def through(ring, n):
        def fn():
            t = torch.empty(n, dtype=torch.uint8, device=dev)
            ring.copy(np.frombuffer(mv[off : off + n], np.uint8), t)
            return t
        return fn

    for n in SIZES:
        fns = {"pageable": lambda n=n: torch.from_numpy(np.frombuffer(buf[off : off + n], np.uint8).copy()).to(dev),
               "upload": lambda n=n: staging.upload(mv[off : off + n], dev)}
        for k, fn in fns.items():
            y = fn()
            torch.cuda.synchronize()
            assert bytes(y.cpu().numpy()) == buf[off : off + n], (k, n)
        out["ms"][n] = _compare(fns, 20 if n <= (4 << 20) else 8)
    for n in SWEEP_SIZES:
        rings = {f"{n}/{c >> 20}MiB/{k}": staging.Ring(c, k) for c in CHUNKS for k in SLOTS}
        out["sweep_ms"].update(_compare({name: through(r, n) for name, r in rings.items()}, 8))
        del rings
    n = 58_000_000
    pinned = torch.empty(n, dtype=torch.uint8, pin_memory=True)
    dst = torch.empty(n, dtype=torch.uint8, device=dev)
    src = np.frombuffer(mv[off : off + n], np.uint8)
    out["bounds_ms"] = _compare({"host_copy_58M": lambda: pinned.numpy().__setitem__(slice(None), src),
                                 "dma_58M": lambda: dst.copy_(pinned, non_blocking=True)}, 8)
    line = json.dumps(out)
    if args.out:
        pathlib.Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        pathlib.Path(args.out).write_text(line + "\n")
    print(line)
    return out


if __name__ == "__main__":
    main()
