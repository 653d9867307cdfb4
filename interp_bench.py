#!/usr/bin/env python3
"""Time the interp kernels at the main path's shapes on one NVIDIA card.

    python3 interp_bench.py [--src DIR] [--splines S,S,S,S --schemes M,M,M,M] [--out FILE]

Makes the 512^3 Nyx-like field of ``chip_smoke.py`` on the card from seed
0, compresses it once with the default spec for its plan (``--splines``
and ``--schemes`` replace the plan's, one per level), and runs
``chip_smoke.interp_main_shapes`` on it: the kernels are checked against
the plain predictor bit for bit, then timed with CUDA events over 20
launches. ``--src`` names the ``src`` directory whose ``repro_torch`` is
timed (default: this checkout's), so one call can time two checkouts in
turns. Prints one JSON line.
"""
from __future__ import annotations

import argparse
import json
import pathlib
import subprocess
import sys

import chip_smoke  # puts this checkout's src first on sys.path; imports no repro_torch

SIDE, SEED, ITERS = 512, 0, 20


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--src", default=str(chip_smoke.ROOT / "src"))
    ap.add_argument("--splines", default=None, help="comma-separated, one per level, in place of the plan's")
    ap.add_argument("--schemes", default=None, help="comma-separated, one per level, in place of the plan's")
    ap.add_argument("--out", default=None, help="append the JSON line to this file")
    args = ap.parse_args()
    sys.path.insert(0, str(pathlib.Path(args.src).resolve()))

    import torch

    if not torch.cuda.is_available():
        print("interp_bench: CUDA is not available; this script runs on an NVIDIA card", file=sys.stderr)
        return 2
    from repro_torch.core import Compressor

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    x = chip_smoke.nyx_like(SIDE, SEED, torch.device("cuda", 0))
    header = Compressor.inspect(Compressor().compress(x))
    if args.splines:
        header["splines"] = args.splines.split(",")
    if args.schemes:
        header["schemes"] = args.schemes.split(",")
    im = chip_smoke.interp_main_shapes(x, header, ITERS)
    out = {"src": args.src, "card": card, "nb": int(im["blocks"].shape[0]), "anchor_stride": im["stride"],
           "splines": header["splines"], "schemes": header["schemes"],
           "n_outliers": int(im["decode_inputs"][1].numel()),
           "encode_ms": im["encode_ms"], "decode_ms": im["decode_ms"]}
    line = json.dumps(out)
    print(line)
    if args.out:
        with open(args.out, "a") as f:
            f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
