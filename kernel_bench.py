#!/usr/bin/env python3
"""Time one kernel at its path's shapes on one NVIDIA card.

    python3 kernel_bench.py --kernel interp|lorenzo|histogram [--src DIR]
                            [--splines S,S,S,S --schemes M,M,M,M] [--out FILE]

Makes the 512^3 Nyx-like field of ``chip_smoke.py`` on the card from seed
0 and runs ``chip_smoke.py``'s phase-6 code for the kernel: each is checked
against its plain version, then timed with CUDA events over 20 launches
(for lorenzo and histogram also the kernel alone, by the profiler).

- ``interp``: the encode and decode kernels on the field's 17^3 blocks
  under the default spec's plan (``--splines`` and ``--schemes`` replace
  it, one per level);
- ``lorenzo``: the Lorenzo encode on the field under the ``fzgpu_like``
  bound;
- ``histogram``: histogram256 on the main path's hf input, and on a
  uniform random stream of its length.

``--src`` names the ``src`` directory whose ``repro_torch`` is timed
(default: this checkout's), so one call can time two checkouts in turns.
Prints one JSON line.
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
    ap.add_argument("--kernel", required=True, choices=("interp", "lorenzo", "histogram"))
    ap.add_argument("--src", default=str(chip_smoke.ROOT / "src"))
    ap.add_argument("--splines", default=None, help="interp: comma-separated, one per level, in place of the plan's")
    ap.add_argument("--schemes", default=None, help="interp: comma-separated, one per level, in place of the plan's")
    ap.add_argument("--out", default=None, help="append the JSON line to this file")
    args = ap.parse_args()
    sys.path.insert(0, str(pathlib.Path(args.src).resolve()))

    import torch

    if not torch.cuda.is_available():
        print("kernel_bench: CUDA is not available; this script runs on an NVIDIA card", file=sys.stderr)
        return 2
    import repro_torch.core as core
    from repro_torch.core import Compressor
    from repro_torch.core.compressor import _sections_unpack
    from repro_torch.core.lossless import pipelines

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    device = torch.device("cuda", 0)
    x = chip_smoke.nyx_like(SIDE, SEED, device)
    out = {"src": args.src, "card": card, "kernel": args.kernel}
    if args.kernel == "interp":
        header = Compressor.inspect(Compressor().compress(x))
        if args.splines:
            header["splines"] = args.splines.split(",")
        if args.schemes:
            header["schemes"] = args.schemes.split(",")
        im = chip_smoke.interp_main_shapes(x, header, ITERS)
        out.update(nb=int(im["blocks"].shape[0]), anchor_stride=im["stride"], splines=header["splines"],
                   schemes=header["schemes"], n_outliers=int(im["decode_inputs"][1].numel()),
                   encode_ms=im["encode_ms"], decode_ms=im["decode_ms"])
    elif args.kernel == "lorenzo":
        out.update(chip_smoke.lorenzo_path_shapes(x, core.fzgpu_like().compress(x), ITERS))
    else:
        seq = pipelines.decode(_sections_unpack(Compressor().compress(x))[1][0], device=device)  # the hf input
        del x
        out.update(chip_smoke.histogram_path_shapes(seq, torch.Generator(device=device).manual_seed(SEED), ITERS))
    line = json.dumps(out)
    print(line)
    if args.out:
        with open(args.out, "a") as f:
            f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
