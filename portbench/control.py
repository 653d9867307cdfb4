"""The readings that the limits of ``correct`` are set from, on the card at a cell's own size.

    python3 portbench/control.py --workload <cell> --seeds 11 12 13 --seconds 3 [--program 0|1]

For each seed, in one process: the program's run of the cell (a short
window at the cell's own load, ``--program 1``) and the control's, the
plain reference put in the program's place and computed in bfloat16
(:class:`portbench.reference.PlainBF16`). Prints one JSON line per run
with the numbers compared and the verdict. The benchmark's own runs never
run the control.
"""
from __future__ import annotations

import json
import pathlib
import sys

HERE = pathlib.Path(__file__).resolve().parent
sys.path[:] = [p for p in sys.path if pathlib.Path(p or ".").resolve() != HERE]
sys.path.insert(0, str(HERE.parent))


def control_codec(cell: str, device, bench_dir=None):
    from portbench.harness import BENCH_DIR, load_cell
    from portbench.reference import PlainBF16

    spec = load_cell(cell, bench_dir or BENCH_DIR)["config"]["spec"]
    return PlainBF16(spec["eb"], spec["eb_mode"], device)


def main(argv) -> int:
    import argparse

    import torch

    from portbench.harness import run_cell

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--program", type=int, choices=(0, 1), default=1)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("the control runs on the card", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    for seed in args.seeds:
        sides = (("program", None), ("control", control_codec(args.workload, device)))
        for side, codec in sides[0 if args.program else 1:]:
            out = run_cell(args.workload, seed, args.seconds, False, device, codec=codec)
            print(json.dumps({"side": side, "cell": args.workload, "seed": seed, "correct": out["correct"],
                              "attempted": out["attempted"], "checks": out["checks"]}, default=str), flush=True)
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
