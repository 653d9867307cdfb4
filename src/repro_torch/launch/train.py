"""End-to-end training driver.

    python -m repro_torch.launch.train --arch yi-34b --scaled --steps 200 --ckpt-dir DIR [--device cpu]
    python -m repro_torch.launch.train --arch whisper-small --ckpt-eb 1e-3 --ckpt-dir DIR

--scaled trains the reduced config; with --ckpt-eb the checkpoints go
through the cuSZ-Hi codec. Flags, defaults and the printed loss line are
the JAX package's (``repro.launch.train``), but for ``--ckpt-dir``'s
default, which lies under ``TMPDIR`` and apart from the JAX package's
``/tmp/repro_ckpt`` (a run resumes from the latest step in its directory,
and each package restores the other's checkpoints); the driver trains on the card
unless given ``--device cpu`` and raises where CUDA is absent. A device
mesh (``--mesh``, ``--compress-pods``) is not ported yet: those flags
raise rather than train without the mesh.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from ..configs import get_config
from ..data.synthetic import Prefetcher, TokenPipeline
from ..models import model_device
from ..runtime.steps import make_train_state, make_train_step
from ..runtime.train_loop import LoopConfig, Trainer, default_ckpt_dir

MESH_NOT_PORTED = ("--mesh and --compress-pods need the port's device mesh, which is not ported yet "
                   "(ROADMAP.md queue 1, slice 11); this driver trains on one device")


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="yi-34b")
    ap.add_argument("--scaled", action="store_true", help="train the reduced smoke config")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--mesh", default="", help="e.g. 2,2 -> (data,model); 2,2,2 -> (pod,data,model)")
    ap.add_argument("--compress-pods", action="store_true")
    ap.add_argument("--ckpt-dir", default=None,
                    help="checkpoints here; a run resumes from the latest step it finds (default: repro_torch_ckpt "
                         "under TMPDIR, else /tmp)")
    ap.add_argument("--ckpt-eb", type=float, default=0.0)
    ap.add_argument("--save-every", type=int, default=50)
    ap.add_argument("--device", default=None, help="train here (default: the card)")
    return ap


def run(argv=None) -> dict:
    """The driver behind :func:`main`: parse ``argv``, train, print the JAX
    package's loss line, and return what it reports: ``losses`` (one per
    step this run took), ``steps`` (the step the run ended at),
    ``start_step`` (the step it resumed from), ``step_s`` (each step's host
    wall), ``wall_s``, ``stragglers``, and the ``trainer`` itself (its
    final ``state``)."""
    args = _parser().parse_args(argv)
    if args.mesh or args.compress_pods:
        raise NotImplementedError(MESH_NOT_PORTED)
    device = model_device(args.device)
    cfg = get_config(args.arch)
    if args.scaled:
        cfg = cfg.scaled()

    extras = {}
    if cfg.stub_frontend == "vit":
        extras["img"] = (cfg.n_img_tokens, cfg.d_model)
    if cfg.enc_layers:
        extras["frames"] = (cfg.enc_seq, cfg.d_model)
    data = Prefetcher(TokenPipeline(cfg.vocab, args.batch, args.seq, extras=extras))

    state = make_train_state(cfg, torch.Generator(device=device).manual_seed(0), device=device)
    step = make_train_step(cfg, None, lr=args.lr)
    step_s: list[float] = []

    def timed(s, b):
        t0 = time.perf_counter()
        out = step(s, b)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        step_s.append(time.perf_counter() - t0)
        return out

    ckpt_dir = args.ckpt_dir or default_ckpt_dir()
    trainer = Trainer(
        timed,
        state,
        data,
        LoopConfig(total_steps=args.steps, save_every=args.save_every, ckpt_dir=ckpt_dir, ckpt_eb=args.ckpt_eb),
    )
    start = trainer.step
    t0 = time.perf_counter()
    trainer.run()
    wall = time.perf_counter() - t0
    losses = trainer.losses
    if losses:
        k = max(len(losses) // 5, 1)
        print(f"first-{k} mean loss {np.mean(losses[:k]):.4f} -> last-{k} {np.mean(losses[-k:]):.4f}")
    else:
        print(f"no step to take: resumed at step {start} of --steps {args.steps} from {ckpt_dir}")
    return {"losses": list(losses), "steps": trainer.step, "start_step": start, "step_s": step_s, "wall_s": wall,
            "stragglers": trainer.stragglers, "trainer": trainer, "cfg": cfg}


def main(argv=None) -> int:
    run(argv)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
