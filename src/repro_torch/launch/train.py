"""End-to-end training driver.

    python -m repro_torch.launch.train --arch yi-34b --scaled --steps 200 --ckpt-dir DIR [--device cpu]
    python -m repro_torch.launch.train --arch whisper-small --ckpt-eb 1e-3 --ckpt-dir DIR
    python -m torch.distributed.run --nproc-per-node 4 -m repro_torch.launch.train --scaled \
        --arch olmoe-1b-7b --mesh 2,2 [--device cpu]

--scaled trains the reduced config; with --ckpt-eb the checkpoints go
through the cuSZ-Hi codec. Flags, defaults and the printed loss line are
the JAX package's (``repro.launch.train``), but for ``--ckpt-dir``'s
default, which lies under ``TMPDIR`` and apart from the JAX package's
``/tmp/repro_ckpt`` (a run resumes from the latest step in its directory,
and each package restores the other's checkpoints); the driver trains on the card
unless given ``--device cpu`` and raises where CUDA is absent.

``--mesh`` lays the ranks out as the JAX package does: ``2,2`` is
``("data", "model")``, ``2,2,2`` ``("pod", "data", "model")`` and one
number ``("model",)``; the state and batch are placed by the partitioning
rules and the activations follow ``activation_rules``, and
``--compress-pods`` exchanges int8 gradients over the ``pod`` axis. The
ranks come from ``torchrun``'s environment (NCCL on the card, gloo with
``--device cpu``); with no such environment a mesh of one rank starts a
group of one itself, and a mesh whose size is not the world size raises.
Only rank 0 prints; every rank returns the same losses and steps.
"""
from __future__ import annotations

import argparse
import math
import time

import numpy as np
import torch

from ..configs import get_config
from ..data.synthetic import Prefetcher, TokenPipeline
from ..models import model_device
from ..runtime import partitioning as part
from ..runtime import sharding_rules as rules_mod
from ..runtime.steps import make_train_state, make_train_step
from ..runtime.train_loop import LoopConfig, Trainer, default_ckpt_dir
from .mesh import init_process_group, make_mesh


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
    device = model_device(args.device)
    cfg = get_config(args.arch)
    if args.scaled:
        cfg = cfg.scaled()
    mesh = rules = None
    if args.mesh:
        dims = tuple(int(x) for x in args.mesh.split(","))
        axes = ("pod", "data", "model")[-len(dims):]
        init_process_group(device.type, world_size=math.prod(dims))
        mesh = make_mesh(dims, axes, device_type=device.type)
        rules = rules_mod.activation_rules(cfg, mesh)
        device = part.mesh_device(mesh.device_mesh)
    lead = mesh is None or torch.distributed.get_rank() == 0
    say = print if lead else (lambda *a, **k: None)

    extras = {}
    if cfg.stub_frontend == "vit":
        extras["img"] = (cfg.n_img_tokens, cfg.d_model)
    if cfg.enc_layers:
        extras["frames"] = (cfg.enc_seq, cfg.d_model)
    data = Prefetcher(TokenPipeline(cfg.vocab, args.batch, args.seq, extras=extras))

    with part.mesh_rules(mesh, rules):
        npods = mesh.shape.get("pod", 0) if (mesh is not None and args.compress_pods) else 0
        state = make_train_state(cfg, torch.Generator(device=device).manual_seed(0), npods=npods, device=device,
                                 mesh=mesh)
        step = make_train_step(cfg, mesh, lr=args.lr, compress_pods=args.compress_pods)
        return _train(args, cfg, state, step, data, device, say)


def _train(args, cfg, state, step, data, device, say) -> dict:
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
        log=say,
    )
    start = trainer.step
    t0 = time.perf_counter()
    trainer.run()
    wall = time.perf_counter() - t0
    losses = trainer.losses
    if losses:
        k = max(len(losses) // 5, 1)
        say(f"first-{k} mean loss {np.mean(losses[:k]):.4f} -> last-{k} {np.mean(losses[-k:]):.4f}")
    else:
        say(f"no step to take: resumed at step {start} of --steps {args.steps} from {ckpt_dir}")
    return {"losses": list(losses), "steps": trainer.step, "start_step": start, "step_s": step_s, "wall_s": wall,
            "stragglers": trainer.stragglers, "trainer": trainer, "cfg": cfg}


def main(argv=None) -> int:
    import torch.distributed as dist

    started = not dist.is_initialized()
    try:
        run(argv)
    finally:
        if started and dist.is_initialized():
            dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
