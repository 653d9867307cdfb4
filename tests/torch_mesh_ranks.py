"""Ranks of a ``gloo`` process group for the port's mesh tests.

Each rank is a subprocess (``python -c SCRIPT DIR ARGS...``) with the
``torchrun`` environment (``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``,
``MASTER_PORT``), one torch thread, and ``src`` (or a copy of the port's
sources) on ``PYTHONPATH``; it writes what it found to ``DIR/rank<R>.pkl``.
Nothing here touches the pytest process's own ``torch.distributed``
state. Every run has a deadline and kills its ranks on the way out, so a
hung collective fails one test and not the suite. Not a test file.
"""
from __future__ import annotations

import os
import pickle
import socket
import subprocess
import sys
import textwrap
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# the start of every rank's script: the group, the rank, and where to write
PRELUDE = textwrap.dedent("""
    import os, pickle, sys
    import numpy as np
    import torch
    import torch.distributed as dist
    torch.set_num_threads(1)
    OUT = sys.argv[1]
    ARGS = sys.argv[2:]
    from repro_torch.launch.mesh import init_process_group, make_mesh
    DEVICE = os.environ.get("MESH_DEVICE", "cpu")  # gloo, or NCCL on the card
    init_process_group(DEVICE)
    RANK = dist.get_rank()

    def finish(out):
        with open(os.path.join(OUT, f"rank{RANK}.pkl"), "wb") as f:
            pickle.dump(out, f)
        dist.destroy_process_group()
""")


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_ranks(script: str, n: int, out_dir, *, args=(), src: str | None = None, timeout: float = 60.0,
              device: str = "cpu") -> list:
    """Run ``PRELUDE + script`` as ``n`` ranks (``device="cuda"``: NCCL);
    returns each rank's pickled result. Raises with the failing rank's
    stderr if a rank fails or the deadline passes."""
    env = dict(os.environ, PYTHONPATH=src or os.path.join(ROOT, "src"), OMP_NUM_THREADS="1",
               MASTER_ADDR="127.0.0.1", MASTER_PORT=str(free_port()), WORLD_SIZE=str(n), MESH_DEVICE=device)
    env.pop("LOCAL_RANK", None)
    code = PRELUDE + textwrap.dedent(script)
    procs = [subprocess.Popen([sys.executable, "-c", code, str(out_dir), *map(str, args)],
                              env=dict(env, RANK=str(r), LOCAL_RANK=str(r)),
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE) for r in range(n)]
    deadline = time.monotonic() + timeout
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=max(deadline - time.monotonic(), 0.1)))
    finally:
        for p in procs:
            p.kill()
            p.wait()
    bad = [(r, p.returncode, err.decode()[-4000:]) for r, (p, (_, err)) in enumerate(zip(procs, outs))
           if p.returncode != 0]
    assert not bad, bad[0]
    results = []
    for r in range(n):
        with open(os.path.join(str(out_dir), f"rank{r}.pkl"), "rb") as f:
            results.append(pickle.load(f))
    return results


def run_jax(code: str, devices: int = 4, timeout: float = 60.0) -> str:
    """``code`` in a JAX subprocess with ``devices`` host devices; its stdout."""
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"), JAX_PLATFORMS="cpu",
               XLA_FLAGS=f"--xla_force_host_platform_device_count={devices}")
    r = subprocess.run([sys.executable, "-c", textwrap.dedent(code)], env=env, capture_output=True, text=True,
                       timeout=timeout)
    assert r.returncode == 0, r.stderr[-4000:]
    return r.stdout


# ------------------------------------------------------------ train steps
STEP_WORKER = """
import dataclasses, importlib, time

with open(ARGS[0], "rb") as f:
    cases = pickle.load(f)
out = {}
src_now = None


def serve_case(case):
    # prefill on the placed parameters, then decode steps from the one-device
    # prefill's cache placed by cache_pspecs; every output gathered whole
    from repro_torch.configs import get_config
    from repro_torch.core.tree import leaf_paths, tree_map
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import init_params
    from repro_torch.runtime import partitioning as part
    from repro_torch.runtime import sharding_rules as rules_mod
    from repro_torch.runtime.partitioning import NamedSharding
    from repro_torch.runtime.steps import make_prefill_step, make_serve_step
    mesh = make_mesh(*case["mesh"], device_type="cpu")
    cfg = dataclasses.replace(get_config(case["arch"]).scaled(), **case["cfg"])
    params = init_params(cfg, torch.Generator().manual_seed(1), "cpu")
    for path, leaf in leaf_paths(params):  # a sharper router: no top-k near-tie for rounding to flip
        if path.endswith("moe_router"):
            leaf.mul_(case.get("router_scale", 1.0))
    rules = rules_mod.activation_rules(cfg, mesh)
    placed = rules_mod.place(params, rules_mod.tree_shardings(params, cfg, mesh))
    cache = rules_mod.place(case["cache"], tree_map(lambda s: NamedSharding(mesh, s),
                                                    rules_mod.cache_pspecs(case["cache"], cfg, mesh, rules)))
    whole = lambda t: t.full_tensor().float().numpy()
    with part.mesh_rules(mesh, rules):
        logits, _ = make_prefill_step(cfg)(placed, case["batch"])
        res = {"prefill": whole(logits), "decode": []}
        step = make_serve_step(cfg)
        for i, tok in enumerate(case["tokens"]):
            tok = rules_mod.place(torch.from_numpy(tok), NamedSharding(mesh, rules_mod.P("data")))
            lg, cache = step(placed, cache, tok, case["pos"] + i)
            res["decode"].append(whole(lg))
    res["cache"] = [whole(t) for _, t in leaf_paths(cache)]
    return res


for name, case in cases.items():
    if case.get("kind") == "serve":
        out[name] = serve_case(case)
        continue
    if case["src"] != src_now:  # a planted fault's copy of the port: import it afresh
        for k in [k for k in sys.modules if k == "repro_torch" or k.startswith("repro_torch.")]:
            del sys.modules[k]
        if src_now is not None:
            sys.path.remove(src_now)
        if case["src"] is not None:
            sys.path.insert(0, case["src"])
        importlib.invalidate_caches()
        src_now = case["src"]
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.configs import get_config
    from repro_torch.core.tree import leaf_paths
    from repro_torch.runtime import steps
    shape, axes = case["mesh"]
    mesh = make_mesh(shape, axes, device_type="cpu")
    cfg = dataclasses.replace(get_config(case["arch"]).scaled(), **case["cfg"])
    pods = case["pods"]
    seen = []
    if pods:  # keep what each rank sends and gets in the exchange: its blocks, and the int8 payloads it quantized
        from repro_torch.optim import grad_compress
        real, real_q = steps.pod_allreduce_compressed, grad_compress.quantize_shard
        sent = []

        def spy_q(t, amax=None):
            q, s = real_q(t, amax)
            sent.append((q, float(s)))
            return q, s

        def spy(g, r, group=None, shard_groups=()):
            avg, new_r = real(g, r, group=group, shard_groups=shard_groups)
            seen.append((list(g), list(r), list(avg), list(new_r), [q for q, _ in sent], [s for _, s in sent]))
            return avg, new_r

        steps.pod_allreduce_compressed, grad_compress.quantize_shard = spy, spy_q
    state = steps.make_train_state(cfg, torch.Generator().manual_seed(1), device="cpu", mesh=mesh, npods=shape[0] if pods else 0)
    step = steps.make_train_step(cfg, mesh, grad_clip=case.get("clip", 1e30), compress_pods=pods)
    t0 = time.perf_counter()
    new, met = step(state, case["batch"])
    wall = time.perf_counter() - t0
    if pods:
        steps.pod_allreduce_compressed, grad_compress.quantize_shard = real, real_q
        # each block gathered over its pod's ("data", "model") sub-mesh: the pod's whole tensor
        from torch.distributed.tensor import DTensor
        sub = mesh.sub(axes[1:]).device_mesh
        refs = [t for _, t in leaf_paths(state.params)]

        def whole(t, ref):
            return DTensor.from_local(t, sub, tuple(ref.placements[1:]), run_check=False, shape=ref.shape,
                                      stride=ref.stride()).full_tensor().numpy()

        seen = [tuple([whole(t, ref) for t, ref in zip(ts, refs, strict=True)] for ts in ex[:5]) + (ex[5],) for ex in seen]
    kept = all(tuple(a.placements) == tuple(b.placements) and a.shape == b.shape
               for (_, a), (_, b) in zip(leaf_paths(new), leaf_paths(state), strict=True))
    m = [t.full_tensor().numpy() for _, t in leaf_paths(new.opt.m)]
    p = [t.full_tensor().numpy() for _, t in leaf_paths(new.params)] if pods else None
    out[name] = {"loss": float(met["loss"]), "grad_norm": float(met["grad_norm"]), "m": m, "params": p,
                 "kept": kept, "exchange": seen, "wall": wall, "rank_in_pod": mesh.rank_in("pod") if pods else None}
finish(out)
"""


def step_batch(cfg, seed: int = 0, b: int = 8, s: int = 16) -> dict:
    """A seeded batch of ``b`` sequences of ``s`` positions (the vit
    family's image tokens among them), labels partly -1."""
    import numpy as np

    r = np.random.default_rng(seed)
    text = s - (cfg.n_img_tokens if cfg.stub_frontend == "vit" else 0)
    batch = {"tokens": r.integers(0, cfg.vocab, (b, text)).astype(np.int32),
             "labels": r.integers(0, cfg.vocab, (b, text)).astype(np.int32)}
    batch["labels"][:, :2] = -1
    if cfg.stub_frontend == "vit":
        batch["img"] = r.standard_normal((b, cfg.n_img_tokens, cfg.d_model)).astype(np.float32)
    if cfg.enc_layers:
        batch["frames"] = r.standard_normal((b, cfg.enc_seq, cfg.d_model)).astype(np.float32)
    return batch


def reference_step(cfg, batch, *, data_shards: int = 1, pods: int = 0, clip: float = 1e30):
    """Slice 10's step on one process from the same seed and batch (no clip
    unless ``clip``): ``(loss, grad_norm, m leaves, params leaves, state)``. ``data_shards``
    runs the MoE on each data shard's tokens, as it runs on a mesh (its
    capacity and balance loss are per shard); ``pods`` takes the global
    view of the compressed step."""
    import types

    import torch

    from repro_torch.core.tree import leaf_paths
    from repro_torch.models import model as model_mod
    from repro_torch.models.layers import _moe_local
    from repro_torch.runtime.steps import make_train_state, make_train_step

    def per_shard(x, p, c):
        ys, auxs = zip(*[_moe_local(xs, p, c, None) for xs in x.chunk(data_shards, 0)])
        return torch.cat(ys, 0), torch.stack(auxs).mean()

    real = model_mod.moe_ffn
    model_mod.moe_ffn = per_shard if data_shards > 1 else real
    try:
        state = make_train_state(cfg, torch.Generator().manual_seed(1), device="cpu", npods=pods)
        mesh = types.SimpleNamespace(shape={"pod": pods}) if pods else None
        new, met = make_train_step(cfg, mesh, grad_clip=clip, compress_pods=bool(pods))(state, batch)
    finally:
        model_mod.moe_ffn = real
    return (float(met["loss"]), float(met["grad_norm"]), [t.numpy() for _, t in leaf_paths(new.opt.m)],
            [t.numpy() for _, t in leaf_paths(new.params)], state)


_REFS: dict = {}


def reference(case: dict, data_shards: int = 1, pods: int = 0):
    """:func:`reference_step` of a ``STEP_WORKER`` case, computed once a
    process (the planted faults share their base case's)."""
    import dataclasses

    from repro_torch.configs import get_config

    key = (case["arch"], tuple(sorted(case["cfg"].items())), len(case["batch"]["tokens"]), data_shards, pods,
           case.get("clip", 1e30))
    if key not in _REFS:
        cfg = dataclasses.replace(get_config(case["arch"]).scaled(), **case["cfg"])
        _REFS[key] = reference_step(cfg, case["batch"], data_shards=data_shards, pods=pods,
                                    clip=case.get("clip", 1e30))
    return _REFS[key]


def run_steps(cases: dict, out_dir, refs=lambda case: (1, 0)) -> list:
    """``STEP_WORKER`` over ``cases`` on 4 ranks; meanwhile this process
    computes each case's :func:`reference` (``refs(case)`` gives its
    ``(data_shards, pods)``). Returns each rank's results."""
    import concurrent.futures

    src = os.path.join(str(out_dir), "cases.pkl")
    with open(src, "wb") as f:
        pickle.dump(cases, f)
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        done = pool.submit(lambda: [reference(c, *refs(c)) for c in cases.values()])
        try:
            return run_ranks(STEP_WORKER, 4, out_dir, args=[src])
        finally:
            done.result()


def rel_errors(got, want) -> list:
    """||got - want|| / ||want|| per leaf (||got|| where want is zero)."""
    import numpy as np

    out = []
    for a, b in zip(got, want, strict=True):
        nb = float(np.linalg.norm(b.astype(np.float64)))
        d = float(np.linalg.norm(a.astype(np.float64) - b.astype(np.float64)))
        out.append(d / nb if nb > 0 else d)
    return out


def mutated_port(dest, old: str, new: str, path: str) -> str:
    """A copy of the port's sources under ``dest`` with ``old`` replaced by
    ``new`` (once, in ``path`` under ``repro_torch/``): a planted fault.
    Returns the directory to put on ``sys.path``."""
    import pathlib
    import shutil

    src = pathlib.Path(ROOT) / "src" / "repro_torch"
    root = pathlib.Path(dest)
    shutil.copytree(src, root / "repro_torch", ignore=shutil.ignore_patterns("__pycache__", "_build"))
    f = root / "repro_torch" / path
    text = f.read_text()
    assert text.count(old) == 1, (path, old)
    f.write_text(text.replace(old, new))
    return str(root)
