"""The JAX package's LM stack as the oracle for repro_torch.models.

Shared by ``tests/test_torch_models_*.py`` (one file per family, so that
``--dist loadfile`` spreads the architectures over workers). For one
architecture at ``.scaled()`` it draws JAX parameters and carries them to
the port as numpy (``repro_torch.models.convert``), makes the inputs from
a numpy seed, and runs both packages' ``forward``, ``prefill`` and 4 greedy
``decode_step``s (the tokens taken from the JAX logits, so both packages
decode the same tokens). MoE architectures uncap the capacity
(``capacity_factor=100``), as the reference's own decode test does.

The JAX package runs unrolled (``scan_layers=False, remat=False``, its
own dry-run form): op by op, each bf16 op rounded where the port rounds
it. Its scanned form compiles each group as one program, which rounds in
other places: on deepseek-moe-16b the scanned and unrolled forwards of the
JAX package itself differ by 0.49 (a near-tie in the top-k routing flips),
while the port agrees with the unrolled one to 1e-7.

Tolerances, max-abs on logits and on every cache leaf: 0.05, the
reference's own (``tests/test_models_smoke.py``), for the dense, local,
MoE, vlm and audio families; 1e-3 for the ssm and hybrid families. The
reference allows those 0.15 because its decode and forward recur in
different orders, but the port's recurrences mirror the unrolled JAX
package's: it reads 1.2e-7 on logits and 1.4e-6 on an SSD state leaf
(mamba2-370m; recurrentgemma-2b 1.2e-7), while a logit's spread at
``.scaled()`` is itself 0.16, so 0.15 would pass a broken recurrence.
1e-3 fails each planted fault tried: dropping the SSD decay, conv or D
skip, or the RG-LRU decay or conv, reads 0.27-1.0 on logits; dropping the
RG-LRU's sqrt(1 - a^2) input gain reads 0.006-0.012 on logits and 0.0625
on its cache. ``python tests/torch_lm_oracle.py ARCH ...`` prints the
readings, and then the training readings of ``grad_readings``: the loss
and every gradient leaf of ``jax.value_and_grad(loss_fn)`` against the
port's ``loss_fn`` and ``torch.autograd.grad``, held to ``GRAD_LIMITS``.
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs import get_config as jget_config
from repro.models import decode_step as jdecode_step
from repro.models import forward as jforward
from repro.models import init_params as jinit_params
from repro.models import loss_fn as jloss_fn
from repro.models import prefill as jprefill
from repro_torch.configs import get_config as tget_config
from repro_torch.core.tree import leaf_paths
from repro_torch.models import decode_step, forward, prefill
from repro_torch.models import init_params as tinit_params
from repro_torch.models import loss_fn as tloss_fn
from repro_torch.models.convert import params_from_numpy, tree_to_numpy

B, S, DECODE_STEPS = 2, 16, 4


def tolerance(cfg) -> float:
    return 1e-3 if ("ssm" in cfg.pattern or "rglru" in cfg.pattern) else 0.05


def configs(arch: str):
    """(JAX config, port config) at .scaled(), MoE capacity uncapped; the
    JAX one unrolled (``scan_layers=False, remat=False``)."""
    kw = {"capacity_factor": 100.0} if jget_config(arch).n_experts else {}
    return jget_config(arch).scaled(scan_layers=False, remat=False, **kw), tget_config(arch).scaled(**kw)


def batches(cfg, seed: int = 0, seq: int = S):
    """The same inputs for both packages, from a numpy seed."""
    r = np.random.default_rng(seed)
    batch = {"tokens": r.integers(0, cfg.vocab, (B, seq)).astype(np.int32)}
    if cfg.stub_frontend == "vit":
        batch["img"] = r.standard_normal((B, cfg.n_img_tokens, cfg.d_model)).astype(np.float32)
    if cfg.enc_layers:
        batch["frames"] = r.standard_normal((B, cfg.enc_seq, cfg.d_model)).astype(np.float32)
    jb = {k: jnp.asarray(v) if k == "tokens" else jnp.asarray(v).astype(jnp.bfloat16) for k, v in batch.items()}
    tb = {k: torch.from_numpy(v).long() if k == "tokens" else torch.from_numpy(v).to(torch.bfloat16)
          for k, v in batch.items()}
    return jb, tb


def f32(a) -> np.ndarray:
    return np.asarray(a).astype(np.float32)


def run_both(arch: str) -> dict:
    """Both packages on the same weights and inputs; numpy results."""
    jcfg, tcfg = configs(arch)
    params = jinit_params(jcfg, jax.random.PRNGKey(1))
    tparams = params_from_numpy(jax.tree.map(np.asarray, params), "cpu")
    jb, tb = batches(jcfg)
    out = {"cfg": tcfg, "tol": tolerance(tcfg)}
    out["forward"] = (f32(jforward(params, jcfg, jb)[0]), f32(forward(tparams, tcfg, tb)[0]))
    cache_len = S + DECODE_STEPS + 2 + (jcfg.n_img_tokens if jcfg.stub_frontend == "vit" else 0)
    jl, jc = jprefill(params, jcfg, jb, cache_len=cache_len)
    tl, tc = prefill(tparams, tcfg, tb, cache_len=cache_len)
    out["prefill"] = (f32(jl), f32(tl))
    out["cache"] = (jax.tree.map(f32, jc), jax.tree.map(f32, tree_to_numpy(tc)))
    out["tree_equal"] = jax.tree.structure(jc) == jax.tree.structure(tc)
    pos0 = S + (jcfg.n_img_tokens if jcfg.stub_frontend == "vit" else 0)
    steps = []
    for i in range(DECODE_STEPS):
        tok = np.argmax(np.asarray(jl), -1).astype(np.int32)
        jl, jc = jdecode_step(params, jcfg, jnp.asarray(tok), jnp.int32(pos0 + i), jc)
        tl, tc = decode_step(tparams, tcfg, torch.from_numpy(tok).long(), pos0 + i, tc)
        steps.append((f32(jl), f32(tl)))
    out["decode"] = steps
    out["decode_cache"] = (jax.tree.map(f32, jc), jax.tree.map(f32, tree_to_numpy(tc)))
    return out


def max_diff(a, b) -> float:
    return float(np.abs(a - b).max())


def leaf_diffs(pair) -> list[float]:
    """max |a - b| per cache leaf."""
    ja, ta = pair
    return [max_diff(a, b) for a, b in zip(jax.tree.leaves(ja), jax.tree.leaves(ta))]


def readings(arch: str) -> dict:
    """max |JAX - port| of each compared output, and the spread of the
    JAX logits, for one architecture."""
    r = run_both(arch)
    return {"forward": max_diff(*r["forward"]), "prefill": max_diff(*r["prefill"]),
            "cache": max(leaf_diffs(r["cache"])), "decode": [max_diff(j, t) for j, t in r["decode"]],
            "decode_cache": max(leaf_diffs(r["decode_cache"])), "logit_std": float(np.std(r["forward"][0])),
            "tol": r["tol"]}


if __name__ == "__main__":
    import json
    import sys

    torch.set_num_threads(1)  # as the tests run
    for name in sys.argv[1:]:
        print(name, json.dumps(readings(name)), flush=True)
        print(name, "train", json.dumps(grad_readings(name)), flush=True)


# ------------------------------------------------------------ training
def label_batches(cfg, seed: int = 0, seq: int = S):
    """``batches`` plus int32 next-token labels, some of them -1 (masked)."""
    jb, tb = batches(cfg, seed, seq)
    r = np.random.default_rng(seed + 1)
    labels = r.integers(0, cfg.vocab, (B, seq)).astype(np.int32)
    labels[:, :2] = -1
    jb["labels"], tb["labels"] = jnp.asarray(labels), torch.from_numpy(labels)
    return jb, tb


def train_configs(arch: str):
    """``configs(arch)`` for the gradient comparison. recurrentgemma-2b's
    ``.scaled()`` is two groups of its 13-layer pattern; the comparison
    runs one group, because XLA compiles the 26 unrolled layers' gradient
    in ~47 s on the CPU (13 layers: ~15 s)."""
    jcfg, tcfg = configs(arch)
    if arch == "recurrentgemma-2b":
        n = len(tcfg.pattern) + tcfg.first_dense
        jcfg, tcfg = dataclasses.replace(jcfg, n_layers=n), dataclasses.replace(tcfg, n_layers=n)
    return jcfg, tcfg


def grads_both(arch: str, loss=None, seed: int = 0) -> dict:
    """Both packages' loss and gradients on the same weights and batch:
    ``jax.value_and_grad(loss_fn)`` of the unrolled JAX package against the
    port's ``loss_fn`` and ``torch.autograd.grad``. The JAX side is jitted
    with XLA's ``xla_allow_excess_precision`` off, so that a fusion rounds
    each bf16 op as eager JAX does (with it on, XLA keeps fused bf16 chains
    in float32 and the loss moves by ~3e-4); that compiles in 2-4 s where
    the eager gradient's per-op compiles take 15-35 s, and agrees with it to
    ~1e-8 on every gradient leaf. The weights
    are the port's draw from seed 1, carried to JAX as numpy (drawing them
    with ``jax.random`` costs seconds of compiles per architecture).
    ``loss`` replaces the port's ``loss_fn`` (a planted fault's copy)."""
    jcfg, tcfg = train_configs(arch)
    tparams = tinit_params(tcfg, torch.Generator().manual_seed(1), "cpu")
    params = jax.tree.map(jnp.asarray, tree_to_numpy(tparams))
    jb, tb = label_batches(jcfg, seed)
    compiled = jax.jit(jax.value_and_grad(jloss_fn), static_argnums=1).lower(params, jcfg, jb).compile(
        {"xla_allow_excess_precision": False})
    jl, jg = compiled(params, jb)
    names = [n for n, _ in leaf_paths(tparams)]
    leaves = [t.requires_grad_() for _, t in leaf_paths(tparams)]
    tl = (loss or tloss_fn)(tparams, tcfg, tb)
    tg = torch.autograd.grad(tl, leaves, allow_unused=True, materialize_grads=True)
    assert [n for n, _ in leaf_paths(jax.tree.map(np.asarray, jg))] == names
    return {"cfg": tcfg, "names": names, "loss": (float(jl), float(tl.detach())),
            "grads": [(f32(a), f32(b.detach())) for a, b in zip(jax.tree.leaves(jg), tg)]}


def grad_errors(pair) -> list[float]:
    """||port - JAX|| / ||JAX|| per gradient leaf (the absolute norm of the
    difference where the JAX gradient is zero)."""
    out = []
    for j, t in pair:
        nj = float(np.linalg.norm(j.astype(np.float64)))
        d = float(np.linalg.norm(j.astype(np.float64) - t.astype(np.float64)))
        out.append(d / nj if nj > 0 else d)
    return out


# Limits of the training comparison, by family: max |loss difference| and
# the largest gradient leaf's ||port - JAX|| / ||JAX||. Each is a few times
# its family's reading (``python tests/torch_lm_oracle.py ARCH`` prints
# them; PERF.md lists both).
GRAD_LIMITS = {
    "dense": (3e-4, 6e-2),
    "moe": (1e-4, 4e-2),
    "ssm": (2e-4, 3e-2),
    "hybrid": (1e-4, 6e-2),
    "vlm": (1e-4, 3e-2),
    "audio": (5e-4, 6e-2),
}


def grad_readings(arch: str) -> dict:
    """max |loss difference| and the worst gradient leaf's relative error,
    for one architecture at ``.scaled()``."""
    r = grads_both(arch)
    errs = grad_errors(r["grads"])
    worst = int(np.argmax(errs))
    return {"loss": abs(r["loss"][0] - r["loss"][1]), "grad_rel": errs[worst], "worst_leaf": r["names"][worst],
            "limits": GRAD_LIMITS[r["cfg"].family]}


def _port_grads(tcfg, tb, seed: int = 1):
    params = tinit_params(tcfg, torch.Generator().manual_seed(seed), "cpu")
    leaves = [t.requires_grad_() for _, t in leaf_paths(params)]
    loss = tloss_fn(params, tcfg, tb)
    return loss.detach(), torch.autograd.grad(loss, leaves, allow_unused=True, materialize_grads=True)


def remat_pair(arch: str, policy: str) -> tuple:
    """The port's loss and gradients with ``remat=False`` and with ``remat=True``
    under ``policy`` on one weight draw and batch, and how many times
    ``torch.utils.checkpoint`` ran in the second: ``((loss, grads), (loss,
    grads), calls)``."""
    import repro_torch.models.model as tmodel

    _, tcfg = train_configs(arch)
    _, tb = label_batches(tcfg)
    plain = _port_grads(dataclasses.replace(tcfg, remat=False), tb)
    calls = []
    real = tmodel.checkpoint

    def counted(*args, **kwargs):
        calls.append(kwargs.get("context_fn"))
        return real(*args, **kwargs)

    tmodel.checkpoint = counted
    try:
        remat = _port_grads(dataclasses.replace(tcfg, remat=True, remat_policy=policy), tb)
    finally:
        tmodel.checkpoint = real
    return plain, remat, len(calls)
