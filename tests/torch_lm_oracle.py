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
readings.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs import get_config as jget_config
from repro.models import decode_step as jdecode_step
from repro.models import forward as jforward
from repro.models import init_params as jinit_params
from repro.models import prefill as jprefill
from repro_torch.configs import get_config as tget_config
from repro_torch.models import decode_step, forward, prefill
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
