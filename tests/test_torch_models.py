"""repro_torch.models: trees, units and self-consistency, against repro.models.

For every architecture at ``.scaled()``: ``init_params`` and ``init_cache``
(also under ``kv_quant=1``) build the JAX package's trees, with its leaf
names (``repro.checkpoint``'s), shapes and dtypes (``jax.eval_shape``); the
port's decode matches its own forward (the reference's check,
``tests/test_models_smoke.py:49``, on the port's own weights). Units with
the JAX package's inputs: blockwise attention with tiles and skipped tiles
(``attn_chunk=8``, S=32, window 16), the int8 KV quantizer code for code,
the ``kv_quant`` decode against the exact one (the reference's criterion,
``tests/test_perf_features.py``), and ``_moe_local`` with and without
dropped rows. The carried-weights comparisons of whole models are in
``tests/test_torch_models_{dense,moe,recurrent,multimodal}.py``.

Tolerances, set from the dtypes before any run: decode against forward
logits 0.05 (0.15 for the ssm and hybrid families), the reference's own
for that check; an attention or MoE output
(bf16) within 0.05 of the largest magnitude of the reference's output;
int8 codes and their float32 scales exactly.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint.manager import _leaf_paths as jleaf_paths
from repro.configs import ARCHS
from repro.configs import get_config as jget_config
from repro.models import init_cache as jinit_cache
from repro.models import init_params as jinit_params
from repro.models import layers as jlayers
from repro_torch.core.tree import leaf_paths
from repro_torch.configs import get_config
from repro_torch.models import decode_step, forward, init_cache, init_params, prefill
from repro_torch.models import layers as tlayers
from repro_torch.models.convert import params_from_numpy, tree_to_numpy

CPU = "cpu"
TORCH_DTYPES = {torch.float32: "float32", torch.bfloat16: "bfloat16", torch.int8: "int8"}


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread while this module runs (the suite runs in several
    worker processes at once)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tol(cfg) -> float:
    return 0.15 if ("ssm" in cfg.pattern or "rglru" in cfg.pattern) else 0.05


def _spec(tree):
    """[(leaf name, shape, dtype name)] in the JAX package's flatten order."""
    return [(name, tuple(leaf.shape), TORCH_DTYPES.get(leaf.dtype, str(leaf.dtype))) for name, leaf in leaf_paths(tree)]


def _jspec(tree):
    return [(name, tuple(leaf.shape), jnp.dtype(leaf.dtype).name) for name, leaf in jleaf_paths(tree)]


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_init_params_tree_is_the_reference_tree(arch):
    jcfg, tcfg = jget_config(arch).scaled(), get_config(arch).scaled()
    want = jax.eval_shape(lambda: jinit_params(jcfg, jax.random.PRNGKey(0)))
    got = init_params(tcfg, torch.Generator().manual_seed(0), CPU)
    assert jax.tree.structure(got) == jax.tree.structure(want)
    assert _spec(got) == _jspec(want)


@pytest.mark.parametrize("kv_quant", [0, 1])
@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_init_cache_tree_is_the_reference_tree(arch, kv_quant):
    jcfg, tcfg = jget_config(arch).scaled(kv_quant=kv_quant), get_config(arch).scaled(kv_quant=kv_quant)
    want = jax.eval_shape(lambda: jinit_cache(jcfg, 2, 24))
    got = init_cache(tcfg, 2, 24, device=CPU)
    assert jax.tree.structure(got) == jax.tree.structure(want)
    assert _spec(got) == _jspec(want)
    assert all(not bool(leaf.any()) for _, leaf in leaf_paths(got))


def _port_batch(cfg, g, seq):
    toks = torch.randint(0, cfg.vocab, (2, seq + 1), generator=g)
    batch = {"tokens": toks[:, :seq]}
    if cfg.stub_frontend == "vit":
        batch["img"] = torch.zeros((2, 0, cfg.d_model), dtype=torch.bfloat16)
    if cfg.enc_layers:
        batch["frames"] = torch.randn((2, cfg.enc_seq, cfg.d_model), generator=g).to(torch.bfloat16)
    return toks, batch


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_the_port_decode_matches_its_own_forward(arch):
    """The reference's decode-vs-forward check on the port's own weights:
    prefill 15 tokens, decode the 16th, against forward's last logits."""
    cfg = get_config(arch)
    sc = cfg.scaled(capacity_factor=100.0) if cfg.n_experts else cfg.scaled()
    g = torch.Generator().manual_seed(1)
    params = init_params(sc, g, CPU)
    seq = 16
    toks, batch = _port_batch(sc, g, seq)
    logits_full, _ = forward(params, sc, batch)
    _, cache = prefill(params, sc, dict(batch, tokens=toks[:, : seq - 1]), cache_len=seq + 1)
    ld, new = decode_step(params, sc, toks[:, seq - 1], seq - 1, cache)
    assert float((logits_full[:, -1] - ld).abs().max()) < _tol(sc)
    assert jax.tree.structure(new) == jax.tree.structure(cache)


def _carried(arch, **kw):
    jcfg, tcfg = jget_config(arch).scaled(**kw), get_config(arch).scaled(**kw)
    params = jinit_params(jcfg, jax.random.PRNGKey(2))
    return jcfg, tcfg, params, params_from_numpy(jax.tree.map(np.asarray, params), CPU)


def _bf16_pair(a: np.ndarray):
    return jnp.asarray(a).astype(jnp.bfloat16), torch.from_numpy(a).to(torch.bfloat16)


def _close(want, got, frac: float = 0.05) -> bool:
    w, g = np.asarray(want).astype(np.float32), got.float().numpy()
    return w.shape == g.shape and float(np.abs(w - g).max()) <= frac * max(1.0, float(np.abs(w).max()))


@pytest.mark.parametrize("kind", ["attn", "local", "bidir"])
def test_blockwise_attention_tiles_and_skips(kind, monkeypatch):
    """attn_chunk=8 at S=32: 4 x 4 tiles, causal tiles above the diagonal and
    local tiles behind the window skipped; against the full path and the
    JAX package's blockwise path on the same q, k, v."""
    jcfg = jget_config("gemma3-12b").scaled(attn_chunk=8)
    tcfg = get_config("gemma3-12b").scaled(attn_chunk=8)
    assert tcfg.window == 16
    r = np.random.default_rng(5)
    B, S, H, Hk, dh = 2, 32, tcfg.n_heads, tcfg.n_kv_heads, tcfg.d_head
    (jq, tq), (jk, tk), (jv, tv) = (_bf16_pair(r.standard_normal(s).astype(np.float32))
                                    for s in ((B, S, H, dh), (B, S, Hk, dh), (B, S, Hk, dh)))
    tiles = []
    real = tlayers._mm32
    monkeypatch.setattr(tlayers, "_mm32", lambda spec, *ops: tiles.append(spec) or real(spec, *ops))
    got = tlayers._attn_core(tq, tk, tv, tcfg, kind)
    monkeypatch.undo()
    assert len(tiles) == {"attn": 10, "local": 9, "bidir": 16}[kind]
    assert _close(jlayers._attn_blockwise(jq, jk, jv, jcfg, kind), got)
    assert _close(tlayers._attn_full(tq, tk, tv, tcfg, kind).float(), got)


def test_kv_quant_codes_and_scales_equal_the_reference():
    r = np.random.default_rng(6)
    k = (r.standard_normal((3, 7, 2, 16)) * np.exp(r.uniform(-8, 8, (3, 7, 2, 1)))).astype(np.float32)
    k[1, 2, 0] = 0.0  # an all-zero (token, head): the 1e-30 floor
    jk, tk = _bf16_pair(k)
    jq, js = jlayers._kv_quant(jk)
    tq, ts = tlayers._kv_quant(tk)
    assert tq.dtype == torch.int8 and ts.dtype == torch.float32
    assert np.array_equal(np.asarray(jq), tq.numpy())
    assert np.array_equal(np.asarray(js), ts.numpy())
    jd = np.asarray(jlayers._kv_dequant(jq, js, jnp.bfloat16)).astype(np.float32)
    assert np.array_equal(jd, tlayers._kv_dequant(tq, ts, torch.bfloat16).float().numpy())


@pytest.mark.parametrize("arch", ["gemma3-12b", "yi-34b"])
def test_kv_quant_decode_holds_the_reference_criterion(arch):
    """The reference's kv_quant check on the port: 12 tokens decoded from an
    empty cache with and without the int8 cache, the same argmax and logits
    within 0.05."""
    cfg = get_config(arch).scaled()
    cfgq = dataclasses.replace(cfg, kv_quant=1)
    g = torch.Generator().manual_seed(0)
    params = init_params(cfg, g, CPU)
    B, S = 2, 12
    toks = torch.randint(0, cfg.vocab, (B, S), generator=g)
    outs = {}
    for c in (cfg, cfgq):
        cache = init_cache(c, B, S + 2, device=CPU)
        for i in range(S):
            logits, cache = decode_step(params, c, toks[:, i], i, cache)
        outs[c.kv_quant] = logits
    assert torch.equal(outs[0].argmax(-1), outs[1].argmax(-1))
    assert float((outs[0] - outs[1]).abs().max()) < 0.05


@pytest.mark.parametrize("capacity_factor", [100.0, 1.25])
@pytest.mark.parametrize("arch", ["olmoe-1b-7b", "deepseek-moe-16b"])
def test_moe_local_agrees_with_and_without_dropped_rows(arch, capacity_factor):
    jcfg, tcfg, params, tparams = _carried(arch, capacity_factor=capacity_factor)
    p_j = jax.tree.map(lambda a: a[0], params["stack"][0]["moe"])
    p_t = jax.tree.map(lambda a: a[0], tparams["stack"][0]["moe"])
    x = np.random.default_rng(7).standard_normal((2, 32, tcfg.d_model)).astype(np.float32)
    jx, tx = _bf16_pair(x)
    jy, jaux = jlayers._moe_local(jx, p_j, jcfg, None)
    ty, taux = tlayers._moe_local(tx, p_t, tcfg, None)
    assert _close(jy, ty)
    assert float(taux) == pytest.approx(float(jaux), rel=1e-5)
    # the default capacity drops rows here; the uncapped one drops none
    T, E, K = 64, tcfg.n_experts, tcfg.top_k
    C = min(T * K, max(int(np.ceil(T * K / E * capacity_factor)), 8))
    probs = torch.softmax((tx.reshape(T, -1) @ p_t["router"].to(torch.bfloat16)).float(), -1)
    load = torch.bincount(tlayers._top_k(probs, K)[1].reshape(-1), minlength=E)
    assert (int(load.max()) > C) == (capacity_factor == 1.25)


def test_params_cross_to_numpy_and_back():
    cfg = get_config("whisper-small").scaled()
    params = init_params(cfg, torch.Generator().manual_seed(4), CPU)
    back = params_from_numpy(tree_to_numpy(params), CPU)
    assert _spec(back) == _spec(params)
    assert all(torch.equal(a, b) for (_, a), (_, b) in zip(leaf_paths(params), leaf_paths(back)))
    cache = init_cache(cfg, 1, 8, device=CPU)
    cache["stack"][0]["k"].normal_(generator=torch.Generator().manual_seed(5))
    arrays = tree_to_numpy(cache)
    assert arrays["stack"][0]["k"].dtype == np.float32
    jbf16 = jax.tree.map(lambda a: np.asarray(jnp.asarray(a).astype(jnp.bfloat16)), arrays)
    again = params_from_numpy(jbf16, CPU)
    assert again["stack"][0]["k"].dtype == torch.bfloat16
    assert torch.equal(again["stack"][0]["k"], cache["stack"][0]["k"])
