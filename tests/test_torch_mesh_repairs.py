"""The mesh repairs that let every cell's sharded step run at the production
meshes, held to the one-device steps on 4 ``gloo`` ranks (one spawn through
``tests/torch_mesh_ranks.py``) and on the CPU.

* A train step whose head counts do not divide ``model``: yi-34b at
  ``.scaled()`` with 6 heads and 2 kv heads on a ``(1, 4)`` mesh, so q moves
  to the sequence split before the head reshape and attends from its
  offset, against slice 10's step within ``MESH_LIMITS``.
* Prefill, then two decode steps from the one-device prefill's cache placed
  by ``cache_pspecs`` (its length split over ``model``, so each rank writes
  the new slot into its own block), for yi-34b and olmoe-1b-7b on ``(2, 2)``
  and the 6-head yi-34b on ``(1, 4)``: logits and the updated cache against
  the one-device ones (the MoE's oracle runs per ``data`` shard, as on a
  mesh), within ``SERVE_LIMITS``.
* The MoE's static dispatch (a sentinel row for dropped pairs) against the
  boolean-mask form it replaced: outputs and gradients bit-equal on the CPU.
"""
import concurrent.futures
import dataclasses
import pickle

import numpy as np
import pytest
import torch

import torch_mesh_ranks as ranks
from repro_torch.configs import get_config
from test_torch_mesh_step import readings, within

UNEVEN = {"n_heads": 6, "n_kv_heads": 2}  # neither divides a model axis of 4
MESH22 = ((2, 2), ("data", "model"))
MESH14 = ((1, 4), ("data", "model"))
SERVE = {"yi-34b": ("yi-34b", {}, MESH22), "olmoe-1b-7b": ("olmoe-1b-7b", {}, MESH22),
         "yi-34b/6h": ("yi-34b", UNEVEN, MESH14)}
B, S, C, STEPS = 4, 12, 16, 2  # C % 2 == C % 4 == 0: the cache's length splits over model
# max |mesh - one| / max |one| of the prefill logits, the decode logits and the cache, a few
# times the worst readings (this module's __main__: 0.0225, 0.0201, 0.0096)
SERVE_LIMITS = {"prefill": 6e-2, "decode": 6e-2, "cache": 3e-2}
# The MoE's router weights are scaled up in both runs: at scale 1 a token's second and third
# expert probabilities sit 6.9e-5 apart on one batch here, far inside bf16's rounding of the
# router logits, and the mesh's other summation order flips that route (its row's logits then
# move by 0.84 of their max). The comparison is of the sharded plumbing, not of such near-ties.
ROUTER_SCALE = 50.0


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def config(arch: str, extra: dict):
    return dataclasses.replace(get_config(arch).scaled(), **extra)


def serve_reference(cfg, batch, tokens, data_shards: int):
    """The one-device prefill logits, the prefill's cache of length C (the
    decode's input), the decode steps' logits and the cache after
    them. ``data_shards``: the MoE runs on each data shard's tokens."""
    from repro_torch.core.tree import leaf_paths, tree_map
    from repro_torch.models import decode_step, init_params, prefill
    from repro_torch.models import model as model_mod
    from repro_torch.models.layers import _moe_local

    def per_shard(x, p, c):
        ys, auxs = zip(*[_moe_local(xs, p, c, None) for xs in x.chunk(data_shards, 0)])
        return torch.cat(ys, 0), torch.stack(auxs).mean()

    params = init_params(cfg, torch.Generator().manual_seed(1), "cpu")
    for path, leaf in leaf_paths(params):
        if path.endswith("moe_router"):
            leaf.mul_(ROUTER_SCALE)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    real = model_mod.moe_ffn
    model_mod.moe_ffn = per_shard if data_shards > 1 else real
    try:
        logits, _ = prefill(params, cfg, tb)
        _, cache = prefill(params, cfg, tb, cache_len=C)
        cache_in = tree_map(torch.clone, cache)
        dec = []
        for i, tok in enumerate(tokens):
            lg, cache = decode_step(params, cfg, torch.from_numpy(tok), S + i, cache)
            dec.append(lg.float().numpy())
    finally:
        model_mod.moe_ffn = real
    return {"prefill": logits.float().numpy(), "decode": dec, "cache": [t.float().numpy() for _, t in leaf_paths(cache)],
            "cache_in": cache_in}


def _run(tmp):
    """One spawn: the uneven-heads train step, then the serve cases."""
    cases = {"train/6h": {"src": None, "arch": "yi-34b", "cfg": UNEVEN, "mesh": MESH14, "pods": False,
                          "batch": ranks.step_batch(config("yi-34b", UNEVEN))}}
    refs = {}
    r = np.random.default_rng(3)
    for name, (arch, extra, mesh) in SERVE.items():
        cfg = config(arch, extra)
        batch = {"tokens": r.integers(0, cfg.vocab, (B, S)).astype(np.int32)}
        tokens = [r.integers(0, cfg.vocab, (B,)).astype(np.int32) for _ in range(STEPS)]
        refs[name] = serve_reference(cfg, batch, tokens, mesh[0][0] if cfg.n_experts else 1)
        cases[name] = {"kind": "serve", "arch": arch, "cfg": extra, "mesh": mesh, "batch": batch, "tokens": tokens,
                       "pos": S, "cache": refs[name]["cache_in"], "router_scale": ROUTER_SCALE}
    src = tmp / "cases.pkl"
    src.write_bytes(pickle.dumps(cases))
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        train_ref = pool.submit(ranks.reference, cases["train/6h"])
        out = ranks.run_ranks(ranks.STEP_WORKER, 4, tmp, args=[src])
        train_ref.result()
    return cases, refs, out


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    return _run(tmp_path_factory.mktemp("mesh_repairs"))


def _rel(got, want) -> float:
    return float(np.abs(got.astype(np.float64) - want).max() / max(np.abs(want).max(), 1e-30))


def serve_readings(ref, outs) -> dict:
    """The worst rank's relative max difference of each output."""
    return {"prefill": max(_rel(o["prefill"], ref["prefill"]) for o in outs),
            "decode": max(_rel(a, b) for o in outs for a, b in zip(o["decode"], ref["decode"], strict=True)),
            "cache": max(_rel(a, b) for o in outs for a, b in zip(o["cache"], ref["cache"], strict=True))}


def test_a_train_step_whose_heads_do_not_divide_model_matches_one_device(run):
    cases, _, out = run
    r = readings(cases["train/6h"], [o["train/6h"] for o in out], 1)
    assert within(r), r
    assert all(o["train/6h"]["kept"] for o in out)


@pytest.mark.parametrize("name", list(SERVE))
def test_prefill_and_decode_on_a_mesh_match_one_device(run, name):
    _, refs, out = run
    r = serve_readings(refs[name], [o[name] for o in out])
    assert all(r[k] < SERVE_LIMITS[k] for k in SERVE_LIMITS), r


@pytest.mark.parametrize("name", list(SERVE))
def test_decode_writes_the_new_slots_into_the_placed_cache(run, name):
    """The slots the decode steps wrote are in the gathered cache, equal on
    every rank (a write into a gathered copy would leave them as the
    prefill left them: zeros)."""
    _, refs, out = run
    for o in out:
        for got, want in zip(o[name]["cache"], refs[name]["cache"], strict=True):
            if got.ndim >= 4 and got.shape[-3] == C:  # a (.., B, C, Hk, dh) attention leaf
                new, ref = got[..., S : S + STEPS, :, :], want[..., S : S + STEPS, :, :]
                assert np.abs(new).max() > 0
                assert _rel(new, ref) < SERVE_LIMITS["cache"]


def _masked_dispatch(rows, el, rank, keep, E_loc, C):
    """The boolean-mask form the static dispatch replaced."""
    buf = torch.zeros((E_loc, C, rows.shape[-1]), dtype=rows.dtype, device=rows.device)
    buf[el[keep], rank[keep]] = rows[keep]
    return buf


@pytest.mark.parametrize("arch,cf", [("olmoe-1b-7b", 1.25), ("olmoe-1b-7b", 0.25), ("deepseek-moe-16b", 0.5)])
def test_the_static_moe_dispatch_is_bit_equal_to_the_masked_form(monkeypatch, arch, cf):
    from repro_torch.models import layers

    cfg = dataclasses.replace(get_config(arch).scaled(), capacity_factor=cf)
    results = []
    for dispatch in (layers._dispatch, _masked_dispatch):
        monkeypatch.setattr(layers, "_dispatch", dispatch)
        g = torch.Generator().manual_seed(5)
        p = layers.init_moe(g, cfg)
        x = torch.randn(4, 16, cfg.d_model, generator=g).to(torch.bfloat16).requires_grad_()
        leaves = [v.requires_grad_() for v in p.values() if isinstance(v, torch.Tensor)]
        y, aux = layers._moe_local(x, p, cfg)
        grads = torch.autograd.grad((y.float() ** 2).sum() + aux, [x, *leaves])
        results.append((y, aux, grads))
    (y0, a0, g0), (y1, a1, g1) = results
    assert torch.equal(y0, y1) and torch.equal(a0, a1)
    assert all(torch.equal(u, v) for u, v in zip(g0, g1, strict=True))


if __name__ == "__main__":
    import pathlib
    import tempfile

    with tempfile.TemporaryDirectory() as d:
        cases, refs, out = _run(pathlib.Path(d))
        print("train/6h", readings(cases["train/6h"], [o["train/6h"] for o in out], 1))
        for name in SERVE:
            print(name, serve_readings(refs[name], [o[name] for o in out]))
