"""repro_torch's MoE under a device mesh against repro's and the one-device MoE.

The oracle of the two tensor-parallel layouts is
``jax.vmap(lambda pl: _moe_local(x, pl, cfg, "model"), axis_name="model")``
over the expert weights split as ``moe_ffn``'s ``w_specs`` split them:
FFN-sharded (w1/w3 columns, w2 rows over ``model``) and expert-parallel
(E/2 whole experts a rank). It needs no devices. Four ``gloo`` ranks on a
``(2, 2)`` ``("data", "model")`` mesh run the port's
``_moe_local(..., "model")`` on their model rank's weights; each rank's
combine (after the psum) and aux loss must match the oracle's at its model
index. Then ``moe_ffn`` on placed tokens and weights (olmoe-1b-7b, both
layouts, and deepseek-moe-16b with its model-sharded shared expert) must
match the one-device ``moe_ffn`` run on each data shard's tokens (the
mesh's meaning: capacity and the balance loss are per data shard, and the
aux loss is their mean), in its output, its aux loss and the gradients of
a loss of both with respect to the tokens and every weight.
"""
import concurrent.futures
import dataclasses
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_mesh_ranks as ranks
from repro.configs import get_config as jget_config
from repro.models.layers import _moe_local as jmoe_local
from repro_torch.configs import get_config
from repro_torch.models.layers import _moe_local

B, S = 4, 8
LIMIT_Y = 2e-5      # oracle vs port, the combine (max |diff|; the outputs are ~0.1-1)
LIMIT_AUX = 1e-6
LIMIT_GRAD = 1e-5   # mesh vs per-shard one-device, ||diff|| / ||g||


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def inputs(arch: str, seed: int = 0):
    cfg = get_config(arch).scaled()
    r = np.random.default_rng(seed)
    d, E, f = cfg.d_model, cfg.n_experts, cfg.d_expert
    w = {"router": r.standard_normal((d, E)) * 0.02, "w1": r.standard_normal((E, d, f)) / np.sqrt(d),
         "w3": r.standard_normal((E, d, f)) / np.sqrt(d), "w2": r.standard_normal((E, f, d)) / np.sqrt(f)}
    if cfg.n_shared:
        fs = cfg.n_shared * cfg.d_expert
        w["shared"] = {"w1": r.standard_normal((d, fs)) / np.sqrt(d), "w3": r.standard_normal((d, fs)) / np.sqrt(d),
                       "w2": r.standard_normal((fs, d)) / np.sqrt(fs)}
    w = jax.tree.map(lambda a: a.astype(np.float32), w)
    x = r.standard_normal((B, S, d)).astype(np.float32)
    return x, w, r.standard_normal((B, S, d)).astype(np.float32)


def split(w: dict, ep: bool, m: int = 2) -> list:
    """Each model rank's local weights, as ``moe_ffn``'s ``w_specs`` split them
    (a shared expert's w1/w3 columns and w2 rows too)."""
    out = []
    for i in range(m):
        local = {"router": w["router"]}
        for k in ("w1", "w3", "w2"):
            axis = 0 if ep else (2 if k != "w2" else 1)
            local[k] = np.split(w[k], m, axis=axis)[i]
        if "shared" in w:
            local["shared"] = {k: np.split(v, m, axis=0 if k == "w2" else 1)[i] for k, v in w["shared"].items()}
        out.append(local)
    return out


def oracle(x, w, ep: bool, arch: str = "olmoe-1b-7b"):
    """The JAX package's collective form under vmap: per model index (y, aux)."""
    cfg = dataclasses.replace(jget_config(arch).scaled(), moe_expert_parallel=ep)
    locals_ = split(w, ep)
    stacked = jax.tree.map(lambda *a: jnp.stack(a), *locals_)
    y, aux = jax.vmap(lambda pl: jmoe_local(jnp.asarray(x), pl, cfg, "model"), axis_name="model")(stacked)
    return np.asarray(y), np.asarray(aux)


WORKER = """
import dataclasses
from torch.distributed.tensor.experimental import implicit_replication
from repro_torch.configs import get_config
from repro_torch.core.tree import leaf_paths, tree_map
from repro_torch.models.layers import _moe_local, moe_ffn
from repro_torch.runtime import partitioning as part
from repro_torch.runtime.partitioning import NamedSharding, P
from repro_torch.runtime.sharding_rules import activation_rules, param_pspec, place

with open(ARGS[0], "rb") as f:
    cases = pickle.load(f)
mesh = make_mesh((2, 2), ("data", "model"), device_type="cpu")
m = mesh.rank_in("model")
out = {}
for name, (arch, ep, x, w, r, locals_) in cases.items():
    cfg = dataclasses.replace(get_config(arch).scaled(), moe_expert_parallel=ep)
    t = lambda a: torch.from_numpy(a)
    # the collective form on this rank's model shard, as a shard_map body runs it
    with part.mesh_rules(mesh, activation_rules(cfg, mesh)), part.no_annotation():
        y, aux = _moe_local(t(x), tree_map(t, locals_[m]), cfg, "model")
    out[name + ":local"] = (y.numpy(), float(aux))
    # moe_ffn on placed tokens and weights, and the gradients of (y . r) + 3 aux
    with part.mesh_rules(mesh, activation_rules(cfg, mesh)), implicit_replication():
        paths = leaf_paths(w)
        shs = [NamedSharding(mesh, param_pspec("/stack/0/moe/" + k.replace("_", "/"), a.shape, cfg, mesh)) for k, a in paths]
        leaves = [place(t(a), sh).detach().requires_grad_() for (_, a), sh in zip(paths, shs)]
        it = iter(leaves)
        pw = tree_map(lambda _: next(it), w)
        xd = place(t(x), NamedSharding(mesh, P("data", None, None))).detach().requires_grad_()
        y, aux = moe_ffn(xd, pw, cfg)
        rd = place(t(r), NamedSharding(mesh, P("data", None, None)))
        g = torch.autograd.grad((y * rd).sum() + 3 * aux, leaves + [xd])
        out[name + ":ffn"] = (y.full_tensor().detach().numpy(), float(aux.full_tensor()),
                              [gi.full_tensor().numpy() for gi in g], [repr(tuple(l.placements)) for l in leaves])
finish(out)
"""


def per_shard(arch: str, ep: bool, x, w, r):
    """The one-device moe_ffn on each data shard's tokens: y, the mean aux,
    and the gradients of (y . r) + 3 aux (weights in leaf order, then x)."""
    from repro_torch.core.tree import leaf_paths, tree_map

    cfg = dataclasses.replace(get_config(arch).scaled(), moe_expert_parallel=ep)
    leaves = [torch.from_numpy(a).requires_grad_() for _, a in leaf_paths(w)]
    it = iter(leaves)
    pw = tree_map(lambda _: next(it), w)
    xt = torch.from_numpy(x).requires_grad_()
    ys, auxs = zip(*[_moe_local(xs, pw, cfg, None) for xs in xt.chunk(2, 0)])
    y, aux = torch.cat(ys), torch.stack(auxs).mean()
    g = torch.autograd.grad((y * torch.from_numpy(r)).sum() + 3 * aux, leaves + [xt])
    return y.detach().numpy(), float(aux), [gi.numpy() for gi in g]


CASES = {"olmoe": ("olmoe-1b-7b", False), "olmoe_ep": ("olmoe-1b-7b", True), "deepseek": ("deepseek-moe-16b", False)}


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("mesh_moe")
    cases = {}
    for name, (arch, ep) in CASES.items():
        x, w, r = inputs(arch)
        cases[name] = (arch, ep, x, w, r, split(w, ep))
    src = tmp / "cases.pkl"
    with open(src, "wb") as f:
        pickle.dump(cases, f)
    with concurrent.futures.ThreadPoolExecutor(1) as pool:  # the oracles run beside the ranks
        want = pool.submit(expected, cases)
        out = ranks.run_ranks(WORKER, 4, tmp, args=[src])
        return cases, out, want.result()


def expected(cases: dict) -> dict:
    """Per case: the JAX collective form's (y, aux) per model index, and the
    one-device moe_ffn on each data shard (:func:`per_shard`)."""
    return {name: {"oracle": oracle(x, w, ep, arch), "per_shard": per_shard(arch, ep, x, w, r)}
            for name, (arch, ep, x, w, r, _) in cases.items()}


@pytest.mark.parametrize("name", ["olmoe", "olmoe_ep"])
def test_both_layouts_match_the_jax_collective_form_rank_by_rank(run, name):
    cases, out, want = run
    jy, jaux = want[name]["oracle"]
    for rank, o in enumerate(out):
        y, aux = o[name + ":local"]
        m = rank % 2
        assert np.abs(y - jy[m]).max() < LIMIT_Y, (rank, np.abs(y - jy[m]).max())
        assert abs(aux - float(jaux[m])) < LIMIT_AUX


def test_a_model_split_shared_expert_adds_its_partial_before_the_psum(run):
    """deepseek's shared expert split over ``model`` (as ``moe_ffn``'s specs
    split it): every rank's combine equals the unsharded MoE's. The JAX
    package adds the shared partial after the psum, so each rank keeps its
    own shard's part (``ROADMAP.md`` §3 item 9): its form is off by about
    the output's own size."""
    cases, out, want = run
    arch, ep, x, w, _, _ = cases["deepseek"]
    cfg = get_config(arch).scaled()
    full = _moe_local(torch.from_numpy(x), jax.tree.map(torch.from_numpy, w), cfg, None)[0].numpy()
    for o in out:
        assert np.abs(o["deepseek:local"][0] - full).max() < LIMIT_Y
    jy, _ = want["deepseek"]["oracle"]
    assert min(float(np.abs(jy[m] - full).max()) for m in range(2)) > 0.1 * float(np.abs(full).max())


@pytest.mark.parametrize("name", list(CASES))
def test_moe_ffn_on_a_mesh_matches_the_one_device_moe_on_each_data_shard(run, name):
    cases, out, want = run
    ep = cases[name][1]
    y1, aux1, g1 = want[name]["per_shard"]
    for o in out:
        y, aux, g, placements = o[name + ":ffn"]
        assert np.abs(y - y1).max() < LIMIT_Y and abs(aux - aux1) < LIMIT_AUX
        errs = [np.linalg.norm(a - b) / np.linalg.norm(b) for a, b in zip(g, g1, strict=True)]
        assert max(errs) < LIMIT_GRAD, errs
        if ep:  # whole experts a rank
            assert placements[1] == "(Replicate(), Shard(dim=0))", placements
