"""repro_torch's device mesh and placements against repro's NamedSharding.

Four ``gloo`` ranks (``tests/torch_mesh_ranks.py``) build the port's
``(2, 2)`` ``("data", "model")`` and ``(2, 1, 2)`` ``("pod", "data",
"model")`` meshes. For every partition spec that ``state_pspecs`` gives
olmoe-1b-7b and gemma3-12b at ``.scaled()`` on those meshes (the pod
mesh's with residuals), each rank places an ``arange`` tensor of the
leaf's shape and keeps its local block; the block must equal the slice
that JAX's ``NamedSharding(mesh, spec).devices_indices_map(shape)`` gives
the device at the same mesh position (a JAX subprocess with four host
devices). The same ranks check the mesh's ``.shape`` mapping, that a mesh
whose size is not the world size raises, ``shard`` (a DTensor is
redistributed to its rule's placements; a plain tensor raises),
``named_sharding`` and ``shard_map`` (the body's local blocks, a psum over
``model``, ``in_manual_region``).
"""
import concurrent.futures
import json
import pickle

import numpy as np
import pytest
import torch

import torch_mesh_ranks as ranks
from repro_torch.configs import get_config
from repro_torch.core.tree import leaf_paths
from repro_torch.runtime.steps import make_train_state, state_pspecs

MESHES = {"data_model": ((2, 2), ("data", "model")), "pod_data_model": ((2, 1, 2), ("pod", "data", "model"))}
ARCHS = ("olmoe-1b-7b", "gemma3-12b")


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def cases() -> dict:
    """Every (shape, spec entries) the two archs' train states give, per mesh."""
    out = {}
    for name, (shape, axes) in MESHES.items():
        fake = type("FakeMesh", (), {"shape": dict(zip(axes, shape))})
        seen = set()
        for arch in ARCHS:
            cfg = get_config(arch).scaled()
            state = make_train_state(cfg, device="meta", npods=shape[0] if "pod" in axes else 0)
            specs = state_pspecs(state, cfg, fake)
            for (_, leaf), (_, spec) in zip(leaf_paths(state), leaf_paths(specs), strict=True):
                seen.add((tuple(leaf.shape), tuple(spec)))
        out[name] = sorted(seen, key=repr)
    return out


WORKER = """
import math
from torch.distributed.tensor import DTensor
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.runtime import partitioning as part
from repro_torch.runtime.partitioning import NamedSharding, P
from repro_torch.runtime.sharding_rules import place

with open(ARGS[0], "rb") as f:
    cases, meshes = pickle.load(f)
out = {"blocks": {}, "slices": {}, "meshes": {}}
for name, (shape, axes) in meshes.items():
    mesh = make_mesh(shape, axes, device_type="cpu")
    out["meshes"][name] = (dict(mesh.shape), mesh.axis_names, mesh.size, type(mesh.shape).__name__)
    for i, (lshape, entries) in enumerate(cases[name]):
        sh = NamedSharding(mesh, P(*entries))
        x = torch.arange(math.prod(lshape), dtype=torch.int64).reshape(lshape)
        d = place(x, sh)
        assert isinstance(d, DTensor) and tuple(d.placements) == sh.placements
        out["blocks"][(name, i)] = d.to_local().numpy()
        out["slices"][(name, i)] = [(s.start, s.stop) for s in sh.local_slices(lshape)]
raised = []
for bad in (lambda: make_mesh((2,), ("model",), device_type="cpu"), lambda: make_mesh((4, 2), ("data", "model"), device_type="cpu"),
            lambda: make_production_mesh(device_type="cpu")):
    try:
        bad()
        raised.append(None)
    except ValueError as e:
        raised.append(str(e))
out["raised"] = raised

mesh = make_mesh((2, 2), ("data", "model"), device_type="cpu")
rules = {"batch": "data", "embed": None, "ffn": "model"}
with part.mesh_rules(mesh, rules):
    x = torch.arange(4 * 6, dtype=torch.float32).reshape(4, 6)
    try:
        part.shard(x, "batch", "ffn")
        out["plain"] = None
    except TypeError as e:
        out["plain"] = str(e)
    d = place(x, NamedSharding(mesh, P(None, None)))
    s = part.shard(d, "batch", "ffn")
    out["shard"] = (tuple(map(repr, s.placements)), s.to_local().numpy(), s.full_tensor().numpy())
    ns = part.named_sharding("batch", "ffn", shape=(4, 6))
    out["named"] = (tuple(ns.spec), tuple(map(repr, ns.placements)))
    with part.no_annotation():
        out["annot_off"] = part.shard(x, "batch", "ffn") is x
    seen = []

    def body(xl, yl):
        seen.append((part.in_manual_region(), tuple(xl.shape), tuple(yl.shape)))
        return part.psum(xl * 2, "model"), yl + 1

    f = part.shard_map(body, mesh, in_specs=(P("data", "model"), P(None, "model")), out_specs=(P("data", None), P(None, "model")))
    a, b = f(place(x, NamedSharding(mesh, P("data", "model"))), place(x, NamedSharding(mesh, P(None, "model"))))
    out["shard_map"] = (seen, tuple(map(repr, a.placements)), a.full_tensor().numpy(), b.full_tensor().numpy(), part.in_manual_region())
finish(out)
"""

JAX = """
import json, pickle, sys
import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
cases, meshes = pickle.load(open(sys.argv[1], "rb"))
out = {}
for name, (shape, axes) in meshes.items():
    mesh = Mesh(np.array(jax.devices()[:4]).reshape(shape), axes)
    for i, (lshape, entries) in enumerate(cases[name]):
        dmap = NamedSharding(mesh, P(*entries)).devices_indices_map(tuple(lshape))
        for pos in np.ndindex(*shape):
            sl = dmap[mesh.devices[pos]]
            out[f"{name}|{i}|{int(np.ravel_multi_index(pos, shape))}"] = [
                [s.start or 0, s.stop if s.stop is not None else n] for s, n in zip(sl, lshape)]
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("mesh_placements")
    cs = cases()
    src = tmp / "cases.pkl"
    with open(src, "wb") as f:
        pickle.dump((cs, MESHES), f)
    with concurrent.futures.ThreadPoolExecutor(1) as pool:  # the JAX side runs beside the ranks
        jax_out = pool.submit(ranks.run_jax, JAX.replace("sys.argv[1]", repr(str(src))))
        out = ranks.run_ranks(WORKER, 4, tmp, args=[src])
        jax_slices = json.loads(jax_out.result().splitlines()[-1])
    return cs, out, jax_slices


def test_meshes_carry_the_jax_axis_names_and_shape_mapping(run):
    _, out, _ = run
    for r in out:
        assert r["meshes"]["data_model"][:3] == ({"data": 2, "model": 2}, ("data", "model"), 4)
        assert r["meshes"]["pod_data_model"][:3] == ({"pod": 2, "data": 1, "model": 2}, ("pod", "data", "model"), 4)
        assert list(r["meshes"]["pod_data_model"][0]) == ["pod", "data", "model"]  # ordered, as Mesh.shape


def test_a_mesh_whose_size_is_not_the_world_size_raises(run):
    for r in run[1]:
        assert all(msg is not None and "4" in msg for msg in r["raised"]), r["raised"]


def test_every_rank_holds_the_block_jax_gives_its_mesh_position(run):
    cs, out, jax_slices = run
    n = 0
    for name, items in cs.items():
        for i, (shape, _) in enumerate(items):
            full = np.arange(int(np.prod(shape))).reshape(shape)
            for rank, r in enumerate(out):
                want = jax_slices[f"{name}|{i}|{rank}"]
                assert [list(s) for s in r["slices"][(name, i)]] == want, (name, items[i], rank)
                assert np.array_equal(r["blocks"][(name, i)], full[tuple(slice(a, b) for a, b in want)])
                n += 1
    assert n > 100


def test_shard_redistributes_placed_activations_and_refuses_plain_ones(run):
    for rank, r in enumerate(run[1]):
        assert r["plain"] is not None and "place it first" in r["plain"]
        placements, local, full = r["shard"]
        assert placements == ("Shard(dim=0)", "Shard(dim=1)")
        x = np.arange(24, dtype=np.float32).reshape(4, 6)
        d, m = divmod(rank, 2)
        assert np.array_equal(local, x[2 * d:2 * d + 2, 3 * m:3 * m + 3]) and np.array_equal(full, x)
        assert r["named"] == (("data", "model"), ("Shard(dim=0)", "Shard(dim=1)"))
        assert r["annot_off"] is True


def test_shard_map_runs_the_body_on_local_blocks_with_collectives(run):
    x = np.arange(24, dtype=np.float32).reshape(4, 6)
    for r in run[1]:
        seen, placements, a, b, after = r["shard_map"]
        assert seen == [(True, (2, 3), (4, 3))] and after is False
        assert placements == ("Shard(dim=0)", "Replicate()")
        # psum over model of each rank's doubled (2, 3) block: the two column halves added
        want = 2 * (x[:, :3] + x[:, 3:])
        assert np.array_equal(a, want) and np.array_equal(b, x + 1)
