"""repro_torch.runtime's partitioning rules and repro_torch.launch.specs against repro's.

For the ten architectures at full size, the specs of every step's inputs
(no allocation: ``jax.eval_shape`` on the JAX side, meta tensors on the
port's) and the partition specs the rules give them on the meshes (16, 16),
(2, 16, 16), (2, 2) and (2, 2, 2): ``activation_rules``, ``tree_pspecs`` of
the parameters, ``state_pspecs`` (with and without pod residuals),
``batch_pspecs`` and ``cache_pspecs``, entry for entry. The JAX side
reads an ``AbstractMesh``; the port's a mesh is anything with an
axis -> size ``.shape``.
"""
import types

import jax
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh, PartitionSpec

from repro.configs import ARCHS as JARCHS
from repro.launch import specs as jspecs
from repro.runtime import partitioning as jpart
from repro.runtime import sharding_rules as jrules
from repro.runtime import steps as jsteps
from repro_torch.configs import ARCHS, get_config
from repro_torch.core.tree import leaf_paths
from repro_torch.launch import specs as tspecs
from repro_torch.runtime import partitioning as tpart
from repro_torch.runtime import sharding_rules as trules
from repro_torch.runtime import steps as tsteps
from repro_torch.runtime.partitioning import P

MESHES = [((16, 16), ("data", "model")), ((2, 16, 16), ("pod", "data", "model")),
          ((2, 2), ("data", "model")), ((2, 2, 2), ("pod", "data", "model"))]
MESH_IDS = ["x".join(map(str, s)) for s, _ in MESHES]


def meshes(i):
    sizes, names = MESHES[i]
    return AbstractMesh(sizes, names), types.SimpleNamespace(shape=dict(zip(names, sizes)))


def jax_specs(tree) -> list:
    """(name, entries) of every PartitionSpec in a JAX tree, in leaf order."""
    flat = jax.tree_util.tree_flatten_with_path(tree, is_leaf=lambda x: isinstance(x, PartitionSpec))[0]
    return [(jax.tree_util.keystr(k, simple=True, separator="_"), tuple(s)) for k, s in flat]


def port_specs(tree) -> list:
    out = leaf_paths(tree)
    assert all(isinstance(s, P) for _, s in out)
    return [(n, tuple(s)) for n, s in out]


def shapes_of(jtree) -> list:
    return [(jax.tree_util.keystr(k, simple=True, separator="_"), tuple(a.shape), np.dtype(a.dtype).name)
            for k, a in jax.tree_util.tree_flatten_with_path(jtree)[0]]


def port_shapes(ttree) -> list:
    out = []
    for n, t in leaf_paths(ttree):
        assert t.device.type == "meta"
        out.append((n, tuple(t.shape), str(t.dtype).removeprefix("torch.")))
    return out


@pytest.fixture(scope="module")
def specs():
    """Both packages' step-input specs for every arch: the train cell (with
    2-pod residuals) and the decode cell."""
    out = {}
    for arch in ARCHS:
        _, jtrain = jspecs.input_specs(arch, "train_4k", npods=2)
        _, ttrain = tspecs.input_specs(arch, "train_4k", npods=2)
        _, jdec = jspecs.input_specs(arch, "decode_32k")
        _, tdec = tspecs.input_specs(arch, "decode_32k")
        out[arch] = (jtrain, ttrain, jdec, tdec)
    return out


def test_the_configs_are_the_same_architectures():
    assert sorted(ARCHS) == sorted(JARCHS)


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_input_specs_match_jax(specs, arch):
    jtrain, ttrain, jdec, tdec = specs[arch]
    assert port_shapes(ttrain["state"]) == shapes_of(jtrain["state"])
    assert port_shapes(ttrain["batch"]) == shapes_of(jtrain["batch"])
    assert port_shapes(tdec["params"]) == shapes_of(jdec["params"])
    assert port_shapes(tdec["cache"]) == shapes_of(jdec["cache"])
    assert tdec["token"].shape == jdec["token"].shape and tdec["pos"].shape == ()


@pytest.mark.parametrize("mesh", range(len(MESHES)), ids=MESH_IDS)
@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_partition_specs_match_jax(specs, arch, mesh):
    jtrain, ttrain, jdec, tdec = specs[arch]
    jm, tm = meshes(mesh)
    jcfg, tcfg = JARCHS[arch], get_config(arch)
    jr, tr = jrules.activation_rules(jcfg, jm), trules.activation_rules(tcfg, tm)
    assert tr == jr
    assert (trules.use_fsdp(tcfg), trules.use_seqpar(tcfg)) == (jrules.use_fsdp(jcfg), jrules.use_seqpar(jcfg))
    assert port_specs(trules.tree_pspecs(tdec["params"], tcfg, tm)) == \
        jax_specs(jrules.tree_pspecs(jdec["params"], jcfg, jm))
    jstate = jtrain["state"]
    assert port_specs(tsteps.state_pspecs(ttrain["state"], tcfg, tm)) == jax_specs(jsteps.state_pspecs(jstate, jcfg, jm))
    no_pods = (dataclass_replace(jstate, resid=()), dataclass_replace(ttrain["state"], resid=()))
    assert port_specs(tsteps.state_pspecs(no_pods[1], tcfg, tm)) == jax_specs(jsteps.state_pspecs(no_pods[0], jcfg, jm))
    assert port_specs(tsteps.batch_pspecs(ttrain["batch"], tm)) == jax_specs(jsteps.batch_pspecs(jtrain["batch"], jm))
    assert port_specs(trules.cache_pspecs(tdec["cache"], tcfg, tm, tr)) == \
        jax_specs(jrules.cache_pspecs(jdec["cache"], jcfg, jm, jr))


def dataclass_replace(state, **kw):
    import dataclasses

    return dataclasses.replace(state, **kw)


@pytest.mark.parametrize("mesh", range(len(MESHES)), ids=MESH_IDS)
def test_resolve_matches_jax_under_installed_rules(mesh):
    jm, tm = meshes(mesh)
    cases = [(("batch", "act_seq", "embed"), (256, 4096, 7168)), (("batch", "seq", "heads", None), (8, 64, 12, 64)),
             (("vocab", "embed"), (51865, 768)), (("batch", "kv_seq", "kv_heads", None), (128, 32768, 8, 128)),
             ((None, "ffn"), (3, 3072)), (("batch", "batch"), (4, 4))]
    for cfg in (get_config("yi-34b"), get_config("whisper-small")):
        rules = trules.activation_rules(cfg, tm)
        for names, shape in cases:
            want = tuple(jpart.resolve(names, shape, jm, jrules.activation_rules(cfg, jm)))
            assert tuple(tpart.resolve(names, shape, tm, rules)) == want
            with tpart.mesh_rules(tm, rules):
                assert tuple(tpart.resolve(names, shape)) == want
    assert tuple(tpart.resolve(("batch",), (8,))) == (None,)  # no mesh installed


def test_shard_and_named_sharding_place_nothing_on_one_device():
    x = torch.ones(2, 3)
    assert tpart.shard(x, "batch", "embed") is x
    assert tpart.named_sharding("batch", "embed", shape=(2, 3)) is None
    with tpart.mesh_rules(types.SimpleNamespace(shape={"data": 1, "model": 1})):
        assert tpart.shard(x, "batch", "embed") is x  # a one-rank mesh places nothing
        assert tpart.get_mesh().shape == {"data": 1, "model": 1}
        with pytest.raises(AssertionError):
            tpart.shard(x, "batch")
    with tpart.mesh_rules(types.SimpleNamespace(shape={"data": 2, "model": 2})):
        with pytest.raises(TypeError, match="place it first"):  # a plain tensor under a mesh of 4 ranks
            tpart.shard(x, "batch", "embed")
        with tpart.no_annotation():
            assert tpart.shard(x, "batch") is x
        ns = tpart.named_sharding("batch", "embed", shape=(2, 3))
        assert ns.mesh is tpart.get_mesh() and ns.spec == tpart.resolve(("batch", "embed"), (2, 3))
    assert tpart.get_mesh() is None and tpart.get_rules() == tpart.DEFAULT_RULES == jpart.DEFAULT_RULES
