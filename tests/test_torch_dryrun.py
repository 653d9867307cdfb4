"""repro_torch.launch.dryrun: the port's steps traced at the production meshes.

The JAX package's own dry-run test fails on the reference (``ROADMAP.md`` §3
item 5), so the oracles are its partition specs on an ``AbstractMesh`` (no
devices), its committed record ``experiments/dryrun/mamba2-370m__decode_32k__pod1.json``
(read only) and the port's own counts: the extrapolation from depths 1 and 2
against a direct trace, and the FLOPs of the sharded step against the same
step on no mesh. Every dry run joins a ``"fake"`` process group, so each runs
in a subprocess (none is left in the pytest process); the four subprocesses
start together in one module fixture.
"""
import json
import os
import pathlib
import subprocess
import sys
import textwrap

import pytest

ROOT = pathlib.Path(__file__).resolve().parent.parent
JAX_RECORD = ROOT / "experiments" / "dryrun" / "mamba2-370m__decode_32k__pod1.json"
TIMEOUT = 120
# the cells whose argument bytes are held to the JAX package's specs: (arch, shape, multi_pod, compress_pods)
ARG_CELLS = [("yi-34b", "train_4k", False, False), ("yi-34b", "train_4k", True, True),
             ("gemma3-12b", "prefill_32k", False, False), ("gemma3-12b", "prefill_32k", True, False)]
AFFINE = ("deepseek-moe-16b", "decode_32k")  # a dense prefix and MoE groups, cut to 3 groups
PODS = "olmoe-1b-7b"  # train_4k on (2, 16, 16) with --compress-pods, one group
# (e): FLOPs per device x 256 against the step on no mesh; readings in the module's __main__
FLOP_CELL = ("olmoe-1b-7b", "train_4k")
FLOP_RATIO = (0.9, 1.5)

PORT_ARGS = """
import json, sys
from repro_torch.configs import get_config
from repro_torch.launch import dryrun as dr
from repro_torch.runtime import partitioning as part
from repro_torch.runtime import sharding_rules as rules_mod
out = {}
for arch, shape, mp, cp in json.loads(sys.argv[1]):
    cfg = get_config(arch)
    with dr.fake_group(512 if mp else 256):
        mesh = dr.make_production_mesh(multi_pod=mp, device_type="cpu")
        with part.mesh_rules(mesh, rules_mod.activation_rules(cfg, mesh)):
            _, args = dr.place_inputs(arch, shape, cfg, mesh, compress_pods=cp)
        out[f"{arch}/{shape}/{mp}/{cp}"] = dr.argument_bytes(args)
print(json.dumps(out))
"""

PORT_COUNTS = """
import dataclasses, json, sys
import torch
from repro_torch.configs import get_config
from repro_torch.core.tree import leaf_paths
from repro_torch.launch import dryrun as dr
from repro_torch.launch.specs import batch_specs, state_specs
from repro_torch.configs import SHAPES
from repro_torch.runtime.sharding_rules import use_fsdp, use_seqpar
from repro_torch.runtime.steps import make_train_step
out = {}

def cut(arch, k):
    cfg = get_config(arch)
    return {"n_layers": cfg.first_dense + k * len(cfg.pattern), "enc_layers": k if cfg.enc_layers else 0,
            "force_fsdp": int(use_fsdp(cfg)), "force_seqpar": int(use_seqpar(cfg))}

arch, shape = AFFINE
rec = dr.run_cell(arch, shape, multi_pod=False, cfg_override=cut(arch, 3))
out["affine"] = {k: rec[k] for k in ("cost", "cost_total", "collectives", "collectives_total", "unit_costs")}

rec = dr.run_cell(PODS, "train_4k", multi_pod=True, compress_pods=True, cfg_override=cut(PODS, 1), extrapolate=False)
cfg = dataclasses.replace(get_config(PODS), **cut(PODS, 1))
with dr.fake_group(512):
    mesh = dr.make_production_mesh(multi_pod=True, device_type="cpu")
    _, (state, _) = dr.place_inputs(PODS, "train_4k", cfg, mesh, compress_pods=True)
    leaves = [t for _, t in leaf_paths(state.params)]
    out["pods"] = {"by_axis": rec["collectives_by_axis"], "n_leaves": len(leaves),
                   "local_numel": sum(t.to_local().numel() for t in leaves), "npods": 2}

arch, shape = FLOP_CELL
rec = dr.run_cell(arch, shape, multi_pod=False, cfg_override=cut(arch, 1), extrapolate=False)
cfg = dataclasses.replace(get_config(arch), **cut(arch, 1))
seq, gbatch, _ = SHAPES[shape]
plain = dr.trace_step(make_train_step(cfg, None), (state_specs(cfg), batch_specs(cfg, seq, gbatch)))
out["flops"] = {"per_device": rec["cost"]["flops"], "n": rec["n_partitions"], "plain": plain["cost"]["flops"]}
print(json.dumps(out))
"""

JAX_ARGS = """
import json, sys
import numpy as np
import jax
from jax.sharding import AbstractMesh
from repro.configs import get_config
from repro.launch.specs import input_specs
from repro.runtime import sharding_rules as rules_mod
from repro.runtime.steps import batch_pspecs, state_pspecs

def local_bytes(tree, specs, mesh):
    total = 0
    for leaf, spec in zip(jax.tree.leaves(tree), jax.tree.leaves(specs, is_leaf=lambda s: isinstance(s, jax.sharding.PartitionSpec)), strict=True):
        shape = list(leaf.shape)
        for d, entry in enumerate(tuple(spec)):
            for ax in (entry,) if isinstance(entry, str) else tuple(entry or ()):
                shape[d] //= mesh.shape[ax]
        total += int(np.prod(shape)) * np.dtype(leaf.dtype).itemsize
    return total

out = {}
for arch, shape, mp, cp in json.loads(sys.argv[1]):
    mesh = AbstractMesh((2, 16, 16), ("pod", "data", "model")) if mp else AbstractMesh((16, 16), ("data", "model"))
    cfg = get_config(arch)
    kind, specs = input_specs(arch, shape, npods=mesh.shape.get("pod", 0) if cp else 0, cfg=cfg)
    if kind == "train":
        n = local_bytes(specs["state"], state_pspecs(specs["state"], cfg, mesh), mesh)
    else:
        n = local_bytes(specs["params"], rules_mod.tree_pspecs(specs["params"], cfg, mesh), mesh)
    out[f"{arch}/{shape}/{mp}/{cp}"] = n + local_bytes(specs["batch"], batch_pspecs(specs["batch"], mesh), mesh)
print(json.dumps(out))
"""


def _env(**extra):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1", **extra)
    env.pop("RANK", None)
    env.pop("WORLD_SIZE", None)
    return env


def _start(code: str, *args, **env):
    return subprocess.Popen([sys.executable, "-c", textwrap.dedent(code), *args], env=_env(**env), cwd=ROOT,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


def _finish(proc) -> str:
    try:
        out, err = proc.communicate(timeout=TIMEOUT)
    finally:
        proc.kill()
        proc.wait()
    assert proc.returncode == 0, err[-4000:]
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The CLI on mamba2-370m decode_32k, the port's counts, the port's and
    the JAX package's argument bytes: started together, read in turn."""
    out_dir = tmp_path_factory.mktemp("dryrun")
    cells = json.dumps(ARG_CELLS)
    consts = f"AFFINE = {AFFINE!r}\nPODS = {PODS!r}\nFLOP_CELL = {FLOP_CELL!r}\n"
    procs = {
        "cli": subprocess.Popen([sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", "mamba2-370m", "--shape",
                                 "decode_32k", "--out-dir", str(out_dir)], env=_env(), cwd=ROOT,
                                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True),
        "counts": _start(consts + PORT_COUNTS),
        "port_args": _start(PORT_ARGS, cells),
        "jax_args": _start(JAX_ARGS, cells, JAX_PLATFORMS="cpu"),
    }
    try:
        got = {name: _finish(p) for name, p in procs.items()}
    finally:
        for p in procs.values():
            p.kill()
            p.wait()
    got["record"] = json.loads((out_dir / "mamba2-370m__decode_32k__pod1.json").read_text())
    for name in ("counts", "port_args", "jax_args"):
        got[name] = json.loads(got[name].strip().splitlines()[-1])
    return got


def test_the_cli_traces_a_cell_and_prints_ok(runs):
    assert "OK   mamba2-370m__decode_32k__pod1: trace=" in runs["cli"], runs["cli"]
    rec = runs["record"]
    assert rec["mesh"] == {"data": 16, "model": 16} and rec["n_partitions"] == 256 and rec["kind"] == "decode"
    assert set(rec["memory"]) == {"argument_bytes", "output_bytes", "temp_bytes", "peak_bytes", "alias_bytes"}
    # the cache is updated in place: the output aliases it
    assert 0 < rec["memory"]["alias_bytes"] <= rec["memory"]["output_bytes"]
    assert rec["cost"]["flops"] > 0 and rec["collectives"] and "cost_total" in rec


def test_the_decode_record_has_the_jax_records_argument_bytes(runs):
    jax_rec = json.loads(JAX_RECORD.read_text())
    assert runs["record"]["memory"]["argument_bytes"] == jax_rec["memory"]["argument_bytes"] == 1125898272


@pytest.mark.parametrize("cell", ARG_CELLS, ids=lambda c: f"{c[0]}-{c[1]}-{'pod2' if c[2] else 'pod1'}")
def test_argument_bytes_equal_the_jax_specs_shards(runs, cell):
    key = "/".join(map(str, cell))
    assert runs["port_args"][key] == runs["jax_args"][key]


def test_the_extrapolated_totals_equal_a_direct_trace(runs):
    """Eager counts are exact, so c(1) + (G - 1) * (c(2) - c(1)) at G = 3
    equals the trace of the 3-group model itself, FLOPs, bytes and every
    collective key."""
    a = runs["counts"]["affine"]
    assert a["unit_costs"]["G"] == 3
    assert a["cost_total"] == a["cost"]
    assert a["collectives_total"] == a["collectives"]


def test_the_pod_axis_carries_only_int8_payloads_their_scales_and_the_loss(runs):
    p = runs["counts"]["pods"]
    pod = p["by_axis"]["pod"]
    keys = {k for k in pod if "/" in k}
    assert keys == {"all-gather/s8", "all-gather/f32", "all-reduce/f32"}, pod
    # one f32 scale a leaf from each pod, and the loss
    assert pod["all-gather/f32"] == 4 * p["npods"] * p["n_leaves"]
    assert pod["all-reduce/f32"] == 4
    # each rank's int8 block of every gradient leaf, from each pod
    assert pod["all-gather/s8"] == p["npods"] * p["local_numel"]


def test_flops_per_device_times_the_mesh_size_match_the_step_on_no_mesh(runs):
    f = runs["counts"]["flops"]
    ratio = f["per_device"] * f["n"] / f["plain"]
    assert FLOP_RATIO[0] <= ratio <= FLOP_RATIO[1], (ratio, f)


if __name__ == "__main__":  # the readings behind FLOP_RATIO and the pod-axis bytes
    consts = f"AFFINE = {AFFINE!r}\nPODS = {PODS!r}\nFLOP_CELL = {FLOP_CELL!r}\n"
    counts = json.loads(_finish(_start(consts + PORT_COUNTS)).strip().splitlines()[-1])
    f = counts["flops"]
    print("flops per device x n / no mesh:", f["per_device"] * f["n"] / f["plain"], f)
    print("pod axis:", counts["pods"]["by_axis"]["pod"], counts["pods"]["n_leaves"], counts["pods"]["local_numel"])
    print("affine:", counts["affine"]["cost"], counts["affine"]["cost_total"])
