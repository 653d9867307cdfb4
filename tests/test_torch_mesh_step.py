"""repro_torch's train step on a device mesh against its step on one device.

Four ``gloo`` ranks (``tests/torch_mesh_ranks.py``) take one step on a
``(2, 2)`` ``("data", "model")`` mesh from slice 10's state (seed 1,
placed by ``state_pspecs``) and batch; the oracle is slice 10's step on
one process from the same seed and batch. The clip is off (a limit of
1e30), so AdamW's first moment after one step is 0.1 times the gradient:
every gradient leaf is compared through it, as ``||mesh - one|| /
||one||``, beside the loss and the global gradient norm, against the
family's limits (``MESH_LIMITS``, a few times the readings ``python
tests/test_torch_mesh_step.py`` prints; ``PERF.md`` lists both). The
returned state must keep the input's placements. This file holds the
dense, vlm and audio families, and two planted faults in copies of the
port, each of which must break the limits: the mean over the batch's
``data`` shards dropped (the gradients' partial sums over ``data`` kept
as they are) or taken twice. One more yi-34b case runs at the default
clip (1.0; its gradient norm is above it), so the clipped update is held
to slice 10's clipped step. ``tests/test_torch_mesh_step_moe.py`` holds
the rest.
"""
import numpy as np
import pytest
import torch

import torch_mesh_ranks as ranks
from repro_torch.configs import get_config

# family -> (max |loss diff|, max grad leaf ||diff|| / ||g||, |grad norm diff| / norm)
MESH_LIMITS = {
    "dense": (1e-3, 5e-2, 5e-4),
    "vlm": (2e-3, 5e-2, 2e-4),
    "audio": (1e-3, 1.2e-1, 1e-3),
    "moe": (5e-4, 6e-2, 3e-3),
    "ssm": (5e-4, 4e-2, 1.5e-3),
    "hybrid": (3e-4, 2e-1, 1e-2),
}
MESH = ((2, 2), ("data", "model"))
ARCHS = {"yi-34b": {}, "internvl2-1b": {}, "whisper-small": {}}
CLIPPED = "yi-34b"  # run again at the default grad_clip
REDISTRIBUTE = "            flat = [g.redistribute(p.device_mesh, p.placements)"
FAULTS = {
    "data_mean_dropped": (REDISTRIBUTE, "            flat = [steps_fault_local(g, p)"),
    "data_mean_twice": (REDISTRIBUTE, "            flat = [g.redistribute(p.device_mesh, p.placements) / m.shape['data']"),
}
# the dropped mean: each gradient reduced over model only, its partial sum over data kept as this rank's
DROP = '''

def steps_fault_local(g, p):
    kept = g.redistribute(p.device_mesh, (g.placements[0],) + tuple(p.placements[1:]))
    return _like(kept.to_local(), p)
'''


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def config(arch: str, extra: dict):
    import dataclasses

    return dataclasses.replace(get_config(arch).scaled(), **extra)


def plant(tmp, name: str) -> str:
    old, new = FAULTS[name]
    src = ranks.mutated_port(tmp / name, old, new, "runtime/steps.py")
    if name == "data_mean_dropped":
        with open(f"{src}/repro_torch/runtime/steps.py", "a") as f:
            f.write(DROP)
    return src


def run_cases(tmp, archs: dict, faults: dict, fault_arch: str, clipped: str | None = None) -> tuple:
    cases = {}
    for arch, extra in archs.items():
        cfg = config(arch, extra)
        cases[arch] = {"src": None, "arch": arch, "cfg": extra, "mesh": MESH, "pods": False, "batch": ranks.step_batch(cfg)}
    if clipped:
        cases["clipped"] = dict(cases[clipped], clip=1.0)
    for name in faults:
        cfg = config(fault_arch, archs[fault_arch])
        cases[name] = {"src": faults[name](tmp, name), "arch": fault_arch, "cfg": archs[fault_arch], "mesh": MESH,
                       "pods": False, "batch": ranks.step_batch(cfg)}
    return cases, ranks.run_steps(cases, tmp)


def readings(case, out, data_shards: int) -> dict:
    """The worst rank's |loss diff|, worst gradient leaf and grad-norm diff."""
    cfg = config(case["arch"], case["cfg"])
    loss, gnorm, m, _, _ = ranks.reference(case, data_shards)
    return {"loss": max(abs(o["loss"] - loss) for o in out),
            "grad": max(max(ranks.rel_errors(o["m"], m)) for o in out),
            "grad_norm": max(abs(o["grad_norm"] - gnorm) / gnorm for o in out),
            "family": cfg.family, "norm": gnorm}


def within(r: dict) -> bool:
    lim = MESH_LIMITS[r["family"]]
    return r["loss"] < lim[0] and r["grad"] < lim[1] and r["grad_norm"] < lim[2]


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("mesh_step")
    return run_cases(tmp, ARCHS, {k: plant for k in FAULTS}, "yi-34b", CLIPPED)


@pytest.mark.parametrize("arch", list(ARCHS))
def test_the_mesh_step_matches_the_one_device_step(run, arch):
    cases, out = run
    r = readings(cases[arch], [o[arch] for o in out], 1)
    assert within(r), r


@pytest.mark.parametrize("arch", list(ARCHS))
def test_the_mesh_step_returns_the_state_with_its_placements(run, arch):
    assert all(o[arch]["kept"] for o in run[1])
    assert len({o[arch]["loss"] for o in run[1]}) == 1 and len({o[arch]["grad_norm"] for o in run[1]}) == 1


def test_the_clipped_mesh_step_matches_the_clipped_one_device_step(run):
    cases, out = run
    r = readings(cases["clipped"], [o["clipped"] for o in out], 1)
    assert r["norm"] > 1.0 and within(r), r  # the clip scales this step's update


@pytest.mark.parametrize("fault", list(FAULTS))
def test_a_planted_fault_in_the_mean_over_data_breaks_the_limits(run, fault):
    cases, out = run
    r = readings(cases[fault], [o[fault] for o in out], 1)
    assert not within(r), r


if __name__ == "__main__":
    import pathlib
    import tempfile

    with tempfile.TemporaryDirectory() as d:
        cases, out = run_cases(pathlib.Path(d), ARCHS, {}, "yi-34b", CLIPPED)
        for arch in [*ARCHS, "clipped"]:
            print(arch, readings(cases[arch], [o[arch] for o in out], 1), max(o[arch]["wall"] for o in out))
