"""repro_torch's train step on a device mesh against its step on one device:
the moe family (``tests/test_torch_mesh_step.py`` describes the comparison;
``tests/test_torch_mesh_step_recurrent.py`` holds the ssm and hybrid
families).

olmoe-1b-7b runs in both tensor-parallel layouts (FFN-sharded and
expert-parallel); its one-device oracle runs the MoE on each ``data``
shard's tokens, which is the MoE's meaning on a mesh (capacity and balance
loss per shard, the aux loss their mean). Two planted faults in copies of
the port must break the moe limits: the MoE combine's psum over ``model``
dropped, and the expert-parallel offset ``e0`` taken as 0. A batch of 6
on a ``(4, 1)`` mesh does not split over ``data``, so every rank takes the
whole batch: the step must equal the one-device step on it (each
gradient counted once, not once a ``data`` rank).
"""
import pytest
import torch

import torch_mesh_ranks as ranks
from test_torch_mesh_step import MESH, config, readings, within

ARCHS = {"olmoe-1b-7b": {}, "olmoe-1b-7b+ep": {"moe_expert_parallel": True}}
WHOLE = ("olmoe-1b-7b", ((4, 1), ("data", "model")), 6)  # arch, mesh, a batch that does not split over data
FAULTS = {
    "moe_psum_dropped": ("olmoe-1b-7b", "        y = part.psum(y, model_axis)  # combine first",
                         "        y = y  # combine first"),
    "moe_e0_zero": ("olmoe-1b-7b+ep", "        e0 = part.axis_index(model_axis) * E_loc", "        e0 = 0 * E_loc"),
}


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def plant(tmp, name: str) -> str:
    _, old, new = FAULTS[name]
    return ranks.mutated_port(tmp / name, old, new, "models/layers.py")


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    return _run(tmp_path_factory.mktemp("mesh_step_moe"))


def _run(tmp, faults: bool = True, archs: dict = ARCHS):
    """One spawn: every arch (``+ep``: the expert-parallel layout), then the
    planted faults and the batch that does not split."""
    cases = {}
    for name, extra in archs.items():
        arch = name.split("+")[0]
        cases[name] = {"src": None, "arch": arch, "cfg": extra, "mesh": MESH, "pods": False,
                       "batch": ranks.step_batch(config(arch, extra))}
    for fault, (base, _, _) in (FAULTS.items() if faults else {}.items()):
        cases[fault] = dict(cases[base], src=plant(tmp, fault))
    if faults:
        arch, mesh, b = WHOLE
        cases["whole_batch"] = {"src": None, "arch": arch, "cfg": {}, "mesh": mesh, "pods": False,
                                "batch": ranks.step_batch(config(arch, {}), b=b)}
    return cases, ranks.run_steps(cases, tmp, lambda c: (shards(c), 0))


def shards(case) -> int:
    """The data shards the one-device oracle splits the batch into: the
    mesh's, where the batch splits over them."""
    return 2 if case["arch"] == "olmoe-1b-7b" and case["mesh"] == MESH else 1


@pytest.mark.parametrize("arch", list(ARCHS))
def test_the_mesh_step_matches_the_one_device_step(run, arch):
    cases, out = run
    r = readings(cases[arch], [o[arch] for o in out], shards(cases[arch]))
    assert within(r), r


@pytest.mark.parametrize("arch", list(ARCHS))
def test_the_mesh_step_returns_the_state_with_its_placements(run, arch):
    assert all(o[arch]["kept"] for o in run[1])
    assert len({o[arch]["loss"] for o in run[1]}) == 1 and len({o[arch]["grad_norm"] for o in run[1]}) == 1


def test_a_batch_that_does_not_split_over_data_matches_the_one_device_step(run):
    cases, out = run
    r = readings(cases["whole_batch"], [o["whole_batch"] for o in out], shards(cases["whole_batch"]))
    assert within(r), r
    assert all(o["whole_batch"]["kept"] for o in out)


@pytest.mark.parametrize("fault", list(FAULTS))
def test_a_planted_fault_in_the_moe_breaks_the_limits(run, fault):
    cases, out = run
    r = readings(cases[fault], [o[fault] for o in out], shards(cases[fault]))
    assert not within(r), r


if __name__ == "__main__":
    import pathlib
    import tempfile

    with tempfile.TemporaryDirectory() as d:
        cases, out = _run(pathlib.Path(d), faults=False)
        for arch in ARCHS:
            print(arch, readings(cases[arch], [o[arch] for o in out], shards(cases[arch])),
                  max(o[arch]["wall"] for o in out))
