"""repro_torch's train step on a device mesh against its step on one device:
the ssm and hybrid families (``tests/test_torch_mesh_step.py`` describes the
comparison). recurrentgemma-2b runs one group of its 13-layer pattern."""
import pytest
import torch

from test_torch_mesh_step import readings, within
from test_torch_mesh_step_moe import _run

ARCHS = {"mamba2-370m": {}, "recurrentgemma-2b": {"n_layers": 13}}


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    return _run(tmp_path_factory.mktemp("mesh_step_recurrent"), faults=False, archs=ARCHS)


@pytest.mark.parametrize("arch", list(ARCHS))
def test_the_mesh_step_matches_the_one_device_step(run, arch):
    cases, out = run
    r = readings(cases[arch], [o[arch] for o in out], 1)
    assert within(r), r


@pytest.mark.parametrize("arch", list(ARCHS))
def test_the_mesh_step_returns_the_state_with_its_placements(run, arch):
    assert all(o[arch]["kept"] for o in run[1])
    assert len({o[arch]["loss"] for o in run[1]}) == 1 and len({o[arch]["grad_norm"] for o in run[1]}) == 1


if __name__ == "__main__":
    import pathlib
    import tempfile

    with tempfile.TemporaryDirectory() as d:
        cases, out = _run(pathlib.Path(d), faults=False, archs=ARCHS)
        for arch in ARCHS:
            print(arch, readings(cases[arch], [o[arch] for o in out], 1), max(o[arch]["wall"] for o in out))
