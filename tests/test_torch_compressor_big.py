"""The port's compressor against the JAX package on the main path: the 96^3
``smooth3d_big`` field (``tests/test_torch_compressor.py`` describes the
comparison; its fields are split across files so that each module fixture
compresses one field)."""
import pytest

import repro.core as R
import repro_torch.core as T
import torch_field_cases as cases
from torch_field_cases import one_torch_thread  # noqa: F401 - autouse
from torch_field_cases import SLACK

FIELDS = {"smooth3d_big": cases.smooth3d_big}


@pytest.fixture(scope="module")
def containers():
    """Per field: (x, reference container, port container, port telemetry)."""
    return cases.compressor_containers(FIELDS)


@pytest.mark.parametrize("name", list(FIELDS))
def test_containers_match_the_reference(containers, name):
    cases.check_containers_match(containers, name)


@pytest.mark.parametrize("name", list(FIELDS))
def test_containers_cross_decode_within_the_bound(containers, name):
    cases.check_cross_decode(containers, name)


def test_verify_telemetry(containers):
    x, _, tb, tel = containers["smooth3d_big"]
    assert tel["fallbacks"] == [] and tel["pipeline"] == "cr"
    v = tel["verify"]
    assert v["mode"] == "sample" and v["checked"] == 1 << 16 and v["repairs"] == 0
    assert v["max_err"] <= v["bound"] * (1 + SLACK)
    assert T.Compressor.inspect(tb) == R.Compressor.inspect(tb)
