"""The port's Lorenzo path and the TP preset against the JAX package: the
``smooth3d_big`` field (``tests/test_torch_lorenzo.py`` describes the
comparison; its fields are split across files so that each module fixture
compresses one field's presets)."""
import pytest

import torch_field_cases as cases
from torch_field_cases import one_torch_thread  # noqa: F401 - autouse
from torch_field_cases import PRESETS

FIELDS = {"smooth3d_big": cases.smooth3d_big}


@pytest.fixture(scope="module")
def containers():
    """Per (field, preset): (x, reference container, port container, port telemetry)."""
    return cases.lorenzo_containers(FIELDS)


CASES = [(f, p) for f in FIELDS for p in PRESETS]


@pytest.mark.parametrize("field,preset", CASES)
def test_containers_match_the_reference(containers, field, preset):
    cases.check_lorenzo_containers_match(containers, field, preset)


@pytest.mark.parametrize("field,preset", CASES)
def test_containers_cross_decode_within_the_bound(containers, field, preset):
    cases.check_lorenzo_cross_decode(containers, field, preset)
