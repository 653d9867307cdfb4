"""The port's compressor against the JAX package on the main path: the
committed golden field (``tests/test_torch_compressor.py`` describes the
comparison; its fields are split across files so that each module fixture
compresses one field)."""
import pytest

import torch_field_cases as cases
from torch_field_cases import one_torch_thread  # noqa: F401 - autouse

FIELDS = {"golden": cases.golden}


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


@pytest.mark.parametrize("name", ["golden"])
def test_device_engine_writes_the_same_container(containers, name):
    cases.check_device_engine(containers, name)
