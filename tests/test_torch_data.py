"""repro_torch.data against repro.data: the generators define the data, so
the port's give the JAX package's arrays byte for byte (they are the same
numpy code, not torch random generators), and the real-field suite equals
the committed ``tests/data/real_fields.npz``. The full-size dataset fields
are compared by shape only (``miranda`` alone is 37.7 M points of FFT)."""
import pathlib

import numpy as np
import pytest

import repro.data as rd
import repro_torch.data as td
from repro.data import fields as rfields
from repro_torch.data import fields as tfields

NPZ = pathlib.Path(__file__).resolve().parent / "data" / "real_fields.npz"

# each family's spectral recipe in DATASETS (alpha, anisotropy, the map applied
# after synthesis), at small shapes of the family's rank
FAMILIES = {
    "cesm": ((12, 20), 2.2, (1.0, 1.0), None),
    "jhtdb": ((8, 10, 6), 1.9, None, None),
    "miranda": ((8, 12, 12), 2.6, None, lambda f: np.tanh(4 * f)),
    "nyx": ((10, 8, 8), 2.0, None, lambda f: np.exp(2.0 * f)),
    "qmcpack": ((4, 5, 6, 7), 1.6, None, None),
    "rtm": ((8, 8, 7), 2.4, (2.0, 1.0, 1.0), None),
}


def _same(a, b) -> bool:
    a, b = np.asarray(a), np.asarray(b)
    return a.dtype == b.dtype and a.shape == b.shape and a.tobytes() == b.tobytes()


@pytest.mark.parametrize("side", [16, 20])
def test_predictor_suite_is_byte_equal(side):
    a, b = td.predictor_suite(side=side), rd.predictor_suite(side=side)
    assert list(a) == list(b)
    for k in a:
        assert _same(a[k], b[k]), k


@pytest.mark.parametrize("seed", [0, 3])
@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_spectral_fields_are_byte_equal(family, seed):
    shape, alpha, aniso, post = FAMILIES[family]
    a = tfields._spectral_field(shape, alpha, seed, aniso=aniso)
    b = rfields._spectral_field(shape, alpha, seed, aniso=aniso)
    assert _same(a, b)
    if post is not None:
        assert _same(post(a), post(b))


def test_dataset_table_matches_in_shapes():
    assert list(td.DATASETS) == list(rd.DATASETS)
    for name in rd.DATASETS:
        assert td.DATASETS[name][0] == rd.DATASETS[name][0]


def test_real_suite_is_byte_equal_to_the_jax_one_and_the_fixture():
    a, b = td.real_suite(), rd.real_suite()
    assert list(a) == list(b) == list(td.REAL_FIELDS)
    with np.load(NPZ) as z:
        committed = {k: np.asarray(z[k]) for k in z.files}
    assert sorted(committed) == sorted(a)
    for k in a:
        assert _same(a[k], b[k]) and _same(a[k], committed[k]), k


def test_load_real_fields_reads_the_committed_fixture(tmp_path):
    loaded = td.load_real_fields()
    with np.load(NPZ) as z:
        for k in z.files:
            assert _same(loaded[k], z[k])
    out = tmp_path / "rf.npz"
    saved = td.save_real_fields(out)
    again = td.load_real_fields(out)
    assert all(_same(saved[k], again[k]) for k in saved)
    regenerated = td.load_real_fields(tmp_path / "absent.npz")
    assert all(_same(regenerated[k], saved[k]) for k in saved)


@pytest.mark.parametrize("extras", [None, {"mel": (3, 4)}])
def test_token_pipeline_batches_are_equal(extras):
    kw = dict(seed=5, start_step=2, extras=extras)
    a, b = td.TokenPipeline(100, 3, 7, **kw), rd.TokenPipeline(100, 3, 7, **kw)
    for _ in range(4):
        ba, bb = next(a), next(b)
        assert list(ba) == list(bb)
        assert all(_same(ba[k], bb[k]) for k in ba)
    assert a.step == b.step == 6


def test_prefetcher_yields_the_stream_in_order():
    src = td.TokenPipeline(50, 2, 5, seed=1)
    ref = rd.TokenPipeline(50, 2, 5, seed=1)
    out = td.Prefetcher(iter([next(src) for _ in range(5)]), depth=2)
    got = list(out)
    assert len(got) == 5
    for g in got:
        assert _same(g["tokens"], next(ref)["tokens"])
