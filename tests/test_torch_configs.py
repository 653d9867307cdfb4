"""repro_torch.configs against repro.configs: the same data.

All ten ModelConfigs field by field (``dataclasses.asdict``), full and at
``.scaled()`` (with and without overrides), their parameter counts, the
shapes, the long-context set and the dry-run cells; the validation in
``__post_init__`` and ``get_config``'s error.
"""
import dataclasses

import pytest

import repro.configs as J
import repro_torch.configs as T
from repro.configs import base as jbase
from repro_torch.configs import base as tbase

ARCH_NAMES = sorted(J.ARCHS)


def test_the_registry_names_the_same_archs_in_the_same_order():
    assert list(T.ARCHS) == list(J.ARCHS)
    assert len(T.ARCHS) == 10


@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_config_fields_equal(arch):
    assert dataclasses.asdict(T.get_config(arch)) == dataclasses.asdict(J.get_config(arch))
    assert T.get_config(arch).n_groups == J.get_config(arch).n_groups
    assert (T.get_config(arch).d_inner, T.get_config(arch).ssm_heads, T.get_config(arch).lru_dim) == \
        (J.get_config(arch).d_inner, J.get_config(arch).ssm_heads, J.get_config(arch).lru_dim)


@pytest.mark.parametrize("kw", [{}, {"capacity_factor": 100.0}, {"kv_quant": 1, "attn_chunk": 8}])
@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_scaled_config_fields_equal(arch, kw):
    assert dataclasses.asdict(T.get_config(arch).scaled(**kw)) == dataclasses.asdict(J.get_config(arch).scaled(**kw))


@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_param_counts_equal(arch):
    for scaled in (False, True):
        t, j = T.get_config(arch), J.get_config(arch)
        if scaled:
            t, j = t.scaled(), j.scaled()
        assert T.param_count(t) == J.param_count(j)
        assert T.active_param_count(t) == J.active_param_count(j)


def test_shapes_long_context_and_cells_equal():
    assert T.SHAPES == J.SHAPES
    assert T.LONG_CONTEXT_OK == J.LONG_CONTEXT_OK
    assert list(T.cells()) == list(J.cells())
    assert list(T.cells(include_skipped=True)) == list(J.cells(include_skipped=True))


def test_gemma3_12b_at_full_width_is_the_served_model():
    """The model the card serves at full width: 48 layers in 8 groups of
    5 local + 1 global, tied embeddings, 8.934 B parameters."""
    cfg = T.get_config("gemma3-12b")
    assert (cfg.n_layers, cfg.n_groups, cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.d_head, cfg.d_ff, cfg.vocab) == \
        (48, 8, 3840, 16, 8, 256, 15360, 262144)
    assert cfg.pattern == ("local",) * 5 + ("attn",) and cfg.window == 1024 and cfg.tie_embeddings
    assert T.param_count(cfg) == J.param_count(J.get_config("gemma3-12b"))
    assert round(T.param_count(cfg) / 1e9, 3) == 8.934
    cut = dataclasses.replace(cfg, n_layers=6)
    assert cut.n_groups == 1 and round(T.param_count(cut) / 1e9, 3) == 1.998


def test_validation_and_errors_match():
    for mod, base in ((J, jbase), (T, tbase)):
        with pytest.raises(KeyError, match="unknown arch"):
            mod.get_config("no-such-arch")
        with pytest.raises(AssertionError, match="not divisible"):
            base.ModelConfig(name="x", family="dense", n_layers=5, d_model=8, n_heads=2, n_kv_heads=1, d_ff=8,
                             vocab=16, pattern=("local", "attn"))
        ok = base.ModelConfig(name="x", family="dense", n_layers=5, d_model=8, n_heads=2, n_kv_heads=1, d_ff=8,
                              vocab=16, pattern=("local", "attn"), scan_layers=False)
        assert ok.d_head == 4
