"""repro_torch.models against repro.models on the vlm and audio families (image-token prefix, the whisper encoder and cross-attention).

Carried JAX weights at ``.scaled()``, the same numpy inputs: forward
logits, prefill's last logits and every cache leaf, and 4 greedy
``decode_step`` logits and the caches after them, within the reference's
own tolerances (``tests/torch_lm_oracle.py`` states them).
"""
import jax
import pytest
import torch

import torch_lm_oracle as oracle

ARCHS = ["internvl2-1b", "whisper-small"]


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread while this module runs (the suite runs in several
    worker processes at once)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module", params=ARCHS)
def run(request):
    return oracle.run_both(request.param)


def test_forward_logits(run):
    j, t = run["forward"]
    assert j.shape == t.shape
    assert oracle.max_diff(j, t) < run["tol"]


def test_prefill_last_logits(run):
    j, t = run["prefill"]
    assert j.shape == t.shape
    assert oracle.max_diff(j, t) < run["tol"]


def test_prefill_cache_leaves(run):
    assert run["tree_equal"]
    ja, ta = run["cache"]
    assert [a.shape for a in jax.tree.leaves(ja)] == [a.shape for a in jax.tree.leaves(ta)]
    assert max(oracle.leaf_diffs(run["cache"])) < run["tol"]


def test_decode_step_logits(run):
    for step, (j, t) in enumerate(run["decode"]):
        assert oracle.max_diff(j, t) < run["tol"], step


def test_cache_after_decoding(run):
    assert max(oracle.leaf_diffs(run["decode_cache"])) < run["tol"]
