"""repro_torch's training loss and gradients against repro's on the dense family (global and local attention, GQA, MQA, qkv bias).

The same weights (carried as numpy) and batch (labels partly masked with
-1): the port's ``loss_fn`` and ``torch.autograd.grad`` against the
unrolled JAX package's ``jax.value_and_grad(loss_fn)``. The loss is held to
a max-abs limit and every gradient leaf to ||port - JAX|| / ||JAX||, both
per family (``tests/torch_lm_oracle.py`` ``GRAD_LIMITS``). Remat changes
memory, never values: the gradients with each policy equal those without
remat bit for bit.
"""
import numpy as np
import pytest
import torch

import torch_lm_oracle as oracle

ARCHS = ["codeqwen1.5-7b", "gemma3-12b", "granite-34b", "yi-34b"]
POLICIES = ["nothing", "dots", "mixer"]


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
    return oracle.grads_both(request.param)


def test_loss_matches_jax(run):
    limit = oracle.GRAD_LIMITS[run["cfg"].family][0]
    j, t = run["loss"]
    assert np.isfinite(t) and abs(j - t) < limit, (j, t)


def test_every_gradient_leaf_matches_jax(run):
    assert all(j.shape == t.shape for j, t in run["grads"])
    assert all(np.isfinite(t).all() for _, t in run["grads"])
    errs = oracle.grad_errors(run["grads"])
    worst = int(np.argmax(errs))
    assert errs[worst] < oracle.GRAD_LIMITS[run["cfg"].family][1], (run["names"][worst], errs[worst])


@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("arch", ARCHS)
def test_remat_changes_no_gradient_bit(arch, policy):
    (l0, g0), (l1, g1), calls = oracle.remat_pair(arch, policy)
    cfg = oracle.train_configs(arch)[1]
    assert calls == cfg.n_groups + cfg.enc_layers  # every group (and encoder layer) ran under checkpoint
    assert torch.equal(l0, l1)
    assert all(torch.equal(a, b) for a, b in zip(g0, g1, strict=True))
