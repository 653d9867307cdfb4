"""Each package's Trainer resumes from the other's checkpoints.

A JAX Trainer (``repro.runtime.train_loop``) trains mamba2-370m at
``.scaled()`` for 10 steps and saves; the port's Trainer, given a state of
its own as the template, restores step 10 from those files; then the
reverse. Checkpoints are lossless (``ckpt_eb=0``: every leaf equal) or
error-bounded (``ckpt_eb=1e-3``: every float leaf of 4096 or more
elements within ``eb * range * (1 + 1e-4)`` of the state that was saved,
the others equal). The leaf names on disk are the same either way. A
lossless resume trains on; a run resumed from an error-bounded checkpoint
is not trained further here: its AdamW v comes back with entries of the
wrong sign and relative errors of 100 % (eb is relative to each leaf's
range), and the next updates diverge in both packages (``ROADMAP.md``).
"""
import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.data import TokenPipeline as JTokenPipeline
from repro.runtime.steps import make_train_state as jmake_train_state
from repro.runtime.steps import make_train_step as jmake_train_step
from repro.runtime.train_loop import LoopConfig as JLoopConfig
from repro.runtime.train_loop import Trainer as JTrainer
from repro_torch import checkpoint as ckpt
from repro_torch.configs import get_config
from repro_torch.core.tree import leaf_paths
from repro_torch.data.synthetic import TokenPipeline
from repro_torch.runtime.steps import make_train_state, make_train_step
from repro_torch.runtime.train_loop import LoopConfig, Trainer

ARCH, STEPS, SLACK = "mamba2-370m", 10, 1e-4


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def jax_step():
    return jax.jit(jmake_train_step(jget_config(ARCH).scaled(), None, lr=1e-3))


def quiet(*_):
    pass


def jax_leaves(state) -> list:
    return [(jax.tree_util.keystr(k, simple=True, separator="_"), np.asarray(v))
            for k, v in jax.tree_util.tree_flatten_with_path(state)[0]]


def port_trainer(directory, eb: float, total: int):
    cfg = get_config(ARCH).scaled()
    state = make_train_state(cfg, torch.Generator().manual_seed(5), device="cpu")
    lc = LoopConfig(total_steps=total, save_every=5, ckpt_dir=str(directory), ckpt_eb=eb, log_every=1000)
    return Trainer(make_train_step(cfg, None, lr=1e-3), state, TokenPipeline(cfg.vocab, 4, 32), lc, log=quiet)


def jax_trainer(directory, eb: float, total: int, step):
    state = jmake_train_state(jget_config(ARCH).scaled(), jax.random.PRNGKey(3))
    lc = JLoopConfig(total_steps=total, save_every=5, ckpt_dir=str(directory), ckpt_eb=eb, log_every=1000)
    return JTrainer(step, state, JTokenPipeline(jget_config(ARCH).vocab, 4, 32), lc, log=quiet)


def check_restored(saved: list, restored: list, eb: float):
    """``saved`` / ``restored``: (name, numpy leaf) lists in leaf order."""
    assert [n for n, _ in restored] == [n for n, _ in saved]
    for (n, want), (_, got) in zip(saved, restored):
        assert got.shape == want.shape and got.dtype == want.dtype, n
        if eb > 0 and want.dtype == np.float32 and want.size >= 4096:
            bound = eb * float(want.max() - want.min()) * (1 + SLACK)
            assert np.abs(got.astype(np.float64) - want).max() <= bound, n
        else:
            assert np.array_equal(got, want), n


@pytest.mark.parametrize("eb", [0.0, 1e-3])
def test_the_port_resumes_from_a_jax_trainers_checkpoint(tmp_path, jax_step, eb):
    jt = jax_trainer(tmp_path, eb, STEPS, jax_step)
    jt.run()
    saved = jax_leaves(jt.state)
    manifest = ckpt.restore(make_train_state(get_config(ARCH).scaled(), None, device="meta"), tmp_path,
                            device="cpu")[1]
    tt = port_trainer(tmp_path, eb, STEPS + 2)
    assert tt.step == STEPS == manifest["step"]
    names = [n for n, _ in leaf_paths(tt.state)]
    assert sorted(manifest["leaves"]) == sorted(names) and [n for n, _ in saved] == names
    check_restored(saved, [(n, t.numpy()) for n, t in leaf_paths(tt.state)], eb)
    if eb == 0:
        tt.run()
        assert tt.step == STEPS + 2 and all(np.isfinite(tt.losses))


@pytest.mark.parametrize("eb", [0.0, 1e-3])
def test_a_jax_trainer_resumes_from_the_ports_checkpoint(tmp_path, jax_step, eb):
    tt = port_trainer(tmp_path, eb, STEPS)
    final = tt.run()
    saved = [(n, t.numpy()) for n, t in leaf_paths(final)]
    jt = jax_trainer(tmp_path, eb, STEPS + 2, jax_step)
    assert jt.step == STEPS
    check_restored(saved, jax_leaves(jt.state), eb)
    if eb == 0:
        jt.run()
        assert jt.step == STEPS + 2 and all(np.isfinite(jt.losses))
