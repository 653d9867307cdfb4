"""repro_torch.runtime.train_loop's Trainer and repro_torch.launch.train.

Counterparts of the JAX package's own loop tests (``tests/test_train_loop.py``:
the loss falls end to end, a restart resumes from the checkpoint, a slow
step counts as a straggler, a NaN loss rolls back) on the port's Trainer
and train step (mamba2-370m at ``.scaled()``, on the CPU), plus SIGTERM
from inside a step (the loop finishes that step, saves and exits), the
train CLI on the CPU, and ``--mesh`` / ``--compress-pods`` raising until
the port's mesh exists.
"""
import gc
import os
import signal
import tempfile
import time
import types
import weakref

import numpy as np
import pytest
import torch

from repro_torch import checkpoint as ckpt
from repro_torch.configs import get_config
from repro_torch.core.tree import leaf_paths
from repro_torch.data.synthetic import TokenPipeline
from repro_torch.launch import train
from repro_torch.runtime.steps import make_train_state, make_train_step
from repro_torch.runtime.train_loop import LoopConfig, Trainer


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _setup(tmp_path, total=30, arch="mamba2-370m"):
    cfg = get_config(arch).scaled()
    state = make_train_state(cfg, torch.Generator().manual_seed(0), device="cpu")
    step = make_train_step(cfg, None, lr=1e-3)
    data = TokenPipeline(cfg.vocab, 4, 32)
    lc = LoopConfig(total_steps=total, save_every=10, ckpt_dir=str(tmp_path), log_every=1000)
    return step, state, data, lc


def _quiet(*_):
    pass


def test_loss_decreases_e2e(tmp_path):
    step, state, data, lc = _setup(tmp_path, total=40)
    tr = Trainer(step, state, data, lc, log=_quiet)
    tr.run()
    k = 8
    assert len(tr.losses) == 40 and all(np.isfinite(tr.losses))
    assert np.mean(tr.losses[-k:]) < np.mean(tr.losses[:k]) - 0.3
    assert ckpt.available_steps(tmp_path) == [10, 20, 30, 40]


def test_restart_resumes(tmp_path):
    step, state, data, lc = _setup(tmp_path, total=20)
    first = Trainer(step, state, data, lc, log=_quiet)
    first.run()
    # a second trainer resumes from the step-20 checkpoint and runs to 25
    lc2 = LoopConfig(total_steps=25, save_every=10, ckpt_dir=str(tmp_path), log_every=1000)
    step2, state2, data2, _ = _setup(tmp_path, total=25)
    tr2 = Trainer(step2, state2, data2, lc2, log=_quiet)
    assert tr2.step == 20  # restored
    for (n, a), (_, b) in zip(leaf_paths(first.state), leaf_paths(tr2.state), strict=True):
        assert torch.equal(a, b), n
    tr2.run()
    assert tr2.step == 25 and len(tr2.losses) == 5


def test_straggler_detection(tmp_path):
    step, state, data, lc = _setup(tmp_path, total=12)
    lc.straggler_factor = 1.5
    slow = {"n": 0}

    def slow_step(s, b):
        slow["n"] += 1
        if slow["n"] == 10:
            time.sleep(0.5)
        return step(s, b)

    tr = Trainer(slow_step, state, data, lc, log=_quiet)
    tr.run()
    assert tr.stragglers >= 1


def test_nan_rollback(tmp_path):
    step, state, data, lc = _setup(tmp_path, total=15)
    calls = {"n": 0}

    def flaky_step(s, b):
        calls["n"] += 1
        new_s, m = step(s, b)
        if calls["n"] == 12:
            m = dict(m, loss=torch.tensor(float("nan")))
        return new_s, m

    tr = Trainer(flaky_step, state, data, lc, log=_quiet)
    tr.run()
    assert tr.step == 15
    assert calls["n"] == 17  # steps 11 and 12 ran again from the step-10 checkpoint
    assert all(np.isfinite(x) for x in tr.losses)


def test_a_loss_that_stays_non_finite_stops_the_loop(tmp_path):
    step, state, data, lc = _setup(tmp_path, total=20)
    calls = {"n": 0}

    def broken_after_10(s, b):
        calls["n"] += 1
        new_s, m = step(s, b)
        return new_s, (m if calls["n"] <= 10 else dict(m, loss=torch.tensor(float("inf"))))

    tr = Trainer(broken_after_10, state, data, lc, log=_quiet)
    with pytest.raises(RuntimeError, match="3 rollbacks in a row"):
        tr.run()
    assert calls["n"] == 14 and tr.step == 11  # 3 rollbacks to step 10; the fourth failure (step 11) raises


def test_sigterm_finishes_the_step_saves_and_exits(tmp_path):
    step, state, data, lc = _setup(tmp_path, total=30)
    calls = {"n": 0}

    def preempted_step(s, b):
        calls["n"] += 1
        if calls["n"] == 5:
            os.kill(os.getpid(), signal.SIGTERM)  # the handler only sets a flag
        return step(s, b)

    before = signal.getsignal(signal.SIGTERM)
    tr = Trainer(preempted_step, state, data, lc, log=_quiet)
    final = tr.run()
    assert tr.preempted and tr.step == 5 and calls["n"] == 5 and len(tr.losses) == 5
    assert signal.getsignal(signal.SIGTERM) is before
    assert ckpt.latest_step(tmp_path) == 5
    restored, manifest = ckpt.restore(final, tmp_path, 5, device="cpu")
    assert manifest["step"] == 5
    for (n, a), (_, b) in zip(leaf_paths(final), leaf_paths(restored), strict=True):
        assert torch.equal(a, b), n


def test_trainer_takes_numpy_batches_onto_the_states_device(tmp_path):
    step, state, data, lc = _setup(tmp_path, total=1)
    seen = []

    def spy(s, b):
        seen.append({k: (type(v), v.device, v.dtype) for k, v in b.items()})
        return step(s, b)

    Trainer(spy, state, data, lc, log=_quiet).run()
    assert seen == [{"tokens": (torch.Tensor, torch.device("cpu"), torch.int32),
                     "labels": (torch.Tensor, torch.device("cpu"), torch.int32)}]


def test_train_cli_on_the_cpu(tmp_path, capsys):
    out = train.run(["--scaled", "--arch", "mamba2-370m", "--steps", "6", "--device", "cpu", "--batch", "4",
                     "--seq", "32", "--ckpt-dir", str(tmp_path), "--save-every", "3"])
    assert out["steps"] == 6 and out["start_step"] == 0 and len(out["losses"]) == 6 and len(out["step_s"]) == 6
    assert all(np.isfinite(out["losses"]))
    assert "first-1 mean loss" in capsys.readouterr().out
    assert ckpt.available_steps(tmp_path) == [3, 6]
    again = train.run(["--scaled", "--arch", "mamba2-370m", "--steps", "7", "--device", "cpu", "--batch", "4",
                       "--seq", "32", "--ckpt-dir", str(tmp_path)])
    assert again["start_step"] == 6 and again["steps"] == 7 and len(again["losses"]) == 1


def test_train_cli_default_ckpt_dir_lies_under_the_temporary_directory(tmp_path, monkeypatch, capsys):
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    assert LoopConfig().ckpt_dir == str(tmp_path / "repro_torch_ckpt")
    argv = ["--scaled", "--arch", "mamba2-370m", "--steps", "2", "--device", "cpu", "--batch", "2", "--seq", "16"]
    out = train.run(argv)
    assert out["steps"] == 2 and len(out["losses"]) == 2
    assert ckpt.available_steps(tmp_path / "repro_torch_ckpt") == [2]
    capsys.readouterr()
    again = train.run(argv)  # resumes at the final step: nothing to train, and it says so
    assert again["start_step"] == 2 and again["losses"] == []
    assert "no step to take: resumed at step 2 of --steps 2" in capsys.readouterr().out


@pytest.mark.parametrize("flag", [["--mesh", "2,2"], ["--mesh", "2,1,2", "--compress-pods"]])
def test_train_cli_mesh_flags_raise_until_the_mesh_is_ported(tmp_path, flag, monkeypatch):
    """The mesh is ported (``tests/test_torch_mesh_cli.py`` trains on it); a
    mesh of 4 ranks in a world of one still raises, before anything is
    written."""
    for k in ("RANK", "WORLD_SIZE"):
        monkeypatch.delenv(k, raising=False)
    with pytest.raises(RuntimeError, match="needs a process group of 4"):
        train.run(["--scaled", "--arch", "mamba2-370m", "--steps", "1", "--device", "cpu",
                   "--ckpt-dir", str(tmp_path)] + flag)
    assert not os.listdir(tmp_path)


def test_a_replaced_train_state_is_freed_on_release():
    """A step's input state goes when its last name does, not at the next
    run of the cycle collector: on the card that is a whole state (params,
    m and v) of device memory held past its step."""
    cfg = get_config("mamba2-370m").scaled()
    state = make_train_state(cfg, torch.Generator().manual_seed(0), device="cpu")
    batch = next(TokenPipeline(cfg.vocab, 2, 16))
    step = make_train_step(cfg, None, lr=1e-3)
    gc.collect()
    gc.disable()
    try:
        s, _ = step(state, batch)
        refs = [weakref.ref(t) for _, t in leaf_paths(s)]
        s, _ = step(s, batch)
        assert all(r() is None for r in refs)
    finally:
        gc.enable()


def test_train_step_without_a_pod_axis_is_the_plain_step():
    cfg = get_config("mamba2-370m").scaled()
    state = make_train_state(cfg, torch.Generator().manual_seed(0), device="cpu")
    batch = next(TokenPipeline(cfg.vocab, 2, 16))
    plain, _ = make_train_step(cfg, None)(state, batch)
    mesh = types.SimpleNamespace(shape={"data": 2, "model": 2})
    other, _ = make_train_step(cfg, mesh, compress_pods=True)(state, batch)
    assert all(torch.equal(a, b) for (_, a), (_, b) in zip(leaf_paths(plain), leaf_paths(other)))
    assert other.resid == ()
