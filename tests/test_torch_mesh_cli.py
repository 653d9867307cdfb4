"""The port's train CLI on a device mesh: ``--mesh`` and ``--compress-pods``.

``python -m torch.distributed.run --nproc-per-node 4 -m
repro_torch.launch.train --device cpu --scaled --arch olmoe-1b-7b --mesh
2,2`` trains on four ``gloo`` ranks and prints the loss line once; the
same under a small driver that calls ``launch.train.run`` on each rank
(mamba2-370m, ``--mesh 2,1,2 --compress-pods``) returns the same losses
and steps on every rank. ``--mesh 1,1`` with no ``torchrun`` environment
starts a group of one itself, and ``--mesh 2,2`` in a world of one raises.
The three launches run at once, each with its own port and directory.
"""
import os
import pickle
import subprocess
import sys
import textwrap
import time

import numpy as np
import pytest

import torch_mesh_ranks as ranks
from repro_torch.launch import train

DRIVER = textwrap.dedent("""
    import pickle, sys
    import torch
    import torch.distributed as dist
    torch.set_num_threads(1)
    from repro_torch.launch import train
    out = train.run(sys.argv[2:])
    keep = {k: out[k] for k in ("losses", "steps", "start_step", "stragglers")}
    keep["state_placed"] = all(hasattr(t, "placements") for t in out["trainer"].state.params.values() if hasattr(t, "shape"))
    with open(f"{sys.argv[1]}/rank{dist.get_rank()}.pkl", "wb") as f:
        pickle.dump(keep, f)
    dist.destroy_process_group()
""")


def _env() -> dict:
    env = dict(os.environ, PYTHONPATH=os.path.join(ranks.ROOT, "src"), OMP_NUM_THREADS="1")
    for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT"):
        env.pop(k, None)
    return env


def torchrun(args) -> list:
    return [sys.executable, "-m", "torch.distributed.run", "--nproc-per-node", "4", "--master-addr", "127.0.0.1",
            "--master-port", str(ranks.free_port()), *args]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The three launches, started together (each has its own port and
    directory) and waited for under one deadline; every process group is
    killed on the way out. ``{name: (returncode, stdout, stderr, dir)}``."""
    dirs = {k: tmp_path_factory.mktemp(k) for k in ("mesh", "pods", "one")}
    (dirs["pods"] / "driver.py").write_text(DRIVER)
    cmds = {
        "mesh": torchrun(["-m", "repro_torch.launch.train", "--device", "cpu", "--scaled", "--arch", "olmoe-1b-7b",
                          "--mesh", "2,2", "--steps", "4", "--ckpt-dir", str(dirs["mesh"] / "ck")]),
        "pods": torchrun([str(dirs["pods"] / "driver.py"), str(dirs["pods"]), "--device", "cpu", "--scaled", "--arch",
                          "mamba2-370m", "--mesh", "2,1,2", "--compress-pods", "--steps", "3", "--ckpt-dir",
                          str(dirs["pods"] / "ck")]),
        "one": [sys.executable, "-m", "repro_torch.launch.train", "--device", "cpu", "--scaled", "--arch",
                "mamba2-370m", "--mesh", "1,1", "--steps", "2", "--ckpt-dir", str(dirs["one"] / "ck")],
    }
    procs = {k: subprocess.Popen(c, env=_env(), stdout=subprocess.PIPE, stderr=subprocess.PIPE, cwd=dirs[k],
                                 start_new_session=True) for k, c in cmds.items()}
    deadline = time.monotonic() + 60.0
    out = {}
    try:
        for k, p in procs.items():
            try:
                o, e = p.communicate(timeout=max(deadline - time.monotonic(), 0.1))
            except subprocess.TimeoutExpired:
                o, e = b"", b"timed out"
            out[k] = (p.returncode, o.decode(), e.decode()[-4000:], dirs[k])
    finally:
        for p in procs.values():
            if p.poll() is None:
                os.killpg(p.pid, 9)
                p.wait()
    return out


def test_train_on_a_2x2_mesh_prints_the_loss_line_once(runs):
    rc, out, err, d = runs["mesh"]
    assert rc == 0, err
    lines = [ln for ln in out.splitlines() if ln.startswith("first-")]
    assert len(lines) == 1, out
    first, last = (float(x) for x in lines[0].replace("->", " ").split() if x.replace(".", "").isdigit())
    assert np.isfinite([first, last]).all()
    assert sorted(os.listdir(d / "ck")) == ["step_00000004"]


def test_compress_pods_on_a_pod_mesh_returns_the_same_run_on_every_rank(runs):
    rc, _, err, d = runs["pods"]
    assert rc == 0, err
    runs_ = []
    for r in range(4):
        with open(d / f"rank{r}.pkl", "rb") as f:
            runs_.append(pickle.load(f))
    assert all(r == runs_[0] for r in runs_), runs_
    assert runs_[0]["steps"] == 3 and runs_[0]["start_step"] == 0 and runs_[0]["state_placed"]
    assert len(runs_[0]["losses"]) == 3 and np.isfinite(runs_[0]["losses"]).all()


def test_a_one_rank_mesh_starts_its_own_group(runs):
    rc, out, err, _ = runs["one"]
    assert rc == 0, err[-3000:]
    assert sum(ln.startswith("first-") for ln in out.splitlines()) == 1


def test_a_mesh_larger_than_the_world_raises(monkeypatch, tmp_path):
    for k in ("RANK", "WORLD_SIZE"):
        monkeypatch.delenv(k, raising=False)
    with pytest.raises(RuntimeError, match="needs a process group of 4"):
        train.run(["--device", "cpu", "--scaled", "--arch", "mamba2-370m", "--mesh", "2,2", "--steps", "1",
                   "--ckpt-dir", str(tmp_path)])
    assert not hasattr(train, "MESH_NOT_PORTED")
