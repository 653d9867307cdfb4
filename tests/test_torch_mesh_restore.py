"""Elastic restore onto the port's device mesh, both ways, and the Trainer on a placed state.

JAX -> port: the JAX package saves gemma3-12b's ``.scaled()`` train state
(``repro.checkpoint.save``, eb 0 and eb 1e-3); four ``gloo`` ranks restore
it onto a ``(2, 2)`` ``("data", "model")`` mesh with ``shardings=`` from
``state_pspecs``, and each rank's block of every leaf must equal the JAX
array's slice at that rank (``NamedSharding.local_slices``, which
``tests/test_torch_mesh_placements.py`` holds to JAX's
``devices_indices_map``) at eb 0, or lie within the bound at 1e-3 (the form
of ``tests/test_distributed.py::test_elastic_restore_across_meshes``).
Port -> JAX: the ranks save the placed state (rank 0 writes the gathered
leaves); the leaf files are byte-equal to the port's single-device save of
the same values, and JAX restores them exactly. The same ranks damage a
leaf of a placed save and restore it with ``strict=False`` (the leaf falls
back to the earlier step, placed), and a Trainer on the placed state saves
(asynchronously, then at the end) and a second Trainer resumes from it
with every leaf's values and placements. A background save that fails on
rank 0 (the only writer) makes the next ``submit`` raise on every rank
instead of leaving the others in a gather that rank 0 never joins.
"""
import concurrent.futures
import pathlib

import jax
import numpy as np
import pytest
import torch

import torch_mesh_ranks as ranks
from repro import checkpoint as jckpt
from repro.configs import get_config as jget_config
from repro.runtime.steps import make_train_state as jmake_train_state
from repro_torch import checkpoint as ckpt
from repro_torch.configs import get_config
from repro_torch.runtime.steps import make_train_state
from test_torch_train_ckpt import SLACK, jax_leaves

ARCH = "gemma3-12b"
STEP = 5

WORKER = """
from repro_torch import checkpoint as ckpt
from repro_torch.configs import get_config
from repro_torch.core.tree import leaf_paths
from repro_torch.data.synthetic import TokenPipeline
from repro_torch.runtime.steps import make_train_state, make_train_step, state_shardings
from repro_torch.runtime.train_loop import LoopConfig, Trainer

import time

eb0, eb1, placed_dir, trainer_dir = ARGS
cfg = get_config("gemma3-12b").scaled()
mesh = make_mesh((2, 2), ("data", "model"), device_type="cpu")
tmpl = make_train_state(cfg, device="meta")
sh = state_shardings(tmpl, cfg, mesh)
out = {}


def restore_blocks(tag, d):
    st, man = ckpt.restore(tmpl, d, shardings=sh)
    out[tag] = {n: (t.to_local().numpy(), [(s.start, s.stop) for s in ns.local_slices(t.shape)], repr(tuple(t.placements)))
                for (n, t), (_, ns) in zip(leaf_paths(st), leaf_paths(sh))}
    return st


def written(d):  # the JAX package writes the checkpoints while the ranks start
    while not os.path.exists(d + ".done"):
        time.sleep(0.1)
    return d


state0 = restore_blocks("eb0", written(eb0))
out["manifest"] = ckpt.save(state0, placed_dir, 5)
# a damaged leaf of a later placed save falls back to step 5, placed
ckpt.save(state0, placed_dir, 6)
name = "params_embed"
if RANK == 0:
    p = os.path.join(placed_dir, "step_00000006", name + ".bin")
    data = bytearray(open(p, "rb").read()); data[len(data) // 2] ^= 0xFF
    open(p, "wb").write(bytes(data))
dist.barrier()
st, man = ckpt.restore(state0, placed_dir, 6, strict=False)
emb = dict(leaf_paths(st))[name]
out["salvage"] = (man["salvage"]["fallback_steps"], repr(tuple(emb.placements)),
                  bool(torch.equal(emb.to_local(), dict(leaf_paths(state0))[name].to_local())))
# a Trainer on the placed state saves; a second resumes from it
step = make_train_step(cfg, mesh, lr=1e-3)
quiet = lambda *a, **k: None
lc = LoopConfig(total_steps=2, save_every=1, ckpt_dir=trainer_dir, log_every=1000)
t1 = Trainer(step, state0, TokenPipeline(cfg.vocab, 4, 16), lc, log=quiet)
t1.run()
t2 = Trainer(step, make_train_state(cfg, torch.Generator().manual_seed(9), device="cpu", mesh=mesh), TokenPipeline(cfg.vocab, 4, 16),
             LoopConfig(total_steps=3, save_every=10, ckpt_dir=trainer_dir, log_every=1000), log=quiet)
same = all(type(a).__name__ == "DTensor" and tuple(a.placements) == tuple(b.placements) and torch.equal(a.to_local(), b.to_local())
           for (_, a), (_, b) in zip(leaf_paths(t2.state), leaf_paths(t1.state)))
t2.run()
out["trainer"] = (t1.step, t2.step, same, [float(x) for x in t1.losses + t2.losses])
# a SIGTERM on rank 0 alone stops every rank before its next step (else the others would wait in a
# collective rank 0 never joins), and the final save still runs on all of them
t3 = Trainer(step, t2.state, TokenPipeline(cfg.vocab, 4, 16), LoopConfig(total_steps=10, save_every=10,
             ckpt_dir=trainer_dir + "_stop", log_every=1000), log=quiet)
if RANK == 0:
    t3._handle_sigterm()
t3.run()
out["stop"] = (t3.step, len(t3.losses), sorted(os.listdir(trainer_dir + "_stop")))
# a background save that fails on rank 0 (the only writer) is raised by the next submit on every rank
ac = ckpt.AsyncCheckpointer(trainer_dir + "_async", device="cpu")
if RANK == 0:
    def broken(tree, step):
        raise RuntimeError("planted write failure")
    ac._save = broken
ac.submit(t3.state.params, 1)
if RANK == 0:
    ac._q.join()  # the worker has failed
raised = None
try:
    ac.submit(t3.state.params, 2)
except RuntimeError as e:
    raised = str(e)
out["async_failure"] = raised
# the error-bounded checkpoint last: the JAX package writes it while the ranks run the rest
restore_blocks("eb1", written(eb1))
finish(out)
"""


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("mesh_restore")

    def save():  # beside the ranks, which restore each checkpoint once it is marked done (eb 1e-3 last)
        state = jmake_train_state(jget_config(ARCH).scaled(), jax.random.PRNGKey(0))
        for name, eb in (("eb0", 0.0), ("eb1", 1e-3)):
            jckpt.save(state, str(tmp / name), STEP, eb=eb)
            (tmp / f"{name}.done").touch()
        return state

    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        saved = pool.submit(save)
        try:
            out = ranks.run_ranks(WORKER, 4, tmp, args=[tmp / "eb0", tmp / "eb1", tmp / "placed", tmp / "trainer"])
        finally:
            state = saved.result()
    return tmp, state, out


@pytest.mark.parametrize("eb", [0.0, 1e-3])
def test_each_rank_restores_its_slice_of_a_jax_checkpoint(run, eb):
    _, state, out = run
    saved = dict(jax_leaves(state))
    for o in out:
        got = o["eb0" if eb == 0 else "eb1"]
        assert sorted(got) == sorted(saved)
        for name, (block, slices, _) in got.items():
            want = saved[name][tuple(slice(a, b) for a, b in slices)]
            assert block.shape == want.shape and block.dtype == want.dtype, name
            full = saved[name]
            if eb > 0 and full.dtype == np.float32 and full.size >= 4096:
                bound = eb * float(full.max() - full.min()) * (1 + SLACK)
                assert np.abs(block.astype(np.float64) - want).max() <= bound, name
            else:
                assert np.array_equal(block, want), name
    placements = {o["eb0"]["params_embed"][2] for o in out}
    assert placements == {"(Replicate(), Shard(dim=0))"}  # vocab over model


def test_a_placed_save_is_a_single_device_save_and_jax_restores_it(run):
    tmp, state, out = run
    single, _ = ckpt.restore(make_train_state(get_config(ARCH).scaled(), device="meta"), tmp / "eb0", device="cpu")
    ckpt.save(single, tmp / "single", STEP, device="cpu")
    placed = pathlib.Path(tmp / "placed" / f"step_{STEP:08d}")
    files = sorted(p.name for p in placed.glob("*.bin"))
    assert files and files == sorted(p.name for p in (tmp / "single" / f"step_{STEP:08d}").glob("*.bin"))
    for name in files:
        assert (placed / name).read_bytes() == (tmp / "single" / f"step_{STEP:08d}" / name).read_bytes(), name
    assert all(o["manifest"] == out[0]["manifest"] for o in out)  # every rank returns rank 0's manifest
    restored, _ = jckpt.restore(jax.eval_shape(lambda: state), str(tmp / "placed"), STEP)
    for (n, a), (_, b) in zip(jax_leaves(state), jax_leaves(restored)):
        assert np.array_equal(a, b), n


def test_a_damaged_placed_leaf_falls_back_to_the_earlier_step(run):
    for o in run[2]:
        fallback, placements, equal = o["salvage"]
        assert fallback == {"params_embed": STEP} and placements == "(Replicate(), Shard(dim=0))" and equal


def test_the_trainer_resumes_a_placed_state(run):
    for o in run[2]:
        s1, s2, same, losses = o["trainer"]
        assert (s1, s2, same) == (2, 3, True) and len(losses) == 3 and np.isfinite(losses).all()
    assert len({tuple(o["trainer"][3]) for o in run[2]}) == 1  # every rank saw the same losses


def test_a_sigterm_on_one_rank_stops_every_rank(run):
    assert all(o["stop"] == (0, 0, ["step_00000000"]) for o in run[2]), [o["stop"] for o in run[2]]


def test_a_failed_background_save_raises_on_every_rank(run):
    raised = [o["async_failure"] for o in run[2]]
    assert raised[0] == "planted write failure", raised
    assert all(r is not None and "planted write failure" in r for r in raised[1:]), raised


def test_a_block_of_whole_rows_decodes_only_its_frames(monkeypatch):
    """A placed restore's block that is whole rows of an error-bounded leaf's
    first axis decodes only the v3 frames holding them, and equals those
    rows of the whole leaf's decode."""
    from repro_torch.checkpoint import codec

    monkeypatch.setattr(codec, "_FRAME_TARGET_BYTES", 1 << 14)  # 16 KiB frames: 8 of them here
    x = torch.randn(64, 512, generator=torch.Generator().manual_seed(0)).cumsum(1)
    payload, meta = codec.encode_tensor(x, eb=1e-3, device="cpu")
    assert meta["mode"] == "cuszhi3" and meta["n_frames"] == 8
    asked = []
    real = codec.Compressor.decompress

    def spy(self, buf, frames=None, **kw):
        if len(buf) == len(payload):  # the leaf's stream (its frames decode through here too)
            asked.append(frames)
        return real(self, buf, frames, **kw)

    monkeypatch.setattr(codec.Compressor, "decompress", spy)
    whole = codec.decode_tensor(payload, meta, device="cpu")
    rows = codec.decode_rows(payload, meta, 8, 24, device="cpu")
    assert asked == [None, [1, 2]] and torch.equal(rows, whole[8:24])
