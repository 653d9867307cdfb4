"""repro_torch.checkpoint against repro.checkpoint, both on the CPU.

The same trees (made from a seed with numpy; the port's with torch
tensors) give the same manifest keys and leaf files in both packages:
lossless leaves byte for byte under zstandard and under zlib (the import
blocked), error-bounded leaves byte for byte where the two predictors'
codes agree and within ``eb * range * (1 + 1e-4)`` everywhere, restored
by the other package both ways. Format-1 manifests and legacy single-
container metas restore; ``restore(strict=False)`` gives the JAX
package's ``salvage`` report on a corrupted leaf, a lost leaf and a
missing manifest; a kernel error inside a decode propagates instead of
being salvaged; an ``AsyncCheckpointer`` snapshot survives an in-place
update made right after ``submit``; ``compressd=`` and ``REPRO_COMPRESSD``
write single-container leaves through a daemon of either package, with the
JAX codec's meta.
The cases of ``tests/test_checkpoint.py`` (and the checkpoint cases of
``test_shard_compress.py``, ``test_orchestrate.py``, ``test_guarantees.py``
and ``test_faults.py``) run against the port."""
import dataclasses
import importlib.util
import io
import json
import pathlib
import sys
import threading
import time
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.checkpoint as J
import repro_torch.checkpoint as T
from repro.checkpoint import codec as jcodec
from repro.data import predictor_suite
from repro.optim.adamw import OptState
from repro.testing.faults import FlakyFile
from repro_torch.checkpoint import codec as tcodec
from repro_torch.checkpoint import manager as tmanager
from repro_torch.core import Compressor, CompressorSpec, frames
from repro_torch.core import tree as ttree
from repro_torch.core.errors import CheckpointDamageError
from repro_torch.kernels.build import KernelError

ROOT = pathlib.Path(__file__).resolve().parent.parent
SLACK = 1e-4
CPU = "cpu"


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread while this module runs (the suite runs in several
    worker processes at once)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(params=["zstandard", "zlib"])
def codec(request, monkeypatch):
    """Both lossless codecs: zstandard where it imports, zlib with it blocked."""
    if request.param == "zstandard":
        pytest.importorskip("zstandard")
    else:
        monkeypatch.setitem(sys.modules, "zstandard", None)
        monkeypatch.setattr(jcodec, "zstandard", None)
        monkeypatch.setattr(tcodec, "zstandard", None)
    return request.param


@dataclasses.dataclass
class Pair:
    """A tree in both packages' forms: numpy for the JAX package, torch for the port."""
    jax: object
    torch: object


def _bf16(v: np.ndarray):
    jb = jnp.asarray(v, jnp.bfloat16)
    tb = torch.from_numpy(np.asarray(jb).view(np.int16).copy()).view(torch.bfloat16)
    return jb, tb


def _mixed_tree(seed=0) -> Pair:
    """Nested dicts with unsorted keys, lists, a dataclass, None, 0-d ints,
    a Python float, a bf16 leaf, a small f64 leaf and an eb leaf of 8192
    elements."""
    rng = np.random.default_rng(seed)
    m = rng.standard_normal((16, 8)).astype(np.float32)
    v = np.abs(rng.standard_normal((16, 8))).astype(np.float32)
    f64 = rng.standard_normal(7)
    w = predictor_suite(side=16)["smooth"][:, :, :].reshape(64, 64) * np.float32(3)
    w = np.concatenate([w, w[::-1]], axis=0)  # 8192 points
    jb, tb = _bf16(rng.standard_normal((3, 5)))
    jtree = {"zeta": {"w": w, "b": [1.0, None, {"z": np.int32(3), "a": f64}]},
             "alpha": OptState(m, v, np.int32(7)), "bf": jb, "none": None, "count": np.int64(-2)}
    ttree = {"zeta": {"w": torch.from_numpy(w.copy()), "b": [1.0, None, {"z": np.int32(3), "a": torch.from_numpy(f64)}]},
             "alpha": OptState(torch.from_numpy(m), torch.from_numpy(v), torch.tensor(7, dtype=torch.int32)),
             "bf": tb, "none": None, "count": torch.tensor(-2, dtype=torch.int64)}
    return Pair(jtree, ttree)


def _test_tree(seed=0) -> dict:
    """tests/test_checkpoint.py's tree, as torch tensors."""
    rng = np.random.default_rng(seed)
    return {
        "w": torch.from_numpy(rng.standard_normal((64, 128)).astype(np.float32)),
        "b": torch.from_numpy(rng.standard_normal((128,)).astype(np.float32)),
        "step": torch.tensor(7, dtype=torch.int32),
        "nested": {"m": torch.from_numpy(rng.standard_normal((512, 32)).astype(np.float32))},
    }


def _files(directory, step=1) -> dict:
    d = pathlib.Path(directory) / f"step_{step:08d}"
    return {p.name: p.read_bytes() for p in sorted(d.iterdir())}


def _np(x):
    """A restored leaf as numpy (bf16 as its 16-bit pattern)."""
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.bfloat16:
            return x.view(torch.int16).numpy()
        return x.numpy()
    x = np.asarray(x)
    return x.view(np.int16) if x.dtype.name == "bfloat16" else x


def _leaves(tree):
    return [leaf for _, leaf in ttree.leaf_paths(tree)]


def _flip(path: pathlib.Path, offset: int | None = None, bit: int = 6):
    b = bytearray(path.read_bytes())
    b[len(b) // 2 if offset is None else offset] ^= 1 << bit
    path.write_bytes(bytes(b))


# ------------------------------------------------------------- leaf names
def test_leaf_names_are_the_jax_key_paths():
    pair = _mixed_tree()
    jpaths = [k for k, _ in jax.tree_util.tree_flatten_with_path(pair.jax)[0]]
    jnames = ["_".join(str(getattr(p, "key", getattr(p, "idx", getattr(p, "name", p)))) for p in path)
              for path in jpaths]
    assert [k for k, _ in ttree.leaf_paths(pair.torch)] == jnames
    assert jnames == ["alpha_m", "alpha_v", "alpha_step", "bf", "count", "zeta_b_0", "zeta_b_2_a", "zeta_b_2_z",
                      "zeta_w"]


def test_tree_map_rebuilds_every_container_kind():
    import collections

    Point = collections.namedtuple("Point", "y x")
    tree = {"b": (1, [2, None]), "a": Point(3, 4), "o": collections.OrderedDict([("z", 5), ("a", 6)]),
            "d": OptState(7, 8, 9)}
    names = [k for k, _ in ttree.leaf_paths(tree)]
    assert names == ["a_y", "a_x", "b_0", "b_1_0", "d_m", "d_v", "d_step", "o_z", "o_a"]
    out = ttree.tree_map(lambda v: v * 10, tree)
    assert out["a"] == Point(30, 40) and out["b"] == (10, [20, None]) and out["d"] == OptState(70, 80, 90)
    assert list(out["o"].items()) == [("z", 50), ("a", 60)]
    assert tree["d"] == OptState(7, 8, 9)  # the input is left as it was


def test_phase9_tree_is_whisper_small_at_depth_one():
    """chip_smoke.py's phase-9 state: the names and shapes of
    repro.models.model.init_params for whisper-small with one decoder and one
    encoder layer (34 leaves, 96,192,000 float32 values)."""
    from repro.configs.whisper_small import CONFIG
    from repro.models.model import init_params

    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    cfg = dataclasses.replace(CONFIG, n_layers=1, enc_layers=1)
    ref = J.manager._leaf_paths(jax.eval_shape(lambda k: init_params(cfg, k), jax.random.PRNGKey(0)))
    got = ttree.leaf_paths(smoke.whisper_small_shapes(**smoke.WHISPER_SMALL))
    assert [k for k, _ in got] == [k for k, _ in ref]
    assert [tuple(t.shape) for _, t in got] == [tuple(r.shape) for _, r in ref]
    assert all(r.dtype == jnp.float32 for _, r in ref) and all(t.dtype == torch.float32 for _, t in got)
    assert len(got) == 34 and sum(t.numel() for _, t in got) == 96_192_000


@pytest.mark.parametrize("shape", [(9, 1024), (1, 4096), (16, 300), (5, 17, 64)])
def test_leaves_of_one_block_row_take_contiguous_blocks(shape):
    """A leaf whose 2-D field has one block along every dim but the last
    (up to 16 rows) gathers into contiguous blocks, as the interp kernels
    require (a strided view of the padded field was rejected on the card)."""
    from repro_torch.core import blocks

    x = torch.from_numpy(np.random.default_rng(0).standard_normal(shape).astype(np.float32))
    field = tcodec._as_field(x)
    padded = blocks.pad_field_batch_t(field.reshape((1,) + tuple(field.shape)))
    assert blocks.gather_blocks_batch_t(padded).is_contiguous()
    assert blocks.gather_blocks_batch_t(blocks.pad_field_batch_t(x.reshape((1,) + shape))).is_contiguous()
    payload, meta = T.encode_tensor(x, eb=1e-3, device=CPU)
    assert meta["mode"] == "cuszhi3"
    rng = float(x.max() - x.min())
    assert float((T.decode_tensor(payload, meta, device=CPU) - x).abs().max()) <= 1e-3 * rng * (1 + SLACK)


# ------------------------------------------------------- files both ways
def test_manifest_and_leaf_files_equal_the_jax_package(tmp_path, codec):
    pair = _mixed_tree()
    mj = J.save(pair.jax, tmp_path / "j", 1, eb=1e-3)
    mt = T.save(pair.torch, tmp_path / "t", 1, eb=1e-3, device=CPU)
    assert mt == mj
    mode = "zstd" if codec == "zstandard" else "zlib"
    assert {m["mode"] for k, m in mt["leaves"].items() if k != "zeta_w"} == {mode}
    assert mt["leaves"]["zeta_w"]["mode"] == "cuszhi3"
    assert mt["leaves"]["bf"]["dtype"] == "bfloat16" and mt["leaves"]["zeta_b_0"]["dtype"] == "float64"
    assert mt["leaves"]["count"]["dtype"] == "int64"
    assert _files(tmp_path / "t") == _files(tmp_path / "j")  # every leaf file and the manifest


def test_checkpoints_restore_in_the_other_package(tmp_path, codec):
    pair = _mixed_tree(seed=4)
    J.save(pair.jax, tmp_path / "j", 1, eb=1e-3)
    T.save(pair.torch, tmp_path / "t", 1, eb=1e-3, device=CPU)
    from_jax, _ = T.restore(pair.torch, tmp_path / "j", device=CPU)
    from_port, _ = J.restore(pair.jax, tmp_path / "t")
    own, _ = T.restore(pair.torch, tmp_path / "t", device=CPU)
    w = pair.jax["zeta"]["w"]
    bound = 1e-3 * float(w.max() - w.min()) * (1 + SLACK)
    for name, ref, a, b, c in zip([k for k, _ in ttree.leaf_paths(pair.torch)], _leaves(pair.jax),
                                  _leaves(from_jax), _leaves(from_port), _leaves(own)):
        assert isinstance(a, torch.Tensor) and a.device.type == "cpu"
        ref = _np(ref)
        for got in (a, b, c):
            got = _np(got)
            assert got.dtype == ref.dtype and got.shape == ref.shape, name
            if name == "zeta_w":
                assert np.abs(got.astype(np.float64) - ref).max() <= bound
            else:
                assert np.array_equal(got, ref), name
    assert isinstance(own["alpha"], OptState) and own["none"] is None and own["zeta"]["b"][1] is None


@pytest.mark.parametrize("name", ["smooth", "ramp", "aniso", "noisy", "sparse"])
def test_eb_leaves_cross_decode_within_the_bound(tmp_path, name):
    """Byte-equal where the two predictors' codes agree (smooth and ramp);
    within the bound both ways on every fixture."""
    x = predictor_suite(side=16)[name]  # 4096 points: the error-bounded path
    mj = J.save({"x": x}, tmp_path / "j", 1, eb=1e-3)
    mt = T.save({"x": torch.from_numpy(x.copy())}, tmp_path / "t", 1, eb=1e-3, device=CPU)
    assert mt["leaves"]["x"]["mode"] == mj["leaves"]["x"]["mode"] == "cuszhi3"
    assert {k: v for k, v in mt["leaves"]["x"].items() if k not in ("bytes", "crc32", "plan")} == \
           {k: v for k, v in mj["leaves"]["x"].items() if k not in ("bytes", "crc32", "plan")}
    if name in ("smooth", "ramp"):
        assert mt == mj and _files(tmp_path / "t") == _files(tmp_path / "j")
    bound = 1e-3 * float(x.max() - x.min()) * (1 + SLACK)
    a, _ = T.restore({"x": x}, tmp_path / "j", device=CPU)
    b, _ = J.restore({"x": x}, tmp_path / "t")
    assert np.abs(a["x"].numpy().astype(np.float64) - x).max() <= bound
    assert np.abs(np.asarray(b["x"]).astype(np.float64) - x).max() <= bound


def test_ckpt_spec_env_is_honoured_identically(tmp_path, monkeypatch):
    monkeypatch.setenv("REPRO_CKPT_SPEC", "lossy,abs,0.01,pipeline=hf")
    x = predictor_suite(side=16)["smooth"]
    pj, mj = jcodec.encode_tensor(x, eb=1e-3)
    pt, mt = T.encode_tensor(torch.from_numpy(x.copy()), eb=1e-3, device=CPU)
    assert mt == mj and pt == pj
    assert mt["spec"] == "lossy,abs,0.01,pipeline=hf" and mt["eb"] == 1e-3 and mt["pipeline"] == "hf"
    assert np.abs(T.decode_tensor(pj, mj, device=CPU).numpy() - x).max() <= 0.01 * (1 + SLACK)
    # spec= opts a leaf into the error-bounded path on its own, eb=0 keeps the spec's bound
    pt, mt = T.encode_tensor(x, spec="lossy,rel,1e-2", device=CPU)
    pj, mj = jcodec.encode_tensor(x, spec="lossy,rel,1e-2")
    assert mt == mj and mt["eb"] == 1e-2 and pt == pj


def test_default_spec_is_the_jax_one():
    for eb in (1e-3, 0.5, 1e-5):
        assert tcodec.default_ckpt_spec(eb) == jcodec.default_ckpt_spec(eb)
        assert tcodec._resolve_spec(eb, None).to_string() == jcodec._resolve_spec(eb, None).to_string()
    assert tcodec._resolve_spec(0.0, None) is None and tcodec._FRAME_TARGET_BYTES == jcodec._FRAME_TARGET_BYTES
    for shape in ((4096,), (3, 1000), (7, 11), (5000, 8192), (1, 64)):
        x = np.zeros(shape, np.float32)
        a, b = tcodec._as_field(torch.from_numpy(x)), jcodec._as_field(x)
        assert tuple(a.shape) == b.shape and tcodec._n_frames(a) == jcodec._n_frames(b)


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_format1_and_legacy_metas_restore(tmp_path, writer):
    x = np.random.default_rng(3).standard_normal((128, 64)).astype(np.float32)
    tree = {"w": x, "s": np.int32(1)}
    if writer == "jax":
        J.save(tree, tmp_path, 1)
    else:
        T.save(tree, tmp_path, 1, device=CPU)
    mp = tmp_path / "step_00000001" / "manifest.json"
    manifest = json.loads(mp.read_text())
    manifest["format"] = 1
    for meta in manifest["leaves"].values():
        meta.pop("crc32", None)
    mp.write_text(json.dumps(manifest))
    out, _ = T.restore(tree, tmp_path, 1, device=CPU)
    assert np.array_equal(out["w"].numpy(), x) and int(out["s"]) == 1
    # a leaf written before the pipeline was recorded (hardcoded "tp"), as one container
    field = jcodec._as_field(x)
    legacy_meta = {"shape": list(x.shape), "dtype": "float32", "mode": "cuszhi", "eb": 1e-3,
                   "field_shape": list(field.shape)}
    if writer == "jax":
        from repro.core import Compressor as JCompressor
        from repro.core import CompressorSpec as JSpec

        payload = JCompressor(JSpec(eb=1e-3, pipeline="tp", autotune=False)).compress(field)
    else:
        payload = Compressor(CompressorSpec(eb=1e-3, pipeline="tp", autotune=False), device=CPU).compress(field)
    rng = float(x.max() - x.min())
    assert np.abs(T.decode_tensor(payload, legacy_meta, device=CPU).numpy() - x).max() <= 1e-3 * rng * (1 + SLACK)
    assert np.abs(jcodec.decode_tensor(payload, legacy_meta) - x).max() <= 1e-3 * rng * (1 + SLACK)


# ------------------------------------------------------------------ salvage
def _salvage_case(tmp_path, writer, damage):
    """Save the tree (steps 1 and 2, or only step 1), damage it, and return
    (template, the directory, the step to restore)."""
    tree = _test_tree()
    save = (lambda t, s: J.save({k: _np_tree(v) for k, v in t.items()}, tmp_path, s, eb=1e-3)) if writer == "jax" \
        else (lambda t, s: T.save(t, tmp_path, s, eb=1e-3, device=CPU))
    m = save(tree, 1)
    if damage != "lost":
        m = save(tree, 2)
    step = 1 if damage == "lost" else 2
    d = tmp_path / f"step_{step:08d}"
    if damage == "manifest":
        (d / "manifest.json").unlink()
    else:
        _flip(d / m["leaves"]["w"]["file"])
    return tree, step


def _np_tree(v):
    return {k: _np_tree(x) for k, x in v.items()} if isinstance(v, dict) else v.numpy()


@pytest.mark.parametrize("damage", ["corrupt", "lost", "manifest"])
@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_degraded_restore_gives_the_jax_salvage(tmp_path, writer, damage):
    tree, step = _salvage_case(tmp_path, writer, damage)
    jtree = _np_tree(tree)
    shapes = jax.tree.map(lambda x: jax.ShapeDtypeStruct(np.shape(x), np.asarray(x).dtype), jtree)
    tshapes = {k: (v.to("meta") if isinstance(v, torch.Tensor) else {"m": v["m"].to("meta")}) for k, v in tree.items()}
    jout, jman = J.restore(shapes, tmp_path, step, strict=False)
    tout, tman = T.restore(tshapes, tmp_path, step, device=CPU, strict=False)
    assert tman["salvage"] == jman["salvage"]
    assert tman == jman
    for a, b in zip(_leaves(tout), _leaves(jout)):
        assert np.array_equal(a.numpy(), np.asarray(b))
    if damage == "lost":
        assert tman["salvage"]["lost"] == ["w"] and not tout["w"].any()
        concrete, _ = T.restore(tree, tmp_path, step, device=CPU, strict=False)  # the template's own value
        assert torch.equal(concrete["w"], tree["w"])


def test_strict_restore_raises_on_corrupt_leaf(tmp_path):
    tree = _test_tree()
    m = T.save(tree, tmp_path, 1, eb=1e-3, device=CPU)
    _flip(tmp_path / "step_00000001" / m["leaves"]["w"]["file"])
    with pytest.raises(CheckpointDamageError):
        T.restore(tree, tmp_path, 1, device=CPU)


@pytest.mark.parametrize("site", ["requested", "older"])
def test_kernel_error_propagates_out_of_degraded_restore(tmp_path, monkeypatch, site):
    """A kernel or device error inside a leaf's decode is not damage: it
    propagates out of restore(strict=False) at the requested step and while
    walking back, and no older step stands in for it."""
    from repro_torch.core import compressor as tcomp

    tree = _test_tree()
    T.save(tree, tmp_path, 1, eb=1e-3, device=CPU)
    m2 = T.save(tree, tmp_path, 2, eb=1e-3, device=CPU)
    if site == "older":  # the requested step's copy is damaged bytes; the walk back decodes step 1
        _flip(tmp_path / "step_00000002" / m2["leaves"]["w"]["file"])

    def broken(*a, **kw):
        raise KernelError("interp_decode launch failed with CUDA error 700")

    monkeypatch.setattr(tcomp._interp, "decompress_blocks", broken)
    with pytest.raises(KernelError):
        T.restore(tree, tmp_path, 2, device=CPU, strict=False)


# -------------------------------------------------------------------- async
def test_async_snapshot_survives_in_place_update(tmp_path, monkeypatch):
    release = threading.Event()
    real_save = tmanager.save

    def gated_save(*a, **kw):
        release.wait(10)
        return real_save(*a, **kw)

    monkeypatch.setattr(tmanager, "save", gated_save)
    tree = _test_tree()
    ref = ttree.tree_map(lambda t: t.numpy().copy(), tree)
    saver = T.AsyncCheckpointer(tmp_path, device=CPU)
    saver.submit(tree, 1)
    for leaf in _leaves(tree):  # an optimizer step right after the submit
        leaf.add_(1)
    release.set()
    saver.close()
    out, _ = T.restore(tree, tmp_path, 1, device=CPU)
    for a, b in zip(_leaves(out), _leaves(ref)):
        assert np.array_equal(a.numpy(), b)


def test_async_checkpointer(tmp_path):
    saver = T.AsyncCheckpointer(tmp_path, device=CPU)
    tree = _test_tree()
    for s in (1, 2, 3):
        saver.submit(tree, s)
    saver.close()
    assert T.latest_step(tmp_path) in (1, 2, 3)
    out, _ = T.restore(tree, tmp_path, device=CPU)
    assert torch.equal(out["w"], tree["w"])


def test_async_submit_is_race_safe(tmp_path):
    saver = T.AsyncCheckpointer(tmp_path, device=CPU)
    tree = {"w": torch.ones(4), "s": 1}
    errs = []

    def hammer(base):
        try:
            for i in range(25):
                saver.submit(tree, base + i)
        except Exception as e:  # noqa: BLE001
            errs.append(e)

    threads = [threading.Thread(target=hammer, args=(100 * (k + 1),)) for k in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(30)
        assert not t.is_alive()
    saver.wait()
    saver.close()
    assert not errs and T.latest_step(tmp_path) is not None


def test_async_close_idempotent_and_rejects_late_submit(tmp_path):
    saver = T.AsyncCheckpointer(tmp_path, device=CPU)
    saver.submit(_test_tree(), 1)
    saver.close()
    saver.close()  # no-op, no deadlock
    with pytest.raises(RuntimeError):
        saver.submit(_test_tree(), 2)


def test_async_close_surfaces_join_timeout(tmp_path, monkeypatch):
    release = threading.Event()
    real_save = tmanager.save

    def slow_save(*a, **kw):
        release.wait(10)
        return real_save(*a, **kw)

    monkeypatch.setattr(tmanager, "save", slow_save)
    saver = T.AsyncCheckpointer(tmp_path, device=CPU)
    try:
        saver.submit(_test_tree(), 1)
        time.sleep(0.05)  # let the worker enter the slow save
        with pytest.raises(TimeoutError):
            saver.close(timeout=0.2)
    finally:
        release.set()
        saver._thread.join(15)


def test_async_save_retries_transient_oserror(tmp_path, monkeypatch):
    real_save = tmanager.save
    attempts = {"n": 0}

    def flaky_save(*a, **kw):
        attempts["n"] += 1
        if attempts["n"] == 1:
            raise OSError("NFS blip")
        return real_save(*a, **kw)

    monkeypatch.setattr(tmanager, "save", flaky_save)
    saver = T.AsyncCheckpointer(tmp_path, device=CPU)
    saver.submit(_test_tree(), 1)
    saver.wait()  # no exception: the retry absorbed the fault
    saver.close()
    assert attempts["n"] == 2 and T.latest_step(tmp_path) == 1


def test_async_checkpointer_surfaces_worker_error_on_wait(tmp_path):
    import traceback

    ac = T.AsyncCheckpointer(tmp_path / "unwritable" / "\0bad", device=CPU)  # save() will fail
    ac.submit({"w": np.ones(4, np.float32)}, 1)
    with pytest.raises(Exception) as ei:
        ac.wait()
    tb = "".join(traceback.format_exception(ei.type, ei.value, ei.value.__traceback__))
    assert "_worker" in tb or "save" in tb  # original worker frames preserved
    ac.close()  # error already consumed: close is clean


def test_async_checkpointer_wait_drains(tmp_path):
    ac = T.AsyncCheckpointer(tmp_path, device=CPU)
    tree = {"w": np.arange(16, dtype=np.float32)}
    ac.submit(tree, 7)
    ac.wait()
    assert T.latest_step(tmp_path) == 7
    restored, _ = T.restore({"w": np.zeros(16, np.float32)}, tmp_path, 7, device=CPU)
    assert np.array_equal(restored["w"].numpy(), tree["w"])
    ac.close()


# ------------------------------------------------------- tests/test_checkpoint.py
def test_save_restore_lossless(tmp_path):
    tree = _test_tree()
    T.save(tree, tmp_path, 10, device=CPU)
    shapes = {"w": tree["w"].to("meta"), "b": tree["b"].to("meta"), "step": tree["step"].to("meta"),
              "nested": {"m": tree["nested"]["m"].to("meta")}}
    out, manifest = T.restore(shapes, tmp_path, 10, device=CPU)
    for a, b in zip(_leaves(tree), _leaves(out)):
        assert torch.equal(a, b) and b.device.type == "cpu"
    assert manifest["step"] == 10


def test_save_restore_error_bounded(tmp_path):
    w = torch.from_numpy(np.random.default_rng(1).standard_normal((256, 256)).astype(np.float32))
    T.save({"w": w}, tmp_path, 1, eb=1e-3, device=CPU)
    out, manifest = T.restore({"w": w}, tmp_path, 1, device=CPU)
    rng = float(w.max() - w.min())
    assert float((out["w"] - w).abs().max()) <= 1e-3 * rng * (1 + 1e-5)
    assert manifest["cr"] > 1.0


def test_f64_leaf_restores_as_f64_equal_to_its_f32_decode(tmp_path):
    x = np.random.default_rng(2).standard_normal((64, 80))
    T.save({"x": x}, tmp_path, 1, eb=1e-3, device=CPU)
    out, m = T.restore({"x": x}, tmp_path, 1, device=CPU)
    assert m["leaves"]["x"]["mode"] == "cuszhi3" and out["x"].dtype == torch.float64
    jout, _ = J.restore({"x": x}, tmp_path, 1)
    assert np.array_equal(out["x"].numpy(), jout["x"])


def test_latest_and_multiple_steps(tmp_path):
    tree = _test_tree()
    for s in (5, 20, 15):
        T.save(tree, tmp_path, s, device=CPU)
    assert T.latest_step(tmp_path) == 20 and T.available_steps(tmp_path) == [5, 15, 20]
    assert T.latest_step(tmp_path / "absent") is None
    with pytest.raises(FileNotFoundError):
        T.restore(tree, tmp_path / "absent", device=CPU)


def test_no_partial_checkpoint_visible(tmp_path):
    T.save(_test_tree(), tmp_path, 1, device=CPU)
    fake_tmp = tmp_path / ".tmp_step_00000099"
    fake_tmp.mkdir()
    (fake_tmp / "x.bin").write_bytes(b"garbage")
    assert T.latest_step(tmp_path) == 1


def test_manifest_corruption_detected(tmp_path):
    tree = _test_tree()
    T.save(tree, tmp_path, 3, device=CPU)
    (tmp_path / "step_00000003" / "manifest.json").write_text("{broken")
    with pytest.raises(ValueError):
        T.restore(tree, tmp_path, 3, device=CPU)


def test_manifest_records_per_leaf_crc32(tmp_path):
    manifest = T.save(_test_tree(), tmp_path, 1, eb=1e-3, device=CPU)
    assert manifest["format"] == 2
    d = tmp_path / "step_00000001"
    for key, meta in manifest["leaves"].items():
        assert meta["crc32"] == (zlib.crc32((d / meta["file"]).read_bytes()) & 0xFFFFFFFF), key


def test_stale_tmp_dirs_swept_on_next_save(tmp_path):
    stale = tmp_path / ".tmp_step_00000007_deadbeef"
    stale.mkdir(parents=True)
    (stale / "w.bin").write_bytes(b"orphaned by a killed process")
    T.save(_test_tree(), tmp_path, 8, device=CPU)
    assert not stale.exists() and T.latest_step(tmp_path) == 8


def test_failed_save_does_not_leak_tmp_dir(tmp_path, monkeypatch):
    def boom(*a, **kw):
        raise OSError("disk full")

    monkeypatch.setattr(tmanager, "encode_tensor_to", boom)
    with pytest.raises(OSError):
        T.save(_test_tree(), tmp_path, 1, device=CPU)
    assert not list(tmp_path.glob(".tmp_step_*"))


# -------------------------------------------------------------- the codec
def test_checkpoint_codec_v3_frames():
    x = torch.from_numpy((np.sin(np.linspace(0, 80, 128 * 1024)).astype(np.float32) * 2).reshape(256, 512))
    payload, meta = T.encode_tensor(x, eb=1e-3, device=CPU)
    assert meta["mode"] == "cuszhi3" and meta["n_frames"] >= 1 and meta["bytes"] == len(payload)
    assert frames.is_v3(payload)
    y = T.decode_tensor(payload, meta, device=CPU)
    rng = float(x.max() - x.min())
    assert y.shape == x.shape and float((y - x).abs().max()) <= 1e-3 * rng * (1 + 1e-5)


def test_checkpoint_meta_records_pipeline():
    from repro_torch.core.lossless import portable_pipelines

    x = np.random.default_rng(3).standard_normal((128, 64)).astype(np.float32)
    payload, meta = T.encode_tensor(x, eb=1e-3, device=CPU)
    assert meta["mode"] == "cuszhi3" and meta["pipeline"] == "auto"
    hdr = Compressor.inspect(payload)
    assert hdr["kind"] == "chunks" and len(hdr["frames"]) == meta["n_frames"]
    assert all(f["pipeline"] in portable_pipelines() for f in hdr["frames"])
    rng = float(x.max() - x.min())
    assert np.abs(T.decode_tensor(payload, meta, device=CPU).numpy() - x).max() <= 1e-3 * rng * (1 + 1e-5)


def test_nfsafe_checkpoint_codec():
    rng = np.random.default_rng(5)
    x = np.cumsum(np.cumsum(rng.standard_normal((32, 32, 8)), 0), 1).astype(np.float32)
    x[0, :2] = np.nan
    x[3, 4, 5] = np.inf
    x[-1, -1, -1] = -np.inf
    payload, meta = T.encode_tensor(x, eb=1e-3, device=CPU)
    assert meta["mode"] == "cuszhi3"
    y = T.decode_tensor(payload, meta, device=CPU).numpy()
    fin = np.isfinite(x)
    assert np.array_equal(x[~fin].view(np.uint32), y[~fin].view(np.uint32))
    xf = x[fin].astype(np.float64)
    assert np.abs(xf - y[fin]).max() <= 1e-3 * float(xf.max() - xf.min()) * (1 + 2e-4)


def test_encode_tensor_to_retries_transient_oserror(monkeypatch):
    monkeypatch.setenv("REPRO_IO_RETRIES", "4")
    x = np.linspace(0, 1, 100 * 64, dtype=np.float32).reshape(100, 64)
    sink = io.BytesIO()
    meta = tcodec.encode_tensor_to(FlakyFile(sink, fail_calls=(1, 3)), x, eb=1e-3, device=CPU)
    assert meta["io_retries"] == 2
    assert meta["crc32"] == (zlib.crc32(sink.getvalue()) & 0xFFFFFFFF)
    out = T.decode_tensor(sink.getvalue(), meta, device=CPU).numpy()
    assert np.abs(out - x).max() <= 1e-3 * float(x.max() - x.min()) * (1 + 1e-5)


@pytest.fixture
def daemon(request):
    """A fresh compressd daemon (empty plan cache) of the package
    ``request.param`` names, on the CPU; yields its address."""
    from repro.launch import compressd as jd
    from repro_torch.launch import compressd as td

    with (td.CompressdServer("127.0.0.1:0", workers=2, device=CPU) if request.param == "port"
          else jd.CompressdServer("127.0.0.1:0", workers=2)).start() as srv:
        yield srv.address


def _daemon_field(seed=0):
    return np.random.default_rng(seed).standard_normal((64, 96)).astype(np.float32)


@pytest.mark.parametrize("daemon", ["port", "jax"], indirect=True)
@pytest.mark.parametrize("route", ["argument", "env"])
def test_compressd_route_writes_single_container_leaves(tmp_path, monkeypatch, daemon, route):
    """compressd= and REPRO_COMPRESSD send each error-bounded leaf to the
    daemon (of either package): one mode="cuszhi" container, the daemon's
    plan-cache outcome in the meta (a hit from the second save on), and a
    restore that needs no daemon, in both packages."""
    x = _daemon_field()
    bound = 1e-3 * float(x.max() - x.min()) * (1 + SLACK)
    if route == "argument":
        metas, payloads = [], []
        for _ in range(2):
            sink = io.BytesIO()
            metas.append(tcodec.encode_tensor_to(sink, torch.from_numpy(x), eb=1e-3, compressd=daemon, device=CPU))
            payloads.append(sink.getvalue())
    else:
        monkeypatch.setenv("REPRO_COMPRESSD", daemon)
        tree = {"w": torch.from_numpy(x), "step": torch.tensor(3, dtype=torch.int32)}
        mans = [T.save(tree, tmp_path, step, eb=1e-3, device=CPU) for step in (1, 2)]
        metas = [m["leaves"]["w"] for m in mans]
        payloads = [(tmp_path / f"step_{step:08d}" / m["file"]).read_bytes() for step, m in zip((1, 2), metas)]
        assert mans[1]["leaves"]["step"]["mode"] in ("zstd", "zlib")
        monkeypatch.delenv("REPRO_COMPRESSD")
        restored, _ = T.restore(tree, tmp_path, 2, device=CPU)
        assert np.abs(restored["w"].numpy().astype(np.float64) - x).max() <= bound
    assert [m["compressd"]["plan_cache"] for m in metas] == ["miss", "hit"]
    for meta, payload in zip(metas, payloads):
        assert meta["mode"] == "cuszhi" and meta["field_shape"] == [3, 2048] and "n_frames" not in meta
        assert meta["compressd"]["pipeline"] == Compressor.inspect(payload)["pipeline"]
        assert meta["bytes"] == len(payload) and meta["crc32"] == zlib.crc32(payload) & 0xFFFFFFFF
        assert np.abs(T.decode_tensor(payload, meta, device=CPU).numpy().astype(np.float64) - x).max() <= bound
        assert np.abs(np.asarray(J.decode_tensor(payload, meta)).astype(np.float64) - x).max() <= bound


@pytest.mark.parametrize("daemon_kind", ["port", "jax"])
def test_compressd_meta_equals_the_jax_codec(daemon_kind):
    """The same leaf through the same kind of daemon (fresh, so both start
    cold): the port codec's meta and payload are the JAX codec's, save after
    save, and each package restores the other's within the bound."""
    from repro.launch import compressd as jd
    from repro_torch.launch import compressd as td

    x = _daemon_field(1)
    bound = 1e-3 * float(x.max() - x.min()) * (1 + SLACK)
    out = {}
    for writer in ("jax", "torch"):
        with (td.CompressdServer("127.0.0.1:0", workers=2, device=CPU) if daemon_kind == "port"
              else jd.CompressdServer("127.0.0.1:0", workers=2)).start() as srv:
            runs = []
            for _ in range(2):
                sink = io.BytesIO()
                if writer == "jax":
                    meta = jcodec.encode_tensor_to(sink, x, eb=1e-3, compressd=srv.address)
                else:
                    meta = tcodec.encode_tensor_to(sink, torch.from_numpy(x), eb=1e-3, compressd=srv.address,
                                                   device=CPU)
                runs.append((meta, sink.getvalue()))
        out[writer] = runs
    assert out["torch"] == out["jax"]
    (mj, pj), (mt, pt) = out["jax"][0], out["torch"][0]
    assert list(mt) == list(mj)  # the same keys in the same order
    assert np.abs(T.decode_tensor(pj, mj, device=CPU).numpy().astype(np.float64) - x).max() <= bound
    assert np.abs(np.asarray(J.decode_tensor(pt, mt)).astype(np.float64) - x).max() <= bound


@pytest.mark.parametrize("daemon", ["port"], indirect=True)
def test_async_checkpointer_reaches_the_daemon_through_the_env(tmp_path, monkeypatch, daemon):
    monkeypatch.setenv("REPRO_COMPRESSD", daemon)
    x = _daemon_field(2)
    saver = T.AsyncCheckpointer(tmp_path, eb=1e-3, device=CPU)
    saver.submit({"w": torch.from_numpy(x)}, 1)
    saver.close(timeout=60)
    monkeypatch.delenv("REPRO_COMPRESSD")
    out, man = T.restore({"w": x}, tmp_path, 1, device=CPU)
    assert man["leaves"]["w"]["mode"] == "cuszhi" and man["leaves"]["w"]["compressd"]["plan_cache"] == "miss"
    assert np.abs(out["w"].numpy().astype(np.float64) - x).max() <= 1e-3 * float(x.max() - x.min()) * (1 + SLACK)


def test_unreachable_daemon_fails_the_save_and_writes_no_step(tmp_path, monkeypatch):
    """No fallback: a daemon that does not answer fails the save; no step
    appears and no leaf is encoded another way."""
    from repro_torch.launch import compressd as td

    srv = td.CompressdServer("127.0.0.1:0", device=CPU)
    addr = srv.address
    srv.close()  # nothing listens there now
    monkeypatch.setenv("REPRO_COMPRESSD", addr)
    with pytest.raises(OSError):
        T.save({"w": torch.from_numpy(_daemon_field())}, tmp_path, 1, eb=1e-3, device=CPU)
    assert T.latest_step(tmp_path) is None


@pytest.mark.parametrize("dtype", ["float16", "bfloat16", "int8", "uint8", "int16", "uint16", "int32", "uint32",
                                   "int64", "uint64", "bool", "complex64", "float64"])
def test_every_dtype_crosses_both_ways(tmp_path, dtype):
    rng = np.random.default_rng(9)
    raw = rng.integers(0, 256, 6 * 4 * 16, dtype=np.uint8).tobytes()
    if dtype == "bfloat16":
        v = np.frombuffer(raw[:48], np.int16).reshape(6, 4)
        jleaf = np.asarray(v.view(jnp.bfloat16))
        tleaf = torch.from_numpy(v.copy()).view(torch.bfloat16)
    else:
        v = np.frombuffer(raw, np.uint8).reshape(6, 4, 16).astype(bool) if dtype == "bool" else \
            np.frombuffer(raw[: 24 * np.dtype(dtype).itemsize], dtype).reshape(6, 4)
        jleaf, tleaf = v, torch.from_numpy(v.copy())
    mj = J.save({"v": jleaf}, tmp_path / "j", 1)
    mt = T.save({"v": tleaf}, tmp_path / "t", 1, device=CPU)
    assert mt == mj and mt["leaves"]["v"]["dtype"] == dtype
    assert _files(tmp_path / "t") == _files(tmp_path / "j")
    a, _ = T.restore({"v": tleaf}, tmp_path / "j", device=CPU)
    b, _ = J.restore({"v": jleaf}, tmp_path / "t")
    assert a["v"].dtype == tleaf.dtype and torch.equal(a["v"], tleaf)
    assert np.array_equal(_np(b["v"]), _np(jleaf))
