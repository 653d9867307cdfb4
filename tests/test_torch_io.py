"""repro_torch.io against repro.io, and repro_torch.core.retry against
repro.core.retry.

Files: the port writes the JAX package's bytes and manifest wherever the
codes agree (and always for lossless variables); each package reads the
other's files, lossy variables within each chunk's bound
(``eb * (1 + 1e-4)``), lossless ones exactly; ``read_variable`` reads one
chunk by random access. Retry: the same attempts, delays (jitter seeded)
and errors as the JAX package under injected faults
(repro.testing.faults.FlakyFile)."""
import io

import numpy as np
import pytest
import torch

import repro.core as R
import repro.io as rio
import repro_torch.core as T
import repro_torch.io as tio
from repro.core import distributed as RD
from repro.core import retry as rretry
from repro.data import load_real_fields
from repro.testing.faults import FlakyFile
from repro_torch.core import SpecError
from repro_torch.core import distributed as TD
from repro_torch.core import frames as tframes
from repro_torch.core import retry as tretry

SLACK = 1e-4


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread while this module runs (the suite runs in several
    worker processes at once)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def weather():
    suite = load_real_fields()
    return {"t2m": suite["temperature"][:32, :40], "vort": suite["vorticity"][:20, :18, :16]}


def _dataset(mod, weather):
    ds = mod.Dataset(attrs={"title": "unit", "run": 3})
    ds["t2m"] = mod.Variable(weather["t2m"], ("lat", "lon"), {"units": "K"})
    ds["vort"] = mod.Variable(weather["vort"], ("z", "y", "x"))
    ds["step"] = mod.Variable(np.arange(10, dtype=np.int32), ("step",))
    ds["flag"] = mod.Variable(np.array(7, np.int16))
    return ds


COMPRESSION = {None: "lossless", "t2m": "lossy,rel,1e-3", "vort": "lossy,abs,0.05,pipeline=hf"}
CHUNKS = {"t2m": (16, 40), "vort": (10, 18, 16), "step": 4}


def _check_read(back, weather, *, t2m_bound: bool = True):
    assert back.attrs == {"title": "unit", "run": 3}
    assert back["t2m"].attrs == {"units": "K"} and back["vort"].dims == ("z", "y", "x")
    assert np.array_equal(back["step"].data, np.arange(10, dtype=np.int32)) and back["step"].dtype == np.int32
    assert back["flag"].data.shape == () and int(back["flag"].data) == 7
    x = weather["vort"]
    assert float(np.abs(back["vort"].data.astype(np.float64) - x).max()) <= 0.05 * (1 + SLACK)
    t = weather["t2m"]
    for lo in (0, 16) if t2m_bound else ():  # rel mode: each chunk's bound is its own range's
        c = t[lo:lo + 16].astype(np.float64)
        err = float(np.abs(back["t2m"].data[lo:lo + 16].astype(np.float64) - c).max())
        assert err <= 1e-3 * (c.max() - c.min()) * (1 + SLACK)


@pytest.mark.parametrize("sync", [False, True])
def test_the_port_writes_the_references_file_and_each_reads_the_other(tmp_path, weather, sync):
    tp, rp = tmp_path / "t.cszh3", tmp_path / "r.cszh3"
    mt = tio.write(_dataset(tio, weather), tp, compression=COMPRESSION, chunks=CHUNKS, sync=sync, device="cpu")
    mr = rio.write(_dataset(rio, weather), rp, compression=COMPRESSION, chunks=CHUNKS, sync=sync)
    assert {k: v for k, v in mt.items() if k != "bytes_written"} == {k: v for k, v in mr.items() if k != "bytes_written"}
    assert tio.manifest(tp) == rio.manifest(rp) == tio.manifest(rp)
    # frame for frame: equal bytes but for t2m's two lossy chunks, whose code
    # streams differ from the JAX package's in 10 and 3 of 825 codes, all in
    # the edge-replicated padding (float tie-breaks of the 2-D predictor)
    _, tfr = tframes.unpack_frames(tp.read_bytes())
    _, rfr = tframes.unpack_frames(rp.read_bytes())
    assert len(tfr) == len(rfr) == 2 + 2 + 3 + 1
    assert [bytes(a) == bytes(b) for a, b in zip(tfr, rfr)] == [False, False] + [True] * 6
    _check_read(tio.read(tp, device="cpu"), weather)
    _check_read(rio.read(rp), weather)
    # across the packages the bound holds for vort; each t2m chunk is the
    # reader's own decode of the writer's frame (their cross-decode lands at
    # err/eb up to 1.002 on these values near 300: ROADMAP.md section 3)
    for back, frames, comp in ((rio.read(tp), tfr, R.Compressor()), (tio.read(rp, device="cpu"), rfr,
                                                                      T.Compressor(device="cpu"))):
        _check_read(back, weather, t2m_bound=False)
        assert np.array_equal(back["t2m"].data, np.concatenate([comp.decompress(bytes(f)) for f in frames[:2]]))


def test_lossless_files_are_byte_identical_and_exact(tmp_path, weather):
    ds = {"t2m": weather["t2m"], "i": np.arange(60, dtype=np.int64).reshape(6, 10), "b": np.ones(5, bool)}
    tp, rp = tmp_path / "t.cszh3", tmp_path / "r.cszh3"
    tio.write(ds, tp, compression="lossless", chunks=(4, 7), device="cpu")
    rio.write(ds, rp, compression="lossless", chunks=(4, 7))
    assert tp.read_bytes() == rp.read_bytes()
    back = tio.read(rp, device="cpu")
    for k, v in ds.items():
        assert np.array_equal(back[k].data, v) and back[k].dtype == v.dtype


def test_read_variable_reads_one_chunk(tmp_path, weather):
    path = tmp_path / "r.cszh3"
    rio.write(_dataset(rio, weather), path, compression=COMPRESSION, chunks=CHUNKS)
    full = tio.read_variable(path, "vort", device="cpu")
    one = tio.read_variable(path, "vort", chunks=(1, 0, 0), device="cpu")
    assert one.shape == (10, 18, 16) and np.array_equal(one, full[10:20])
    assert np.array_equal(tio.read_variable(path, "vort", chunks=1, device="cpu"), one)
    ref = rio.read_variable(path, "vort", chunks=1)
    assert float(np.abs(one.astype(np.float64) - ref).max()) <= 0.05 * SLACK
    assert np.array_equal(tio.read_variable(path, "step", chunks=2, device="cpu"), np.arange(8, 10, dtype=np.int32))
    with pytest.raises(IndexError):
        tio.read_variable(path, "vort", chunks=(2, 0, 0), device="cpu")
    with pytest.raises(IndexError):
        tio.read_variable(path, "step", chunks=3, device="cpu")
    with pytest.raises(KeyError):
        tio.read_variable(path, "nope", device="cpu")


def test_spec_handling_matches_the_reference(tmp_path):
    for spec in ("lossless", " LOSSLESS ", "lossy,abs,1e-3,predictor=auto", "lossy,psnr,60", None):
        t, r = tio.parse_compression(spec), rio.parse_compression(spec)
        assert (t is None) == (r is None)
        if t is not None:
            assert t.to_string() == r.to_string()
    for bad in ("lossy,abs", "zstd", "lossy,abs,1e-3,bogus=1"):
        with pytest.raises(SpecError):
            tio.parse_compression(bad)
    with pytest.raises(SpecError):
        tio.parse_compression(3.0)
    with pytest.raises(ValueError, match="not a repro.io dataset"):
        tio.manifest(TD.chunk_compress(np.ones((4, 4), np.float32), device="cpu"))
    with pytest.raises(ValueError, match="rank"):
        tio.write({"a": np.zeros((4, 4), np.float32)}, tmp_path / "x", chunks={"a": (2,)}, device="cpu")


def test_the_npz_adapter_and_open_dataset(tmp_path, weather):
    ds = tio.Dataset.from_arrays({"t2m": weather["t2m"]})
    path = tmp_path / "d.npz"
    ds.to_npz(path)
    back = tio.open_dataset(path)
    assert np.array_equal(back["t2m"].data, weather["t2m"]) and back["t2m"].dims == ("t2m_d0", "t2m_d1")
    with pytest.raises(ValueError, match="don't know how to open"):
        tio.open_dataset(tmp_path / "d.txt")
    with pytest.raises(ValueError, match="dims"):
        tio.Variable(np.zeros((2, 2)), ("a",))


# ----------------------------------------------------------------- retry
@pytest.mark.parametrize("fails,attempts", [(0, 3), (2, 3), (3, 3), (1, 1), (4, 6)])
@pytest.mark.parametrize("jitter", [0.0, 0.5])
def test_retry_call_matches_the_reference(fails, attempts, jitter):
    def run(mod):
        calls, sleeps, seen = {"n": 0}, [], []

        def flaky():
            calls["n"] += 1
            if calls["n"] <= fails:
                raise OSError(f"transient {calls['n']}")
            return "ok"

        policy = mod.RetryPolicy(attempts=attempts, jitter=jitter)
        try:
            out = mod.retry_call(flaky, policy=policy, sleep=sleeps.append, seed=7,
                                 on_retry=lambda a, e, d: seen.append((a, str(e), d)))
        except OSError as e:
            out = ("raised", str(e))
        return out, calls["n"], sleeps, seen

    assert run(tretry) == run(rretry)


def test_retry_only_retries_its_errors_and_reads_the_attempts_variable(monkeypatch):
    with pytest.raises(ValueError):
        tretry.retry_call(lambda: (_ for _ in ()).throw(ValueError("not transient")), sleep=lambda s: None)
    for env in ("5", "0", "junk"):
        monkeypatch.setenv("REPRO_IO_RETRIES", env)
        assert tretry.default_policy() == tretry.RetryPolicy(attempts=rretry.default_policy().attempts)
    p = tretry.RetryPolicy(base_delay=0.1, max_delay=0.3, jitter=0.0)
    import random
    assert [p.delay(a, random.Random(0)) for a in (1, 2, 3, 4)] == [0.1, 0.2, 0.3, 0.3]


@pytest.mark.parametrize("fail_calls", [(), (2, 5), (1, 2)])
def test_chunk_compress_through_a_flaky_sink_retries_as_the_reference(fail_calls):
    x = load_real_fields()["vorticity"][:16, :18, :16]
    ref = RD.chunk_compress(x, n_chunks=4)
    outs = []
    for mod, produce in ((tretry, lambda w: TD.chunk_compress(x, n_chunks=4, out=w, device="cpu")),
                         (rretry, lambda w: RD.chunk_compress(x, n_chunks=4, out=w))):
        sink = io.BytesIO()
        w = mod.RetryingWriter(FlakyFile(sink, fail_calls=fail_calls), policy=mod.RetryPolicy(attempts=3, jitter=0.0),
                               sleep=lambda s: None)
        produce(w)
        outs.append((sink.getvalue(), w.retries))
    assert outs[0] == outs[1] and outs[0][0] == ref and outs[0][1] == len(fail_calls)


def test_a_sink_that_keeps_failing_raises_and_leaves_no_trailer():
    x = load_real_fields()["vorticity"][:16, :18, :16]
    sink = io.BytesIO()
    w = tretry.RetryingWriter(FlakyFile(sink, fail_calls=(4, 5, 6)), policy=tretry.RetryPolicy(attempts=3),
                              sleep=lambda s: None)
    with pytest.raises(OSError):
        TD.chunk_compress(x, n_chunks=4, out=w, device="cpu")
    assert not sink.getvalue().endswith(b"CSZ3END\n")
