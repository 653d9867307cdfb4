"""repro_torch.launch.serve against repro.launch.serve, both on the CPU.

A scaled gemma3 prefill cache (batch 4, prompt 32, cache_len 64: 12 bf16
leaves of 4096 and 16384 elements) made by the JAX package and carried to
the port goes through both packages' ``_kv_roundtrip``: the same frame
count, frame order (each frame's shape), ``raw_bytes`` and ``stats`` keys;
every restored leaf within ``eb * (1 + 1e-4)`` of its float32 value before
the cast back to bf16 (``eb`` = 1e-3 of the leaf's own value range); each
package's stream decoded by the other within that bound. Tiny and integer
leaves pass through; a damaged frame leaves its leaf as it was and sets
``stats["damage"]``; the ``compressd=`` route, through a port daemon and
through a JAX daemon, writes the in-process frames byte for byte and counts
plan-cache hits. ``main`` prints the JAX package's lines.
"""
import contextlib
import io
import re
import tempfile

import jax
import numpy as np
import pytest
import torch

import repro.core as jcore
from repro.configs import get_config as jget_config
from repro.launch import compressd as jcompressd
from repro.launch import serve as jserve
from repro.models import init_params as jinit_params
from repro.models import prefill as jprefill
from repro_torch.core import Compressor
from repro_torch.core import frames as tframes
from repro_torch.core.compressor import _sections_unpack
from repro_torch.launch import compressd as tcompressd
from repro_torch.launch import serve as tserve
from repro_torch.models.convert import params_from_numpy, tree_to_numpy

SPEC = tserve.DEFAULT_KV_SPEC
EB = 1e-3
SLACK = 1e-4  # the repo-wide float32 bound slack
B, PROMPT, CACHE_LEN = 4, 32, 64


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread while this module runs (the suite runs in several
    worker processes at once)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _leaves(tree):
    return jax.tree.leaves(tree)


class _Recorder:
    """Wraps a FrameWriter class: every frame written is kept, in order,
    and so is the file the stream went to."""

    def __init__(self, cls):
        self.frames, self.file = [], None
        rec = self

        class Writer(cls):
            def __init__(self, f, *args, **kwargs):
                rec.file = f
                super().__init__(f, *args, **kwargs)

            def write_frame(self, frame):
                rec.frames.append(bytes(frame))
                super().write_frame(frame)

        self.cls = Writer


def _port_roundtrip(cache, **kwargs):
    """The port's _kv_roundtrip of ``cache``, with a recorder of its stream."""
    rec = _Recorder(tserve.FrameWriter)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tserve, "FrameWriter", rec.cls)
        out, stats = tserve._kv_roundtrip(cache, SPEC, **kwargs)
    return out, stats, rec


@pytest.fixture(scope="module")
def ref():
    """The JAX package's scaled gemma3 cache and its _kv_roundtrip, with
    the frames it wrote."""
    cfg = jget_config("gemma3-12b").scaled()
    key = jax.random.PRNGKey(0)
    params = jinit_params(cfg, key)
    tokens = jax.random.randint(key, (B, PROMPT), 0, cfg.vocab)
    _, cache = jprefill(params, cfg, {"tokens": tokens}, cache_len=CACHE_LEN)
    cache_np = jax.tree.map(np.asarray, cache)
    rec = _Recorder(jcore.FrameWriter)
    mp = pytest.MonkeyPatch()
    mp.setattr(jcore, "FrameWriter", rec.cls)
    try:
        restored, stats = jserve._kv_roundtrip(cache, SPEC)
    finally:
        mp.undo()
    return {"cache": cache_np, "restored": jax.tree.map(np.asarray, restored), "stats": stats, "frames": rec.frames}


@pytest.fixture(scope="module")
def port(ref):
    """The port's _kv_roundtrip of the carried cache, with its stream."""
    cache = params_from_numpy(ref["cache"], "cpu")
    restored, stats, rec = _port_roundtrip(cache)
    return {"cache": cache, "restored": restored, "stats": stats, "stream": rec.file.getvalue(),
            "frames": rec.frames}


def _f32(a) -> np.ndarray:
    return np.asarray(a).astype(np.float32)


def _framed(cache_np) -> list[np.ndarray]:
    """The float32 values of the framed leaves (here every leaf: each is
    bf16 with at least 4096 elements)."""
    return [_f32(a) for a in _leaves(cache_np)]


def _within(decoded: np.ndarray, x: np.ndarray) -> float:
    """max |decoded - x| over the bound eb of x's own value range."""
    eb_abs = EB * float(x.max() - x.min())
    return float(np.abs(decoded.astype(np.float64) - x.astype(np.float64)).max()) / eb_abs


def test_the_cache_is_the_case_the_issue_names(ref):
    shapes = sorted({a.shape for a in _leaves(ref["cache"])})
    assert shapes == [(2, 4, 16, 2, 16), (2, 4, 64, 2, 16)]
    assert all(a.size >= 4096 and a.dtype.name == "bfloat16" for a in _leaves(ref["cache"]))


def test_frame_count_order_raw_bytes_and_stats_keys_equal_the_reference(ref, port):
    js, ts = ref["stats"], port["stats"]
    assert sorted(ts) == sorted(js)
    assert ts["frames"] == js["frames"] == len(_leaves(ref["cache"])) == 12
    assert ts["raw_bytes"] == js["raw_bytes"] == sum(a.size * 2 for a in _leaves(ref["cache"]))
    assert len(port["frames"]) == len(ref["frames"]) == 12
    for tf, jf, leaf in zip(port["frames"], ref["frames"], _leaves(ref["cache"])):
        assert tuple(Compressor.inspect(tf)["shape"]) == tuple(jcore.Compressor.inspect(jf)["shape"]) == leaf.shape
    assert sum(ts["pipelines"].values()) == 12
    assert ts["stream_bytes"] == len(port["stream"])
    assert [f for _, f in tframes.FrameReader(io.BytesIO(port["stream"])).iter_frames()] == port["frames"]
    assert ts["cr"] == pytest.approx(ts["raw_bytes"] / ts["comp_bytes"])


def test_every_restored_leaf_is_within_the_bound(ref, port):
    """Each frame's float32 decode lies within eb of its leaf, and the
    restored bf16 leaf is that decode cast back."""
    for frame, x, r in zip(port["frames"], _framed(ref["cache"]), _leaves(tree_to_numpy(port["restored"]))):
        y = Compressor(device="cpu").decompress(frame)
        assert _within(y, x) <= 1 + SLACK
        assert np.array_equal(r, torch.from_numpy(y).to(torch.bfloat16).float().numpy())
    for r, j in zip(_leaves(tree_to_numpy(port["restored"])), _leaves(ref["restored"])):
        assert r.shape == j.shape


def test_the_streams_decode_across_the_packages(ref, port):
    """The port's stream through the JAX package's FrameReader and
    Compressor, and the JAX package's frames through the port's."""
    xs = _framed(ref["cache"])
    reader = jcore.FrameReader(io.BytesIO(port["stream"]))
    assert reader.header == {"kind": "kvcache", "spec": "lossy,rel,0.001,autotune=false,pipeline=auto", "_sync": 1}
    decoded = [jcore.Compressor().decompress(f) for f in reader]
    assert len(decoded) == len(xs)
    for y, x in zip(decoded, xs):
        assert _within(np.asarray(y).reshape(x.shape), x) <= 1 + SLACK
    for f, x in zip(ref["frames"], xs):
        assert _within(Compressor(device="cpu").decompress(f).reshape(x.shape), x) <= 1 + SLACK


def test_tiny_and_integer_leaves_pass_through():
    g = torch.Generator().manual_seed(3)
    big = torch.randn((4, 32, 64), generator=g).to(torch.bfloat16)
    tiny = torch.randn((10, 16), generator=g).to(torch.bfloat16)
    ints = torch.randint(0, 1000, (5000,), generator=g, dtype=torch.int32)
    cache = {"a": big, "b": tiny, "c": ints}
    out, stats = tserve._kv_roundtrip(cache, SPEC)
    assert stats["frames"] == 1 and stats["raw_bytes"] == big.numel() * 2
    assert out["b"] is tiny and out["c"] is ints
    assert out["a"].dtype == torch.bfloat16 and out["a"].shape == big.shape


def test_a_damaged_frame_leaves_its_leaf_and_sets_damage(port, monkeypatch):
    """A bit flipped inside frame 3's payload: that leaf keeps its value,
    every other leaf is restored, and the damage is reported."""
    stream = port["stream"]
    victim = port["frames"][3]
    at = stream.index(victim) + len(victim) // 2
    damaged = bytearray(stream)
    damaged[at] ^= 0x40
    real = tserve.FrameReader
    monkeypatch.setattr(tserve, "FrameReader", lambda f: real(io.BytesIO(bytes(damaged))))
    cache = port["cache"]
    out, stats = tserve._kv_roundtrip(cache, SPEC)
    assert "damage" in stats and "crc" in stats["damage"]
    leaves, before, after = _leaves(tree_to_numpy(port["restored"])), _leaves(tree_to_numpy(cache)), _leaves(tree_to_numpy(out))
    for i, (a, b, r) in enumerate(zip(after, before, leaves)):
        assert np.array_equal(a, b if i == 3 else r), i


@pytest.mark.parametrize("daemon", ["port", "jax"])
def test_the_compressd_route_writes_the_in_process_frames(ref, port, daemon):
    """Frames through a daemon == the in-process frames of the daemon's
    package, byte for byte, with plan-cache hits counted."""
    if daemon == "port":
        server, want = tcompressd.CompressdServer("127.0.0.1:0", workers=2, device="cpu"), port["frames"]
    else:
        server, want = jcompressd.CompressdServer("127.0.0.1:0", workers=2), ref["frames"]
    with server as srv:
        srv.start()
        out, stats, rec = _port_roundtrip(port["cache"], compressd=srv.address)
    got = rec.frames
    assert len(got) == len(want) == 12
    hits = 0
    for g, w in zip(got, want):
        if g == w:
            continue
        # a plan-cache hit skips the orchestrator: its container says
        # "pcached" in place of the orchestrator's "pchoice" record, and is
        # otherwise the in-process container
        (gh, gs), (wh, ws) = _sections_unpack(g), _sections_unpack(w)
        assert gh.pop("pcached") is True and "pchoice" not in gh
        assert wh.pop("pchoice")["pipeline"] == gh["pipeline"]
        assert gh == wh and [bytes(x) for x in gs] == [bytes(x) for x in ws]
        hits += 1
    assert stats["plan_cache_hits"] == hits > 0
    assert sorted(set(stats) - {"plan_cache_hits"}) == sorted(port["stats"])
    for a, b in zip(_leaves(tree_to_numpy(out)), _leaves(tree_to_numpy(port["restored"]))):
        if daemon == "port":
            assert np.array_equal(a, b)
        else:
            assert a.shape == b.shape


def _numbers_to_pattern(line: str) -> str:
    """``line`` as a regex in which every number may be any number."""
    parts = re.split(r"(-?\d+(?:\.\d+)?)", line)
    return "".join(r"-?\d+(?:\.\d+)?" if i % 2 else re.escape(p) for i, p in enumerate(parts))


def test_main_prints_the_reference_lines(capsys):
    argv = ["--scaled", "--tokens", "4"]
    assert jserve.main(argv) == 0
    jlines = capsys.readouterr().out.strip().splitlines()
    assert tserve.main(argv + ["--device", "cpu", "--kv-compress"]) == 0
    tlines = capsys.readouterr().out.strip().splitlines()
    assert len(tlines) == len(jlines) + 1
    assert re.fullmatch(r"kv-cache offload: \d+\.\d MiB -> \d+\.\d MiB in 12 layer-frames \(CR \d+\.\d\d, "
                        r"spec='lossy,rel,1e-3,autotune=false,pipeline=auto', pipelines \{.+\}, \d+\.\d\ds roundtrip\)",
                        tlines[0]), tlines[0]
    for t, j in zip(tlines[1:], jlines):
        assert re.fullmatch(_numbers_to_pattern(j), t), (t, j)


def test_kv_eb_warns_and_clashes_with_kv_spec():
    argv = ["--scaled", "--tokens", "2", "--prompt-len", "8", "--batch", "1", "--device", "cpu", "--kv-compress"]
    with contextlib.redirect_stdout(io.StringIO()), pytest.warns(DeprecationWarning, match="--kv-eb is deprecated"):
        assert tserve.main(argv + ["--kv-eb", "1e-2"]) == 0
    with contextlib.redirect_stderr(io.StringIO()), pytest.raises(SystemExit) as e:
        tserve.main(argv + ["--kv-eb", "1e-2", "--kv-spec", SPEC])
    assert e.value.code == 2


def test_serve_runs_the_port_prefill_and_decode_on_the_cpu():
    """run() returns what main() prints: the greedy tokens and finite logits."""
    with contextlib.redirect_stdout(io.StringIO()) as out:
        r = tserve.run(["--scaled", "--tokens", "3", "--device", "cpu"])
    assert r["tokens"].shape == (4, 3) and r["logits_finite"] and r["kv"] is None
    assert r["prefill_logits"].shape == (4, r["cfg"].vocab)
    assert f"sample: {r['tokens'][0].tolist()}" in out.getvalue()


def test_unix_socket_daemon_route(port):
    """The compressd= route over a unix socket."""
    with tempfile.TemporaryDirectory(prefix="kv") as d:
        with tcompressd.CompressdServer(f"unix:{d}/s", device="cpu") as srv:
            srv.start()
            out, stats = tserve._kv_roundtrip(port["cache"], SPEC, compressd=srv.address)
    assert stats["frames"] == 12 and "damage" not in stats
    for a, b in zip(_leaves(tree_to_numpy(out)), _leaves(tree_to_numpy(port["restored"]))):
        assert np.array_equal(a, b)

