"""Container v3 frames (repro_torch.core.frames) against the JAX package's
(repro.core.frames): the writers give the same bytes, with and without
sync markers, and the readers give the same tables, payloads, salvage
reports and error types on intact streams and on their damaged forms (made
with the JAX package's fault injectors, repro.testing.faults)."""
import io

import numpy as np
import pytest

from repro.core import errors as rerr
from repro.core import frames as rf
from repro.testing import faults
from repro_torch.core import errors as terr
from repro_torch.core import frames as tf

HEADER = {"kind": "chunks", "version": 3, "shape": [40, 8], "axis": 0, "chunk_sizes": [10, 10, 10, 10],
          "eb_mode": "rel", "note": "x" * 3}


def _payloads(kind: str) -> list[bytes]:
    rng = np.random.default_rng(len(kind))
    if kind == "none":
        return []
    if kind == "empty":
        return [b"", b"a", b""]
    if kind == "text":  # payloads that look like prefixes and markers
        return [b"CSZ3END\n" * 3, tf.SYNC_MARKER * 2, bytes(12), b"plain text payload"]
    return [rng.integers(0, 256, int(n), dtype=np.uint8).tobytes() for n in (300, 1, 4097, 64)]


def _stream(kind: str, sync: bool) -> bytes:
    return rf.pack_frames(HEADER, _payloads(kind), sync=sync)


def _report(r) -> tuple:
    return (tuple((x.kind, x.offset, x.index, x.detail) for x in r.records), r.frames_ok, r.frames_damaged,
            r.bytes_skipped, r.declared_frames, r.truncated, r.ok, r.summary())


def _outcome(fn, *args, **kw):
    """('ok', value) or ('raise', error class name, message)."""
    try:
        return "ok", fn(*args, **kw)
    except Exception as e:  # the comparison is the point: both packages must raise alike
        return "raise", type(e).__name__, str(e)


def _damaged(name: str, buf: bytes) -> bytes:
    n = len(buf)
    return {
        "intact": lambda: buf,
        "bitflip_payload": lambda: faults.corrupt_frame(buf, 2, offset=3, bit=5),
        "bitflip_length": lambda: faults.bit_flip(buf, rf.frame_table(buf)[1][2][0] - 10, 6),
        "drop": lambda: faults.drop_frame(buf, 2),
        "trunc_half": lambda: faults.truncate_fraction(buf, 0.5),
        "trunc_tail": lambda: buf[:-3],
        "torn": lambda: faults.torn_tail(buf, 0.7, garbage=40, seed=3),
        "torn_small": lambda: faults.torn_tail(buf, 0.95, garbage=7, seed=1),
        "no_trailer": lambda: buf[: n - 12],
        "header_cut": lambda: buf[:9],
    }[name]()


DAMAGE = ("intact", "bitflip_payload", "bitflip_length", "drop", "trunc_half", "trunc_tail", "torn", "torn_small",
          "no_trailer", "header_cut")


def test_the_error_taxonomy_is_the_references():
    for name in ("ContainerError", "TruncatedContainerError", "FrameCRCError", "FrameSyncError", "SpecError",
                 "BoundViolationError"):
        t, r = getattr(terr, name), getattr(rerr, name)
        assert [c.__name__ for c in t.__mro__] == [c.__name__ for c in r.__mro__]
    e = terr.FrameCRCError("m", index=2, offset=9)
    assert (e.index, e.offset, str(e)) == (2, 9, "m")
    tr, rr = terr.DamageReport(), rerr.DamageReport()
    for rep in (tr, rr):
        rep.add("crc", 7, index=1, detail="payload CRC32 mismatch")
        rep.add("trailer", 99)
        rep.frames_ok, rep.frames_damaged, rep.bytes_skipped, rep.truncated = 3, 1, 12, True
    assert _report(tr) == _report(rr)
    assert terr.DamageReport().summary() == rerr.DamageReport().summary()
    assert str(terr.DamageRecord("sync", 4)) == str(rerr.DamageRecord("sync", 4))


@pytest.mark.parametrize("sync", [False, True])
@pytest.mark.parametrize("kind", ["none", "empty", "text", "random"])
def test_writers_give_the_reference_bytes(kind, sync):
    frames = _payloads(kind)
    ref = rf.pack_frames(HEADER, frames, sync=sync)
    assert tf.pack_frames(HEADER, frames, sync=sync) == ref
    bio = io.BytesIO()
    w = tf.FrameWriter(bio, HEADER, sync=sync)
    for fr in frames:
        w.write_frame(fr)
    assert w.close() == len(frames) and w.close() == len(frames)
    assert bio.getvalue() == ref
    with pytest.raises(ValueError, match="closed"):
        w.write_frame(b"x")


@pytest.mark.parametrize("sync", [False, True])
def test_an_aborted_writer_leaves_the_trailer_off_as_the_reference(sync):
    streams = []
    for mod in (tf, rf):
        bio = io.BytesIO()
        with pytest.raises(RuntimeError):
            with mod.FrameWriter(bio, HEADER, sync=sync) as w:
                w.write_frame(b"abc")
                raise RuntimeError("producer failed")
        streams.append(bio.getvalue())
    assert streams[0] == streams[1]
    assert _outcome(tf.frame_table, streams[0])[:2] == ("raise", "TruncatedContainerError")


@pytest.mark.parametrize("sync", [False, True])
@pytest.mark.parametrize("damage", DAMAGE)
def test_readers_agree_with_the_reference(damage, sync):
    buf = _damaged(damage, _stream("random", sync))
    assert tf.is_v3(buf) == rf.is_v3(buf)
    assert _outcome(tf.read_header, buf) == _outcome(rf.read_header, buf)
    t, r = _outcome(tf.frame_table, buf), _outcome(rf.frame_table, buf)
    assert t == r
    if t[0] == "ok":
        for entry in t[1][1]:
            assert _outcome(lambda: bytes(tf.read_frame(buf, entry))) == _outcome(lambda: bytes(rf.read_frame(buf, entry)))
        tu, ru = _outcome(tf.unpack_frames, buf), _outcome(rf.unpack_frames, buf)
        assert tu[:2] == ru[:2]
        if tu[0] == "ok":
            assert tu[1][0] == ru[1][0] and [bytes(p) for p in tu[1][1]] == [bytes(p) for p in ru[1][1]]
        assert [bytes(p) for p in tf.unpack_frames(buf, verify=False)[1]] == \
            [bytes(p) for p in rf.unpack_frames(buf, verify=False)[1]]
    for kw in ({}, {"resync": False}, {"verify": False}):
        ts, rs = _outcome(tf.scan_frames, buf, **kw), _outcome(rf.scan_frames, buf, **kw)
        assert ts[0] == rs[0]
        if ts[0] == "ok":
            assert [(i, bytes(p)) for i, p in ts[1][0]] == [(i, bytes(p)) for i, p in rs[1][0]]
            assert _report(ts[1][1]) == _report(rs[1][1])
        else:
            assert ts == rs


def _read_stream(mod, buf, on_error):
    try:
        r = mod.FrameReader(io.BytesIO(buf))
    except Exception as e:
        return "open", type(e).__name__, str(e)
    got = []
    try:
        for i, p in r.iter_frames(on_error=on_error):
            got.append((i, bytes(p)))
    except Exception as e:
        return "raise", type(e).__name__, str(e), got
    return "ok", r.header, got, _report(r.damage), r.frames_read


@pytest.mark.parametrize("sync", [False, True])
@pytest.mark.parametrize("damage", DAMAGE)
def test_the_streaming_reader_agrees_with_the_reference(damage, sync):
    buf = _damaged(damage, _stream("random", sync))
    for on_error in ("raise", "skip"):
        assert _read_stream(tf, buf, on_error) == _read_stream(rf, buf, on_error)
    if damage == "intact":
        with tf.FrameReader(io.BytesIO(buf)) as r:
            assert [bytes(p) for p in r] == _payloads("random")
    if damage != "header_cut":
        with pytest.raises(ValueError, match="on_error"):
            next(tf.FrameReader(io.BytesIO(buf)).iter_frames(on_error="fill"))


@pytest.mark.parametrize("seed", range(6))
def test_random_bit_flips_salvage_as_the_reference(seed):
    """A flipped bit anywhere in the frame region: the same survivors and the
    same report (plain streams resync by the (length, CRC) probe)."""
    rng = np.random.default_rng(seed)
    for sync in (False, True):
        buf = _stream("random", sync)
        start = len(rf.MAGIC_V3) + 4 + int.from_bytes(buf[6:10], "little")
        flipped = faults.bit_flip(buf, int(rng.integers(start, len(buf) - 12)), int(rng.integers(0, 8)))
        t, r = tf.scan_frames(flipped), rf.scan_frames(flipped)
        assert [(i, bytes(p)) for i, p in t[0]] == [(i, bytes(p)) for i, p in r[0]]
        assert _report(t[1]) == _report(r[1])


def test_bad_magic_raises_the_references_error():
    for buf in (b"CSZH2\n" + bytes(20), b"", b"CSZH3"):
        assert _outcome(tf.frame_table, buf) == _outcome(rf.frame_table, buf)
        assert _outcome(tf.scan_frames, buf)[:2] == _outcome(rf.scan_frames, buf)[:2]
    with pytest.raises(terr.ContainerError):
        tf.FrameReader(io.BytesIO(b"nope!!" + bytes(8)))
