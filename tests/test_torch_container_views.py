"""The decode path's container views and upload accounting, on the CPU.

``_sections_unpack`` returns views of the caller's buffer (bytes, bytearray
or memoryview), inner containers (nfsafe, pw_rel) included; every mode
decodes any bytes-like input to the JAX package's decode of the same
container: bit for bit where the two packages' decoders agree bit for bit
(const, Lorenzo, offset1d, nonfinite), and elsewhere within the container's
bound of it and of the field; ``last_telemetry["decode"]`` counts the
uploaded bytes, which on a CPU device all take the plain copy
(``pageable_bytes``). The staging ring itself needs pinned memory, so its
tests are in ``test_torch_cuda.py``; its chunk plan is a pure function and
is tested here.
"""
import numpy as np
import pytest
import torch

import repro.core as R
import repro_torch.core as T
from repro_torch.core import staging
from repro_torch.core.compressor import _sections_unpack

from torch_field_cases import SLACK


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _field(shape=(18, 21, 26), seed=3) -> np.ndarray:
    g = np.random.default_rng(seed)
    return np.cumsum(np.cumsum(g.standard_normal(shape), 0), 2).astype(np.float32)


def _nonfinite() -> np.ndarray:
    x = _field()
    x[1, 2, 3], x[4, 5, 6], x[7, 8, 9] = np.nan, np.inf, -np.inf
    return x


def _signed() -> np.ndarray:
    x = _field() + 0.5
    x[0, :3, 0] = 0.0
    return x


MODES = {  # mode: (field, spec) of a container of that mode
    "const": (lambda: np.full((9, 10, 11), 2.5, np.float32), {}),
    "interp": (_field, {}),
    "interp-tp": (_field, {"pipeline": "tp"}),
    "lorenzo": (_field, {"predictor": "lorenzo", "pipeline": "fz"}),
    "lorenzo-hf": (_field, {"predictor": "lorenzo", "pipeline": "hf"}),
    "offset1d": (_field, {"predictor": "offset1d", "pipeline": "none"}),
    "nfsafe": (_nonfinite, {}),
    "nonfinite": (lambda: np.full((4, 5), np.nan, np.float32), {}),
    "pw_rel": (_signed, {"eb_mode": "pw_rel", "eb": 1e-2}),
    "v3": (_field, {}),
}

# the modes whose decode the port and the JAX package compute bit for bit (the
# interp decode's float rounding differs between the two by an ulp or so)
EXACT = {"const", "lorenzo", "lorenzo-hf", "offset1d", "nonfinite"}

_BUFS: dict = {}


def _container(mode: str) -> bytes:
    if mode not in _BUFS:
        make, spec = MODES[mode]
        comp = T.Compressor(T.CompressorSpec(**spec), device="cpu")
        x = make()
        _BUFS[mode] = T.chunk_compress(x, n_chunks=3, compressor=comp) if mode == "v3" else comp.compress(x)
    return _BUFS[mode]


_REFS: dict = {}


def _reference(mode: str) -> np.ndarray:
    """The JAX package's decode of the mode's container."""
    if mode not in _REFS:
        _REFS[mode] = np.asarray(R.Compressor().decompress(_container(mode)))
    return _REFS[mode]


def _bound(buf: bytes, x: np.ndarray) -> np.ndarray:
    """Each point's error bound under the container's header."""
    info = R.Compressor.inspect(buf)
    if info.get("kind") == "chunks":  # v3: each frame's bound over its chunk
        assert info["axis"] == 0
        ebs = np.repeat([f["eb_abs"] for f in info["frames"]], info["chunk_sizes"])
        return np.broadcast_to(ebs.reshape((-1,) + (1,) * (x.ndim - 1)), x.shape)
    if info["mode"] == "pw_rel":
        return info["eb_rel"] * np.abs(x.astype(np.float64))
    return np.full(x.shape, info.get("inner", info)["eb_abs"])


def _check_against_reference(mode: str, y) -> None:
    y = y.cpu().numpy() if isinstance(y, torch.Tensor) else np.asarray(y)
    ref = _reference(mode)
    assert y.shape == ref.shape and y.dtype == ref.dtype
    if mode in EXACT:
        assert np.array_equal(y.view(np.uint8), ref.view(np.uint8))
        return
    x = MODES[mode][0]()
    fin = np.isfinite(x)
    assert np.array_equal(y[~fin].view(np.uint32), ref[~fin].view(np.uint32))  # NaN and Inf patterns
    bound = _bound(_container(mode), x)[fin]
    yf = y[fin].astype(np.float64)
    assert np.all(np.abs(yf - ref[fin]) <= 2 * bound)
    assert np.all(np.abs(yf - x[fin]) <= bound * (1 + SLACK))


AS = {"bytes": bytes, "bytearray": bytearray, "memoryview": memoryview,
      "offset-view": lambda b: memoryview(b"?" + b)[1:]}


def _shares(section, buf) -> bool:
    return np.shares_memory(np.frombuffer(section, np.uint8), np.frombuffer(buf, np.uint8))


@pytest.mark.parametrize("kind", list(AS))
@pytest.mark.parametrize("mode", ["interp", "lorenzo", "nfsafe", "pw_rel"])
def test_sections_are_views_of_the_callers_buffer(mode, kind):
    buf = AS[kind](_container(mode))
    header, sections = _sections_unpack(buf)
    assert header["mode"] == mode
    assert all(_shares(s, buf) for s in sections if len(s))
    if mode in ("nfsafe", "pw_rel"):  # the inner container's sections read the outer buffer too
        inner_header, inner = _sections_unpack(sections[0])
        assert inner_header["mode"] == "interp"
        assert all(_shares(s, buf) for s in inner if len(s))
    assert [bytes(s) for s in sections] == [bytes(s) for s in _sections_unpack(bytes(buf))[1]]


@pytest.mark.parametrize("kind", list(AS))
@pytest.mark.parametrize("mode", list(MODES))
def test_every_mode_decodes_any_bytes_like_to_the_same_array(mode, kind):
    buf = _container(mode)
    comp = T.Compressor(T.CompressorSpec(**MODES[mode][1]), device="cpu")
    _check_against_reference(mode, comp.decompress(AS[kind](buf)))
    dev = comp.decompress(AS[kind](buf), out="device")
    assert isinstance(dev, torch.Tensor)
    _check_against_reference(mode, dev)
    _check_against_reference(mode, T.Compressor(device="cpu", engine="numpy").decompress(AS[kind](buf)))


def test_inspect_of_a_view_is_the_inspect_of_the_bytes():
    for mode in ("interp", "nfsafe", "pw_rel", "v3"):
        buf = _container(mode)
        assert T.Compressor.inspect(memoryview(buf)) == T.Compressor.inspect(buf)


def test_decode_counts_each_upload_as_a_plain_copy_on_the_cpu():
    comp = T.Compressor(T.CompressorSpec(pipeline="none", engine="device"), device="cpu")
    buf = comp.compress(_field())
    verify = comp.last_telemetry["decode"]  # the held verify decode adds to the compress's record
    _, (stream, anchors, oi, ov) = _sections_unpack(buf)
    # the device engine uploads the stream once: under pipeline "none", all but
    # its 5 bytes of LLP2 framing
    moved = len(stream) - 5 + len(anchors) + len(oi) + len(ov)
    assert verify == {"staged_bytes": 0, "pageable_bytes": moved}
    comp.decompress(buf, out="device")
    tel = comp.last_telemetry["decode"]
    assert tel["staged_bytes"] == 0 and tel["pageable_bytes"] == moved
    assert tel["bytes"] == _field().nbytes


def test_v3_frames_add_their_uploads_to_the_streams_record():
    buf = _container("v3")
    comp = T.Compressor(device="cpu")
    comp.decompress(buf)
    whole = comp.last_telemetry["decode"]["pageable_bytes"]
    frames = []
    for i in range(3):
        comp.decompress(buf, frames=[i])
        frames.append(comp.last_telemetry["decode"]["pageable_bytes"])
    assert whole == sum(frames) > 0 and comp.last_telemetry["decode"]["staged_bytes"] == 0


def test_upload_keeps_dtype_shape_and_bytes_on_the_cpu():
    tel = {}
    a = np.arange(12, dtype=np.float32).reshape(3, 4)
    t = staging.upload(a, "cpu", tel)
    assert t.dtype == torch.float32 and tuple(t.shape) == (3, 4) and np.array_equal(t.numpy(), a)
    raw = memoryview(b"\x01\x02\x03")
    assert staging.upload(raw, torch.device("cpu"), tel).tolist() == [1, 2, 3]
    assert staging.upload(np.zeros(0, np.int64), "cpu", tel).numel() == 0
    assert tel == {"decode": {"staged_bytes": 0, "pageable_bytes": 48 + 3}}


@pytest.mark.parametrize("n,chunk", [(0, 8), (1, 8), (7, 8), (8, 8), (9, 8), (3 * 8 + 17, 8),
                                     (staging.CHUNK + 1, staging.CHUNK)])
def test_chunk_plan_covers_the_stream_once_in_order(n, chunk):
    plan = staging.chunk_plan(n, chunk)
    assert all(0 < ln <= chunk for _, ln in plan)
    assert [off for off, _ in plan] == list(range(0, n, chunk))
    assert sum(ln for _, ln in plan) == n
    assert len(plan) == -(-n // chunk)


@pytest.mark.parametrize("n", [0, 1, staging.PART_MIN - 1, staging.PART_MIN, staging.PART_MIN + 1,
                               3 * staging.PART_MIN + 17])
def test_host_copy_is_byte_equal_in_parts(n):
    """The ring's host copy (a memmove, in PARTS parts on as many threads
    from PART_MIN bytes) writes exactly the source's bytes, at any offsets."""
    src = np.random.default_rng(n).integers(0, 256, n + 3, np.uint8)[3:]
    dst = np.zeros(n + 8, np.uint8)
    staging.host_copy(dst.ctypes.data + 5, src.ctypes.data, n)
    assert np.array_equal(dst[5 : 5 + n], src)
    assert not dst[:5].any() and not dst[5 + n :].any()
