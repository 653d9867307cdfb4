"""The port's lossless stages and pipelines against the JAX package, byte for
byte: the host stages, and the torch twins of the device engine run on CPU
tensors (the same code that runs on the card, with the histogram's plain
version)."""
import numpy as np
import pytest
import torch

import repro.core.lossless.huffman as rhf
import repro.core.lossless.pipelines as rpipe
import repro.core.lossless.stages as rstages
import repro_torch.core.lossless.engine as teng
import repro_torch.core.lossless.huffman as thf
import repro_torch.core.lossless.pipelines as tpipe
import repro_torch.core.lossless.stages as tstages
from repro.kernels.histogram import histogram256_ref
from repro_torch.kernels.histogram import histogram256

LENGTHS = [0, 1, 1023, 1024, 1025, 300_001]


def _stream(kind: str, n: int) -> np.ndarray:
    rng = np.random.default_rng(n + (0 if kind == "random" else 1))
    if kind == "random":
        return rng.integers(0, 256, n, dtype=np.uint8)
    # quantization-code-like: centered on 128, runs of the center code, rare outliers (0)
    d = np.clip(np.rint(rng.laplace(128, 1.5, n)), 1, 255).astype(np.uint8)
    d[rng.random(n) < 0.4] = 128
    d[rng.random(n) < 0.001] = 0
    return d


STAGES = ["hf"] + [f"{s}{k}" for s in ("rre", "rze") for k in (1, 2, 4, 8)] + ["tcms1", "tcms8"]


@pytest.mark.parametrize("n", LENGTHS)
@pytest.mark.parametrize("kind", ["random", "codes"])
@pytest.mark.parametrize("stage", STAGES)
def test_stage_bytes_equal_host_and_twin(stage, kind, n):
    data = _stream(kind, n)
    rp, rh = rstages.get_stage(stage).encode(data)
    tst = tstages.get_stage(stage)
    tp, th = tst.encode(data)
    assert bytes(tp) == bytes(rp) and th == rh
    dp, dh = tst.encode_device(torch.from_numpy(data))
    assert dp.dtype == torch.uint8 and dp.numpy().tobytes() == bytes(rp) and dh == rh
    assert tst.pack_header(th) == rstages.get_stage(stage).pack_header(rh)
    assert np.array_equal(tst.decode(bytes(rp), rh)[:n], data)
    tel = {}
    back = tst.decode_device(torch.from_numpy(np.frombuffer(bytes(rp), np.uint8).copy()), rh, tel)
    assert np.array_equal(back.numpy()[:n], data)
    if stage == "hf" and n:
        assert tel["hf_decode"] == "device"


@pytest.mark.parametrize("n", LENGTHS)
@pytest.mark.parametrize("kind", ["random", "codes"])
def test_cr_pipeline_bytes_equal(kind, n):
    data = _stream(kind, n)
    ref = rpipe.encode(data, "cr")
    assert tpipe.encode(data, "cr") == ref
    assert tpipe.encode(torch.from_numpy(data), "cr") == ref
    assert np.array_equal(tpipe.decode(ref), data)
    assert np.array_equal(tpipe.decode(ref, device="cpu").numpy(), data)


def _legacy_hex_stream(data: np.ndarray):
    """An hf stream in the oldest format: hex code lengths and u32 chunk
    sizes in a JSON header, 4096-symbol chunks, each byte-aligned."""
    lens = rhf.code_lengths(np.bincount(data, minlength=256))
    codes, *_ = rhf.canonical_codes(lens)
    chunks, sizes = [], []
    for a in range(0, data.size, rhf._LEGACY_CHUNK):
        bits = [(int(codes[s]) >> (int(lens[s]) - 1 - i)) & 1 for s in data[a : a + rhf._LEGACY_CHUNK]
                for i in range(int(lens[s]))]
        packed = np.packbits(np.asarray(bits, np.uint8))
        chunks.append(packed.tobytes())
        sizes.append(packed.size)
    header = {"n": int(data.size), "lens": lens.tobytes().hex(),
              "chunk_bytes": np.asarray(sizes, np.uint32).tobytes().hex()}
    return b"".join(chunks), header


@pytest.mark.parametrize("form", ["no-offs", "hex-lens"])
def test_legacy_hf_streams_decode_through_the_host_route(form):
    data = _stream("codes", 9000)
    if form == "no-offs":
        payload, header = rhf.encode(data)
        header = {"n": header["n"]}  # a stream written before the offset table
    else:
        payload, header = _legacy_hex_stream(data)
        assert np.array_equal(rhf.decode(payload, header), data)
    assert np.array_equal(thf.decode(payload, header), data)
    tel = {}
    out = teng.hf_decode_device(torch.from_numpy(np.frombuffer(payload, np.uint8).copy()), header, tel)
    assert np.array_equal(out.numpy(), data)
    assert tel["hf_decode"] == "host-legacy"


def _legacy_rr_stream(payload: bytes, header: dict):
    """The same rre/rze stream in the oldest format: the bitmap's top level
    (hex) and the level sizes in the JSON header, the payload without them."""
    top_len, n_levels = (int(v) for v in np.frombuffer(payload[:4], "<u2"))
    off = 4 + 16 * n_levels
    szs = [int(v) for v in np.frombuffer(payload[4:off], "<u8")]
    legacy = dict(header, top=payload[off : off + top_len].hex(), sizes=szs[:n_levels], lvl_sizes=szs[n_levels:])
    return payload[off + top_len :], legacy


@pytest.mark.parametrize("n", [1, 1025, 300_001])
@pytest.mark.parametrize("stage", ["rre1", "rre4", "rze1", "rze8"])
def test_legacy_rr_streams_decode_on_the_device_route(stage, n):
    data = _stream("codes", n)
    payload, header = _legacy_rr_stream(*rstages.get_stage(stage).encode(data))
    rst, tst = rstages.get_stage(stage), tstages.get_stage(stage)
    assert np.array_equal(rst.decode(payload, header)[:n], data)
    assert np.array_equal(tst.decode(payload, header)[:n], data)
    tel = {}
    out = tst.decode_device(torch.from_numpy(np.frombuffer(payload, np.uint8).copy()), header, tel)
    assert np.array_equal(out.numpy()[:n], data)
    # no host route recorded; the flag bitmap's upload is counted (a plain copy on the CPU)
    assert tel == {"decode": {"staged_bytes": 0, "pageable_bytes": tel["decode"]["pageable_bytes"]}}


@pytest.mark.parametrize("n", [0, 1, 8191, 8193, 100_001])
def test_histogram_plain_matches_reference(n):
    d = _stream("codes", n)
    h = histogram256(torch.from_numpy(d))
    assert h.dtype == torch.int64
    assert np.array_equal(h.numpy(), histogram256_ref(d))
