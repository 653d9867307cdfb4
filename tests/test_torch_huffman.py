"""The port's hf stage against the JAX package, byte for byte: the engine's
``hf_encode_device`` / ``hf_decode_device`` on CPU tensors (the Huffman
wrappers' plain versions, which the card's kernels are held to) against the
JAX package's jitted ``hf_encode_device`` / ``hf_decode_device`` and against
the host coder, at chunk-edge lengths up to past the JAX encoder's slab
(``_PAR_SLAB``), on uniform, quantization-code-like, one-symbol and
16-bit-deep streams; and the plain decode of damaged streams, pinned."""
import hashlib

import numpy as np
import pytest
import torch

import jax.numpy as jnp
import repro.core.lossless.engine as reng
import repro.core.lossless.huffman as rhf
import repro_torch.core.lossless.engine as teng
import repro_torch.core.lossless.huffman as thf
from repro_torch.kernels import huffman as khf
from torch_hf_streams import DEEP_FROM, KINDS, LENGTHS, damaged, stream


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread while this module runs (the suite runs in several
    worker processes at once)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(raw: bytes) -> torch.Tensor:
    return torch.from_numpy(np.frombuffer(raw, np.uint8).copy())


def test_the_wrappers_share_the_format_constants():
    assert (khf.ops.CHUNK, khf.ops.MAXLEN) == (thf.CHUNK, thf.MAXLEN) == (rhf.CHUNK, rhf.MAXLEN)
    assert max(LENGTHS) > reng._PAR_SLAB  # the JAX encoder's slabbed route is crossed


@pytest.mark.parametrize("n", LENGTHS)
@pytest.mark.parametrize("kind", KINDS)
def test_hf_bytes_equal_the_jax_package_and_the_host_coder(kind, n):
    data = stream(kind, n)
    ref, rh = rhf.encode(data)
    assert thf.encode(data) == (ref, rh)
    jp, jh = reng.hf_encode_device(jnp.asarray(data))
    assert np.asarray(jp).tobytes() == ref and jh == rh
    tp, th = teng.hf_encode_device(torch.from_numpy(data))
    assert tp.dtype == torch.uint8 and tp.numpy().tobytes() == ref and th == rh
    if kind == "deep" and n >= DEEP_FROM:
        assert int(np.frombuffer(ref[:256], np.uint8).max()) == thf.MAXLEN
    if kind == "one" and n:
        assert sorted(set(ref[:256])) == [0, 1]
    tel = {}
    back = teng.hf_decode_device(_t(ref), rh, tel)
    assert back.dtype == torch.uint8 and np.array_equal(back.numpy(), data)
    assert tel.get("hf_decode") == ("device" if n else None)
    assert np.array_equal(np.asarray(reng.hf_decode_device(jnp.asarray(np.frombuffer(ref, np.uint8)), rh)), data)
    assert np.array_equal(thf.decode(ref, rh), data)


def test_plain_wrappers_are_the_cpu_route():
    """On CPU tensors the wrappers are their plain versions, launching nothing."""
    data = torch.from_numpy(stream("codes", 5000))
    hist = np.bincount(data.numpy(), minlength=256)
    codes, lens, first_code, sym_table, offsets, counts = thf.canonical_codes(thf.code_lengths(hist))
    before = dict(khf.LAUNCHES)
    payload, cb = khf.hf_encode(data, lens, codes, hist)
    pp, pcb = khf.hf_encode_plain(data, lens, codes)
    assert torch.equal(payload, pp) and np.array_equal(cb, pcb) and cb.dtype == np.dtype("<u2")
    maxlen = int(lens.max())
    lut = torch.from_numpy(thf._pair_lut(first_code, counts, sym_table, offsets, maxlen).view(np.int16))
    offs = torch.from_numpy(np.concatenate([[0], np.cumsum(cb.astype(np.int64))[:-1]]))
    bits = payload[256 + 2 * cb.size:]
    assert torch.equal(khf.hf_decode(bits, offs, lut, maxlen, 5000), data)
    assert torch.equal(khf.hf_decode_plain(bits, offs, lut, maxlen, 5000), data)
    assert khf.LAUNCHES == before


# sha256 of the plain decode of each damaged stream (the stream "codes" at
# 300,001 symbols); the card's kernel is held to the plain decode itself
DAMAGED_SHA256 = {
    "flip": "98baf236ca17f12522da00053662f073b2348016c492d3450d753aa744f91fd6",
    "trunc": "d629ca4c66fd58c2de593e4268b103174e2f70f1f536357736ff339b6f4f7182",
}


@pytest.mark.parametrize("how", sorted(DAMAGED_SHA256))
def test_damaged_streams_decode_as_pinned(how):
    """A bit flip and a truncation decode without error to the bytes pinned
    here, equal to the JAX package's device decode of the same bytes (both
    clamp word reads to the zero-padded stream); the symbols before the
    damage are the original's."""
    n = 300_001
    data = stream("codes", n)
    ref, rh = rhf.encode(data)
    bad = damaged(ref, n, how)
    out = teng.hf_decode_device(_t(bad), rh).numpy()
    assert out.shape == (n,)
    assert hashlib.sha256(out.tobytes()).hexdigest() == DAMAGED_SHA256[how]
    assert np.array_equal(out, np.asarray(reng.hf_decode_device(jnp.asarray(np.frombuffer(bad, np.uint8)), rh)))
    assert np.array_equal(out[:1024], data[:1024]) and not np.array_equal(out, data)
