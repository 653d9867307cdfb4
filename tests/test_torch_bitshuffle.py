"""The port's BIT1 stage and bitshuffle kernels' plain versions against the
JAX package, byte for byte: the host stage, its torch twin on CPU tensors
(the code that runs on the card, with the kernels' plain versions), the
Pallas kernels in interpret mode, and the tp / fz / fzh pipelines."""
import numpy as np
import pytest
import torch

import repro.core.lossless.bitshuffle as rbit
import repro.core.lossless.pipelines as rpipe
import repro.core.lossless.stages as rstages
import repro_torch.core.lossless.bitshuffle as tbit
import repro_torch.core.lossless.engine as teng
import repro_torch.core.lossless.pipelines as tpipe
import repro_torch.core.lossless.stages as tstages
from repro.kernels.bitshuffle.bitshuffle import bitshuffle_pallas_raw, bitunshuffle_pallas_raw
from repro_torch.kernels import bitshuffle as kbit

LENGTHS = [0, 1, 8191, 8192, 8193, 300_001]


def _stream(kind: str, n: int) -> np.ndarray:
    rng = np.random.default_rng(n + (0 if kind == "random" else 1))
    if kind == "random":
        return rng.integers(0, 256, n, dtype=np.uint8)
    # quantization-code-like: centered on 128, runs of the center code, rare outliers (0)
    d = np.clip(np.rint(rng.laplace(128, 1.5, n)), 1, 255).astype(np.uint8)
    d[rng.random(n) < 0.4] = 128
    d[rng.random(n) < 0.001] = 0
    return d


@pytest.mark.parametrize("n", LENGTHS)
@pytest.mark.parametrize("kind", ["random", "codes"])
def test_bit1_stage_bytes_equal_host_twin_and_reference(kind, n):
    data = _stream(kind, n)
    rp, rh = rbit.bitshuffle_encode(data)
    tp, th = tbit.bitshuffle_encode(data)
    assert tp == rp and th == rh
    dp, dh = teng.bit1_encode_device(torch.from_numpy(data))
    assert dp.dtype == torch.uint8 and dp.numpy().tobytes() == rp and dh == rh
    st = tstages.get_stage("bit1")
    assert st.pack_header(th) == rstages.get_stage("bit1").pack_header(rh)
    assert st.unpack_header(st.pack_header(th)) == th
    assert np.array_equal(tbit.bitshuffle_decode(rp, rh), data)
    back = teng.bit1_decode_device(torch.from_numpy(np.frombuffer(rp, np.uint8).copy()), rh)
    assert np.array_equal(back.numpy(), data)


@pytest.mark.parametrize("kind", ["random", "codes"])
def test_plain_kernels_equal_the_pallas_kernels(kind):
    """Two blocks of 8192 B, as the JAX engine calls the kernels (tile_blocks=1)."""
    data = _stream(kind, 2 * kbit.BLOCK)
    arr = data.reshape(2, kbit.BLOCK)
    ref = np.asarray(bitshuffle_pallas_raw(arr, True, tile_blocks=1)).reshape(-1)
    planes = kbit.bitshuffle(torch.from_numpy(data))
    assert np.array_equal(planes.numpy(), ref)
    inv = np.asarray(bitunshuffle_pallas_raw(ref.reshape(2, kbit.BLOCK), True, tile_blocks=1)).reshape(-1)
    assert np.array_equal(inv, data)
    assert np.array_equal(kbit.bitunshuffle(torch.from_numpy(ref.copy())).numpy(), data)


@pytest.mark.parametrize("block", [8, 24, 64, 1024])
def test_plain_kernels_take_any_block_that_is_a_multiple_of_8(block):
    data = _stream("random", 5 * block - 3)
    planes = kbit.bitshuffle(torch.from_numpy(data), block)
    assert planes.numpy().tobytes() == rbit.bitshuffle_encode(data, block)[0]
    assert np.array_equal(kbit.bitunshuffle(planes, block).numpy()[: data.size], data)


def test_wrappers_check_their_inputs():
    with pytest.raises(ValueError):
        kbit.bitshuffle(torch.zeros(16, dtype=torch.uint8), 12)
    with pytest.raises(ValueError):
        kbit.bitunshuffle(torch.zeros(100, dtype=torch.uint8), 64)
    with pytest.raises(ValueError):
        kbit.bitshuffle(torch.empty(16, dtype=torch.uint8, device="meta"))
    with pytest.raises(ValueError):
        kbit.bitunshuffle(torch.empty(8192, dtype=torch.uint8, device="meta"))


@pytest.mark.parametrize("n", LENGTHS)
@pytest.mark.parametrize("kind", ["random", "codes"])
@pytest.mark.parametrize("pipeline", ["tp", "fz", "fzh"])
def test_bit1_pipelines_bytes_equal(pipeline, kind, n):
    data = _stream(kind, n)
    ref = rpipe.encode(data, pipeline)
    assert tpipe.encode(data, pipeline) == ref
    assert tpipe.encode(torch.from_numpy(data), pipeline) == ref
    assert np.array_equal(tpipe.decode(ref), data)
    assert np.array_equal(tpipe.decode(ref, device="cpu").numpy(), data)
    assert np.array_equal(rpipe.decode(tpipe.encode(torch.from_numpy(data), pipeline)), data)


def test_applied_bit1_records_decode_in_both_packages():
    """bit1 never shrinks a stream, so both packages' encoders store it
    through; a stream whose bit1 record is applied (a hand-built one) still
    decodes the same on the host and through the twins."""
    data = _stream("codes", 20_000)
    payload, hdr = rbit.bitshuffle_encode(data)
    hb = rstages.get_stage("bit1").pack_header(hdr)
    stream = b"LLP2" + bytes([1, 0, 4]) + b"bit1" + len(hb).to_bytes(4, "little") + hb + payload
    assert np.array_equal(rpipe.decode(stream), data)
    assert np.array_equal(tpipe.decode(stream), data)
    assert np.array_equal(tpipe.decode(stream, device="cpu").numpy(), data)
