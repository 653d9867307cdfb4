"""repro_torch.optim.grad_compress against repro.optim.grad_compress, on the CPU.

The gradient quantizer gives the JAX package's int8 codes and scale; the
packer gives its bytes for the same int8 input and pipeline (``auto``,
``tp``, ``none``, ``cr``), from a numpy array and from a tensor alike, and
each package unpacks the other's. The sharded payload of a partition given
as ``(index, tensor)`` pairs equals the JAX package's for an array with the
same addressable shards. The cases of ``tests/test_orchestrate.py``,
``tests/test_shard_compress.py`` (over ``["cpu"] * 4`` shards) and the
quantizer's property of ``tests/test_properties.py`` run against the port.
"""
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st
from hypothesis.extra import numpy as hnp

import repro.optim.grad_compress as J
from repro_torch.core import frames
from repro_torch.optim import (pack_quantized, pack_quantized_sharded, quantize_shard, unpack_quantized,
                               unpack_quantized_sharded)

PIPELINES = ("auto", "tp", "none", "cr")


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread while this module runs (the suite runs in several
    worker processes at once)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def registries_as_shipped(monkeypatch):
    """Both packages' pipeline registries without the pipelines another test
    file registered into one of them and left there: pipeline="auto" weighs
    every registered pipeline, so a leftover would change one side's choice."""
    from repro.core.lossless import pipelines as rpp
    from repro_torch.core.lossless import pipelines as tpp

    for name in set(rpp.PIPELINES) - set(tpp.PIPELINES):
        monkeypatch.delitem(rpp.PIPELINES, name)
    for name in set(tpp.PIPELINES) - set(rpp.PIPELINES):
        monkeypatch.delitem(tpp.PIPELINES, name)


def _laplace_q(seed=4, n=50000, shape=(250, 200)):
    rng = np.random.default_rng(seed)
    return np.clip(np.round(rng.laplace(0, 2, n)), -127, 127).astype(np.int8).reshape(shape)


# ------------------------------------------------------ the reference's cases
def test_grad_pack_roundtrip_auto_and_fixed():
    q = _laplace_q()
    for pipe in ("auto", "tp", "none"):
        for form in (q, torch.from_numpy(q)):
            buf = pack_quantized(form, 0.125, pipeline=pipe)
            q2, scale = unpack_quantized(buf)
            assert np.array_equal(q2, q) and scale == 0.125
    assert len(pack_quantized(q.reshape(-1), 1.0)) < q.nbytes  # sparse-ish grads compress


def _row_shards(q: np.ndarray, n: int, device="cpu"):
    rows = q.shape[0] // n
    return [((slice(i * rows, (i + 1) * rows), slice(None)), torch.from_numpy(q[i * rows: (i + 1) * rows]).to(device))
            for i in range(n)]


def test_grad_pack_sharded_roundtrip():
    """Four row shards on ["cpu"] * 4 reassemble exactly; frames=[0] fills
    only the first shard's slice."""
    qnp = np.random.default_rng(0).integers(-50, 50, (4 * 2, 512), dtype=np.int8)
    buf = pack_quantized_sharded(_row_shards(qnp, 4), 0.25)
    q2, scale = unpack_quantized_sharded(buf)
    assert scale == 0.25 and np.array_equal(q2, qnp)
    header, table = frames.frame_table(buf)
    assert header["kind"] == "gradq" and len(table) == 4
    part, _ = unpack_quantized_sharded(buf, frames=[0])
    sl = tuple(slice(a, b) for a, b in header["slices"][0])
    assert np.array_equal(part[sl], qnp[sl])
    outside = np.ones_like(part, bool)
    outside[sl] = False
    assert not part[outside].any()


def test_replicated_shards_are_packed_once():
    qnp = _laplace_q(5, 64 * 96, (64, 96))
    shards = _row_shards(qnp, 2)
    buf = pack_quantized_sharded(shards + shards[::-1], 0.5)  # every shard twice
    header, table = frames.frame_table(buf)
    assert len(table) == 2 and header["slices"] == [[[0, 32], [0, 96]], [[32, 64], [0, 96]]]
    assert buf == pack_quantized_sharded(shards, 0.5)
    assert np.array_equal(unpack_quantized_sharded(buf)[0], qnp)


def test_shard_index_must_match_the_shard():
    with pytest.raises(ValueError, match="does not index"):
        pack_quantized_sharded([((slice(0, 4),), torch.zeros((4, 4), dtype=torch.int8))], 1.0)
    with pytest.raises(ValueError, match="at least one shard"):
        pack_quantized_sharded([], 1.0)


@given(t=hnp.arrays(np.float32, st.integers(1, 512), elements=st.floats(-1e6, 1e6, width=32)))
@settings(max_examples=25, deadline=None)
def test_gradient_quantizer_error_bounded(t):
    q, scale = quantize_shard(torch.from_numpy(t))
    deq = q.numpy().astype(np.float32) * float(scale)
    assert np.abs(deq - t).max() <= float(scale) * 0.5 + 1e-6 + np.abs(t).max() * 1e-6


# ---------------------------------------------------- against the JAX package
@pytest.mark.parametrize("case", ["laplace", "normal_tiny", "zeros", "one_spike", "ties"])
def test_quantize_shard_equals_the_jax_package(case):
    rng = np.random.default_rng(7)
    t = {"laplace": lambda: rng.laplace(0, 0.01, (64, 96)),
         "normal_tiny": lambda: rng.standard_normal(1000) * 1e-20,
         "zeros": lambda: np.zeros((8, 8)),
         "one_spike": lambda: np.eye(16) * 3.5,
         # values on exact half steps of the scale: rounding half to even in both
         "ties": lambda: np.array([127.0, -127.0, 0.5, 1.5, 2.5, -0.5, -2.5, 126.5])}[case]().astype(np.float32)
    qj, sj = J.quantize_shard(jnp.asarray(t))
    qt, scale = quantize_shard(torch.from_numpy(t))
    assert qt.dtype == torch.int8 and np.array_equal(np.asarray(qj), qt.numpy())
    assert np.float32(sj) == np.float32(scale.item())


@pytest.mark.parametrize("pipeline", PIPELINES)
@pytest.mark.parametrize("seed,shape", [(4, (250, 200)), (9, (3, 1000)), (11, (70000,))])
def test_pack_quantized_bytes_equal_the_jax_package(registries_as_shipped, pipeline, seed, shape):
    q = _laplace_q(seed, int(np.prod(shape)), shape)
    ref = J.pack_quantized(q, 0.125, pipeline=pipeline)
    assert pack_quantized(q, 0.125, pipeline=pipeline) == ref
    assert pack_quantized(torch.from_numpy(q), torch.tensor(0.125), pipeline=pipeline) == ref
    for buf in (ref, pack_quantized(q, 0.125, pipeline=pipeline)):
        qt, st_ = unpack_quantized(buf)
        qj, sj = J.unpack_quantized(buf)
        assert np.array_equal(qt, q) and np.array_equal(qj, q) and st_ == sj == 0.125


def test_pack_quantized_of_a_quantized_gradient_equals_the_jax_package(registries_as_shipped):
    g = np.random.default_rng(3).laplace(0, 1e-3, (128, 384)).astype(np.float32)
    qj, sj = J.quantize_shard(jnp.asarray(g))
    qt, scale = quantize_shard(torch.from_numpy(g))
    assert pack_quantized(qt, scale) == J.pack_quantized(np.asarray(qj), sj)


def _jax_sharded_like(q: np.ndarray, shards):
    """An object with a JAX array's ``shape`` and ``addressable_shards``
    (``index``, ``data``) over numpy shards: the JAX package's packer reads
    nothing else of it."""
    return types.SimpleNamespace(shape=q.shape, addressable_shards=[
        types.SimpleNamespace(index=index, data=t.numpy()) for index, t in shards])


@pytest.mark.parametrize("partition", ["rows", "cols", "grid", "replicated"])
def test_sharded_payload_equals_the_jax_package(registries_as_shipped, partition):
    qnp = _laplace_q(6, 64 * 96, (64, 96))
    r, c = (slice(0, 32), slice(32, 64)), (slice(0, 48), slice(48, 96))
    full = (slice(None),)
    index = {"rows": [(r[0], full[0]), (r[1], full[0])],
             "cols": [(full[0], c[0]), (full[0], c[1])],
             "grid": [(a, b) for a in r for b in c],
             "replicated": [(r[0], full[0]), (r[1], full[0])] * 2}[partition]
    shards = [(ix, torch.from_numpy(np.ascontiguousarray(qnp[ix]))) for ix in index]
    buf = pack_quantized_sharded(shards, 0.25)
    ref = J.pack_quantized_sharded(_jax_sharded_like(qnp, shards), 0.25)
    assert buf == ref
    assert np.array_equal(J.unpack_quantized_sharded(buf)[0], qnp)
    assert np.array_equal(unpack_quantized_sharded(ref)[0], qnp)
