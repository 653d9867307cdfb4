"""Error-bounded gradient quantization and its host-relay packer, on the card.

The JAX package's ``repro.optim.grad_compress`` with its bytes. Each shard
of a gradient is quantized to int8 with a per-tensor scale (absolute error
bound = scale/2, i.e. value-range-relative eb ~ 1/254, Eq. 1's contract on
the gradient tensor). For host-relayed links (DCN pod exchange,
parameter-server push, gradient spooling to disk), :func:`pack_quantized`
/ :func:`unpack_quantized` run the int8 shard through the lossless
orchestrator (``pipeline="auto"`` picks the best-fit portable pipeline per
shard and records it in the payload header), shrinking the wire bytes well
below plain int8 when gradients are sparse or low-entropy.
:func:`pack_quantized_sharded` packs each shard of a partitioned tensor as
its own container-v3 frame straight off its device, with each frame's
slice of the full tensor in the header for (partial) reassembly.

A card tensor is re-biased on the card and its stream runs through the
stages' device twins (the orchestrator's statistics through the
``histogram256`` kernel, its bit1 trials through ``bitshuffle``); only the
encoded payload crosses to the host. A numpy array takes the host stages.
The bytes are the same either way, which is the engine's contract.

:func:`pod_allreduce_compressed` is the cross-pod error-feedback
all-reduce itself, on a ``torch.distributed`` process group: each rank
quantizes its gradient plus residual, all-gathers the int8 payloads (the
4x-smaller wire format) and their scales, and averages them; what the
quantization lost becomes the rank's next residual.
"""
from __future__ import annotations

import contextlib
import io
import struct

import numpy as np
import torch

from ..core.frames import FrameWriter, frame_table, read_frame
from ..core.lossless import encode_auto, pipelines
from ..core.serial import pack_obj, unpack_obj
from ..core.tree import leaf_paths, tree_map


def quantize_shard(t, amax=None):
    """``(q, scale)``: ``t`` quantized to int8 in [-127, 127] with the scale
    ``max|t| / 127`` (a 0-d tensor of ``t``'s dtype), rounding half to even.
    ``amax``: the max to use in place of ``t``'s own (that of a whole tensor
    ``t`` is a block of)."""
    t = torch.as_tensor(t)
    scale = torch.clamp(t.abs().max() if amax is None else amax, min=1e-30) / 127.0
    q = torch.clamp(torch.round(t / scale), -127, 127).to(torch.int8)
    return q, scale


def _max_over(values, groups) -> list:
    """Each 0-d tensor of ``values`` as its max over the ranks of every
    group in ``groups`` (one MAX all-reduce a group for all of them)."""
    import torch.distributed as dist

    m = torch.stack(values)
    for grp in groups:
        dist.all_reduce(m, op=dist.ReduceOp.MAX, group=grp)
    return list(m.unbind())


def pod_allreduce_compressed(grads, residuals, group=None, shard_groups=()):
    """Error-feedback int8 all-reduce across the ranks of ``group`` (the
    default process group when None); every rank calls it with its own
    gradients.

    grads / residuals: trees of rank-local float32 tensors of one shape
    each. Returns ``(avg_grads, new_residuals)``: ``avg = sum_r scale_r *
    q_r / world`` over the ranks' int8 payloads ``q_r``, and ``t - q *
    scale`` of this rank's ``t = g + r``.

    ``shard_groups``: the leaves are this rank's blocks of tensors split
    over the ranks of these groups (a pod's sub-mesh). Each block is then
    quantized with its whole tensor's scale (the max over those ranks), so
    its payload is that block of the whole tensor's, and only the blocks
    cross ``group``."""
    import torch.distributed as dist

    world = dist.get_world_size(group)
    # torch 2.13 renames all_gather_into_tensor; both fill a flat output with the ranks' inputs in order
    gather = getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor
    leaves_g = [g for _, g in leaf_paths(grads)]
    leaves_r = [r for _, r in leaf_paths(residuals)]
    amax = [None] * len(leaves_g)
    if shard_groups:
        amax = _max_over([(g.float() + r).abs().max() if g.numel() else r.new_zeros(())
                          for g, r in zip(leaves_g, leaves_r, strict=True)], shard_groups)
    avg, new_res = [], []
    for g, r, m in zip(leaves_g, leaves_r, amax, strict=True):
        t = g.float() + r
        q, scale = quantize_shard(t, m)
        new_res.append(t - q.float() * scale)
        q_all = torch.empty((world * q.numel(),), dtype=torch.int8, device=q.device)
        s_all = torch.empty((world,), dtype=torch.float32, device=q.device)
        gather(q_all, q.reshape(-1).contiguous(), group=group)  # int8 on the wire
        gather(s_all, scale.reshape(1).float(), group=group)
        q_all = q_all.view((world,) + tuple(q.shape))
        avg.append(torch.tensordot(s_all, q_all.float(), dims=([0], [0])) / world)
    ia, ir = iter(avg), iter(new_res)
    return tree_map(lambda _: next(ia), grads), tree_map(lambda _: next(ir), residuals)


# ------------------------------------------------- host-relay lossless path
def pack_quantized(q, scale, pipeline: str = "auto") -> bytes:
    """Serialize an int8-quantized shard through the lossless orchestrator.

    The int8 stream is re-biased to offset-128 uint8 (zero-centered
    gradients land on 128, matching the quantization-code law the stage
    cost hooks were built for). ``pipeline="auto"`` records the chosen
    pipeline in the header; any registered pipeline name is also accepted.

    ``q`` may be a tensor (re-biased where it lives, the stream encoded on
    its device) or a numpy array (the host stages); the bytes are the same.
    """
    if isinstance(q, torch.Tensor):
        qd = q if q.dtype == torch.int8 else q.to(torch.int8)
        shape = tuple(qd.shape)
        stream = qd.contiguous().reshape(-1).view(torch.uint8) ^ 0x80
    else:
        qd = np.ascontiguousarray(np.asarray(q, np.int8))
        shape = qd.shape
        stream = qd.reshape(-1).view(np.uint8) ^ np.uint8(0x80)
    if pipeline == "auto":
        # portable pipelines only: the payload may be decoded on another pod
        # or archived, so it must never require an optional codec
        payload, record = encode_auto(stream, portable_only=True)
        name = record["pipeline"]
    else:
        payload = pipelines.encode(stream, pipeline)
        name = pipeline
    hb = pack_obj({"shape": [int(s) for s in shape], "scale": float(scale), "pipeline": name})
    return struct.pack("<I", len(hb)) + hb + payload


def unpack_quantized(buf):
    """Inverse of :func:`pack_quantized`: returns ``(q int8, scale)`` on the host.

    ``buf`` is any bytes-like object; the payload is decoded from a
    zero-copy view (the sharded reader hands frames through as
    memoryviews)."""
    mv = buf if isinstance(buf, memoryview) else memoryview(buf)
    (hlen,) = struct.unpack_from("<I", mv, 0)
    hdr = unpack_obj(mv[4 : 4 + hlen])
    stream = pipelines.decode(mv[4 + hlen :])
    q = (stream ^ np.uint8(0x80)).view(np.int8).reshape(hdr["shape"])
    return q, hdr["scale"]


def pack_quantized_sharded(shards, scale, pipeline: str = "auto") -> bytes:
    """Per-shard :func:`pack_quantized`, with no gather of the full tensor.

    ``shards``: ``(index, tensor)`` pairs, ``index`` a tuple of slices (one
    per dimension) of the int8 tensor that the shard holds, each tensor on
    its own device (a shard list like a JAX array's ``addressable_shards``).
    The full shape is what the shards cover. Each shard is packed as its
    own container-v3 frame, its stream encoded on its device, so every
    shard keeps its own best-fit pipeline. Replicated shards (the same
    index again) are packed once. The global header records each frame's
    slice of the full tensor; :func:`unpack_quantized_sharded` reassembles
    (a subset of frames reassembles a partial tensor).
    """
    shards = [(tuple(index), t) for index, t in shards]
    if not shards:
        raise ValueError("pack_quantized_sharded needs at least one shard")
    ndim = shards[0][1].dim()
    for index, t in shards:
        if len(index) != ndim or t.dim() != ndim:
            raise ValueError(f"shard index {index} does not index a {ndim}-d shard of shape {tuple(t.shape)}")
    shape = [max((index[d].start or 0) + int(t.shape[d]) for index, t in shards) for d in range(ndim)]
    seen: dict[tuple, torch.Tensor] = {}
    for index, t in shards:
        key = tuple((sl.start or 0, sl.stop if sl.stop is not None else dim) for sl, dim in zip(index, shape))
        seen.setdefault(key, t)
    order = sorted(seen)
    sink = io.BytesIO()
    header = {
        "kind": "gradq",
        "shape": shape,
        "scale": float(scale),
        "slices": [[list(b) for b in key] for key in order],
    }
    with FrameWriter(sink, header) as w:
        for key in order:
            t = seen[key]
            with torch.cuda.device(t.device) if t.is_cuda else contextlib.nullcontext():
                w.write_frame(pack_quantized(t, scale, pipeline))
    return sink.getvalue()


def unpack_quantized_sharded(buf: bytes, frames=None):
    """Inverse of :func:`pack_quantized_sharded`: ``(q int8, scale)`` on the host.

    ``frames``: optional frame indices — only those shards are filled
    (the rest of the tensor is zero), for partial/streamed reassembly.
    """
    header, table = frame_table(buf)
    if header.get("kind") != "gradq":
        raise ValueError(f"not a sharded gradient payload (kind={header.get('kind')!r})")
    out = np.zeros(tuple(header["shape"]), np.int8)
    idx = range(len(table)) if frames is None else frames
    for i in idx:
        q_s, _ = unpack_quantized(read_frame(buf, table[i]))
        sl = tuple(slice(a, b) for a, b in header["slices"][i])
        out[sl] = q_s
    return out, header["scale"]
