"""Fault-tolerant checkpointing of torch state, in the JAX package's layout.

Layout: <dir>/step_<N>/  one file per leaf + manifest.json; writes go to a
temp directory first, fsync'd, then atomically renamed — a crash mid-save
never corrupts the latest checkpoint. Orphaned ``.tmp_step_*`` dirs from a
killed earlier process are swept on the next :func:`save` (live tmp dirs
of *this* process are tracked and never touched, so the async worker and a
final sync save cannot stomp each other). Async save runs on a daemon
thread with a single-slot queue so training never blocks more than one
pending snapshot.

The files, the manifest (format 2, per-leaf CRC32; format 1 still read)
and the leaf names are the JAX package's (``repro.checkpoint.manager``),
so either package restores the other's checkpoints. A tree is nested
dicts (keys sorted, as JAX sorts them), lists, tuples, namedtuples and
dataclasses (fields in declaration order); ``None`` is an empty subtree
with no leaf; anything else is a leaf: a tensor, an array or a scalar.
A leaf's name joins its path with ``_``, as ``jax.tree_util``'s key path
does (``{"a": OptState(m, v, step)}`` gives ``a_m``, ``a_v``, ``a_step``).

Device: :func:`save`, :func:`restore` and :class:`AsyncCheckpointer` run
on the card unless given ``device="cpu"``, and raise where CUDA is absent.
Error-bounded leaves compress where they live; :func:`restore` returns
tensors on ``device``.

Device meshes: a tree that holds DTensors (a state placed on a
``launch.mesh`` mesh) saves its leaves' full tensors, gathered on the
calling thread in leaf order on every rank; rank 0 writes them and the
other ranks wait for its outcome, so the files are byte for byte a
single-device save of the same values and every rank returns the same
manifest or raises. :func:`restore` places each leaf by its
``shardings=`` entry (a :class:`repro_torch.runtime.partitioning.NamedSharding`,
the JAX package's elastic restore onto a mesh of any shape) or, where
none is given, as the template's DTensor leaf is placed. Where a rank's
block of an error-bounded leaf is whole rows of its first axis, it
decodes only the v3 frames that hold them; otherwise it decodes the leaf
and keeps its block (a lossless leaf is one zstd/zlib stream).

Damage model: every leaf file carries a whole-payload CRC32 in the
manifest. ``restore(..., strict=False)`` turns a damaged checkpoint into
the best state still on disk instead of an exception: each corrupt leaf
falls back to the newest earlier step whose copy of that leaf verifies
and decodes, and a leaf with no surviving copy is reconstructed as zeros
(or the template's value when ``tree_like`` carries concrete tensors or
arrays). What happened per leaf is reported under ``manifest["salvage"]``.
Damage is about bytes: a kernel or device error
(:data:`repro_torch.core.compressor.DEVICE_ERRORS`) is never recorded as
damage and never replaced by an older step; it propagates.

Tracing: ``checkpoint.save`` and ``checkpoint.restore`` span the calls,
with each leaf's ``checkpoint.encode_leaf`` / ``checkpoint.decode_leaf``
inside.
"""
from __future__ import annotations

import collections
import json
import os
import pathlib
import queue
import shutil
import threading
import uuid
import zlib

import numpy as np
import torch
from torch.profiler import record_function as span

from ..core.compressor import DEVICE_ERRORS
from ..core.errors import CheckpointDamageError
from ..core.retry import retry_call
from ..core.tree import leaf_paths, tree_map
from ..runtime.partitioning import is_placed, mesh_device
from .codec import _as_leaf, _device, _nbytes, _torch_dtype, decode_rows, decode_tensor, encode_tensor_to

_MANIFEST = "manifest.json"

# tmp dirs owned by in-flight save() calls in this process; the stale
# sweep skips these so concurrent savers (async worker + a final sync
# save) never delete each other's work
_live_tmp: set[str] = set()
_live_tmp_lock = threading.Lock()


def _sweep_stale_tmp(directory: pathlib.Path) -> list[str]:
    """Remove orphaned ``.tmp_step_*`` dirs left by a crashed/killed save.

    A tmp dir not registered by this process is assumed dead: the layout
    is single-writer-per-directory by design (the atomic rename publish
    relies on that already), so anything unregistered belongs to a
    process that no longer exists. Returns the removed dir names.
    """
    removed = []
    with _live_tmp_lock:
        live = set(_live_tmp)
    for d in directory.glob(".tmp_step_*"):
        if str(d) in live or not d.is_dir():
            continue
        shutil.rmtree(d, ignore_errors=True)
        removed.append(d.name)
    return removed


# ------------------------------------------------------------ device meshes
def _placed(tree) -> bool:
    return any(is_placed(leaf) for _, leaf in leaf_paths(tree))


def _gather(tree, keep: bool):
    """``[(key, leaf)]`` with every DTensor leaf's full tensor, gathered in
    leaf order (a collective per placed leaf: every rank calls this);
    ``keep=False`` drops the gathered tensors as they come."""
    out = []
    for key, leaf in leaf_paths(tree):
        full = leaf.full_tensor() if is_placed(leaf) else leaf
        out.append((key, full if keep else None))
    return out


def _rank0_outcome(result, err):
    """Rank 0's manifest (or error) on every rank: the other ranks wait here
    until rank 0 has written."""
    import torch.distributed as dist

    box = [result if err is None else {"error": repr(err)}]
    dist.broadcast_object_list(box, src=0)
    if err is not None:
        raise err
    if "error" in box[0]:
        raise RuntimeError(f"rank 0 failed to save the checkpoint: {box[0]['error']}")
    return box[0]


# -------------------------------------------------------------------- save
def save(tree, directory: str | os.PathLike, step: int, *, eb: float = 0.0, device=None) -> dict:
    """Synchronous atomic save. Returns the manifest. ``device``: where the
    error-bounded leaves compress (the card unless ``"cpu"``; a tree of
    DTensors: its mesh's device). A tree of DTensors is gathered and
    written by rank 0 (see the module's docstring); every rank must call
    this."""
    if _placed(tree):
        import torch.distributed as dist

        writer = dist.get_rank() == 0
        if device is None:  # the mesh's device, as restore's
            device = mesh_device(next(leaf for _, leaf in leaf_paths(tree) if is_placed(leaf)).device_mesh)
        leaves = _gather(tree, keep=writer)
        result, err = None, None
        if writer:
            try:
                result = _write(leaves, directory, step, eb=eb, device=device)
            except Exception as e:  # noqa: BLE001 - re-raised here, and reported to the other ranks
                err = e
        del leaves
        return _rank0_outcome(result, err)
    return _write(leaf_paths(tree), directory, step, eb=eb, device=device)


def _write(leaves, directory, step: int, *, eb: float, device) -> dict:
    dev = _device(device)
    directory = pathlib.Path(directory)
    directory.mkdir(parents=True, exist_ok=True)
    _sweep_stale_tmp(directory)
    final = directory / f"step_{step:08d}"
    # unique tmp dir: concurrent savers (async worker + final sync save)
    # must never stomp each other's in-flight files
    tmp = directory / f".tmp_step_{step:08d}_{uuid.uuid4().hex[:8]}"
    tmp.mkdir(parents=True)
    with _live_tmp_lock:
        _live_tmp.add(str(tmp))
    try:
        with span("checkpoint.save"):
            manifest = {"step": int(step), "leaves": {}, "format": 2}
            raw_total = comp_total = 0
            for key, leaf in leaves:
                arr = _as_leaf(leaf)
                fn = f"{key}.bin"
                # error-bounded leaves stream v3 frames into the file as each chunk
                # encodes, so OS writeback of earlier frames overlaps the encode of
                # later ones; one fsync per leaf seals the file
                with open(tmp / fn, "wb") as f:
                    meta = encode_tensor_to(f, arr, eb=eb, device=dev)
                    f.flush()
                    os.fsync(f.fileno())
                manifest["leaves"][key] = dict(meta, file=fn)
                raw_total += _nbytes(arr)
                comp_total += meta["bytes"]
            manifest["raw_bytes"] = int(raw_total)
            manifest["compressed_bytes"] = int(comp_total)
            manifest["cr"] = round(raw_total / max(comp_total, 1), 3)
            with open(tmp / _MANIFEST, "w") as f:
                json.dump(manifest, f)
                f.flush()
                os.fsync(f.fileno())
            if final.exists():
                shutil.rmtree(final)
            os.replace(tmp, final)  # atomic publish
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)  # don't leak the partial save
        raise
    finally:
        with _live_tmp_lock:
            _live_tmp.discard(str(tmp))
    return manifest


def available_steps(directory: str | os.PathLike) -> list[int]:
    """All steps with a manifest on disk, ascending."""
    directory = pathlib.Path(directory)
    if not directory.exists():
        return []
    steps = []
    for d in directory.iterdir():
        if d.name.startswith("step_") and (d / _MANIFEST).exists():
            steps.append(int(d.name.split("_")[1]))
    return sorted(steps)


def latest_step(directory: str | os.PathLike) -> int | None:
    steps = available_steps(directory)
    return steps[-1] if steps else None


# ----------------------------------------------------------------- restore
def _load_leaf(step_dir: pathlib.Path, meta: dict, device: torch.device, rows=None) -> torch.Tensor:
    """Read + CRC-verify + decode one leaf file (``rows``: only that
    ``(lo, hi)`` range of its first axis); raises on any damage."""
    payload = (step_dir / meta["file"]).read_bytes()
    want = meta.get("crc32")
    if want is not None:
        got = zlib.crc32(payload) & 0xFFFFFFFF
        if got != int(want):
            raise CheckpointDamageError(
                f"{meta['file']}: payload crc32 mismatch (expected {int(want):#010x}, got {got:#010x})"
            )
    if rows is not None:
        return decode_rows(payload, meta, *rows, device=device)
    return decode_tensor(payload, meta, device=device)


def _lost_leaf(tmpl, meta: dict, device: torch.device) -> torch.Tensor:
    """A leaf with no surviving copy: the template's own value when it is
    concrete (a tensor off the ``meta`` device, or an array), else zeros."""
    if isinstance(tmpl, torch.Tensor) and tmpl.device.type != "meta":
        return tmpl.detach().to(device, copy=True)
    if isinstance(tmpl, (np.ndarray, np.generic)):
        return torch.from_numpy(np.array(tmpl)).to(device)
    return torch.zeros(tuple(meta["shape"]), dtype=_torch_dtype(meta["dtype"]), device=device)


def _target(tmpl, sh):
    """``(device_mesh, placements)`` of a restored leaf, or None (a plain tensor)."""
    if sh is not None:
        return sh.mesh.device_mesh, sh.placements
    if is_placed(tmpl):
        return tmpl.device_mesh, tuple(tmpl.placements)
    return None


def _put(arr: torch.Tensor, target):
    """``arr`` (the whole leaf, on this rank) placed: this rank's block."""
    from torch.distributed.tensor import distribute_tensor

    dm, pl = target
    return distribute_tensor(arr.to(mesh_device(dm)), dm, pl, src_data_rank=None)


def _block_rows(meta: dict, target):
    """``(lo, hi)`` where this rank's block of an error-bounded leaf is whole
    rows of its first axis (and not all of them): its frames' rows, which
    decode on their own. None otherwise."""
    from torch.distributed.tensor._utils import compute_local_shape_and_global_offset

    shape = tuple(int(s) for s in meta["shape"])
    if target is None or meta["mode"] != "cuszhi3" or not shape:
        return None
    size, off = compute_local_shape_and_global_offset(shape, *target)
    if tuple(size[1:]) != shape[1:] or size[0] == shape[0]:
        return None
    return int(off[0]), int(off[0]) + int(size[0])


def _put_block(block: torch.Tensor, shape: tuple, target):
    """This rank's ``block`` of a leaf of ``shape``, placed."""
    from torch.distributed.tensor import DTensor

    dm, pl = target
    stride = torch.empty(shape, device="meta").stride()
    return DTensor.from_local(block.to(mesh_device(dm)), dm, pl, run_check=False, shape=torch.Size(shape),
                              stride=stride)


def restore(tree_like, directory: str | os.PathLike, step: int | None = None, *, device=None,
            strict: bool = True, shardings=None):
    """Restore into the structure of ``tree_like``; returns ``(tree, manifest)``
    with every leaf a tensor on ``device`` (the card unless ``"cpu"``).
    Template leaves may be tensors on the ``meta`` device (shape only, as
    ``jax.ShapeDtypeStruct`` in the JAX package), concrete tensors or arrays,
    or scalars.

    ``shardings``: a tree of :class:`repro_torch.runtime.partitioning.NamedSharding`
    (or ``None`` entries) matching ``tree_like``: each leaf comes back as a
    DTensor placed by it, on its mesh's device, whatever mesh wrote the
    checkpoint (elastic restore). A template leaf that is itself a DTensor
    is placed as it is placed.

    ``strict=True`` (default): any damaged leaf — CRC mismatch, truncated
    file, undecodable container — raises
    :class:`repro_torch.core.errors.CheckpointDamageError` (or the
    underlying decode error). ``strict=False``: restore degrades per leaf
    instead. Each damaged leaf falls back to the newest *earlier* step whose
    copy of that leaf verifies; a leaf with no surviving copy anywhere is
    reconstructed as zeros (or the template's own value when ``tree_like``
    holds concrete tensors or arrays). The returned manifest then carries a
    ``"salvage"`` report::

        {"damaged": {key: reason, ...},        # leaves bad at the requested step
         "fallback_steps": {key: step, ...},   # where each damaged leaf came from
         "lost": [key, ...]}                   # leaves with no surviving copy

    A kernel or device error (``DEVICE_ERRORS``) propagates under either mode.
    """
    template = leaf_paths(tree_like)
    flat_sh = [None] * len(template) if shardings is None else [s for _, s in leaf_paths(shardings)]
    if len(flat_sh) != len(template):
        raise ValueError(f"{len(template)} template leaves, {len(flat_sh)} shardings")
    targets = [_target(tmpl, sh) for (_, tmpl), sh in zip(template, flat_sh)]
    placed_on = next((mesh_device(t[0]) for t in targets if t is not None), None)
    # placed leaves decode on their mesh's device unless told otherwise
    dev = _device(device if device is not None or placed_on is None else placed_on)
    directory = pathlib.Path(directory)
    step = step if step is not None else latest_step(directory)
    if step is None:
        raise FileNotFoundError(f"no checkpoint under {directory}")
    older = [s for s in available_steps(directory) if s < step]

    d = directory / f"step_{step:08d}"
    try:
        manifest = json.loads((d / _MANIFEST).read_text())
    except (OSError, ValueError) as e:
        if strict or not older:
            raise
        # the requested step's manifest itself is gone/corrupt: restore the
        # newest earlier step wholesale and report the demotion
        prev = older[-1]
        tree, manifest = restore(tree_like, directory, prev, device=dev, strict=False, shardings=shardings)
        salvage = manifest.setdefault("salvage", {"damaged": {}, "fallback_steps": {}, "lost": []})
        salvage["damaged"]["<manifest>"] = f"step {step} manifest unreadable: {e!r}"
        salvage["fallback_steps"]["<manifest>"] = prev
        return tree, manifest

    salvage = {"damaged": {}, "fallback_steps": {}, "lost": []}
    leaves = []
    with span("checkpoint.restore"):
        for (key, tmpl), target in zip(template, targets):
            meta = manifest["leaves"][key]
            rows = _block_rows(meta, target)
            try:
                arr = _load_leaf(d, meta, dev, rows)
            except DEVICE_ERRORS:
                raise  # the card failed, not the bytes: no older step stands in
            except Exception as e:  # noqa: BLE001 - every damage mode funnels into the salvage path
                if strict:
                    raise
                salvage["damaged"][key] = repr(e)
                arr = None
                for prev in reversed(older):  # newest surviving copy wins
                    pd = directory / f"step_{prev:08d}"
                    try:
                        pmanifest = json.loads((pd / _MANIFEST).read_text())
                        arr = _load_leaf(pd, pmanifest["leaves"][key], dev)
                    except DEVICE_ERRORS:
                        raise
                    except Exception:  # noqa: BLE001 - that step's copy is damaged too; keep walking back
                        continue
                    salvage["fallback_steps"][key] = prev
                    break
                if arr is None:
                    salvage["lost"].append(key)
                    # a placed template's stand-in is gathered (every rank finds the same files lost)
                    arr = _lost_leaf(tmpl.full_tensor() if is_placed(tmpl) else tmpl, meta, dev)
                rows = None  # an older step's copy, or the stand-in: the whole leaf
            if target is None:
                leaves.append(arr)
            elif rows is not None:
                leaves.append(_put_block(arr, tuple(meta["shape"]), target))
            else:
                leaves.append(_put(arr, target))
    if salvage["damaged"]:
        manifest = dict(manifest, salvage=salvage)
    it = iter(leaves)
    return tree_map(lambda _: next(it), tree_like), manifest


# ------------------------------------------------------------------- async
def _snapshot(tree):
    """A copy of every leaf taken now, and the events that say the copies of
    card tensors have landed. A card tensor is copied into pinned host
    memory without blocking, on its device's current stream, so the copy is
    ordered before any later in-place update on that stream and card memory
    is not doubled; a CPU tensor is cloned; scalars and arrays become numpy
    arrays."""
    cards = set()

    def snap(leaf):
        if isinstance(leaf, torch.Tensor):
            leaf = leaf.detach()
            if leaf.device.type == "cuda":
                host = torch.empty(leaf.shape, dtype=leaf.dtype, pin_memory=True)
                host.copy_(leaf, non_blocking=True)
                cards.add(leaf.device)
                return host
            return leaf.clone()
        return np.array(leaf)

    snapped = tree_map(snap, tree)
    ready = []
    for d in cards:
        ev = torch.cuda.Event()
        ev.record(torch.cuda.current_stream(d))
        ready.append(ev)
    return snapped, ready


class AsyncCheckpointer:
    """Single-slot background saver: at most one pending snapshot, newer
    requests replace queued ones (training never waits on I/O).

    :meth:`submit` copies every leaf before it returns (torch optimizers
    update parameters in place, so holding references would save a later
    state): card tensors go to pinned host memory without blocking, and
    the worker waits for those copies before it reads them. The worker
    encodes under a CUDA stream of its own.

    Worker-thread failures are never silently parked until a later
    ``submit``: :meth:`wait` (drain) and :meth:`close` (the sync point
    before a final synchronous save) both re-raise the stored exception
    *object*, so the original worker-thread traceback is preserved on it.
    Saves are retried through :func:`repro_torch.core.retry.retry_call` — a
    transient ``OSError`` (NFS blip, ENOSPC race) costs a backoff, not
    the snapshot; the partial tmp dir of a failed attempt is swept by the
    retry's own :func:`save`.

    A tree of DTensors is gathered on the calling thread in leaf order (the
    background thread issues no collective, so it cannot cross the
    training thread's), and only rank 0 queues the snapshot; every rank
    must call :meth:`submit`, :meth:`wait` and :meth:`close`. All three
    raise on every rank if a save of rank 0's failed (``submit`` before it
    gathers, so no rank is left waiting in a collective); the last two
    wait for rank 0's saves first.
    """

    def __init__(self, directory: str | os.PathLike, *, eb: float = 0.0, device=None):
        self.directory = pathlib.Path(directory)
        self.eb = eb
        self.device = _device(device)
        self._q: queue.Queue = queue.Queue(maxsize=1)
        self._err: Exception | None = None
        self._submit_lock = threading.Lock()
        self._closed = False
        self._ranks = False  # a placed tree was submitted: wait/close agree with rank 0
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def _save(self, tree, step: int):
        retry_call(lambda: save(tree, self.directory, step, eb=self.eb, device=self.device))

    def _worker(self):
        stream = torch.cuda.Stream(self.device) if self.device.type == "cuda" else None
        while True:
            item = self._q.get()
            try:
                if item is None:
                    return
                tree, step, ready = item
                for ev in ready:  # the snapshot's copies have landed in host memory
                    ev.synchronize()
                if stream is None:
                    self._save(tree, step)
                else:
                    with torch.cuda.device(self.device), torch.cuda.stream(stream):
                        self._save(tree, step)
            except Exception as e:  # noqa: BLE001 - stored with its traceback, re-raised on wait/close
                self._err = e
            finally:
                self._q.task_done()

    def _raise_pending(self):
        if self._err:
            err, self._err = self._err, None
            raise err  # the exception object still carries the worker traceback

    def _agree(self):
        """Surface a stored error; after a placed submit, on every rank."""
        if not self._ranks:
            self._raise_pending()
            return
        err, self._err = self._err, None
        _rank0_outcome({}, err)

    def submit(self, tree, step: int):
        placed = _placed(tree)
        self._ranks = self._ranks or placed
        self._agree()  # before any gather: a rank-0 save that failed stops every rank here
        if self._closed:
            raise RuntimeError("submit() on a closed AsyncCheckpointer")
        if placed:
            import torch.distributed as dist

            writer = dist.get_rank() == 0
            leaves = _gather(tree, keep=writer)
            if not writer:
                return
            tree = collections.OrderedDict(leaves)  # leaf names as keys: the same files
        host_tree, ready = _snapshot(tree)  # snapshot now
        # serialize submitters: the old drop-then-put could race two callers
        # into a Full queue (both drop, both put, second put explodes) or
        # drop the snapshot a concurrent caller just queued without
        # replacing it
        with self._submit_lock:
            while True:
                try:
                    self._q.put_nowait((host_tree, step, ready))
                    return
                except queue.Full:
                    try:
                        self._q.get_nowait()  # drop the stale pending snapshot
                        self._q.task_done()
                    except queue.Empty:
                        pass  # the worker grabbed it first; slot is free now

    def wait(self):
        """Block until every submitted snapshot is saved (or failed), then
        surface any worker exception with its original traceback."""
        self._q.join()
        self._agree()

    def close(self, timeout: float = 60.0):
        """Drain, stop the worker, surface any stored error. Idempotent —
        a second close is a no-op (beyond re-raising a pending error).
        Raises :class:`TimeoutError` if the worker fails to exit within
        ``timeout`` seconds instead of silently abandoning the join."""
        if not self._closed:
            self._closed = True
            self._q.put(None)
            self._thread.join(timeout=timeout)
            if self._thread.is_alive():
                raise TimeoutError(
                    f"AsyncCheckpointer worker did not exit within {timeout}s; "
                    "a save may still be in flight"
                )
        self._agree()
