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
tensors on ``device``. Placement onto a device mesh (the JAX package's
``shardings=``) waits for the port's mesh stack.

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
import copy
import dataclasses
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
from .codec import _as_leaf, _device, _nbytes, _torch_dtype, decode_tensor, encode_tensor_to

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


# ------------------------------------------------------------------- trees
def _children(node):
    """``[(key, child), ...]`` of a container node in ``jax.tree_util``'s
    order, ``[]`` for ``None``, or ``None`` for a leaf."""
    if node is None:
        return []
    if isinstance(node, dict):
        keys = list(node) if isinstance(node, collections.OrderedDict) else sorted(node)
        return [(k, node[k]) for k in keys]
    if isinstance(node, tuple) and hasattr(node, "_fields"):  # namedtuple
        return list(zip(node._fields, node))
    if isinstance(node, (list, tuple)):
        return list(enumerate(node))
    if dataclasses.is_dataclass(node) and not isinstance(node, type):
        return [(f.name, getattr(node, f.name)) for f in dataclasses.fields(node)]
    return None


def _leaf_paths(tree) -> list[tuple[str, object]]:
    """``(name, leaf)`` of every leaf, the name its key path joined by ``_``."""
    out = []

    def walk(node, path):
        kids = _children(node)
        if kids is None:
            out.append(("_".join(str(k) for k in path), node))
            return
        for k, child in kids:
            walk(child, path + (k,))

    walk(tree, ())
    return out


def _tree_map(fn, tree):
    """``tree`` with every leaf replaced by ``fn(leaf)``, called in
    :func:`_leaf_paths`'s order."""
    kids = _children(tree)
    if kids is None:
        return fn(tree)
    if tree is None:
        return None
    mapped = [(k, _tree_map(fn, child)) for k, child in kids]
    if isinstance(tree, dict):
        return (collections.OrderedDict if isinstance(tree, collections.OrderedDict) else dict)(mapped)
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(v for _, v in mapped))
    if isinstance(tree, (list, tuple)):
        return type(tree)(v for _, v in mapped)
    new = copy.copy(tree)  # a dataclass: its fields replaced, frozen or not
    for k, v in mapped:
        object.__setattr__(new, k, v)
    return new


# -------------------------------------------------------------------- save
def save(tree, directory: str | os.PathLike, step: int, *, eb: float = 0.0, device=None) -> dict:
    """Synchronous atomic save. Returns the manifest. ``device``: where the
    error-bounded leaves compress (the card unless ``"cpu"``)."""
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
            for key, leaf in _leaf_paths(tree):
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
def _load_leaf(step_dir: pathlib.Path, meta: dict, device: torch.device) -> torch.Tensor:
    """Read + CRC-verify + decode one leaf file; raises on any damage."""
    payload = (step_dir / meta["file"]).read_bytes()
    want = meta.get("crc32")
    if want is not None:
        got = zlib.crc32(payload) & 0xFFFFFFFF
        if got != int(want):
            raise CheckpointDamageError(
                f"{meta['file']}: payload crc32 mismatch (expected {int(want):#010x}, got {got:#010x})"
            )
    return decode_tensor(payload, meta, device=device)


def _lost_leaf(tmpl, meta: dict, device: torch.device) -> torch.Tensor:
    """A leaf with no surviving copy: the template's own value when it is
    concrete (a tensor off the ``meta`` device, or an array), else zeros."""
    if isinstance(tmpl, torch.Tensor) and tmpl.device.type != "meta":
        return tmpl.detach().to(device, copy=True)
    if isinstance(tmpl, (np.ndarray, np.generic)):
        return torch.from_numpy(np.array(tmpl)).to(device)
    return torch.zeros(tuple(meta["shape"]), dtype=_torch_dtype(meta["dtype"]), device=device)


def restore(tree_like, directory: str | os.PathLike, step: int | None = None, *, device=None,
            strict: bool = True):
    """Restore into the structure of ``tree_like``; returns ``(tree, manifest)``
    with every leaf a tensor on ``device`` (the card unless ``"cpu"``).
    Template leaves may be tensors on the ``meta`` device (shape only, as
    ``jax.ShapeDtypeStruct`` in the JAX package), concrete tensors or arrays,
    or scalars.

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
    dev = _device(device)
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
        tree, manifest = restore(tree_like, directory, prev, device=dev, strict=False)
        salvage = manifest.setdefault("salvage", {"damaged": {}, "fallback_steps": {}, "lost": []})
        salvage["damaged"]["<manifest>"] = f"step {step} manifest unreadable: {e!r}"
        salvage["fallback_steps"]["<manifest>"] = prev
        return tree, manifest

    salvage = {"damaged": {}, "fallback_steps": {}, "lost": []}
    leaves = []
    with span("checkpoint.restore"):
        for key, tmpl in _leaf_paths(tree_like):
            meta = manifest["leaves"][key]
            try:
                arr = _load_leaf(d, meta, dev)
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
                    arr = _lost_leaf(tmpl, meta, dev)
            leaves.append(arr)
    if salvage["damaged"]:
        manifest = dict(manifest, salvage=salvage)
    it = iter(leaves)
    return _tree_map(lambda _: next(it), tree_like), manifest


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

    snapped = _tree_map(snap, tree)
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
    """

    def __init__(self, directory: str | os.PathLike, *, eb: float = 0.0, device=None):
        self.directory = pathlib.Path(directory)
        self.eb = eb
        self.device = _device(device)
        self._q: queue.Queue = queue.Queue(maxsize=1)
        self._err: Exception | None = None
        self._submit_lock = threading.Lock()
        self._closed = False
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

    def submit(self, tree, step: int):
        self._raise_pending()
        if self._closed:
            raise RuntimeError("submit() on a closed AsyncCheckpointer")
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
        self._raise_pending()

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
        self._raise_pending()
