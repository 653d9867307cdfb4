"""Host-to-device uploads of a container's bytes through a pinned staging ring.

A decode reads its container's sections as views of the caller's bytes and
moves each one to the card once. On a CUDA device the bytes are copied chunk
by chunk into a small ring of pinned host buffers, and each chunk goes up by
an asynchronous copy on the current stream while the host copies the next
one. An event recorded behind each chunk's copy is waited on only before that
pinned buffer is written again, so the ring never overwrites bytes still in
flight, and the caller's bytes are read once, straight into pinned memory.
A chunk of ``PART_MIN`` bytes or more is copied by ``PARTS`` host threads at
once (the caller and a shared pool's workers, each a ``memmove`` of its
part, which runs without the GIL): on an H100's host one thread copies 58 MB
into pinned memory in 4.4-6.8 ms, drifting within a process, eight threads
in 0.9-1.9 ms, and the DMA takes 1.1. The copy does not use torch's
intra-op threads, whose number the caller sets (a service feeding the card
from one host thread sets one).

The ring belongs to the thread: threads that share a Compressor never write
into one another's buffers. It is allocated on the thread's first CUDA
upload above ``SMALL`` bytes, ``SLOTS`` buffers of ``CHUNK`` bytes (16 MiB),
and is all the pinned memory it ever holds; each buffer keeps one event, made
with the ring. Both numbers come from a sweep on an H100
(``staging_bench.py``): two 8 MiB buffers were first at 11 MB and within
0.2 ms of the first at 58 MB.

An upload of at most ``SMALL`` bytes (64 KiB) skips the ring: an
asynchronous copy from the caller's memory, which the driver stages itself
before it returns, without waiting for the kernels queued before it. A
small container's decode makes several such uploads (anchors, outliers, a
stage's table or flag bitmap), and the ring's copy and two events cost each
one more host time: on an H100's host, decodes of 6-490 KB containers took
4.0-4.5 ms with every upload in the ring, 6-12 % more than with the
plain blocking copies, and as long as those with the small ones so.

A non-CUDA device keeps the plain copy and ``.to(device)``. Each upload adds
its bytes to ``tel["decode"]``: ``staged_bytes`` through the ring,
``pageable_bytes`` through a copy from pageable memory (every upload on a
non-CUDA device, the small ones on the card).
"""
from __future__ import annotations

import ctypes
import threading
import warnings
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

CHUNK = 8 << 20
SLOTS = 2
SMALL = 64 << 10
PARTS = 4
PART_MIN = 1 << 20

# a small upload reads the caller's bytes, read-only as a rule, through a
# tensor it never writes; torch would warn of that tensor (once a process)
warnings.filterwarnings("ignore", message="The given NumPy array is not writable", category=UserWarning,
                        module=__name__)


_pool = None
_pool_lock = threading.Lock()


def _workers() -> ThreadPoolExecutor:
    global _pool
    with _pool_lock:
        if _pool is None:
            _pool = ThreadPoolExecutor(PARTS - 1, thread_name_prefix="staging-copy")
    return _pool


def host_copy(dst: int, src: int, n: int) -> None:
    """Copy ``n`` bytes from address ``src`` to address ``dst`` (which do
    not overlap), in ``PARTS`` parts on as many threads from ``PART_MIN``
    bytes."""
    if n < PART_MIN:
        ctypes.memmove(dst, src, n)
        return
    step = -(-n // PARTS)
    parts = [_workers().submit(ctypes.memmove, dst + off, src + off, min(step, n - off))
             for off in range(step, n, step)]
    ctypes.memmove(dst, src, step)
    for part in parts:
        part.result()


def chunk_plan(n: int, chunk: int = CHUNK) -> list[tuple[int, int]]:
    """(offset, length) of each chunk of an ``n``-byte stream, in the order
    ``Ring.copy`` takes them."""
    return [(off, min(chunk, n - off)) for off in range(0, n, chunk)]


class Ring:
    """``slots`` pinned host buffers of ``chunk`` bytes, used in turn."""

    def __init__(self, chunk: int = CHUNK, slots: int = SLOTS):
        self.chunk = chunk
        self.host = [torch.empty(chunk, dtype=torch.uint8, pin_memory=True) for _ in range(slots)]
        self.ptrs = [h.data_ptr() for h in self.host]
        self.done = [torch.cuda.Event() for _ in range(slots)]  # behind each buffer's last copy
        self.device = None  # the device the events were recorded on
        self.next = 0

    def _slot(self) -> int:
        """The next buffer, once the copy that last read it has finished."""
        i = self.next
        self.next = (i + 1) % len(self.host)
        self.done[i].synchronize()  # returns at once before the first record
        return i

    def copy(self, src: np.ndarray, out: torch.Tensor) -> None:
        """Copy the flat uint8 array ``src`` into the CUDA tensor ``out``,
        asynchronously on ``out``'s device's current stream."""
        if out.device != self.device:  # an event records on one device only
            for e in self.done:
                e.synchronize()
            self.done = [torch.cuda.Event() for _ in self.host]
            self.device = out.device
        stream = torch.cuda.current_stream(out.device)
        n, addr = src.size, src.ctypes.data
        for off, ln in chunk_plan(n, self.chunk):
            i = self._slot()
            host_copy(self.ptrs[i], addr + off, ln)
            host = self.host[i] if ln == self.chunk else self.host[i][:ln]
            (out if ln == n else out[off : off + ln]).copy_(host, non_blocking=True)
            self.done[i].record(stream)


class _Local(threading.local):
    ring = None


_local = _Local()


def _ring() -> Ring:
    if _local.ring is None:
        _local.ring = Ring()
    return _local.ring


_DTYPES: dict = {}  # numpy dtype -> torch dtype


def _dtype(dt: np.dtype) -> torch.dtype:
    t = _DTYPES.get(dt)
    if t is None:
        t = _DTYPES[dt] = torch.from_numpy(np.empty(0, dt)).dtype
    return t


def _count(tel: dict | None, key: str, n: int) -> None:
    if tel is not None:
        tel.setdefault("decode", {"staged_bytes": 0, "pageable_bytes": 0})[key] += n


def upload(arr, device, tel: dict | None = None) -> torch.Tensor:
    """A copy of ``arr`` (a numpy array, or a bytes-like object read as
    uint8) on ``device``, of its dtype and shape; the bytes are counted in
    ``tel``."""
    if not isinstance(arr, np.ndarray):
        arr = np.frombuffer(arr, np.uint8)
    device = torch.device(device)
    if device.type != "cuda":
        _count(tel, "pageable_bytes", arr.nbytes)
        return torch.from_numpy(arr.copy()).to(device)
    raw = np.ascontiguousarray(arr).reshape(-1).view(np.uint8)
    if arr.nbytes <= SMALL:
        _count(tel, "pageable_bytes", arr.nbytes)
        out = torch.from_numpy(raw).to(device, non_blocking=True)
    else:
        _count(tel, "staged_bytes", arr.nbytes)
        out = torch.empty(arr.nbytes, dtype=torch.uint8, device=device)
        _ring().copy(raw, out)
    return out.view(_dtype(arr.dtype)).reshape(arr.shape)
