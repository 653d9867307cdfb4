"""compressd — multi-tenant streaming compression daemon, on the card.

    python -m repro_torch.launch.compressd --addr 127.0.0.1:7733 --workers 4 [--device cpu]

The JAX package's daemon (``repro.launch.compressd``) with the same wire
protocol, ops, admission control, survivability and env knobs: one daemon
accepts many concurrent compress/decompress streams (checkpoint shards, KV
pages, field snapshots) over a local socket, feeds them through the
port's :class:`~repro_torch.core.Compressor` on a worker pool, and shares
one LRU plan cache (:class:`repro_torch.core.PlanCache`) across all
tenants, so recurring field signatures skip the tuners. A client of either
package talks to a daemon of either package.

Protocol (v1, length-prefixed binary, symmetric request/response)::

    frame := b"CPD1" | u32 header_len | header | u64 payload_len | payload

with ``header`` a :mod:`repro_torch.core.serial` dict (the JAX package's
bytes). Request headers carry ``op`` plus op-specific fields; response
headers carry ``ok`` and either results or ``error``/``message`` (the
client re-raises the matching typed exception). Ops:

``compress``
    header ``{op, shape, dtype, stream?, spec?}``, payload = raw array
    bytes (C order). ``spec`` is a canonical spec string, or a
    whitelisted CompressorSpec kwargs dict (the legacy form). Response:
    CR/MB/s/plan-cache outcome in the header, the container as payload.
``decompress``
    payload = any v1/v2/v3 container; response payload = raw float32
    field bytes, shape/dtype in the header.
``stats`` / ``health`` / ``ping`` / ``shutdown``
    zero-payload control ops, served on the connection thread and never
    admitted, so they answer while the daemon is saturated or draining.
``sleep``
    diagnostic op: holds its payload's in-flight budget for ``seconds``.

Admission runs after the request prefix and **before** the payload is
read: a payload above ``max_request_bytes`` is drained and rejected
(:class:`~repro_torch.core.errors.RequestTooLargeError`); one that would
exceed ``max_inflight_bytes`` queues up to ``queue_depth`` waiters, beyond
which it is shed (:class:`~repro_torch.core.errors.ServiceOverloadedError`).
Per-request deadlines (``REPRO_COMPRESSD_DEADLINE_MS``), idle reaping
(``REPRO_COMPRESSD_IDLE_S``), the SIGTERM drain (``REPRO_COMPRESSD_DRAIN_S``)
and the stale unix-socket probe are the JAX package's.

Device: the daemon serves on the card (``device=None``) and raises where
CUDA is absent unless given ``device="cpu"``; every cached Compressor runs
there. A compress payload becomes a tensor on that device; a decompress
response is the host bytes of the decoded field. The worker threads run
their requests on the current stream of the thread that built the server.

No fallback: a failing request becomes a typed error *response* (that is
the protocol) and is never run again on another route or on the CPU.
``KernelError``, ``torch.OutOfMemoryError`` and CUDA errors reach the
client under their own class name, and the ``fallbacks`` field of a
compress response is always 0.

Tracing: ``compressd.recv`` (a request's payload off the socket),
``compressd.compress`` / ``compressd.decompress`` (the worker's call, the
compressor's spans inside; they appear in a profile that records every
thread) and ``compressd.send`` (the response onto the socket).
"""
from __future__ import annotations

import argparse
import os
import signal
import socket
import struct
import threading
import time
import warnings
from concurrent.futures import ThreadPoolExecutor
from concurrent.futures import TimeoutError as FutureTimeoutError

import numpy as np
import torch
from torch.profiler import record_function as span

from ..core import Compressor, CompressorSpec, PlanCache
from ..core import errors as _errors
from ..core.errors import (
    DeadlineExceededError,
    RequestTooLargeError,
    ServiceError,
    ServiceOverloadedError,
    ServiceProtocolError,
    SpecError,
)
from ..core.retry import RetryPolicy, retry_call
from ..core.serial import pack_obj, unpack_obj
from ..kernels.build import KernelError

MAGIC = b"CPD1"
_PREFIX = struct.Struct("<I")   # header length
_PLEN = struct.Struct("<Q")     # payload length
_MAX_HEADER = 1 << 20           # 1 MiB of header is already absurd
_DRAIN_CHUNK = 1 << 16
_ONE_SEND = 1 << 16             # payloads below this ride in the prefix's send

# CompressorSpec kwargs a request may set; everything else is rejected so a
# client typo cannot silently fall back to defaults
_SPEC_KEYS = frozenset({
    "eb", "eb_mode", "predictor", "pipeline", "anchor_stride", "autotune",
    "reorder", "backend", "engine", "splines", "schemes",
    "pipeline_candidates", "plan_anchor_strides", "psnr_target", "verify",
})

# zero-payload ops served on the connection thread, bypassing admission
_CONTROL_OPS = ("stats", "ping", "health", "shutdown")

# error names of the card and the kernels a response may carry, besides
# repro_torch.core.errors and the builtins
_DEVICE_ERRORS = {"KernelError": KernelError, "OutOfMemoryError": torch.OutOfMemoryError}
if hasattr(torch, "AcceleratorError"):
    _DEVICE_ERRORS["AcceleratorError"] = torch.AcceleratorError


def _env_int(name: str, default: int) -> int:
    try:
        v = int(os.environ.get(name, ""))
        return v if v > 0 else default
    except ValueError:
        return default


def _env_nonneg(name: str, default: float) -> float:
    """Like :func:`_env_int` but float-valued and 0 is a legal setting
    (0 disables the knob rather than falling back to the default)."""
    try:
        v = float(os.environ.get(name, ""))
        return v if v >= 0 else default
    except ValueError:
        return default


def default_workers() -> int:
    return _env_int("REPRO_COMPRESSD_WORKERS", 4)


def _device(device) -> torch.device:
    """The device the daemon serves on: the card unless ``device`` says otherwise."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("CUDA is not available; compressd serves on the card unless given device='cpu'")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"compressd serves on 'cuda' or 'cpu', got {dev}")
    return dev


# ------------------------------------------------------------------ framing
def _recv_buffer(sock: socket.socket, n: int) -> bytearray:
    """``n`` bytes off ``sock`` into a fresh (writable) buffer."""
    buf = bytearray(n)
    view = memoryview(buf)
    got = 0
    while got < n:
        k = sock.recv_into(view[got:], n - got)
        if k == 0:
            raise ConnectionError("peer closed mid-frame")
        got += k
    return buf


def _recv_exact(sock: socket.socket, n: int) -> bytes:
    return bytes(_recv_buffer(sock, n))


def _drain(sock: socket.socket, n: int) -> None:
    """Discard ``n`` payload bytes without materializing them (rejections
    stay O(chunk) in memory and keep the stream framing intact)."""
    left = n
    while left > 0:
        k = len(sock.recv(min(left, _DRAIN_CHUNK)))
        if k == 0:
            raise ConnectionError("peer closed mid-frame")
        left -= k


def _frame_prefix(header: dict, payload_len: int) -> bytes:
    hb = pack_obj(header)
    return MAGIC + _PREFIX.pack(len(hb)) + hb + _PLEN.pack(payload_len)


def pack_frame(header: dict, payload: bytes = b"") -> bytes:
    return _frame_prefix(header, len(payload)) + payload


def _send_frame(sock: socket.socket, header: dict, payload=b"") -> None:
    """Send :func:`pack_frame`'s bytes; a large payload goes from its own
    buffer, not through a concatenated copy."""
    mv = memoryview(payload).cast("B")
    if mv.nbytes < _ONE_SEND:
        sock.sendall(_frame_prefix(header, mv.nbytes) + mv)
    else:
        sock.sendall(_frame_prefix(header, mv.nbytes))
        sock.sendall(mv)


def _read_prefix(sock: socket.socket) -> tuple[dict, int]:
    """Read one frame's magic + header + payload length (NOT the payload —
    admission control decides whether the payload is read or drained)."""
    magic = _recv_exact(sock, len(MAGIC))
    if magic != MAGIC:
        raise ServiceProtocolError(f"bad frame magic {magic!r}; expected {MAGIC!r}")
    (hlen,) = _PREFIX.unpack(_recv_exact(sock, _PREFIX.size))
    if hlen > _MAX_HEADER:
        raise ServiceProtocolError(f"header length {hlen} exceeds {_MAX_HEADER}")
    try:
        header = unpack_obj(_recv_exact(sock, hlen))
    except Exception as e:
        raise ServiceProtocolError(f"undecodable header: {e!r}") from e
    if not isinstance(header, dict):
        raise ServiceProtocolError(f"header must be a dict, got {type(header).__name__}")
    (plen,) = _PLEN.unpack(_recv_exact(sock, _PLEN.size))
    return header, plen


def read_frame(sock: socket.socket) -> tuple[dict, bytes]:
    header, plen = _read_prefix(sock)
    return header, _recv_exact(sock, plen)


def parse_addr(addr: str):
    """``host:port`` (TCP) or ``unix:/path`` -> (family, sockaddr)."""
    if addr.startswith("unix:"):
        return socket.AF_UNIX, addr[len("unix:"):]
    host, _, port = addr.rpartition(":")
    if not host or not port:
        raise ValueError(f"address must be 'host:port' or 'unix:/path', got {addr!r}")
    return socket.AF_INET, (host, int(port))


# ------------------------------------------------------------------- server
class CompressdServer:
    """The daemon. ``start()`` serves from a background thread (tests,
    in-process benches); ``serve_forever()`` blocks (the CLI). Both accept
    one thread per connection, with requests executed on a shared
    ``workers``-wide pool — concurrency scales with client count while a
    single connection stays strictly ordered. ``device``: where requests
    run, the card unless ``"cpu"``."""

    def __init__(self, addr: str = "127.0.0.1:0", *, workers: int | None = None,
                 queue_depth: int | None = None, max_request_bytes: int | None = None,
                 max_inflight_bytes: int | None = None, plan_cache: PlanCache | None = None,
                 plan_cache_entries: int | None = None, allow_shutdown: bool = True,
                 deadline_ms: float | None = None, idle_s: float | None = None,
                 drain_s: float | None = None, device=None):
        self.device = _device(device)
        # the workers' requests run on this thread's current stream (the
        # payloads come from and go to host memory, so no producer waits)
        self._cuda_stream = torch.cuda.current_stream(self.device) if self.device.type == "cuda" else None
        self.workers = workers if workers is not None else default_workers()
        # survivability knobs; 0 disables (no deadline / no idle reaping)
        self.deadline_ms = (float(deadline_ms) if deadline_ms is not None
                            else _env_nonneg("REPRO_COMPRESSD_DEADLINE_MS", 0.0))
        self.idle_s = (float(idle_s) if idle_s is not None
                       else _env_nonneg("REPRO_COMPRESSD_IDLE_S", 300.0))
        self.drain_s = (float(drain_s) if drain_s is not None
                        else _env_nonneg("REPRO_COMPRESSD_DRAIN_S", 30.0))
        self.queue_depth = (queue_depth if queue_depth is not None
                            else _env_int("REPRO_COMPRESSD_QUEUE_DEPTH", 32))
        self.max_request_bytes = (max_request_bytes if max_request_bytes is not None
                                  else _env_int("REPRO_COMPRESSD_MAX_REQUEST_MB", 256) << 20)
        self.max_inflight_bytes = (max_inflight_bytes if max_inflight_bytes is not None
                                   else _env_int("REPRO_COMPRESSD_INFLIGHT_MB", 512) << 20)
        # a lone maximal request must always be admissible, else it would
        # queue forever against an empty daemon
        self.max_inflight_bytes = max(self.max_inflight_bytes, self.max_request_bytes)
        self.plan_cache = plan_cache if plan_cache is not None else PlanCache(
            plan_cache_entries if plan_cache_entries is not None
            else _env_int("REPRO_COMPRESSD_PLANS", 256))
        self.allow_shutdown = allow_shutdown

        self._family, sockaddr = parse_addr(addr)
        self._listener = socket.socket(self._family, socket.SOCK_STREAM)
        if self._family == socket.AF_INET:
            self._listener.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._unix_path = sockaddr if self._family == socket.AF_UNIX else None
        try:
            if self._unix_path and os.path.exists(self._unix_path):
                self._reclaim_stale_socket(self._unix_path)
            self._listener.bind(sockaddr)
            self._listener.listen(128)
        except BaseException:
            self._listener.close()
            raise
        # periodic accept timeout: closing the listener from another thread
        # does not reliably wake a blocked accept(), so the loop polls the
        # closing flag instead
        self._listener.settimeout(0.2)

        self._pool = ThreadPoolExecutor(max_workers=self.workers,
                                        thread_name_prefix="compressd-worker")
        self._closing = threading.Event()
        self._accept_thread: threading.Thread | None = None
        self._conns: set[socket.socket] = set()
        self._conn_threads: list[threading.Thread] = []
        self._conn_lock = threading.Lock()

        # admission state (condition guards the byte/waiter counters)
        self._cv = threading.Condition()
        self._inflight_bytes = 0
        self._queued = 0
        self._draining = threading.Event()
        self._drain_lock = threading.Lock()  # serializes concurrent drain() calls

        # telemetry (single lock; all counters are cheap increments)
        self._tlock = threading.Lock()
        self._t0 = time.time()
        self._streams: dict[str, dict] = {}
        self._rejected_overload = 0
        self._rejected_oversize = 0
        self._deadline_exceeded = 0
        self._idle_reaped = 0
        self._errors = 0

        # one Compressor per canonical spec, all sharing the plan cache;
        # Compressor per-call state is thread-local, so sharing instances
        # across the worker pool is safe
        self._comps: dict[tuple, Compressor] = {}
        self._comp_lock = threading.Lock()

    # ------------------------------------------------------------ lifecycle
    @staticmethod
    def _reclaim_stale_socket(path: str) -> None:
        """A unix socket path left behind by a dead daemon (SIGKILL, OOM)
        would make every restart fail with EADDRINUSE. Probe it: nobody
        answering -> unlink and rebind; a live daemon -> raise rather than
        hijack its address."""
        probe = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        probe.settimeout(0.5)
        try:
            probe.connect(path)
        except (ConnectionRefusedError, ConnectionResetError, socket.timeout,
                FileNotFoundError):
            try:
                os.unlink(path)
            except FileNotFoundError:
                pass
        else:
            raise OSError(
                f"unix socket {path!r} has a live daemon; refusing to replace it")
        finally:
            probe.close()

    @property
    def address(self) -> str:
        if self._family == socket.AF_UNIX:
            return f"unix:{self._unix_path}"
        host, port = self._listener.getsockname()
        return f"{host}:{port}"

    def start(self) -> "CompressdServer":
        self._accept_thread = threading.Thread(target=self._accept_loop,
                                               name="compressd-accept", daemon=True)
        self._accept_thread.start()
        return self

    def serve_forever(self) -> None:
        self._accept_loop()

    def drain(self, budget_s: float | None = None) -> None:
        """Graceful stop: quit accepting (listener closed, unix socket
        unlinked so a successor can bind immediately), shed new requests
        on live connections, let in-flight work finish for up to
        ``budget_s`` (default ``drain_s``), then close. Idempotent; a
        second concurrent call blocks until the first finishes."""
        with self._drain_lock:
            if self._closing.is_set():
                return
            self._draining.set()
            try:
                self._listener.close()
            except OSError:
                pass
            if self._unix_path:
                try:
                    os.unlink(self._unix_path)
                except OSError:
                    pass
            budget = self.drain_s if budget_s is None else float(budget_s)
            deadline = time.monotonic() + budget
            with self._cv:
                while self._inflight_bytes > 0 and time.monotonic() < deadline:
                    self._cv.wait(0.05)
            self.close()

    def close(self) -> None:
        if self._closing.is_set():
            return
        self._closing.set()
        try:
            self._listener.close()
        finally:
            if self._unix_path:
                try:
                    os.unlink(self._unix_path)
                except OSError:
                    pass
        with self._cv:
            self._cv.notify_all()  # wake queued admissions so they abort
        with self._conn_lock:
            conns = list(self._conns)
        for c in conns:
            try:
                c.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            try:
                c.close()
            except OSError:
                pass
        self._pool.shutdown(wait=False)
        me = threading.current_thread()
        if self._accept_thread is not None and self._accept_thread is not me:
            self._accept_thread.join(timeout=5)
        for t in self._conn_threads:
            if t is not me:  # a conn thread may trigger close() via "shutdown"
                t.join(timeout=5)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    # ------------------------------------------------------------ accepting
    def _accept_loop(self) -> None:
        while not self._closing.is_set():
            try:
                conn, _ = self._listener.accept()
            except socket.timeout:
                continue  # poll the closing flag
            except OSError:
                break  # listener closed
            if self._family == socket.AF_INET:
                conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            if self.idle_s > 0:
                # a connection silent past idle_s raises socket.timeout in
                # _read_prefix and gets reaped (leaked clients can't pin
                # connection threads forever)
                conn.settimeout(self.idle_s)
            with self._conn_lock:
                self._conns.add(conn)
                t = threading.Thread(target=self._serve_conn, args=(conn,),
                                     name="compressd-conn", daemon=True)
                self._conn_threads.append(t)
            t.start()

    # ------------------------------------------------------------ admission
    def _admit(self, payload_len: int, deadline: float | None = None) -> None:
        """Reserve ``payload_len`` in-flight bytes, queueing up to the
        depth cap. Raises the typed rejection errors; on return the bytes
        are reserved and MUST be released via :meth:`_release`.
        ``deadline`` (``time.monotonic()`` instant) bounds the queue wait:
        a request cannot burn its whole budget waiting for admission."""
        if self._draining.is_set():
            with self._tlock:
                self._rejected_overload += 1
            raise ServiceOverloadedError(
                "server is draining: finishing in-flight requests, not "
                "accepting new work")
        if payload_len > self.max_request_bytes:
            with self._tlock:
                self._rejected_oversize += 1
            raise RequestTooLargeError(
                f"request payload {payload_len} B exceeds max_request_bytes="
                f"{self.max_request_bytes}")
        with self._cv:
            if self._inflight_bytes + payload_len > self.max_inflight_bytes:
                if self._queued >= self.queue_depth:
                    with self._tlock:
                        self._rejected_overload += 1
                    raise ServiceOverloadedError(
                        f"admission queue full ({self._queued} waiting, depth cap "
                        f"{self.queue_depth}, {self._inflight_bytes} B in flight)")
                self._queued += 1
                try:
                    while self._inflight_bytes + payload_len > self.max_inflight_bytes:
                        if self._closing.is_set() or self._draining.is_set():
                            raise ServiceError("server shutting down")
                        if deadline is not None and time.monotonic() >= deadline:
                            with self._tlock:
                                self._deadline_exceeded += 1
                            raise DeadlineExceededError(
                                f"request deadline ({self.deadline_ms:g} ms) expired "
                                f"while queued for admission")
                        self._cv.wait(0.05)
                finally:
                    self._queued -= 1
            self._inflight_bytes += payload_len

    def _release(self, payload_len: int) -> None:
        with self._cv:
            self._inflight_bytes -= payload_len
            self._cv.notify_all()

    # ----------------------------------------------------------- connection
    def _serve_conn(self, sock: socket.socket) -> None:
        try:
            while not self._closing.is_set():
                try:
                    header, plen = _read_prefix(sock)
                except socket.timeout:
                    with self._tlock:
                        self._idle_reaped += 1
                    break  # idle connection reaped
                except (ConnectionError, OSError):
                    break
                except ServiceProtocolError as e:
                    self._send_error(sock, e)
                    break  # framing is lost; the connection cannot recover
                op = str(header.get("op", ""))
                if plen == 0 and op in _CONTROL_OPS:
                    # control ops bypass admission and the pool: they must
                    # stay responsive exactly when the daemon is saturated
                    self._respond(sock, *self._handle_control(op))
                    if op == "shutdown" and self.allow_shutdown:
                        self.close()
                        break
                    continue
                deadline = (time.monotonic() + self.deadline_ms / 1e3
                            if self.deadline_ms > 0 else None)
                try:
                    self._admit(plen, deadline)
                except ServiceError as e:
                    try:
                        _drain(sock, plen)
                        self._send_error(sock, e)
                        continue
                    except (ConnectionError, OSError):
                        break
                # bytes are reserved from here; released once the response
                # is sent, or by the done-callback when a deadline strands
                # the worker (releasing early would lie to admission control —
                # the straggler still holds memory until it finishes — and
                # would let a drain close the connection before the response
                # of a request it waited for goes out)
                released = False
                try:
                    with span("compressd.recv"):
                        payload = _recv_buffer(sock, plen)
                    fut = self._pool.submit(self._handle, header, payload)
                    try:
                        budget = (None if deadline is None
                                  else max(0.0, deadline - time.monotonic()))
                        rh, rp = fut.result(timeout=budget)
                    except FutureTimeoutError:
                        fut.cancel()  # still queued -> never runs
                        fut.add_done_callback(
                            lambda f, n=plen: self._reap_stranded(f, n))
                        released = True
                        with self._tlock:
                            self._deadline_exceeded += 1
                        e = DeadlineExceededError(
                            f"request exceeded its {self.deadline_ms:g} ms deadline "
                            f"(op {op!r}, {plen} B payload)")
                        rh, rp = self._error_response(e), b""
                    except Exception as e:  # a typed error response, never a retry elsewhere
                        rh, rp = self._error_response(e), b""
                    with span("compressd.send"):
                        sent = self._respond(sock, rh, rp)
                finally:
                    if not released:
                        self._release(plen)
                if not sent:
                    break
        finally:
            with self._conn_lock:
                self._conns.discard(sock)
            try:
                sock.close()
            except OSError:
                pass

    def _reap_stranded(self, fut, payload_len: int) -> None:
        """Done-callback for a worker that outlived its request's deadline:
        release the in-flight reservation now that the bytes are truly free,
        and swallow the orphaned result/exception (the error response was
        already sent)."""
        try:
            if not fut.cancelled():
                fut.exception()
        finally:
            self._release(payload_len)

    def _respond(self, sock, header: dict, payload=b"") -> bool:
        try:
            _send_frame(sock, header, payload)
            return True
        except (ConnectionError, OSError):
            return False

    def _error_response(self, e: Exception) -> dict:
        with self._tlock:
            self._errors += 1
        return {"ok": False, "error": type(e).__name__, "message": str(e)}

    def _send_error(self, sock, e: Exception) -> bool:
        return self._respond(sock, self._error_response(e), b"")

    # ------------------------------------------------------------- handlers
    def _compressor(self, spec_req) -> Compressor:
        """Resolve a request's ``spec`` field to a (cached) Compressor.

        The canonical wire form is the spec *string* (the
        ``CompressorSpec.from_string`` grammar) — one opaque value, parsed
        and validated in one place. The legacy dict-of-kwargs form still
        works (key-whitelisted) so old clients keep running; the client
        side deprecates it."""
        if isinstance(spec_req, str):
            try:
                spec = CompressorSpec.from_string(spec_req)
            except SpecError as e:
                raise ServiceProtocolError(f"bad spec string: {e}") from e
            key = ("spec", spec_req)
        else:
            kw = {}
            for k, v in (spec_req or {}).items():
                if k not in _SPEC_KEYS:
                    raise ServiceProtocolError(
                        f"unknown spec field {k!r}; allowed: {', '.join(sorted(_SPEC_KEYS))}")
                kw[k] = tuple(v) if isinstance(v, list) else v
            # bad field values raise as CompressorSpec raises them (ValueError on the wire)
            spec = CompressorSpec(**kw)
            key = tuple(sorted(kw.items()))
        with self._comp_lock:
            comp = self._comps.get(key)
            if comp is None:
                comp = Compressor(spec, device=self.device, plan_cache=self.plan_cache)
                self._comps[key] = comp
        return comp

    def _stream(self, name: str) -> dict:
        rec = self._streams.get(name)
        if rec is None:
            rec = self._streams[name] = {
                "requests": 0, "errors": 0, "raw_bytes": 0, "comp_bytes": 0,
                "seconds": 0.0, "plan_cache_hits": 0, "plan_cache_misses": 0,
            }
        return rec

    def _handle(self, header: dict, payload: bytearray) -> tuple[dict, object]:
        if self._cuda_stream is None:
            return self._dispatch(header, payload)
        with torch.cuda.device(self.device), torch.cuda.stream(self._cuda_stream):
            return self._dispatch(header, payload)

    def _dispatch(self, header: dict, payload: bytearray) -> tuple[dict, object]:
        op = str(header.get("op", ""))
        if op == "compress":
            return self._op_compress(header, payload)
        if op == "decompress":
            return self._op_decompress(header, payload)
        if op == "sleep":  # diagnostic: hold the in-flight budget, do nothing
            time.sleep(min(float(header.get("seconds", 0.0)), 30.0))
            return {"ok": True, "held_bytes": len(payload)}, b""
        raise ServiceProtocolError(f"unknown op {op!r}")

    def _handle_control(self, op: str) -> tuple[dict, bytes]:
        if op == "ping":
            return {"ok": True, "pong": True}, b""
        if op == "health":
            with self._cv:
                inflight, queued = self._inflight_bytes, self._queued
            return {
                "ok": True,
                "healthy": not self._closing.is_set(),
                "draining": self._draining.is_set(),
                "inflight_bytes": inflight,
                "queued": queued,
                "deadline_ms": self.deadline_ms,
                "uptime_s": time.time() - self._t0,
            }, b""
        if op == "shutdown":
            if not self.allow_shutdown:
                return self._error_response(ServiceError("remote shutdown disabled")), b""
            return {"ok": True, "shutting_down": True}, b""
        return {"ok": True, **self.stats()}, b""

    def _count_error(self, stream: str) -> None:
        with self._tlock:
            self._stream(stream)["errors"] += 1

    def _op_compress(self, header: dict, payload: bytearray) -> tuple[dict, bytes]:
        stream = str(header.get("stream", "default"))
        try:
            shape = tuple(int(s) for s in header["shape"])
            dtype = np.dtype(str(header.get("dtype", "float32")))
        except (KeyError, TypeError) as e:
            raise ServiceProtocolError(f"compress needs shape/dtype: {e!r}") from e
        n = int(np.prod(shape, dtype=np.int64)) if shape else 1
        if n * dtype.itemsize != len(payload):
            raise ServiceProtocolError(
                f"payload is {len(payload)} B but shape {shape} dtype {dtype} "
                f"needs {n * dtype.itemsize} B")
        arr = np.frombuffer(payload, dtype=dtype).reshape(shape)  # the buffer is writable: no copy, no warning
        comp = self._compressor(header.get("spec") or {})
        t0 = time.perf_counter()
        try:
            with span("compressd.compress"):
                buf = comp.compress(torch.from_numpy(arr).to(self.device))
        except Exception:
            self._count_error(stream)
            raise
        dt = time.perf_counter() - t0
        tel = comp.last_telemetry or {}
        cache_state = tel.get("plan_cache")
        with self._tlock:
            rec = self._stream(stream)
            rec["requests"] += 1
            rec["raw_bytes"] += len(payload)
            rec["comp_bytes"] += len(buf)
            rec["seconds"] += dt
            if cache_state == "hit":
                rec["plan_cache_hits"] += 1
            elif cache_state == "miss":
                rec["plan_cache_misses"] += 1
        info = {
            "ok": True, "cr": len(payload) / max(len(buf), 1), "seconds": dt,
            "mbps": len(payload) / dt / 1e6 if dt > 0 else 0.0,
            "plan_cache": cache_state, "pipeline": tel.get("pipeline"),
            "fallbacks": len(tel.get("fallbacks") or ()),
        }
        return info, buf

    def _op_decompress(self, header: dict, payload: bytearray) -> tuple[dict, memoryview]:
        stream = str(header.get("stream", "default"))
        comp = self._compressor(header.get("spec") or {})
        t0 = time.perf_counter()
        try:
            with span("compressd.decompress"):
                out = np.ascontiguousarray(comp.decompress(bytes(payload)))
        except Exception:
            self._count_error(stream)
            raise
        dt = time.perf_counter() - t0
        with self._tlock:
            rec = self._stream(stream)
            rec["requests"] += 1
            rec["raw_bytes"] += out.nbytes
            rec["comp_bytes"] += len(payload)
            rec["seconds"] += dt
        info = {"ok": True, "shape": list(out.shape), "dtype": str(out.dtype),
                "seconds": dt, "mbps": out.nbytes / dt / 1e6 if dt > 0 else 0.0}
        return info, memoryview(out.reshape(-1).view(np.uint8))

    # ------------------------------------------------------------ telemetry
    def stats(self) -> dict:
        with self._cv:
            queue = {
                "inflight_bytes": self._inflight_bytes,
                "queued": self._queued,
                "queue_depth": self.queue_depth,
                "max_inflight_bytes": self.max_inflight_bytes,
                "max_request_bytes": self.max_request_bytes,
            }
        with self._tlock:
            streams = {}
            totals = {"requests": 0, "errors": self._errors, "raw_bytes": 0,
                      "comp_bytes": 0, "seconds": 0.0}
            for name, rec in self._streams.items():
                view = dict(rec)
                view["cr"] = rec["raw_bytes"] / max(rec["comp_bytes"], 1)
                view["mbps"] = (rec["raw_bytes"] / rec["seconds"] / 1e6
                                if rec["seconds"] > 0 else 0.0)
                streams[name] = view
                for k in ("requests", "raw_bytes", "comp_bytes", "seconds"):
                    totals[k] += rec[k]
            queue["rejected_overload"] = self._rejected_overload
            queue["rejected_oversize"] = self._rejected_oversize
            queue["deadline_exceeded"] = self._deadline_exceeded
            queue["idle_reaped"] = self._idle_reaped
        return {
            "uptime_s": time.time() - self._t0,
            "workers": self.workers,
            "draining": self._draining.is_set(),
            "queue": queue,
            "plan_cache": self.plan_cache.stats(),
            "streams": streams,
            "totals": totals,
        }


# ------------------------------------------------------------------- client
class CompressdClient:
    """Blocking client for one daemon connection (of either package).

    Not thread-safe: one client per thread (connections are cheap; the
    daemon's concurrency comes from many connections). Errors reported by
    the daemon re-raise as the matching typed exception: a class of
    :mod:`repro_torch.core.errors`, ``KernelError``,
    ``torch.OutOfMemoryError``, a CUDA error, or a builtin, else
    :class:`ServiceError`. ``last_info`` keeps the most recent response
    header (CR, MB/s, plan-cache outcome) for observability.

    ``retries`` opts into bounded retry with exponential backoff on
    *transient* failures — load shed (``ServiceOverloadedError``) and
    broken connections (daemon restarting, drain-window races). Default
    0: callers that want to see backpressure see the raw typed errors.
    Deadline expiries, protocol and spec errors and device errors never
    retry.
    """

    def __init__(self, addr: str, *, timeout: float = 120.0, stream: str | None = None,
                 retries: int = 0, retry_backoff_s: float = 0.05):
        self.addr = addr
        self.timeout = timeout
        self.stream = stream
        self.retries = int(retries)
        self.retry_backoff_s = float(retry_backoff_s)
        self.last_info: dict | None = None
        self._sock: socket.socket | None = None

    # ------------------------------------------------------------ transport
    def _connect(self) -> socket.socket:
        if self._sock is None:
            family, sockaddr = parse_addr(self.addr)
            s = socket.socket(family, socket.SOCK_STREAM)
            s.settimeout(self.timeout)
            try:
                s.connect(sockaddr)
            except BaseException:
                s.close()
                raise
            if family == socket.AF_INET:
                s.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            self._sock = s
        return self._sock

    def request(self, header: dict, payload=b"") -> tuple[dict, bytes]:
        """One request/response exchange; raises the daemon's typed error.
        With ``retries > 0``, shed/connection failures re-send the request
        (it lives entirely in this frame, so a resend is safe) after
        exponential backoff; other errors raise immediately."""
        rh, rp = self._exchange(header, payload)
        return rh, bytes(rp)

    def _exchange(self, header: dict, payload=b"") -> tuple[dict, bytearray]:
        if self.retries <= 0:
            return self._request_once(header, payload)
        policy = RetryPolicy(
            attempts=self.retries + 1, base_delay=self.retry_backoff_s,
            retry_on=(ServiceOverloadedError, ConnectionError, OSError))
        return retry_call(lambda: self._request_once(header, payload), policy=policy)

    def _request_once(self, header: dict, payload=b"") -> tuple[dict, bytearray]:
        sock = self._connect()
        try:
            _send_frame(sock, header, payload)
            rh, plen = _read_prefix(sock)
            rp = _recv_buffer(sock, plen)
        except (ConnectionError, OSError, struct.error):
            self.close()  # framing is lost; force a reconnect next time
            raise
        self.last_info = rh
        if not rh.get("ok", False):
            raise self._to_exception(rh)
        return rh, rp

    @staticmethod
    def _to_exception(rh: dict) -> Exception:
        name = str(rh.get("error", "ServiceError"))
        msg = str(rh.get("message", "service error"))
        cls = getattr(_errors, name, None)
        if not (isinstance(cls, type) and issubclass(cls, BaseException)):
            cls = _DEVICE_ERRORS.get(name)
        if cls is not None:
            return cls(msg)
        builtin = {"ValueError": ValueError, "TypeError": TypeError, "KeyError": KeyError}
        return builtin.get(name, ServiceError)(f"{name}: {msg}" if name not in builtin else msg)

    def close(self) -> None:
        if self._sock is not None:
            try:
                self._sock.close()
            finally:
                self._sock = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    # ------------------------------------------------------------------ ops
    @staticmethod
    def _spec_header(spec, legacy: dict):
        """The wire ``spec`` value: canonical string from ``spec=``, or the
        legacy kwargs dict (deprecated) — never both."""
        if spec is not None and legacy:
            raise TypeError("pass spec=... or legacy spec kwargs, not both")
        if spec is not None:
            if isinstance(spec, CompressorSpec):
                return spec.to_string()
            CompressorSpec.from_string(spec)  # validate client-side: typed SpecError
            return str(spec)
        if legacy:
            warnings.warn(
                "per-field spec kwargs on CompressdClient are deprecated; pass "
                "spec=\"lossy,<eb_mode>,<eb>,...\" (CompressorSpec.from_string "
                "grammar) instead", DeprecationWarning, stacklevel=3)
            return {k: list(v) if isinstance(v, tuple) else v for k, v in legacy.items()}
        return None

    def _op_header(self, op: str, spec, stream, legacy: dict, **fields) -> dict:
        """A request header in the JAX client's key order (its bytes, too)."""
        header = {"op": op, **fields}
        wire_spec = self._spec_header(spec, legacy)
        if wire_spec is not None:
            header["spec"] = wire_spec
        if stream or self.stream:
            header["stream"] = stream or self.stream
        return header

    def compress(self, arr, *, spec=None, stream: str | None = None, **legacy) -> bytes:
        """Compress ``arr`` (a numpy array or a torch tensor; a card tensor
        is copied to the host once) on the daemon; returns the container
        bytes.

        ``spec`` is the canonical compression-spec string (the
        ``CompressorSpec.from_string`` grammar) or a ``CompressorSpec``;
        the response header lands on ``last_info``. Bare CompressorSpec
        kwargs (``eb=...``, ...) still work but are deprecated.
        """
        if isinstance(arr, torch.Tensor):
            arr = arr.detach().contiguous().cpu().numpy()
        arr = np.ascontiguousarray(arr)
        header = self._op_header("compress", spec, stream, legacy, shape=list(arr.shape), dtype=str(arr.dtype))
        _, payload = self._exchange(header, arr.reshape(-1).view(np.uint8))
        return bytes(payload)

    def decompress(self, buf, *, spec=None, stream: str | None = None, **legacy) -> np.ndarray:
        """Decode a container on the daemon; returns the field as a numpy array."""
        header = self._op_header("decompress", spec, stream, legacy)
        rh, payload = self._exchange(header, buf)
        return np.frombuffer(payload, dtype=np.dtype(str(rh["dtype"]))).reshape(tuple(rh["shape"]))

    def stats(self) -> dict:
        rh, _ = self.request({"op": "stats"})
        return rh

    def health(self) -> dict:
        rh, _ = self.request({"op": "health"})
        return rh

    def ping(self) -> bool:
        rh, _ = self.request({"op": "ping"})
        return bool(rh.get("pong"))

    def shutdown(self) -> None:
        self.request({"op": "shutdown"})
        self.close()


def wait_ready(addr: str, timeout: float = 30.0, interval: float = 0.1) -> None:
    """Block until a daemon at ``addr`` answers ping (subprocess startup)."""
    deadline = time.monotonic() + timeout
    last: Exception | None = None
    while time.monotonic() < deadline:
        try:
            with CompressdClient(addr, timeout=min(timeout, 5.0)) as c:
                if c.ping():
                    return
        except (ConnectionError, OSError, ServiceError) as e:
            last = e
        time.sleep(interval)
    raise TimeoutError(f"compressd at {addr} not ready after {timeout}s: {last!r}")


# ---------------------------------------------------------------------- CLI
def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="multi-tenant streaming compression daemon")
    ap.add_argument("--addr", default="127.0.0.1:0",
                    help="host:port (port 0 = ephemeral) or unix:/path")
    ap.add_argument("--workers", type=int, default=None,
                    help=f"worker pool width (default REPRO_COMPRESSD_WORKERS or {default_workers()})")
    ap.add_argument("--queue-depth", type=int, default=None,
                    help="max queued admissions before load shed")
    ap.add_argument("--max-request-mb", type=int, default=None,
                    help="per-request payload cap (MiB)")
    ap.add_argument("--max-inflight-mb", type=int, default=None,
                    help="total admitted payload bytes cap (MiB)")
    ap.add_argument("--plan-cache-entries", type=int, default=None,
                    help="LRU plan cache capacity (field signatures)")
    ap.add_argument("--no-remote-shutdown", action="store_true",
                    help="ignore shutdown requests from clients")
    ap.add_argument("--deadline-ms", type=float, default=None,
                    help="per-request deadline in ms (0 = none; "
                         "default REPRO_COMPRESSD_DEADLINE_MS)")
    ap.add_argument("--idle-s", type=float, default=None,
                    help="reap connections idle this long (0 = never; "
                         "default REPRO_COMPRESSD_IDLE_S or 300)")
    ap.add_argument("--drain-s", type=float, default=None,
                    help="SIGTERM drain budget for in-flight requests "
                         "(default REPRO_COMPRESSD_DRAIN_S or 30)")
    ap.add_argument("--device", default=None,
                    help="where requests run: cuda[:N] (default: the card) or cpu")
    args = ap.parse_args(argv)
    server = CompressdServer(
        args.addr,
        workers=args.workers,
        queue_depth=args.queue_depth,
        max_request_bytes=None if args.max_request_mb is None else args.max_request_mb << 20,
        max_inflight_bytes=None if args.max_inflight_mb is None else args.max_inflight_mb << 20,
        plan_cache_entries=args.plan_cache_entries,
        allow_shutdown=not args.no_remote_shutdown,
        deadline_ms=args.deadline_ms,
        idle_s=args.idle_s,
        drain_s=args.drain_s,
        device=args.device,
    )

    # SIGTERM (the supervisor's stop signal) drains instead of dying
    # mid-request: the handler fires in the main thread, which is blocked
    # inside serve_forever, so the drain runs on a helper thread and
    # serve_forever returns once the listener closes.
    def _on_sigterm(signum, frame):
        threading.Thread(target=server.drain, name="compressd-drain",
                         daemon=True).start()

    try:
        signal.signal(signal.SIGTERM, _on_sigterm)
    except ValueError:
        pass  # not the main thread (embedded use); drain() is still callable
    print(f"compressd listening on {server.address} "
          f"(workers={server.workers}, queue_depth={server.queue_depth}, "
          f"deadline_ms={server.deadline_ms:g}, device={server.device})", flush=True)
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        # second drain() call waits for an in-progress SIGTERM drain, then
        # no-ops; a plain Ctrl-C with nothing in flight closes immediately
        server.drain()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
