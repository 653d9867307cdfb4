"""repro_torch.launch.compressd: the daemon on the CPU, and CPD1 both ways.

The cases of ``tests/test_compressd.py`` (and ``test_nfsafe_compressd`` of
``tests/test_guarantees.py``) run against the port's daemon with
``device="cpu"``; then the two packages face each other: a port client
against a JAX daemon and a JAX client against a port daemon, equal frames,
equal error headers for the same bad requests, the same ``stats`` and
``health`` keys, containers that each package decodes within
``eb * range * (1 + 1e-4)``, and the default spec's container of the golden
field byte-equal across the daemons. A kernel or device error inside a
request reaches the client under its own class, once, with nothing run
again elsewhere.

Every socket, join, wait and subprocess here has a timeout of at most
``TIMEOUT`` seconds, every server closes in a ``with`` or ``finally``, the
drain and deadline tests synchronise on what ``health`` and ``stats``
report instead of on sleeps, and unix sockets live under a short temporary
directory (an AF_UNIX path stops at 107 bytes).
"""
import os
import pathlib
import shutil
import signal
import socket
import struct
import subprocess
import sys
import tempfile
import threading
import time
import warnings

import numpy as np
import pytest
import torch

import repro.launch.compressd as J
from repro.core import Compressor as JCompressor
from repro.core import CompressorSpec as JSpec
from repro.core import errors as jerrors
from repro_torch.core import Compressor, CompressorSpec, PlanCache, frames
from repro_torch.core.errors import (
    ContainerError,
    DeadlineExceededError,
    RequestTooLargeError,
    ServiceError,
    ServiceOverloadedError,
    ServiceProtocolError,
    SpecError,
    TruncatedContainerError,
)
from repro_torch.kernels.build import KernelError
from repro_torch.launch.compressd import (
    MAGIC,
    CompressdClient,
    CompressdServer,
    default_workers,
    pack_frame,
    parse_addr,
    read_frame,
    _send_frame,
    wait_ready,
)

ROOT = pathlib.Path(__file__).resolve().parent.parent
DATA = ROOT / "tests" / "data"
CPU = "cpu"
SLACK = 1e-4
TIMEOUT = 60  # seconds: the most any socket, join, wait or subprocess here may block


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


@pytest.fixture
def short_dir():
    """A temporary directory whose socket paths stay far below AF_UNIX's
    107 bytes: under the temporary directory when its path is short, else
    under /tmp."""
    base = tempfile.gettempdir()
    d = tempfile.mkdtemp(prefix="cpd", dir=base if len(base) <= 60 else "/tmp")
    try:
        yield d
    finally:
        shutil.rmtree(d, ignore_errors=True)


def _field(seed=0, n=24):
    g = np.linspace(0, 4 * np.pi, n)
    X, Y, Z = np.meshgrid(g, g, g, indexing="ij")
    rng = np.random.default_rng(seed)
    return (np.sin(X + seed) * np.cos(Y) * np.sin(Z)
            + 0.01 * rng.standard_normal(X.shape)).astype(np.float32)


def _within(x, y, eb_rel, slack=SLACK):
    return float(np.max(np.abs(x.astype(np.float64) - y))) <= eb_rel * float(x.max() - x.min()) * (1 + slack)


def _until(cond, what: str, timeout: float = TIMEOUT):
    """Poll ``cond()`` until it returns a true value; fail after ``timeout``."""
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        v = cond()
        if v:
            return v
        time.sleep(0.02)
    raise AssertionError(f"timed out waiting for {what}")


def _health(addr: str) -> dict:
    with CompressdClient(addr, timeout=TIMEOUT) as c:
        return c.health()


def _join(*threads):
    for t in threads:
        t.join(timeout=TIMEOUT)
        assert not t.is_alive(), f"thread {t.name} still running after {TIMEOUT} s"


def _start_cli(*args):
    """``python -m repro_torch.launch.compressd --device cpu ...``; returns the
    process and the address it printed (the process is killed if no address
    comes within TIMEOUT)."""
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([str(ROOT / "src")] + (
        [os.environ["PYTHONPATH"]] if os.environ.get("PYTHONPATH") else [])))
    proc = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.compressd", "--device", "cpu", *args],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env)
    watchdog = threading.Timer(TIMEOUT, proc.kill)
    watchdog.start()
    try:
        lines = []
        for line in proc.stdout:
            lines.append(line)
            if "compressd listening on " in line:
                return proc, line.split("compressd listening on ")[1].split()[0]
        raise AssertionError(f"the CLI printed no address: {''.join(lines)!r}")
    except BaseException:
        proc.kill()
        proc.wait(timeout=TIMEOUT)
        raise
    finally:
        watchdog.cancel()


def _stop(proc):
    if proc.poll() is None:
        proc.kill()
    proc.wait(timeout=TIMEOUT)
    proc.stdout.close()


@pytest.fixture(scope="module")
def server():
    with CompressdServer("127.0.0.1:0", workers=4, device=CPU).start() as srv:
        wait_ready(srv.address, timeout=10)
        yield srv


@pytest.fixture(scope="module")
def jax_server():
    with J.CompressdServer("127.0.0.1:0", workers=2).start() as srv:
        J.wait_ready(srv.address, timeout=10)
        yield srv


# ----------------------------------------------------------------- protocol
def test_parse_addr():
    assert parse_addr("127.0.0.1:7733") == (socket.AF_INET, ("127.0.0.1", 7733))
    assert parse_addr("unix:/tmp/x.sock") == (socket.AF_UNIX, "/tmp/x.sock")
    with pytest.raises(ValueError):
        parse_addr("7733")


def test_ping_and_stats_shape(server):
    with CompressdClient(server.address, timeout=TIMEOUT) as c:
        assert c.ping()
        st = c.stats()
    assert st["workers"] == 4
    assert {"inflight_bytes", "queued", "queue_depth", "rejected_overload",
            "rejected_oversize"} <= set(st["queue"])
    assert {"entries", "hits", "misses", "hit_rate"} <= set(st["plan_cache"])


def test_bad_magic_gets_protocol_error(server):
    family, sockaddr = parse_addr(server.address)
    with socket.socket(family, socket.SOCK_STREAM) as s:
        s.settimeout(TIMEOUT)
        s.connect(sockaddr)
        s.sendall(b"NOPE" + b"\x00" * 12)
        rh, _ = read_frame(s)
    assert rh["ok"] is False and rh["error"] == "ServiceProtocolError"


def test_unknown_op_and_bad_shape(server):
    with CompressdClient(server.address, timeout=TIMEOUT) as c:
        with pytest.raises(ServiceProtocolError):
            c.request({"op": "frobnicate"}, b"x")
        # connection survives a typed rejection
        with pytest.raises(ServiceProtocolError):
            c.request({"op": "compress", "shape": [10, 10], "dtype": "float32"},
                      b"\x00" * 12)  # 12 B != 400 B
        assert c.ping()


def test_unknown_spec_field_rejected(server):
    with CompressdClient(server.address, timeout=TIMEOUT) as c:
        with pytest.raises(ServiceProtocolError, match="unknown spec field"):
            c.compress(_field(), ebb=1e-3)  # typo must not silently default
        with pytest.raises(ValueError):
            c.compress(_field(), eb=1e-3, pipeline="not-a-pipeline")
        assert c.ping()


# ------------------------------------------------------------ compress path
def test_roundtrip_and_plan_cache_hit(server):
    x = _field(3)
    with CompressdClient(server.address, stream="t-roundtrip", timeout=TIMEOUT) as c:
        buf = c.compress(x, eb=1e-3, predictor="auto", pipeline="auto")
        first = dict(c.last_info)
        c.compress(x, eb=1e-3, predictor="auto", pipeline="auto")
        second = dict(c.last_info)
        y = c.decompress(buf)
        st = c.stats()
    assert first["plan_cache"] == "miss" and second["plan_cache"] == "hit"
    assert second["pipeline"] == first["pipeline"]
    assert first["fallbacks"] == 0 and second["fallbacks"] == 0
    assert y.shape == x.shape and y.dtype == np.float32
    assert np.max(np.abs(x - y)) <= 1e-3 * (x.max() - x.min()) * (1 + 1e-5)
    rec = st["streams"]["t-roundtrip"]
    assert rec["requests"] == 3 and rec["plan_cache_hits"] >= 1
    assert rec["cr"] > 0 and rec["mbps"] > 0


def test_spec_variants_roundtrip(server):
    x = _field(4)
    with CompressdClient(server.address, timeout=TIMEOUT) as c:
        for spec in ({"eb": 1e-2}, {"eb": 1e-3, "eb_mode": "abs"},
                     {"eb": 1e-3, "pipeline": "tp", "autotune": False}):
            buf = c.compress(x, **spec)
            y = c.decompress(buf)
            assert y.shape == x.shape


def test_daemon_matches_local_compressor(server):
    """A daemon container is the in-process container: byte-equal, and the
    same decode."""
    x = _field(5)
    with CompressdClient(server.address, timeout=TIMEOUT) as c:
        buf = c.compress(x, eb=1e-3, pipeline="tp", autotune=False)
        default = c.compress(x)
    local = Compressor(CompressorSpec(eb=1e-3, pipeline="tp", autotune=False), device=CPU)
    assert buf == local.compress(x)
    assert np.array_equal(local.decompress(buf), local.decompress(local.compress(x)))
    assert default == Compressor(device=CPU).compress(x)


def test_tensor_payload_equals_numpy_payload(server):
    """The client takes a torch tensor as it takes a numpy array."""
    x = _field(6, n=16)
    with CompressdClient(server.address, timeout=TIMEOUT) as c:
        assert c.compress(torch.from_numpy(x), spec="lossy,rel,1e-3") == c.compress(x, spec="lossy,rel,1e-3")


# ---------------------------------------------------------------- concurrency
def test_concurrent_clients(server):
    """N clients hammer concurrently; every roundtrip lands within bound."""
    n_clients, per_client = 6, 3
    fields = [_field(seed, n=20) for seed in range(n_clients)]
    errors = []

    def run(k):
        try:
            with CompressdClient(server.address, stream=f"conc-{k}", timeout=TIMEOUT) as c:
                for _ in range(per_client):
                    buf = c.compress(fields[k], eb=1e-3)
                    y = c.decompress(buf)
                    assert np.max(np.abs(fields[k] - y)) <= \
                        1e-3 * (fields[k].max() - fields[k].min()) * (1 + 1e-5)
        except Exception as e:  # pragma: no cover - failure path
            errors.append((k, repr(e)))

    threads = [threading.Thread(target=run, args=(k,)) for k in range(n_clients)]
    for t in threads:
        t.start()
    _join(*threads)
    assert not errors, errors
    with CompressdClient(server.address, timeout=TIMEOUT) as c:
        st = c.stats()
    for k in range(n_clients):
        assert st["streams"][f"conc-{k}"]["requests"] == 2 * per_client
        assert st["streams"][f"conc-{k}"]["errors"] == 0


# ------------------------------------------------------------- backpressure
def test_backpressure_queue_then_shed():
    """In-flight byte budget: 1st holds it, 2nd queues, 3rd is shed."""
    with CompressdServer("127.0.0.1:0", workers=4, max_request_bytes=1 << 20,
                         max_inflight_bytes=1 << 20, queue_depth=1, device=CPU).start() as srv:
        hold = b"\x00" * (1 << 20)
        results = {}

        def sleeper(name, seconds):
            try:
                with CompressdClient(srv.address, timeout=TIMEOUT) as c:
                    rh, _ = c.request({"op": "sleep", "seconds": seconds}, hold)
                    results[name] = rh
            except ServiceError as e:
                results[name] = e

        t1 = threading.Thread(target=sleeper, args=("a", 1.0))
        t1.start()
        _until(lambda: _health(srv.address)["inflight_bytes"] == 1 << 20, "a to hold the whole budget")
        t2 = threading.Thread(target=sleeper, args=("b", 0.1))
        t2.start()
        _until(lambda: _health(srv.address)["queued"] == 1, "b to park in the admission queue")
        t3 = threading.Thread(target=sleeper, args=("c", 0.1))
        t3.start()
        _join(t3)
        assert isinstance(results["c"], ServiceOverloadedError)  # shed, typed
        _join(t1, t2)
        assert results["a"]["ok"] and results["b"]["ok"]  # queued b completed
        # a request's budget is released once its response is sent, so the
        # client may read the stats a moment before the release
        def released():
            st = srv.stats()
            return st if st["queue"]["inflight_bytes"] == 0 else None

        st = _until(released, "the budget to be fully released")
        assert st["queue"]["rejected_overload"] == 1
        assert st["queue"]["inflight_bytes"] == 0  # budget fully released


def test_oversized_request_rejected_and_connection_survives():
    with CompressdServer("127.0.0.1:0", workers=2, max_request_bytes=1 << 16, device=CPU).start() as srv:
        with CompressdClient(srv.address, timeout=TIMEOUT) as c:
            with pytest.raises(RequestTooLargeError):
                c.compress(np.zeros((256, 256), np.float32))  # 256 KiB > 64 KiB
            # payload was drained, not buffered: framing intact, daemon alive
            assert c.ping()
            small = np.zeros((64, 64), np.float32)
            assert isinstance(c.compress(small, eb=1e-3), bytes)
            assert srv.stats()["queue"]["rejected_oversize"] == 1


def test_compress_error_is_typed_and_worker_survives(server):
    with CompressdClient(server.address, timeout=TIMEOUT) as c:
        bad = np.full((20, 20, 20), np.nan, np.float32)
        y = c.decompress(c.compress(bad, eb=1e-3))  # the port keeps an all-NaN field bit for bit
        assert np.array_equal(y.view(np.uint32), bad.view(np.uint32))
        with pytest.raises(ContainerError):
            c.decompress(b"this is not a container")
        assert c.ping()  # the daemon always survives


@pytest.mark.parametrize("error", ["KernelError", "OutOfMemoryError", "AcceleratorError"])
def test_device_errors_reach_the_client_typed_once(monkeypatch, error):
    """No fallback: a kernel or device error inside a request comes back
    under its own class, the request ran once, and nothing reran it on
    another route."""
    cls = {"KernelError": KernelError, "OutOfMemoryError": torch.OutOfMemoryError,
           "AcceleratorError": getattr(torch, "AcceleratorError", None)}[error]
    if cls is None:
        pytest.skip("this torch has no AcceleratorError")
    calls = []

    def failing(self, x):
        calls.append(x.device)
        raise cls("injected device failure")

    monkeypatch.setattr(Compressor, "compress", failing)
    with CompressdServer("127.0.0.1:0", workers=2, device=CPU).start() as srv:
        with CompressdClient(srv.address, timeout=TIMEOUT, retries=3) as c:
            with pytest.raises(cls, match="injected device failure"):
                c.compress(_field(1, n=8))
            assert c.last_info["error"] == error and c.ping()
        st = srv.stats()
    assert calls == [torch.device(CPU)]
    assert st["streams"]["default"]["errors"] == 1 and st["streams"]["default"]["requests"] == 0


# --------------------------------------------------------- shared plan cache
def test_shared_cache_across_connections():
    cache = PlanCache(max_entries=8)
    with CompressdServer("127.0.0.1:0", workers=2, plan_cache=cache, device=CPU).start() as srv:
        x = _field(7)
        with CompressdClient(srv.address, timeout=TIMEOUT) as c1:
            c1.compress(x, eb=1e-3, predictor="auto", pipeline="auto")
            assert c1.last_info["plan_cache"] == "miss"
        with CompressdClient(srv.address, timeout=TIMEOUT) as c2:  # new connection, same cache
            c2.compress(x, eb=1e-3, predictor="auto", pipeline="auto")
            assert c2.last_info["plan_cache"] == "hit"
        assert cache.stats()["hits"] == 1


# -------------------------------------------------- telemetry thread-safety
def test_compressor_telemetry_is_per_thread():
    """One Compressor shared across threads must not cross-wire
    ``last_telemetry`` between concurrent calls (the daemon's worker pool
    shares per-spec instances)."""
    comp = Compressor(CompressorSpec(eb=1e-3, pipeline="tp", autotune=False), device=CPU)
    sizes = [16, 20, 24, 28]
    bufs = {n: comp.compress(_field(1, n=n)) for n in sizes}
    barrier = threading.Barrier(len(sizes))
    failures = []

    def run(n):
        try:
            for _ in range(5):
                barrier.wait(timeout=30)
                out = comp.decompress(bufs[n])
                tel = comp.last_telemetry
                # this thread's view must describe THIS call
                assert tel["decode"]["bytes"] == out.nbytes == n ** 3 * 4
        except Exception as e:  # pragma: no cover - failure path
            failures.append((n, repr(e)))

    threads = [threading.Thread(target=run, args=(n,)) for n in sizes]
    for t in threads:
        t.start()
    _join(*threads)
    assert not failures, failures


# ------------------------------------------------------------------ CLI/env
def test_env_knob_workers(monkeypatch):
    monkeypatch.setenv("REPRO_COMPRESSD_WORKERS", "7")
    assert default_workers() == 7
    monkeypatch.setenv("REPRO_COMPRESSD_WORKERS", "bogus")
    assert default_workers() == 4
    monkeypatch.delenv("REPRO_COMPRESSD_WORKERS")
    srv = CompressdServer("127.0.0.1:0", workers=3, queue_depth=5, device=CPU)
    try:
        assert srv.workers == 3 and srv.queue_depth == 5
    finally:
        srv.close()


def test_unix_socket_roundtrip(short_dir):
    addr = f"unix:{short_dir}/compressd.sock"
    with CompressdServer(addr, workers=2, device=CPU).start() as srv:
        assert srv.address == addr
        with CompressdClient(addr, timeout=TIMEOUT) as c:
            x = _field(8, n=16)
            y = c.decompress(c.compress(x, eb=1e-2))
            assert y.shape == x.shape
    assert not os.path.exists(f"{short_dir}/compressd.sock")  # unlinked on close


def test_cli_subprocess_serves_and_shuts_down():
    proc, addr = _start_cli("--addr", "127.0.0.1:0", "--workers", "2")
    try:
        wait_ready(addr, timeout=TIMEOUT)
        with CompressdClient(addr, timeout=TIMEOUT) as c:
            x = _field(9, n=16)
            y = c.decompress(c.compress(x, eb=1e-2))
            assert np.max(np.abs(x - y)) <= 1e-2 * (x.max() - x.min()) * (1 + 1e-5)
            c.shutdown()
        assert proc.wait(timeout=TIMEOUT) == 0
    finally:
        _stop(proc)


def test_frame_codec_symmetry():
    hdr = {"op": "ping", "n": 3}
    frame = pack_frame(hdr, b"payload")
    assert frame.startswith(MAGIC)
    # decode through a socketpair to exercise the exact recv path
    a, b = socket.socketpair()
    try:
        b.settimeout(TIMEOUT)
        a.sendall(frame)
        rh, rp = read_frame(b)
    finally:
        a.close()
        b.close()
    assert rh == hdr and rp == b"payload"
    (hlen,) = struct.unpack_from("<I", frame, 4)
    assert len(frame) == 4 + 4 + hlen + 8 + len(b"payload")


# ------------------------------------------------------- spec-string surface
def test_spec_string_roundtrip_no_warning(server):
    x = _field(9)
    with CompressdClient(server.address, stream="t-specstr", timeout=TIMEOUT) as c:
        with warnings.catch_warnings():
            warnings.simplefilter("error", DeprecationWarning)
            buf = c.compress(x, spec="lossy,abs,1e-3,autotune=false")
            y = c.decompress(buf)
        assert np.max(np.abs(x - y)) <= 1e-3 * (1 + 1e-4) + 1e-9
        # CompressorSpec objects are accepted and canonicalized client-side
        buf2 = c.compress(x, spec=CompressorSpec(eb=1e-3, eb_mode="abs", autotune=False))
        assert len(buf2) == len(buf)
        # bad grammar fails client-side with the typed error, nothing sent
        with pytest.raises(SpecError):
            c.compress(x, spec="lossy,abs,oops")


def test_legacy_spec_kwargs_deprecated_but_equivalent(server):
    x = _field(9)
    with CompressdClient(server.address, stream="t-legacy", timeout=TIMEOUT) as c:
        with pytest.warns(DeprecationWarning, match="deprecated"):
            legacy = c.compress(x, eb=1e-3, eb_mode="abs", autotune=False)
        modern = c.compress(x, spec="lossy,abs,1e-3,autotune=false")
        y = c.decompress(legacy)
        assert np.max(np.abs(x - y)) <= 1e-3 * (1 + 1e-4) + 1e-9
        assert len(legacy) == len(modern)  # same spec through either surface
        with pytest.raises(TypeError, match="not both"):
            c.compress(x, spec="lossy,abs,1e-3", eb=1e-3)


# ------------------------------------------------------------ survivability
def test_deadline_exceeded_typed_and_bytes_released():
    with CompressdServer("127.0.0.1:0", workers=1, deadline_ms=150, device=CPU).start() as srv:
        with CompressdClient(srv.address, timeout=TIMEOUT) as c:
            with pytest.raises(DeadlineExceededError):
                c.request({"op": "sleep", "seconds": 3.0}, b"x" * 256)
            # answered at the deadline: the stranded worker still holds its bytes
            assert c.stats()["queue"]["inflight_bytes"] == 256
            assert c.ping()  # connection framing survived
            # the stranded worker's reservation drains once the sleep ends
            _until(lambda: c.stats()["queue"]["inflight_bytes"] == 0, "the stranded worker to release its bytes")
            assert c.stats()["queue"]["deadline_exceeded"] >= 1


def test_deadline_off_by_default(server):
    assert server.deadline_ms == 0.0
    with CompressdClient(server.address, timeout=TIMEOUT) as c:
        rh, _ = c.request({"op": "sleep", "seconds": 0.2}, b"y" * 16)
        assert rh["ok"]


def test_health_op_bypasses_admission(server):
    with CompressdClient(server.address, timeout=TIMEOUT) as c:
        h = c.health()
        assert h["healthy"] and not h["draining"]
        assert "inflight_bytes" in h and "queued" in h


def test_drain_finishes_inflight_sheds_new():
    srv = CompressdServer("127.0.0.1:0", workers=2, drain_s=TIMEOUT, device=CPU).start()
    slow = CompressdClient(srv.address, timeout=TIMEOUT)
    probe = CompressdClient(srv.address, timeout=TIMEOUT)
    drainer = threading.Thread(target=srv.drain)
    try:
        probe.ping()  # connection established before the drain begins
        done = {}

        def run_slow():
            done["resp"] = slow.request({"op": "sleep", "seconds": 2.0}, b"z" * 64)

        t = threading.Thread(target=run_slow)
        t.start()
        _until(lambda: probe.health()["inflight_bytes"] == 64, "the slow request's admission")
        drainer.start()
        _until(lambda: probe.health()["draining"], "the drain to begin")
        # new work on a live connection is shed while draining...
        with pytest.raises(ServiceOverloadedError):
            probe.request({"op": "sleep", "seconds": 0.1}, b"w" * 16)
        # ...but health still answers, reporting the drain
        assert probe.health()["draining"]
        _join(t, drainer)
        # the in-flight request completed during the drain window
        assert done["resp"][0]["ok"]
        # and the daemon is fully closed: new connections are refused
        with pytest.raises((ConnectionError, OSError)):
            CompressdClient(srv.address, timeout=TIMEOUT).ping()
    finally:
        slow.close()
        probe.close()
        srv.close()


def test_drain_unlinks_unix_socket(short_dir):
    path = f"{short_dir}/drain.sock"
    srv = CompressdServer(f"unix:{path}", device=CPU).start()
    try:
        wait_ready(srv.address, timeout=10)
        srv.drain()
        assert not os.path.exists(path)
    finally:
        srv.close()


def test_sigterm_drains_under_load():
    """SIGTERM to the CLI daemon with a request in flight: the in-flight
    request completes and the process exits cleanly."""
    proc, addr = _start_cli("--addr", "127.0.0.1:0", "--workers", "2", "--drain-s", str(TIMEOUT))
    try:
        wait_ready(addr, timeout=TIMEOUT)
        inflight = {}

        def slow_request():
            with CompressdClient(addr, timeout=TIMEOUT) as c:
                rh, _ = c.request({"op": "sleep", "seconds": 1.5}, b"x" * 64)
                inflight["rh"] = rh

        t = threading.Thread(target=slow_request)
        t.start()
        _until(lambda: _health(addr)["inflight_bytes"] == 64, "the sleep to be admitted")
        proc.send_signal(signal.SIGTERM)
        _join(t)
        assert inflight["rh"]["ok"]  # in-flight work finished during the drain
        assert proc.wait(timeout=TIMEOUT) == 0
        with pytest.raises((ConnectionError, OSError)):
            CompressdClient(addr, timeout=TIMEOUT).ping()  # daemon is gone, not wedged
    finally:
        _stop(proc)


def test_stale_unix_socket_reclaimed(short_dir):
    path = f"{short_dir}/stale.sock"
    # a dead daemon's leftover: bound once, never unlinked
    leftover = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
    leftover.bind(path)
    leftover.close()
    assert os.path.exists(path)
    with CompressdServer(f"unix:{path}", device=CPU).start() as srv:
        wait_ready(srv.address, timeout=10)
        with CompressdClient(srv.address, timeout=TIMEOUT) as c:
            assert c.ping()


def test_live_unix_socket_not_hijacked(short_dir):
    path = f"{short_dir}/live.sock"
    with CompressdServer(f"unix:{path}", device=CPU).start() as srv:
        wait_ready(srv.address, timeout=10)
        with pytest.raises(OSError, match="live daemon"):
            CompressdServer(f"unix:{path}", device=CPU)
        with CompressdClient(srv.address, timeout=TIMEOUT) as c:
            assert c.ping()  # the incumbent is untouched


def test_idle_connection_reaped():
    with CompressdServer("127.0.0.1:0", idle_s=0.3, device=CPU).start() as srv:
        c = CompressdClient(srv.address, timeout=TIMEOUT)
        try:
            assert c.ping()
            _until(lambda: srv.stats()["queue"]["idle_reaped"] >= 1, "the idle connection to be reaped")
            with pytest.raises((ConnectionError, OSError)):
                c.ping()
        finally:
            c.close()
        with CompressdClient(srv.address, timeout=TIMEOUT) as c2:  # daemon itself is fine
            assert c2.stats()["queue"]["idle_reaped"] >= 1


def test_client_retry_rides_out_restart_window():
    """A client with retries enabled survives transient connection loss:
    first attempt hits a dead port, the daemon 'comes back' before the
    retry (simulated by binding the listener between attempts)."""
    srv = CompressdServer("127.0.0.1:0", device=CPU).start()
    addr = srv.address
    srv.close()  # daemon gone: first attempt gets ECONNREFUSED
    revived = {}

    def revive():
        time.sleep(0.3)
        host, port = addr.rsplit(":", 1)
        revived["srv"] = CompressdServer(f"{host}:{port}", device=CPU).start()

    reviver = threading.Thread(target=revive)
    reviver.start()
    try:
        c = CompressdClient(addr, retries=8, retry_backoff_s=0.2, timeout=TIMEOUT)
        assert c.ping()  # retried through the dead window
        c.close()
    finally:
        _join(reviver)
        revived["srv"].close()


def test_client_retry_default_off():
    srv = CompressdServer("127.0.0.1:0", workers=1, max_request_bytes=1 << 20,
                          max_inflight_bytes=1 << 20, queue_depth=0, device=CPU).start()
    with srv:
        blocker = CompressdClient(srv.address, timeout=TIMEOUT)
        t = threading.Thread(target=lambda: blocker.request(
            {"op": "sleep", "seconds": 1.0}, b"b" * (1 << 20)))
        t.start()
        try:
            _until(lambda: _health(srv.address)["inflight_bytes"] == 1 << 20, "the blocker's admission")
            with CompressdClient(srv.address, timeout=TIMEOUT) as c:  # retries=0: shed is surfaced raw
                with pytest.raises(ServiceOverloadedError):
                    c.request({"op": "sleep", "seconds": 0.1}, b"c" * (1 << 19))
        finally:
            _join(t)
            blocker.close()


def test_verify_spec_key_accepted(server):
    x = _field(3)
    with CompressdClient(server.address, timeout=TIMEOUT) as c:
        buf = c.compress(x, spec="lossy,rel,1e-3,verify=full")
        y = c.decompress(buf)
        rng = float(x.max() - x.min())
        assert float(np.max(np.abs(x - y))) <= 1e-3 * rng * (1 + 2e-4)


def test_nfsafe_compressd():
    """NaN and +-Inf restored bit for bit through the daemon, finite points
    within the bound (``tests/test_guarantees.py``'s entry path 4)."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal((24, 24, 24))
    for ax in range(3):
        x = np.cumsum(x, axis=ax)
    x = (x / max(1.0, float(np.max(np.abs(x))))).astype(np.float32)
    x[0, :2] = np.nan
    x[3, 4, 5] = np.inf
    x[-1, -1, -1] = -np.inf
    with CompressdServer("127.0.0.1:0", workers=2, device=CPU) as srv:
        srv.start()
        with CompressdClient(srv.address, timeout=TIMEOUT) as c:
            y = c.decompress(c.compress(x, spec="lossy,rel,1e-3,verify=sample"))
    fin = np.isfinite(x)
    assert np.array_equal(x[~fin].view(np.uint32), y[~fin].view(np.uint32))
    xf, yf = x[fin].astype(np.float64), y[fin].astype(np.float64)
    assert np.max(np.abs(xf - yf)) <= 1e-3 * (xf.max() - xf.min()) * (1 + 2e-4)


# -------------------------------------------------------- CPD1 both ways
FRAMES = [
    ({"op": "ping"}, b""),
    ({"op": "compress", "shape": [4, 5, 6], "dtype": "float32", "stream": "ckpt", "spec": "lossy,rel,0.001"},
     bytes(range(256)) * 3),
    ({"op": "compress", "shape": [8], "dtype": "float32", "spec": {"eb": 1e-3, "splines": ["cubic", "linear"],
                                                                   "autotune": False}}, b"\x01" * 32),
    ({"ok": False, "error": "ServiceProtocolError", "message": "unknown op 'x'"}, b""),
    ({"ok": True, "cr": 8.25, "seconds": 0.5, "plan_cache": None, "pipeline": "cr", "fallbacks": 0}, b"\xff" * 70000),
]


@pytest.mark.parametrize("header,payload", FRAMES, ids=lambda v: str(v)[:24])
def test_pack_frame_byte_equal_across_packages(header, payload):
    assert pack_frame(header, payload) == J.pack_frame(header, payload)
    a, b = socket.socketpair()
    sender = threading.Thread(target=_send_frame, args=(a, header, payload))
    try:
        b.settimeout(TIMEOUT)
        sender.start()
        rh, rp = J.read_frame(b)  # the port's sending path, read by the JAX package
        _join(sender)
    finally:
        a.close()
        b.close()
    assert rh == header and rp == payload


@pytest.fixture(scope="module")
def capped_pair():
    """A port daemon and a JAX daemon with the same 64 KiB request cap."""
    with CompressdServer("127.0.0.1:0", workers=2, max_request_bytes=1 << 16, device=CPU).start() as t, \
            J.CompressdServer("127.0.0.1:0", workers=2, max_request_bytes=1 << 16).start() as j:
        yield t, j


def _raw_exchange(addr: str, raw: bytes) -> dict:
    family, sockaddr = parse_addr(addr)
    with socket.socket(family, socket.SOCK_STREAM) as s:
        s.settimeout(TIMEOUT)
        s.connect(sockaddr)
        s.sendall(raw)
        rh, _ = read_frame(s)
    return rh


BAD_REQUESTS = {
    "bad_magic": b"NOPE" + b"\x00" * 12,
    "unknown_op": pack_frame({"op": "frobnicate"}, b"x"),
    "bad_shape": pack_frame({"op": "compress", "shape": [10, 10], "dtype": "float32"}, b"\x00" * 12),
    "unknown_spec_field": pack_frame({"op": "compress", "shape": [4, 4], "dtype": "float32",
                                      "spec": {"ebb": 1e-3}}, b"\x00" * 64),
    "oversize": pack_frame({"op": "compress", "shape": [256, 256], "dtype": "float32"}, b"\x00" * (1 << 18)),
    "unknown_spec_string": pack_frame({"op": "compress", "shape": [4, 4], "dtype": "float32",
                                       "spec": "lossy,abs,oops"}, b"\x00" * 64),
}


@pytest.mark.parametrize("case", sorted(BAD_REQUESTS))
def test_error_headers_equal_across_packages(capped_pair, case):
    t, j = capped_pair
    rt, rj = _raw_exchange(t.address, BAD_REQUESTS[case]), _raw_exchange(j.address, BAD_REQUESTS[case])
    assert rt["ok"] is False and rj["ok"] is False
    assert (rt["error"], rt["message"]) == (rj["error"], rj["message"])


def test_stats_and_health_key_sets_equal(server, jax_server):
    with CompressdClient(server.address, timeout=TIMEOUT) as c, J.CompressdClient(jax_server.address) as jc:
        c.ping()
        jc.ping()
        st, sj = c.stats(), jc.stats()
        ht, hj = c.health(), jc.health()
    assert set(st) == set(sj) and set(st["queue"]) == set(sj["queue"])
    assert set(st["plan_cache"]) == set(sj["plan_cache"]) and set(st["totals"]) == set(sj["totals"])
    assert set(ht) == set(hj)


@pytest.fixture
def fresh_pair():
    """A port daemon and a JAX daemon with empty plan caches (a plan-cache
    hit replays the plan of an earlier field in the same stats bucket)."""
    with CompressdServer("127.0.0.1:0", workers=2, device=CPU).start() as t, \
            J.CompressdServer("127.0.0.1:0", workers=2).start() as j:
        yield t, j


@pytest.mark.parametrize("spec", ["lossy,rel,0.001", "lossy,rel,0.001,predictor=auto,pipeline=auto",
                                  "lossy,abs,0.01,pipeline=tp", "lossy,rel,0.001,predictor=lorenzo"])
def test_containers_decode_both_ways_through_both_daemons(fresh_pair, registries_as_shipped, spec):
    """Port client -> JAX daemon and JAX client -> port daemon; each
    package's container decodes in the other package (daemon and
    in-process) within the bound; the port daemon's container is the
    port's in-process one."""
    server, jax_server = fresh_pair
    x = _field(11)
    sp = CompressorSpec.from_string(spec)
    eb_rel = sp.eb if sp.eb_mode == "rel" else sp.eb / float(x.max() - x.min())
    with CompressdClient(jax_server.address, timeout=TIMEOUT) as c, J.CompressdClient(server.address) as jc:
        from_jax = c.compress(x, spec=spec)          # port client, JAX daemon
        from_port = jc.compress(x, spec=spec)        # JAX client, port daemon
        assert jc.last_info["fallbacks"] == 0
        assert _within(x, c.decompress(from_jax), eb_rel)    # JAX daemon decodes its own
        assert _within(x, jc.decompress(from_port), eb_rel)  # port daemon decodes its own
        assert _within(x, c.decompress(from_port), eb_rel)   # JAX daemon decodes the port's
        assert _within(x, jc.decompress(from_jax), eb_rel)   # port daemon decodes JAX's
    assert from_port == Compressor(sp, device=CPU).compress(x)
    assert _within(x, JCompressor(JSpec.from_string(spec)).decompress(from_port), eb_rel)
    assert _within(x, Compressor(device=CPU).decompress(from_jax), eb_rel)


def test_golden_field_default_spec_byte_equal_across_daemons(server, jax_server):
    x = np.load(DATA / "golden_field.npy")
    with CompressdClient(jax_server.address, timeout=TIMEOUT) as c, J.CompressdClient(server.address) as jc:
        assert c.compress(x) == jc.compress(x)


def test_typed_errors_cross_the_packages(server, jax_server):
    """A daemon's error re-raises as the client package's class of the same
    name: the port's container errors (ContainerError subclasses, ValueErrors
    both) reach a JAX client as the JAX package's, the JAX daemon's reach a
    port client as what that daemon sent."""
    x = _field(12, n=16)
    v3 = frames.pack_frames({"kind": "chunks"}, [Compressor(device=CPU).compress(x)])
    torn = v3[: len(v3) - 20]
    with CompressdClient(jax_server.address, timeout=TIMEOUT) as c, J.CompressdClient(server.address) as jc, \
            CompressdClient(server.address, timeout=TIMEOUT) as tc:
        with pytest.raises(TruncatedContainerError):
            tc.decompress(torn)
        with pytest.raises(jerrors.TruncatedContainerError):
            jc.decompress(torn)
        with pytest.raises(jerrors.ContainerError):
            jc.decompress(b"this is not a container")
        with pytest.raises(ValueError, match="bad container magic"):
            c.decompress(b"this is not a container")
        with pytest.raises(ServiceProtocolError, match="unknown spec field"):
            c.compress(_field(), ebb=1e-3)


@pytest.mark.parametrize("kw", [{}, {"spec": "lossy,rel,0.001", "stream": "s"}, {"eb": 1e-3, "stream": "t"}])
def test_client_requests_are_the_jax_clients_bytes(kw):
    """Both clients put the same request frame on the wire."""
    x = _field(13, n=8)
    sent = {}
    for name, cls in (("port", CompressdClient), ("jax", J.CompressdClient)):
        a, b = socket.socketpair()
        try:
            a.settimeout(TIMEOUT)
            b.settimeout(TIMEOUT)
            client = cls("127.0.0.1:1")
            client._sock = a  # the client's end of a socketpair stands for its connection
            reply = threading.Thread(target=lambda: (sent.__setitem__(name, J.read_frame(b)),
                                                     b.sendall(pack_frame({"ok": True}, b"c"))))
            reply.start()
            with warnings.catch_warnings():
                warnings.simplefilter("ignore", DeprecationWarning)
                client.compress(x, **kw)
            _join(reply)
        finally:
            a.close()
            b.close()
    assert pack_frame(*sent["port"]) == pack_frame(*sent["jax"])
    assert list(sent["port"][0]) == list(sent["jax"][0])
