"""One Compressor shared by several threads: each thread keeps its own call
records (``last_plan``, ``last_telemetry``, ``last_damage`` and the hold
flag), and a shared plan cache stores each field's own plan, as in the JAX
package (``repro.core.compressor._PerCallState``). Also: the kernels'
launch counts stay exact under threads."""
import sys
import threading

import numpy as np
import pytest
import torch

from repro_torch.core import Compressor, CompressorSpec, PlanCache
from repro_torch.kernels import build, launch_counts, reset_launch_counts
from repro_torch.kernels.histogram import ops as hist_ops

SIDE = 24


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread while this module runs (the suite runs in several
    worker processes at once)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _nyx_like(side: int, seed: int = 0) -> np.ndarray:
    """The 'nyx' recipe of the synthetic datasets: exp(2 f), f a |k|^-2
    spectral field normalized to [-1, 1]."""
    shape = (side,) * 3
    white = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    ks = np.meshgrid(*[np.fft.fftfreq(n) for n in shape[:-1]] + [np.fft.rfftfreq(shape[-1])], indexing="ij")
    filt = (sum(k**2 for k in ks) + 1e-6) ** -1.0
    filt.flat[0] = 0.0
    f = np.fft.irfftn(np.fft.rfftn(white) * filt, s=shape, axes=(0, 1, 2)).astype(np.float32)
    return np.exp(2.0 * f / np.abs(f).max()).astype(np.float32)


def _ramp(side: int) -> np.ndarray:
    g = np.arange(side, dtype=np.float32)
    return (g[:, None, None] + 2 * g[None, :, None] + 3 * g[None, None, :]).astype(np.float32)


FIELDS = {"nyx": _nyx_like(SIDE), "ramp": _ramp(SIDE)}
SPEC = CompressorSpec(predictor="auto")


def _alone(x, device):
    """(plan, cache key, cache entry, container) of a single-threaded compress."""
    cache = PlanCache()
    comp = Compressor(SPEC, device=device, plan_cache=cache)
    buf = comp.compress(x)
    (key,) = cache.keys()
    return comp.last_plan, key, cache.peek(key), buf


def shared_compressor_keeps_each_threads_plan(device, monkeypatch):
    """Two threads share one Compressor and PlanCache on ``device``; both
    tune before either caches its plan (a barrier in ``_tune_interp``). Each
    thread's last_plan, each cache entry and each container equal a
    single-threaded run's. (Fails where the records are per instance.)"""
    alone = {name: _alone(x, device) for name, x in FIELDS.items()}
    assert alone["nyx"][0] != alone["ramp"][0], "the two fields must tune to different plans"
    cache = PlanCache()
    comp = Compressor(SPEC, device=device, plan_cache=cache)
    barrier = threading.Barrier(len(FIELDS), timeout=120)
    tune = Compressor._tune_interp

    def tune_then_wait(self, *args, **kwargs):
        out = tune(self, *args, **kwargs)
        barrier.wait()  # every thread has tuned before any caches its plan
        return out

    monkeypatch.setattr(Compressor, "_tune_interp", tune_then_wait)
    got, errors = {}, []

    def run(name):
        try:
            buf = comp.compress(FIELDS[name])
            got[name] = (comp.last_plan, buf, comp.last_telemetry)
        except Exception as e:  # reported below, after the join
            errors.append(e)
            barrier.abort()

    threads = [threading.Thread(target=run, args=(name,)) for name in FIELDS]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    assert not any(t.is_alive() for t in threads) and not errors, errors
    for name, (plan, key, entry, buf) in alone.items():
        assert got[name][0] == plan, f"{name}: the thread's last_plan is another thread's"
        assert cache.peek(key) == entry, f"{name}: the shared cache holds another field's plan"
        assert got[name][1] == buf
        assert got[name][2]["plan_cache"] == "miss"
    assert cache.misses == 2 and len(cache) == 2


def test_threads_sharing_a_compressor_and_plan_cache_keep_their_own_plans(monkeypatch):
    shared_compressor_keeps_each_threads_plan("cpu", monkeypatch)


def test_call_records_and_hold_are_per_thread():
    comp = Compressor(device="cpu")
    x = _ramp(8)
    buf = comp.compress(x)
    comp._telemetry_hold = True
    comp.last_damage = {"report": None}
    seen = {}

    def other():
        seen["hold"] = comp._telemetry_hold
        seen["damage"] = comp.last_damage
        seen["telemetry"] = comp.last_telemetry
        comp.decompress(buf)
        seen["decode"] = "decode" in comp.last_telemetry

    t = threading.Thread(target=other)
    t.start()
    t.join(timeout=60)
    assert not t.is_alive()
    assert seen == {"hold": False, "damage": None, "telemetry": None, "decode": True}
    assert comp._telemetry_hold and comp.last_damage == {"report": None}
    assert "decode" not in comp.last_telemetry  # the other thread's decode is not this thread's


def test_a_held_compress_adds_to_the_callers_telemetry():
    comp = Compressor(device="cpu")
    comp.compress(_ramp(8))
    comp.last_telemetry["mark"] = 1
    comp._telemetry_hold = True
    try:
        comp.compress(_ramp(9))
    finally:
        comp._telemetry_hold = False
    assert comp.last_telemetry["mark"] == 1
    comp.compress(_ramp(9))
    assert "mark" not in comp.last_telemetry


def test_record_fallback_has_the_reference_shape():
    comp = Compressor(device="cpu")
    comp._record_fallback("decode", "device", "numpy", ValueError("x"))
    assert comp.last_telemetry["fallbacks"] == [{"point": "decode", "from": "device", "to": "numpy",
                                                "error": "ValueError('x')"}]


def test_launch_counts_stay_exact_under_threads():
    """Eight threads add to one count with a tiny switch interval; a lost
    read-modify-write would show as a short total."""
    reset_launch_counts()
    n_threads, per_thread = 8, 2000
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def bump():
            for _ in range(per_thread):
                build.count_launch(hist_ops.LAUNCHES, "histogram256")

        threads = [threading.Thread(target=bump) for _ in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    assert launch_counts()["histogram256"] == n_threads * per_thread
    reset_launch_counts()
