"""The port's plan cache against the JAX package's (``repro.core.plancache``,
``Compressor(plan_cache=...)``): the LRU counters move alike, a hit skips
the planner and the orchestrator and replays their outcome, one cache
serves many compressors, and the cache key is the JAX package's
``_plan_cache_key`` for the same field and spec."""
import pathlib

import numpy as np
import pytest
import torch

import repro.core as R
import repro_torch.core as T
import repro_torch.core.compressor as tcomp


@pytest.fixture(autouse=True)
def registries_as_shipped(monkeypatch):
    """Both packages' pipeline registries without the pipelines another test
    file registered into one of them and left there (tests/test_orchestrate.py
    registers a third-party pipeline in the JAX package's): pipeline="auto"
    weighs every registered pipeline, so a leftover would change one side's
    choice and the containers compared here."""
    from repro.core.lossless import pipelines as rpp
    from repro_torch.core.lossless import pipelines as tpp

    for name in set(rpp.PIPELINES) - set(tpp.PIPELINES):
        monkeypatch.delitem(rpp.PIPELINES, name)
    for name in set(tpp.PIPELINES) - set(rpp.PIPELINES):
        monkeypatch.delitem(tpp.PIPELINES, name)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread while this module runs: the suite runs in several
    worker processes at once, and torch's spinning thread pools in all of
    them oversubscribe the cores many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


GOLDEN = pathlib.Path(__file__).parent / "data" / "golden_field.npy"


def _field(seed: int = 0, shape=(24, 20, 18)) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return np.cumsum(rng.standard_normal(shape), axis=0).astype(np.float32)


@pytest.mark.parametrize("cls", [R.PlanCache, T.PlanCache], ids=["jax", "torch"])
def test_lru_counters(cls):
    c = cls(max_entries=2)
    assert c.get("a") is None
    c.put("a", 1)
    c.put("b", 2)
    assert c.get("a") == 1  # refreshes "a": "b" is now the oldest
    c.put("c", 3)
    assert "b" not in c and "a" in c and len(c) == 2 and c.keys() == ["a", "c"]
    assert c.peek("c") == 3 and c.stats() == {"entries": 2, "max_entries": 2, "hits": 1, "misses": 1,
                                              "evictions": 1, "hit_rate": 0.5}
    c.put("c", 4)
    assert c.peek("c") == 4 and c.evictions == 1
    c.clear()
    assert len(c) == 0
    with pytest.raises(ValueError):
        cls(max_entries=0)


def test_lru_counters_agree_on_one_sequence():
    rng = np.random.default_rng(1)
    r, t = R.PlanCache(max_entries=3), T.PlanCache(max_entries=3)
    for op, key in zip(rng.integers(0, 2, 200), rng.integers(0, 6, 200)):
        if op:
            assert r.get(int(key)) == t.get(int(key))
        else:
            r.put(int(key), int(key))
            t.put(int(key), int(key))
    assert r.stats() == t.stats() and r.keys() == t.keys()


SPECS = {
    "autoplan": dict(predictor="auto", pipeline="auto"),
    "auto": dict(pipeline="auto"),
    "interp-autotune": dict(),
    "strides": dict(predictor="auto", plan_anchor_strides=(8,), pipeline="cr"),
    "abs-candidates": dict(eb_mode="abs", eb=0.05, pipeline="auto", pipeline_candidates=("cr", "tp")),
    "psnr": dict(psnr_target=50.0, predictor="auto"),
}


@pytest.mark.parametrize("name", list(SPECS))
def test_cache_key_is_the_reference_key(name):
    x = _field()
    rkey = R.Compressor(R.CompressorSpec(**SPECS[name]), plan_cache=R.PlanCache())._plan_cache_key(x)
    tc = T.Compressor(T.CompressorSpec(**SPECS[name]), device="cpu", plan_cache=T.PlanCache())
    assert tc._plan_cache_key(torch.from_numpy(x)) == rkey
    big = np.random.default_rng(2).standard_normal((70, 40, 30)).astype(np.float32)  # > 65536 points: strided bucket
    assert tc._plan_cache_key(torch.from_numpy(big)) == R.Compressor(
        R.CompressorSpec(**SPECS[name]), plan_cache=R.PlanCache())._plan_cache_key(big)


def test_uncacheable_specs_have_no_key():
    x = torch.from_numpy(_field())
    assert T.Compressor(device="cpu")._plan_cache_key(x) is None  # no cache
    for spec in (dict(autotune=False), dict(predictor="lorenzo", pipeline="auto")):
        assert T.Compressor(T.CompressorSpec(**spec), device="cpu", plan_cache=T.PlanCache())._plan_cache_key(x) is None


@pytest.fixture
def counting_planner(monkeypatch):
    calls = {"plan": 0, "autotune": 0, "orchestrate": 0}

    def wrap(name, fn):
        def counted(*a, **k):
            calls[name] += 1
            return fn(*a, **k)
        return counted

    monkeypatch.setattr(tcomp, "autotune_plan", wrap("plan", tcomp.autotune_plan))
    monkeypatch.setattr(tcomp, "autotune", wrap("autotune", tcomp.autotune))
    monkeypatch.setattr(tcomp.orchestrate, "encode_auto", wrap("orchestrate", tcomp.orchestrate.encode_auto))
    return calls


def test_hit_skips_the_tuners_and_replays_them(counting_planner):
    x = np.load(GOLDEN)  # every code agrees with the reference: the containers are byte-equal
    cache = T.PlanCache()
    tc = T.Compressor(T.CompressorSpec(**SPECS["autoplan"]), device="cpu", plan_cache=cache)
    first = tc.compress(x)
    plan = tc.last_plan
    assert tc.last_telemetry["plan_cache"] == "miss" and counting_planner == {"plan": 1, "autotune": 0,
                                                                            "orchestrate": 1}
    second = tc.compress(x)
    assert tc.last_telemetry["plan_cache"] == "hit" and counting_planner["plan"] == 1
    assert counting_planner["orchestrate"] == 1
    assert tc.last_plan.to_header() == plan.to_header()
    hdr1, hdr2 = T.Compressor.inspect(first), T.Compressor.inspect(second)
    assert hdr2["pcached"] is True and "pchoice" not in hdr2 and hdr2["pipeline"] == hdr1["pipeline"]
    assert (hdr2["splines"], hdr2["schemes"], hdr2["anchor_stride"]) == (hdr1["splines"], hdr1["schemes"],
                                                                        hdr1["anchor_stride"])
    assert cache.stats()["hits"] == 1 and cache.stats()["misses"] == 1
    # the reference writes the same replayed container
    rcache = R.PlanCache()
    rc = R.Compressor(R.CompressorSpec(**SPECS["autoplan"]), plan_cache=rcache)
    assert rc.compress(x) == first and rc.compress(x) == second
    y = R.Compressor().decompress(second)
    assert float(np.abs(y - x).max()) <= hdr2["eb_abs"] * (1 + 1e-4)


def test_hit_skips_the_legacy_autotune(counting_planner):
    x = _field(4)
    tc = T.Compressor(device="cpu", plan_cache=T.PlanCache())
    a, b = tc.compress(x), tc.compress(x)
    assert counting_planner["autotune"] == 1 and a == b


def test_one_cache_serves_many_compressors(counting_planner):
    x = _field(5)
    cache = T.PlanCache()
    for _ in range(3):
        T.Compressor(T.CompressorSpec(**SPECS["autoplan"]), device="cpu", plan_cache=cache).compress(x)
    assert counting_planner["plan"] == 1 and cache.stats()["hits"] == 2 and len(cache) == 1
    # another spec or another field is another entry
    T.Compressor(T.CompressorSpec(**SPECS["auto"]), device="cpu", plan_cache=cache).compress(x)
    T.Compressor(T.CompressorSpec(**SPECS["autoplan"]), device="cpu", plan_cache=cache).compress(_field(6) * 1e3)
    assert len(cache) == 3 and counting_planner["plan"] == 2


def test_eviction_retunes(counting_planner):
    cache = T.PlanCache(max_entries=1)
    comp = T.Compressor(T.CompressorSpec(**SPECS["autoplan"]), device="cpu", plan_cache=cache)
    comp.compress(_field(7))
    comp.compress(_field(8) * 1e3)
    comp.compress(_field(7))
    assert counting_planner["plan"] == 3 and cache.evictions == 2


def test_no_cache_means_no_telemetry_key():
    tc = T.Compressor(T.CompressorSpec(**SPECS["autoplan"]), device="cpu")
    tc.compress(_field(9))
    assert "plan_cache" not in tc.last_telemetry
