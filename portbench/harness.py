"""One run of one cell: set-up, a measured window, the reference's verdict, one result line.

The harness is driven by files that it finds by name:

- ``workloads/<cell>.json``: the cell's configuration and its traffic mix;
- ``configs/<config>.json``: the fields (shape, count, recipe), the
  compressor's spec and the guarantee the reference holds it to;
- ``traffic/<mix>.json``: the mix, read by :mod:`portbench.traffic`;
- ``metrics/<metric>.py``: one reader per metric that ``BENCHMARK.json``
  lists for the cell (``--trace 0``: the end-to-end metrics; ``--trace 1``:
  the per-layer ones). A reader that finds nothing to read returns None and
  the metric is left out of the line.

A run makes the cell's resident fields on the device, builds the program
and the set-up its traffic needs, warms every shape up, then runs the
closed loop for the window. Each timed call sits in a ``bench.<op>`` span;
a compress ends when its bytes are on the host, a decompress in a device
synchronisation. Between calls, outside the timed walls and the calls'
memory peaks, the reference judges what came back: each container's
structure, and every point of each decoded field against its input. Once
the window has closed, the same program compresses and decodes the seed's
snapshot (:mod:`portbench.fields`), new fields in every run, and the
reference judges those requests the same way.

The process computes on the host with one thread (``HOST_THREADS``): the
compressor's host side runs eager torch ops on small tensors, and the
intra-op pool's threads only contend with the thread that feeds the card.
"""
from __future__ import annotations

import dataclasses
import importlib.util
import json
import math
import os
import pathlib
import subprocess
import sys
import time
import traceback

BENCH_DIR = pathlib.Path(__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
HOST_THREADS = 1
NAME_CHARS = set("abcdefghijklmnopqrstuvwxyzABCDEFGHIJKLMNOPQRSTUVWXYZ0123456789_.-")


def log(*parts) -> None:
    print(*parts, file=sys.stderr, flush=True)


def _safe(name: str) -> str:
    if not name or not set(name) <= NAME_CHARS or name.startswith("."):
        raise ValueError(f"not a benchmark name: {name!r}")
    return name


def read_json(path: pathlib.Path) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark(bench_dir: pathlib.Path = BENCH_DIR) -> dict:
    return read_json(bench_dir.parent / "BENCHMARK.json")


def load_cell(name: str, bench_dir: pathlib.Path = BENCH_DIR) -> dict:
    """The cell's configuration and its mix, found by the names in the cell's own file."""
    cell = read_json(bench_dir / "workloads" / f"{_safe(name)}.json")
    config = read_json(bench_dir / "configs" / f"{_safe(cell['config'])}.json")
    mix = read_json(bench_dir / "traffic" / f"{_safe(cell['traffic'])}.json")
    return {"config": config, "mix": mix}


def metric_module(name: str, bench_dir: pathlib.Path = BENCH_DIR):
    """The reader of metric ``name``, ``metrics/<name>.py``."""
    path = bench_dir / "metrics" / f"{_safe(name)}.py"
    spec = importlib.util.spec_from_file_location(f"portbench_metric_{name.replace('.', '_').replace('-', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def metric_names(bench: dict, cell: str, trace: bool) -> list[str]:
    """The metrics ``BENCHMARK.json`` has the cell report in this mode."""
    rows = bench["per_layer"] if trace else bench["end_to_end"]
    return [m["name"] for m in rows if "workloads" not in m or cell in m["workloads"]]


@dataclasses.dataclass
class Call:
    op: str
    field: int
    points: int
    wall_s: float = 0.0
    peak_bytes: int | None = None
    container_bytes: int = 0
    hf: tuple = (0, 0)         # the container's hf stage: symbols in, payload bytes out
    repairs: int = 0           # re-encodes the compress made after its verify
    error: str | None = None   # the call raised
    diff: float | None = None  # decompress: max |y - x| over every point
    container_ok: bool | None = None


@dataclasses.dataclass
class Run:
    """What the metric readers read."""
    config: dict
    calls: list
    setup_s: float
    counters: dict
    device: dict
    trace: object = None
    power_limit: str = "not read"
    notes: list = dataclasses.field(default_factory=list)

    def of(self, op: str) -> list:
        return [c for c in self.calls if c.op == op and c.error is None]

    def note(self, text: str) -> None:
        self.notes.append(text)


class Timer:
    """Times one call of the program in its ``bench.<op>`` span, with the
    device's memory peak of that call alone."""

    def __init__(self, device):
        import torch

        self.torch, self.device, self.cuda = torch, device, device.type == "cuda"

    def __call__(self, call: Call, fn, *args):
        torch = self.torch
        if self.cuda:
            torch.cuda.reset_peak_memory_stats(self.device)
        out = None
        t0 = time.perf_counter()
        try:
            with torch.profiler.record_function(f"bench.{call.op}"):
                out = fn(*args)
                if call.op == "decompress" and self.cuda:
                    torch.cuda.synchronize(self.device)
        except Exception as e:  # an answer that never came: counted, judged, and the loop goes on
            call.error = f"{type(e).__name__}: {e}"
            log(f"{call.op} of field {call.field} raised:\n{traceback.format_exc(limit=6)}")
        call.wall_s = time.perf_counter() - t0
        if self.cuda:
            torch.cuda.synchronize(self.device)  # a compress's trailing device work stays on its side
            call.peak_bytes = int(torch.cuda.max_memory_allocated(self.device))
        return out


def judge_container(call: Call, buf, shape) -> None:
    from . import container

    call.container_bytes = len(buf) if isinstance(buf, (bytes, bytearray)) else 0
    try:
        header, _ = container.parse(buf)
        call.container_ok = list(header.get("shape", ())) == list(shape)
        call.hf = container.hf_bytes(buf)
    except (container.ContainerFault, TypeError):
        call.container_ok = False


# each number of a request's verdict, and the check that holds it to its limit
VERDICT_CHECKS = {"err_over_eb": "max_err_over_eb", "bad_container": "bad_containers", "failed_call": "failed_calls"}


def verdict(d: Call, eb_abs: float) -> dict:
    """The reference's numbers for one request, read at its decompress: its
    decoded field's worst error over the bound (inf where none came back), a
    bad container (0 or 1) and a call that raised (0 or 1: its compress,
    which leaves the decompress nothing to decode, or the decompress)."""
    if d.diff is None:
        err = math.inf
    else:
        err = d.diff / eb_abs if eb_abs > 0 else (0.0 if d.diff == 0 else math.inf)
    return {"err_over_eb": err, "bad_container": int(d.container_ok is False), "failed_call": int(d.error is not None)}


def request(timer, codec, x, f: int, container=None) -> list:
    """One request on field ``x`` (index ``f``): a compress where no
    ``container`` is given, then the decompress of the container, judged
    against ``x``. Returns its calls."""
    from . import reference

    calls = []
    if container is None:
        c = Call("compress", f, x.numel())
        container = timer(c, codec.compress, x)
        if c.error is None:
            c.repairs = codec.last_repairs()
            judge_container(c, container, x.shape)
        calls.append(c)
    d = Call("decompress", f, x.numel(), container_bytes=len(container) if container is not None else 0)
    if calls:  # the container this request made: its judgement and its hf counts
        d.container_ok, d.hf = calls[0].container_ok, calls[0].hf
    if container is None:
        d.error = "no container to decode"
    else:
        y = timer(d, codec.decompress, container)
        if d.error is None:
            d.diff = reference.max_abs_diff(x, y)
        del y
    return calls + [d]


def window(mix, codec, fields, containers, seconds: float, device, profile: bool):
    """The closed loop over the window; returns (calls, trace or None, window seconds)."""
    import torch

    from .tracing import Trace

    timer = Timer(device)
    calls, i = [], 0
    prof = None
    if profile:
        from torch.profiler import ProfilerActivity

        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if device.type == "cuda" else [])
        prof = torch.profiler.profile(activities=acts)
        prof.__enter__()
    t0 = time.perf_counter()
    deadline = t0 + seconds
    try:
        while time.perf_counter() < deadline:
            f = i % len(fields)
            calls += request(timer, codec, fields[f], f, containers.get(f))
            i += 1
    finally:
        t_end = time.perf_counter()
        if prof is not None:
            prof.__exit__(None, None, None)
    trace = Trace.from_profiler(prof) if prof is not None else None
    return calls, trace, t_end - t0


def snapshot(codec, cfg: dict, seed: int, device) -> list:
    """The seed's snapshot, once the window has closed: each of its fields
    compressed and decoded once by the window's program, one field on the
    device at a time. Returns (decompress call, absolute bound) pairs."""
    from . import reference
    from .fields import make_field

    timer, judged = Timer(device), []
    for i in range(int(cfg["fields"])):
        x = make_field(cfg["recipe"], cfg["shape"], seed, i, device)
        d = request(timer, codec, x, i)[-1]
        judged.append((d, reference.abs_bound(cfg["spec"]["eb"], cfg["spec"]["eb_mode"], x)))
        del x
    return judged


def power_limit(device) -> str:
    if device.type != "cuda":
        return "no card"
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader",
                              f"--id={device.index or 0}"], capture_output=True, text=True, timeout=20)
        return out.stdout.strip() or "not read"
    except (OSError, subprocess.SubprocessError):
        return "not read"


def run_cell(name: str, seed: int, seconds: float, trace: bool, device, *, t_start: float | None = None,
             codec=None, bench_dir: pathlib.Path = BENCH_DIR) -> dict:
    """One run of cell ``name``; returns the result line as a dict, with the
    numbers compared under ``checks`` (last)."""
    import torch

    from . import reference
    from .fields import make_field
    from .traffic import Mix

    t_start = time.perf_counter() if t_start is None else t_start
    bench = benchmark(bench_dir)
    cell = load_cell(name, bench_dir)
    cfg, mix = cell["config"], Mix(cell["mix"])
    base = int(cfg["recipe"]["base_seed"])
    fields = [make_field(cfg["recipe"], cfg["shape"], base, i, device) for i in range(int(cfg["fields"]))]
    if codec is None:
        from .program import Program

        codec = Program(cfg["spec"], device, plan_cache=mix.plan_cache)
    containers = mix.setup(codec, fields)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    setup_s = time.perf_counter() - t_start
    before = codec.counters()
    calls, tr, window_s = window(mix, codec, fields, containers, seconds, device, trace)
    after = codec.counters()
    counters = {k: after[k] - before.get(k, 0) for k in after}

    # the reference's verdict, once the window has closed
    eb_abs = [reference.abs_bound(cfg["spec"]["eb"], cfg["spec"]["eb_mode"], x) for x in fields]
    for i, buf in containers.items():
        probe = Call("setup", i, fields[i].numel())
        judge_container(probe, buf, fields[i].shape)
        for c in calls:
            if c.op == "decompress" and c.field == i:
                c.container_ok, c.hf = probe.container_ok, probe.hf
    handled = [c for c in calls if c.op == "decompress"]
    peaks = [c.peak_bytes for c in calls if c.peak_bytes is not None]
    del fields, containers
    judged = [(c, eb_abs[c.field]) for c in handled] + snapshot(codec, cfg, seed, device)
    verdicts = [verdict(c, eb) for c, eb in judged]
    checks = {"max_err_over_eb": {"value": max((v["err_over_eb"] for v in verdicts), default=math.inf),
                                  "limit": 1.0 + float(cfg["guarantee"]["slack"])},
              "bad_containers": {"value": sum(v["bad_container"] for v in verdicts), "limit": 0},
              "failed_calls": {"value": sum(v["failed_call"] for v in verdicts), "limit": 0}}
    # a request fails where one of its own numbers is over the limit of the check that holds it
    failed = sum(1 for v in verdicts if any(v[k] > checks[check]["limit"] for k, check in VERDICT_CHECKS.items()))
    correct = bool(handled) and failed == 0

    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
           "count": 1, "memory_peak_bytes": max(peaks) if peaks else 0}
    run = Run(cfg, calls, setup_s, counters, dev, tr, power_limit(device))
    metrics = {}
    for m in metric_names(bench, name, trace):
        mod = metric_module(m, bench_dir)
        value = mod.read(run)
        if value is not None:
            metrics[m] = {"value": value, "unit": mod.UNIT}
    for text in run.notes:
        log(text)
    for op in ("compress", "decompress"):
        walls = [round(c.wall_s * 1e3, 1) for c in calls if c.op == op]
        if walls:
            log(f"{op} walls ms, in order: {walls}")
    log(f"cell {name} seed {seed}: {len(handled)} fields handled in a window of {window_s:.3f} s "
        f"(asked {seconds} s) and {len(judged) - len(handled)} of the seed's snapshot after it, "
        f"set-up {setup_s:.3f} s, {run.power_limit}")
    out = {"correct": correct, "attempted": len(judged), "failed": failed, "metrics": metrics, "device": dev}
    if tr is not None:
        dev["busy_s"] = tr.busy_s()
        dev["window_s"] = tr.wall_s()
        out["breakdown"] = tr.breakdown()
    out["checks"] = checks
    return out


def leaked_modules() -> list[str]:
    """Top-level names of the JAX stack or the JAX package in ``sys.modules``."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def main(argv, t_start: float) -> int:
    import argparse

    ap = argparse.ArgumentParser(description="Run one cell of the port's benchmark once.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    os.environ["OMP_NUM_THREADS"] = str(HOST_THREADS)
    import torch

    torch.set_num_threads(HOST_THREADS)
    bench = benchmark()
    cells = {w["name"]: w for w in bench["workloads"]}
    if args.workload not in cells:
        log(f"no cell {args.workload!r} in BENCHMARK.json")
        return 2
    if not torch.cuda.is_available() or torch.cuda.device_count() < int(cells[args.workload]["chips"]):
        log(f"cell {args.workload} needs {cells[args.workload]['chips']} CUDA card(s); "
            f"torch sees {torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return 2
    out = run_cell(args.workload, args.seed, args.seconds, bool(args.trace), torch.device("cuda", 0),
                   t_start=t_start)
    leaked = leaked_modules()
    if leaked:
        log(f"the process holds modules of the JAX stack or the JAX package: {', '.join(leaked)}")
        return 3
    for v in out["checks"].values():
        if not math.isfinite(v["value"]):
            v["value"] = str(v["value"])  # a JSON number cannot say inf
    for k, v in out["checks"].items():
        log(f"check {k} {v['value']} limit {v['limit']}")
    print(json.dumps(out, allow_nan=False), flush=True)
    return 0
