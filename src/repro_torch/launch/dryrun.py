"""Multi-pod dry run: every (arch x shape x mesh) step traced once on shape-only tensors.

Proves the distribution config holds together without hardware, as the JAX
package's ``repro.launch.dryrun`` does with ``.lower().compile()``. Per cell
the port's own step (``make_train_step``, ``make_prefill_step``,
``make_serve_step``) runs once, eagerly, on ``meta`` tensors laid out as
DTensors on the production mesh (``(16, 16)``, or ``(2, 16, 16)`` with
``--multi-pod``) over a ``"fake"`` process group of 256 or 512 ranks
(``torch.testing._internal.distributed.fake_pg.FakeStore``: this process is
rank 0, and every collective returns at once). No tensor holds a value, so
nothing runs the model on any device. A dispatch mode over the step
records, per device (the local shards of rank 0):

  * ``memory``: the input shards' bytes, the outputs' and those of them that
    reuse an input's storage (the decode cache), and a live-bytes tracker's
    peak over the step;
  * ``cost``: FLOPs by the formulas of ``torch.utils.flop_counter``
    (``FlopCounterMode``'s registry) and the bytes of each op's operands and
    outputs;
  * ``collectives``: the output bytes of every ``_c10d_functional`` and
    ``c10d`` collective, keyed ``op`` and ``op/dtype`` under the JAX
    package's HLO names, and the same by the mesh axis whose group it ran
    over;

into ``experiments/dryrun_torch/<cell>.json``. The JAX package's records in
``experiments/dryrun/`` are never written.

Usage:
  python -m repro_torch.launch.dryrun --arch yi-34b --shape train_4k [--multi-pod]
  python -m repro_torch.launch.dryrun --all [--both-meshes] [--compress-pods]

The process group is set up by :func:`run_cell` and destroyed after it;
importing this module starts nothing.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import pathlib
import sys
import time
import traceback
import weakref

import torch

from ..configs import SHAPES, cells, get_config
from ..core.tree import tree_map
from ..runtime import partitioning as part
from ..runtime import sharding_rules as rules_mod
from ..runtime.partitioning import NamedSharding
from ..runtime.steps import batch_pspecs, make_prefill_step, make_serve_step, make_train_step, state_pspecs
from .mesh import make_production_mesh
from .specs import input_specs

OUT_DIR = pathlib.Path(__file__).resolve().parents[3] / "experiments" / "dryrun_torch"

# the collectives a step can issue, under the JAX package's HLO names
_COLLECTIVES = {
    "all_gather_into_tensor": "all-gather", "all_gather_into_tensor_out": "all-gather",
    "_allgather_base_": "all-gather", "allgather_": "all-gather", "allgather_into_tensor_coalesced_": "all-gather",
    "allgather_coalesced_": "all-gather", "all_gather_into_tensor_coalesced": "all-gather",
    "all_reduce": "all-reduce", "all_reduce_coalesced": "all-reduce", "allreduce_": "all-reduce",
    "allreduce_coalesced_": "all-reduce",
    "reduce_scatter_tensor": "reduce-scatter", "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "_reduce_scatter_base_": "reduce-scatter", "reduce_scatter_": "reduce-scatter",
    "reduce_scatter_tensor_coalesced_": "reduce-scatter",
    "all_to_all_single": "all-to-all", "alltoall_base_": "all-to-all", "alltoall_": "all-to-all",
    "broadcast_": "collective-permute", "broadcast": "collective-permute",
}
_NAMESPACES = ("_c10d_functional", "c10d_functional", "c10d")
# ops that allocate and touch no bytes
_ALLOCATIONS = {torch.ops.aten.empty, torch.ops.aten.empty_strided, torch.ops.aten.empty_like,
                torch.ops.aten.new_empty, torch.ops.aten.new_empty_strided}
_DTYPES = {torch.float64: "f64", torch.int64: "s64", torch.float32: "f32", torch.int32: "s32", torch.bfloat16: "bf16",
           torch.float16: "f16", torch.int8: "s8", torch.uint8: "u8", torch.bool: "pred"}


def collective_bytes(events) -> dict:
    """Sum the output bytes of collectives, keyed "op" and "op/dtype" (the
    dtype split diagnoses e.g. f32 gathers that should be bf16). ``events``:
    ``(op, dtype, nbytes)`` triples, as the trace records them (the JAX
    package parses them out of the partitioned HLO)."""
    out: dict[str, int] = {}
    for op, dt, nbytes in events:
        out[op] = out.get(op, 0) + nbytes
        out[f"{op}/{dt}"] = out.get(f"{op}/{dt}", 0) + nbytes
    return out


def _tensors(tree) -> list:
    """The tensors in nested lists, tuples, dicts and dataclasses (no
    closure: a recursive one would hold the tensors in a reference cycle,
    past their release)."""
    out, todo = [], [tree]
    while todo:
        x = todo.pop()
        if isinstance(x, torch.Tensor):
            out.append(x)
        elif isinstance(x, (list, tuple)):
            todo.extend(reversed(x))
        elif isinstance(x, dict):
            todo.extend(reversed(list(x.values())))
        elif dataclasses.is_dataclass(x) and not isinstance(x, type):
            todo.extend(reversed([getattr(x, f.name) for f in dataclasses.fields(x)]))
    return out


def _op_tensors(*groups) -> list:
    """The tensors among an op's arguments (or outputs): each of ``groups``
    holds tensors, lists of them and other values (an op's schema nests no
    deeper)."""
    out = []
    for group in groups:
        for a in group:
            if isinstance(a, torch.Tensor):
                out.append(a)
            elif isinstance(a, (list, tuple)):
                out.extend(b for b in a if isinstance(b, torch.Tensor))
    return out


def _local(t):
    return t._local_tensor if part.is_placed(t) else t


def _storage(t):
    """``t``'s storage and its key (None for a tensor with no storage)."""
    try:
        st = t.untyped_storage()
    except (NotImplementedError, RuntimeError):
        return None, None
    return st, st._cdata


def _nbytes(tensors) -> int:
    """The bytes of the distinct storages under ``tensors`` (DTensors: the local shard)."""
    seen = {}
    for t in tensors:
        st, key = _storage(_local(t))
        if key is not None:
            seen[key] = st.nbytes()
    return sum(seen.values())


def _group_name(obj) -> str:
    """The name of the process group a c10d op's ScriptObject argument boxes."""
    import torch.distributed as dist

    return dist.ProcessGroup.unbox(obj).group_name


class _Trace:
    """A dispatch mode over a step on shape-only tensors: FLOPs, bytes,
    collectives and live bytes of the ops that run on local tensors.

    An op with a DTensor argument is handed back (``NotImplemented``), so
    DTensor lowers it to local ops and collectives first, as
    ``CommDebugMode`` does; those are what is counted. The ops DTensor runs
    on ``FakeTensor`` s to propagate shapes are skipped. A storage is live
    from the op that first returns it to its release (a weakref finalizer);
    the step's arguments are not counted as live.

    ``bytes`` counts every op's operand and output bytes (views and bare
    allocations excepted): an eager step's traffic, which is more than XLA's
    ``bytes accessed``, where a fused region reads its operands and writes
    its outputs once.

    ``axis_of_group``: process group name -> mesh axis; ``known``: the
    storages of the step's arguments."""

    def __init__(self, axis_of_group: dict, known: set):
        self.axis_of_group = axis_of_group
        self.known = known
        self.flops = 0
        self.bytes = 0
        self.events: list = []
        self.by_axis: dict = {}
        self.live: dict = {}
        self.cur = 0
        self.peak = 0
        self._mode = None

    def __enter__(self):
        from torch.utils._python_dispatch import TorchDispatchMode

        tr = self

        class Mode(TorchDispatchMode):
            def __torch_dispatch__(self, func, types, args=(), kwargs=None):
                return tr._dispatch(func, types, args, kwargs or {})

        self._mode = Mode()
        self._mode.__enter__()
        return self

    def __exit__(self, *exc):
        self._mode.__exit__(*exc)
        self._mode = None

    def _release(self, key):
        self.cur -= self.live.pop(key, 0)

    def _dispatch(self, func, types, args, kwargs):
        from torch._subclasses.fake_tensor import FakeTensor
        from torch.distributed.tensor import DTensor
        from torch.utils.flop_counter import flop_registry

        if isinstance(func, torch._ops.HigherOrderOperator):
            return func(*args, **kwargs)
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        ins = _op_tensors(args, kwargs.values())
        out = func(*args, **kwargs)
        outs = [out] if isinstance(out, torch.Tensor) else _op_tensors(out if isinstance(out, (list, tuple)) else ())
        if any(isinstance(t, FakeTensor) for t in ins + outs):  # DTensor's shape propagation
            return out
        packet = func._overloadpacket
        ns, name = func.namespace, packet.__name__
        if ns in _NAMESPACES and name in _COLLECTIVES:
            self._collective(_COLLECTIVES[name], func, args, kwargs, out)
            return out
        if ns in _NAMESPACES:  # a wait or a wrapper of a collective's output
            return out
        if packet in flop_registry:
            self.flops += int(flop_registry[packet](*args, **kwargs, out_val=out))
        if not func.is_view and packet not in _ALLOCATIONS:
            self.bytes += sum(t.numel() * t.element_size() for t in ins + outs)
        in_keys = {_storage(t)[1] for t in ins}
        for t in outs:
            st, key = _storage(t)
            if key is None or key in in_keys or key in self.live or key in self.known:
                continue
            n = st.nbytes()
            self.live[key] = n
            self.cur += n
            self.peak = max(self.peak, self.cur)
            weakref.finalize(st, self._release, key)
        return out

    def _collective(self, op: str, func, args, kwargs, out) -> None:
        """One collective's output bytes (for an in-place c10d op, its
        output tensors), by dtype and by the mesh axis of its group."""
        name = func._overloadpacket.__name__
        if func.namespace == "c10d":
            if name in ("_allgather_base_", "_reduce_scatter_base_", "alltoall_base_"):
                tensors = [args[0]]
            else:
                tensors = _tensors(args[0])
            gname = next((_group_name(a) for a in args if isinstance(a, torch.ScriptObject)
                          and "ProcessGroup" in str(a._type())), None)
        else:
            tensors = _tensors(out)
            gname = kwargs.get("group_name") or [a for a in args if isinstance(a, str)][-1]  # the schema's last str
        axis = self.axis_of_group.get(gname, gname or "?")
        for t in tensors:
            ev = (op, _DTYPES.get(t.dtype, str(t.dtype)), t.numel() * t.element_size())
            self.events.append(ev)
            self.by_axis.setdefault(axis, []).append(ev)

    def record(self, args, out, trace_s: float) -> dict:
        arg_tensors = _tensors(args)
        out_tensors = _tensors(out)
        arg_keys = {_storage(_local(t))[1] for t in arg_tensors}
        out_bytes = _nbytes(out_tensors)
        alias = _nbytes([t for t in out_tensors if _storage(_local(t))[1] in arg_keys])
        argument = _nbytes(arg_tensors)
        return {
            "memory": {"argument_bytes": argument, "output_bytes": out_bytes,
                       "temp_bytes": max(self.peak - (out_bytes - alias), 0),
                       "peak_bytes": argument + self.peak, "alias_bytes": alias},
            "cost": {"flops": self.flops, "bytes": self.bytes},
            "collectives": collective_bytes(self.events),
            "collectives_by_axis": {ax: collective_bytes(ev) for ax, ev in sorted(self.by_axis.items())},
            "trace_s": round(trace_s, 2),
        }


def trace_step(step, args, mesh=None) -> dict:
    """Run ``step(*args)`` once under :class:`_Trace` and return its record
    (``memory``, ``cost``, ``collectives``, ``collectives_by_axis``,
    ``trace_s``). ``args`` are shape-only tensors (``meta``, or DTensors of
    ``meta`` shards on ``mesh``); so are the step's outputs."""
    axis_of_group = {}
    if mesh is not None:
        import torch.distributed as dist

        for ax in mesh.axis_names:
            axis_of_group[mesh.get_group(ax).group_name] = ax
        axis_of_group[dist.group.WORLD.group_name] = "world"
    tr = _Trace(axis_of_group, {_storage(_local(t))[1] for t in _tensors(args)})
    t0 = time.perf_counter()
    with tr:
        out = step(*args)
    return tr.record(args, out, time.perf_counter() - t0)


def _unit_variant(cfg, k: int):
    """Config with k pattern-group units: cost(k) is affine in k (each group
    runs the same ops), so the cost probes trace k = 1, 2 and the totals
    extrapolate. The sharding policy is pinned to the full model's."""
    from ..runtime.sharding_rules import use_fsdp, use_seqpar

    return dataclasses.replace(
        cfg,
        n_layers=cfg.first_dense + k * len(cfg.pattern),
        enc_layers=k if cfg.enc_layers else 0,
        scan_layers=False,
        force_fsdp=int(use_fsdp(cfg)),      # pin the FULL model's sharding policy
        force_seqpar=int(use_seqpar(cfg)),
    )


def place_shapes(tree, specs, mesh):
    """``tree``'s shape-only leaves as DTensors laid out by ``specs`` (a
    tree of :class:`P`) on ``mesh``, with no copy (``place`` keeps
    shape-only leaves as they are)."""
    return rules_mod.place(tree, tree_map(lambda s: NamedSharding(mesh, s), specs))


def place_inputs(arch: str, shape: str, cfg, mesh, *, compress_pods: bool = False, rules: dict | None = None):
    """The cell's step arguments, as shape-only DTensors placed as the JAX
    package's ``in_shardings`` place them: ``(kind, args)``. A decode step's
    ``pos`` is ``seq - 1``."""
    npods = mesh.shape.get("pod", 0) if compress_pods else 0
    kind, specs = input_specs(arch, shape, npods=npods, cfg=cfg)
    rules = rules if rules is not None else rules_mod.activation_rules(cfg, mesh)
    if kind == "train":
        state = place_shapes(specs["state"], state_pspecs(specs["state"], cfg, mesh), mesh)
        return kind, (state, place_shapes(specs["batch"], batch_pspecs(specs["batch"], mesh), mesh))
    params = place_shapes(specs["params"], rules_mod.tree_pspecs(specs["params"], cfg, mesh), mesh)
    if kind == "prefill":
        return kind, (params, place_shapes(specs["batch"], batch_pspecs(specs["batch"], mesh), mesh))
    cache = place_shapes(specs["cache"], rules_mod.cache_pspecs(specs["cache"], cfg, mesh, rules), mesh)
    token = place_shapes(specs["token"], batch_pspecs(specs["token"], mesh), mesh)
    return kind, (params, cache, token, SHAPES[shape][0] - 1)


def argument_bytes(args) -> int:
    """The local bytes of the step arguments' shards on this rank."""
    return _nbytes(_tensors(args))


def _trace_once(arch, shape, cfg, mesh, *, compress_pods, rules_override):
    """One cell's step traced once: the port's form of the JAX package's
    ``repro.launch.dryrun._compile_once`` (which lowers and compiles the
    step); returns the record without ``arch``/``shape``/``mesh``."""
    rules = rules_mod.activation_rules(cfg, mesh)
    if rules_override:
        rules.update(rules_override)
    with part.mesh_rules(mesh, rules):
        kind, args = place_inputs(arch, shape, cfg, mesh, compress_pods=compress_pods, rules=rules)
        if kind == "train":
            step = make_train_step(cfg, mesh, compress_pods=compress_pods)
        elif kind == "prefill":
            step = make_prefill_step(cfg)
        else:
            step = make_serve_step(cfg)
        rec = {"kind": kind}
        rec.update(trace_step(step, args, mesh))
    rec["n_partitions"] = mesh.size
    return rec


@contextlib.contextmanager
def fake_group(world_size: int):
    """A ``"fake"`` default process group of ``world_size`` ranks (this
    process is rank 0), destroyed on the way out."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        raise RuntimeError("the dry run needs its own process group; one is already initialized")
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=world_size)
    try:
        yield
    finally:
        dist.destroy_process_group()


def run_cell(arch: str, shape: str, *, multi_pod: bool, compress_pods: bool = False, rules_override=None,
             cfg_override=None, tag: str = "", extrapolate: bool = True):
    """Full-model trace + (optionally) per-step cost totals from two
    reduced-depth traces: cost(k units) is affine in k, so total = c(1) +
    (G-1) * (c(2) - c(1)) with G = cfg.n_groups. Joins a fake group of the
    production mesh's size for the call."""
    cfg = get_config(arch)
    if cfg_override:
        cfg = dataclasses.replace(cfg, **cfg_override)
    with fake_group(512 if multi_pod else 256):
        mesh = make_production_mesh(multi_pod=multi_pod, device_type="cpu")
        rec = {"arch": arch, "shape": shape, "mesh": dict(mesh.shape), "compress_pods": bool(compress_pods), "tag": tag}
        rec.update(_trace_once(arch, shape, cfg, mesh, compress_pods=compress_pods, rules_override=rules_override))
        if extrapolate:
            G = cfg.n_groups
            c1, c2 = (_trace_once(arch, shape, _unit_variant(cfg, k), mesh, compress_pods=compress_pods,
                                  rules_override=rules_override) for k in (1, 2))
            tot = {key: c1["cost"][key] + (G - 1) * (c2["cost"][key] - c1["cost"][key]) for key in ("flops", "bytes")}
            colls = {}
            for op in set(c1["collectives"]) | set(c2["collectives"]):
                a, b = c1["collectives"].get(op, 0), c2["collectives"].get(op, 0)
                colls[op] = max(a + (G - 1) * (b - a), max(a, b))
            rec["cost_total"] = tot                     # per device, full depth
            rec["collectives_total"] = colls            # per device, full depth
            rec["unit_costs"] = {"c1": c1["cost"], "c2": c2["cost"], "G": G}
    return rec


def main(argv=None, out_dir=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch")
    ap.add_argument("--shape", choices=list(SHAPES))
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--compress-pods", action="store_true")
    ap.add_argument("--tag", default="")
    ap.add_argument("--out-dir", default=None, help=f"where the records go (default {OUT_DIR})")
    args = ap.parse_args(argv)
    out = pathlib.Path(args.out_dir or out_dir or OUT_DIR)
    out.mkdir(parents=True, exist_ok=True)
    todo = list(cells()) if args.all else [(args.arch, args.shape)]
    meshes = [False, True] if args.both_meshes else [args.multi_pod]
    failures = 0
    for arch, shape in todo:
        for mp in meshes:
            name = f"{arch}__{shape}__{'pod2' if mp else 'pod1'}{('__' + args.tag) if args.tag else ''}"
            t0 = time.perf_counter()
            try:
                # cost extrapolation only on the single-pod mesh (roofline)
                rec = run_cell(arch, shape, multi_pod=mp, compress_pods=args.compress_pods and mp,
                               tag=args.tag, extrapolate=not mp)
                rec["wall_s"] = round(time.perf_counter() - t0, 2)  # every trace of the cell
                (out / f"{name}.json").write_text(json.dumps(rec, indent=1))
                tot = rec.get("cost_total", rec["cost"])
                coll = sum(v for k, v in rec.get("collectives_total", rec["collectives"]).items() if "/" not in k)
                mem = rec["memory"]
                perdev = mem["argument_bytes"] + mem["temp_bytes"] + mem["output_bytes"] - mem["alias_bytes"]
                print(f"OK   {name}: trace={rec['trace_s']}s flops/dev={tot['flops']:.3e} "
                      f"bytes/dev={tot['bytes']:.3e} coll/dev={coll:.3e}B mem/dev={perdev / 2**30:.2f}GiB", flush=True)
            except Exception as e:  # noqa: BLE001 - report and continue
                failures += 1
                print(f"FAIL {name}: {type(e).__name__}: {e}", flush=True)
                traceback.print_exc(limit=3)
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
