"""Logical-axis partitioning (maxtext-style rules, simplified).

Model code names the axes of its activations with *logical* names; the
runtime installs a mesh and a logical -> mesh-axis mapping, and
:func:`resolve` turns the names of a shape into a partition spec, dropping
mesh axes that do not divide. The rules are the JAX package's
(``repro.runtime.partitioning``); the rules read only a mesh's axis ->
size ``.shape``.

Placement is DTensor's. A spec becomes one placement per mesh axis
(:func:`placements`): ``Shard(d)`` on every axis that tensor dim ``d`` is
split over (an entry ``("pod", "data")`` nests ``pod`` outside ``data``,
as JAX nests them), ``Replicate()`` elsewhere. Under an installed mesh
(:class:`repro_torch.launch.mesh.Mesh`) :func:`shard` redistributes a
DTensor activation to its rule's placements (GSPMD's sharding constraint
made explicit), :func:`shard_map` is ``local_map`` with the body run under
:func:`no_annotation`, and :func:`psum` / :func:`pmean` /
:func:`axis_index` are the collectives of a body over one mesh axis.
With no mesh, on a one-rank mesh and under :func:`no_annotation`,
:func:`shard` returns its input.
"""
from __future__ import annotations

import math
from contextlib import contextmanager

import torch

# logical axis -> mesh axis (str | tuple | None)
DEFAULT_RULES: dict[str, object] = {
    "batch": ("pod", "data"),
    "seq": None,
    "seq_kv": None,
    "embed": None,
    "act_seq": None,          # residual-stream sequence axis (seq-parallel lever)
    "heads": "model",
    "kv_heads": "model",
    "kv_seq": None,           # decode KV cache length
    "ffn": "model",
    "vocab": "model",
    "experts": None,
    "expert_ffn": "model",
    "lru": "model",
    "ssm_heads": "model",
}

_STATE: dict = {"mesh": None, "rules": dict(DEFAULT_RULES), "off": 0, "manual": 0}


class P:
    """A partition spec: one entry per array axis, each a mesh axis name, a
    tuple of names or ``None`` (``jax.sharding.PartitionSpec``'s entries,
    normalised as it normalises them: a one-name tuple is the name, an
    empty one ``None``). Not a tuple, so the shared tree walk takes a spec
    for one leaf."""

    __slots__ = ("_entries",)

    def __init__(self, *entries):
        def norm(e):
            if isinstance(e, (tuple, list)):
                return None if not e else e[0] if len(e) == 1 else tuple(e)
            return e

        self._entries = tuple(norm(e) for e in entries)

    def __iter__(self):
        return iter(self._entries)

    def __len__(self) -> int:
        return len(self._entries)

    def __getitem__(self, i):
        return self._entries[i]

    def __eq__(self, other) -> bool:
        return isinstance(other, P) and self._entries == other._entries

    def __hash__(self) -> int:
        return hash(self._entries)

    def __repr__(self) -> str:
        return f"P{self._entries!r}"


@contextmanager
def no_annotation():
    """Disable shard() annotations (e.g. inside per-device regions)."""
    _STATE["off"] += 1
    try:
        yield
    finally:
        _STATE["off"] -= 1


def set_mesh(mesh, rules: dict | None = None) -> None:
    _STATE["mesh"] = mesh
    _STATE["rules"] = dict(DEFAULT_RULES, **(rules or {}))


def get_mesh():
    return _STATE["mesh"]


def get_rules() -> dict:
    return _STATE["rules"]


@contextmanager
def mesh_rules(mesh, rules: dict | None = None):
    old = (_STATE["mesh"], _STATE["rules"])
    set_mesh(mesh, rules)
    try:
        yield
    finally:
        _STATE["mesh"], _STATE["rules"] = old


def _axis_size(mesh, ax) -> int:
    if ax is None:
        return 1
    if isinstance(ax, str):
        return mesh.shape[ax] if ax in mesh.shape else 0
    return math.prod(_axis_size(mesh, a) for a in ax)


def resolve(names: tuple, shape: tuple, mesh=None, rules: dict | None = None) -> P:
    """Logical names -> partition spec, dropping axes that don't divide."""
    mesh = mesh or _STATE["mesh"]
    rules = rules or _STATE["rules"]
    spec = []
    used: set = set()
    for i, nm in enumerate(names):
        ax = rules.get(nm) if nm else None
        size = _axis_size(mesh, ax) if mesh is not None else 0
        flat = (ax,) if isinstance(ax, str) else tuple(ax or ())
        if ax is None or size == 0 or shape[i] % size != 0 or any(a in used for a in flat):
            spec.append(None)
        else:
            spec.append(ax)
            used.update(flat)
    return P(*spec)


def is_placed(x) -> bool:
    """Whether ``x`` is a DTensor: a tensor placed on a device mesh."""
    return isinstance(x, torch.Tensor) and hasattr(x, "device_mesh") and hasattr(x, "placements")


def is_shape_only(x) -> bool:
    """Whether ``x`` is a tensor with a shape and no values: on the ``meta``
    device or a ``FakeTensor`` (a DTensor of such shards too)."""
    from torch._subclasses.fake_tensor import is_fake

    return isinstance(x, torch.Tensor) and (x.is_meta or is_fake(x))


def place_like(t, device_mesh, placements):
    """A plain tensor ``t``, the same on every rank, as a DTensor with
    ``placements`` on ``device_mesh``: each rank keeps its own block (no
    collective)."""
    from torch.distributed.tensor import DTensor, Replicate

    rep = DTensor.from_local(t, device_mesh, [Replicate()] * device_mesh.ndim, run_check=False)
    return rep.redistribute(device_mesh, tuple(placements))


def mesh_device(device_mesh) -> torch.device:
    """The device of this rank's shards on a ``DeviceMesh``."""
    dt = device_mesh.device_type
    return torch.device(dt, torch.cuda.current_device()) if dt == "cuda" else torch.device(dt)


def _mesh_size(mesh) -> int:
    return math.prod(mesh.shape.values())


def placements(spec: P, mesh) -> tuple:
    """The DTensor placements of ``spec`` on ``mesh``: one per mesh axis."""
    from torch.distributed.tensor import Replicate, Shard

    names = tuple(mesh.shape)
    out = [Replicate()] * len(names)
    for dim, entry in enumerate(spec):
        if entry is None:
            continue
        axes = (entry,) if isinstance(entry, str) else tuple(entry)
        pos = [names.index(a) for a in axes]
        if pos != sorted(pos):
            raise NotImplementedError(f"{spec}: dim {dim} nests {axes} against the mesh's axis order {names}")
        for i in pos:
            if out[i] != Replicate():
                raise ValueError(f"{spec}: mesh axis {names[i]!r} splits two dims")
            out[i] = Shard(dim)
    return tuple(out)


class NamedSharding:
    """``jax.sharding.NamedSharding``: a mesh and a spec, with the spec's
    DTensor ``.placements`` on that mesh."""

    __slots__ = ("mesh", "spec")

    def __init__(self, mesh, spec: P):
        self.mesh, self.spec = mesh, spec

    @property
    def placements(self) -> tuple:
        return placements(self.spec, self.mesh)

    def local_slices(self, shape: tuple) -> tuple:
        """This rank's block of a global ``shape``: one slice per dim."""
        from torch.distributed.tensor._utils import compute_local_shape_and_global_offset

        size, offset = compute_local_shape_and_global_offset(tuple(shape), self.mesh.device_mesh, self.placements)
        return tuple(slice(o, o + n) for o, n in zip(offset, size))

    def __repr__(self) -> str:
        return f"NamedSharding({self.mesh!r}, {self.spec!r})"


def shard(x, *names: str | None):
    """Constrain activation ``x`` to the placements of its logical axes:
    a DTensor is redistributed. ``x`` comes back unchanged with no mesh,
    under :func:`no_annotation` and on a one-rank mesh; a plain tensor
    under a mesh of more ranks raises (its caller did not place it)."""
    mesh = _STATE["mesh"]
    if mesh is None or _STATE["off"]:
        return x
    assert len(names) == x.ndim, f"shard(): {len(names)} names for rank-{x.ndim} array"
    if _mesh_size(mesh) == 1:
        return x
    if not is_placed(x):
        raise TypeError(f"shard(): a plain {tuple(x.shape)} tensor under a {dict(mesh.shape)} mesh; "
                        "place it first (runtime.sharding_rules.place)")
    want = placements(resolve(tuple(names), tuple(x.shape), mesh), mesh)
    return x if tuple(x.placements) == want else x.redistribute(mesh.device_mesh, want)


def named_sharding(*names: str, shape: tuple):
    """The placement of an array with these logical axes under the
    installed mesh; ``None`` with no mesh, as the JAX package's."""
    mesh = _STATE["mesh"]
    if mesh is None:
        return None
    return NamedSharding(mesh, resolve(tuple(names), shape, mesh))


# ------------------------------------------------------------ manual regions
def in_manual_region() -> bool:
    """True inside a :func:`shard_map` body."""
    return _STATE["manual"] > 0


def region_mesh(x):
    """The installed device mesh when ``x`` is a DTensor outside a manual
    region (a block that can run per shard in one), else None."""
    mesh = _STATE["mesh"]
    if mesh is None or _STATE["manual"] or not is_placed(x) or not hasattr(mesh, "device_mesh"):
        return None
    return mesh


def spec_axes(spec: P) -> tuple:
    """The mesh axes that ``spec`` splits, in its order."""
    out = []
    for e in spec:
        out.extend((e,) if isinstance(e, str) else tuple(e or ()))
    return tuple(out)


def _grad_placements(pl: tuple, names: tuple, grad_axes) -> tuple:
    """Where a body's input is replicated over an axis of ``grad_axes``,
    each rank's local gradient is its share of the total (the body's
    outputs are sharded, psum'd or pmean'd over that axis): ``Partial``
    there. Over any other axis every rank computes the whole gradient:
    ``Replicate``. ``Shard`` is kept."""
    from torch.distributed.tensor import Partial, Replicate

    return tuple(Partial() if p == Replicate() and (grad_axes is None or n in grad_axes) else p
                 for p, n in zip(pl, names))


def _specs_like(specs, args) -> list:
    """One spec per leaf of ``args``, in the order ``local_map`` flattens
    them (dicts in insertion order), looked up by key; a spec in place of
    a subtree covers all its leaves."""
    if isinstance(args, dict):
        return [s for k, a in args.items() for s in _specs_like(specs[k] if isinstance(specs, dict) else specs, a)]
    if isinstance(args, (list, tuple)):
        return [s for i, a in enumerate(args)
                for s in _specs_like(specs[i] if isinstance(specs, (list, tuple)) else specs, a)]
    return [specs]


def shard_map(f, mesh, in_specs, out_specs, *, grad_axes=None):
    """``jax.shard_map`` on DTensor's ``local_map``: ``f`` runs on each
    rank's local blocks of its DTensor arguments, laid out by
    ``in_specs`` (inputs are redistributed to them first), and its outputs
    become DTensors placed by ``out_specs``. The body runs under
    :func:`no_annotation` and :func:`in_manual_region`. An output spec that
    leaves a mesh axis out says the output is the same on that axis (psum
    it first). Gradients flow: an input replicated over an axis of
    ``grad_axes`` (every axis when None) collects its gradient as the sum
    of the ranks' shares; over the other axes the body must compute the
    same on every rank."""
    from torch.distributed.tensor.experimental import local_map
    from torch.utils import _pytree as pytree

    def body(*args):
        _STATE["manual"] += 1
        try:
            with no_annotation():
                return f(*args)
        finally:
            _STATE["manual"] -= 1

    def call(*args):
        flat_in = _specs_like(tuple(in_specs), args)
        in_pl = tuple(placements(s, mesh) if s is not None else None for s in flat_in)
        names = tuple(mesh.shape)
        grads = tuple(_grad_placements(p, names, grad_axes) if p is not None else None for p in in_pl)
        outs = out_specs if isinstance(out_specs, tuple) else (out_specs,)
        out_pl = tuple(placements(s, mesh) for s in pytree.tree_leaves(outs))
        fn = local_map(body, out_placements=out_pl,
                       in_placements=in_pl, in_grad_placements=grads, device_mesh=mesh.device_mesh,
                       redistribute_inputs=True)
        return fn(*args)

    return call


class _AllReduce(torch.autograd.Function):
    """Sum over a mesh axis; the gradient passes through (the cotangent of
    a replicated output is each rank's own, as ``psum``'s transpose)."""

    @staticmethod
    def forward(ctx, x, mesh, axis, scale):
        from torch.distributed import _functional_collectives as funcol

        y = funcol.all_reduce(x, "sum", (mesh.device_mesh, tuple(mesh.shape).index(axis)))
        y = funcol.wait_tensor(y) if hasattr(y, "wait") else y
        ctx.scale = scale
        return y * scale if scale != 1 else y

    @staticmethod
    def backward(ctx, g):
        return (g * ctx.scale if ctx.scale != 1 else g), None, None, None


class _Settle(torch.autograd.Function):
    """Identity; the gradient is laid out as the forward value was."""

    @staticmethod
    def forward(ctx, x):
        ctx.mesh, ctx.placements = x.device_mesh, tuple(x.placements)
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        if is_placed(g) and tuple(g.placements) != ctx.placements:
            g = g.redistribute(ctx.mesh, ctx.placements)
        return g


def settle_grad(x):
    """``x``, whose gradient is redistributed to ``x``'s placements where it
    arrives (a partial sum from a manual region is reduced there). Without
    it DTensor lays such a gradient out as the next op's strategy likes,
    and may split a dim that does not divide (1500 frames over 16 ranks),
    which its own reshapes then cannot view. Plain tensors pass through."""
    if not is_placed(x) or not x.requires_grad:
        return x
    return _Settle.apply(x)


def axis_index(axis: str) -> int:
    """This rank's coordinate on ``axis`` of the installed mesh."""
    return _STATE["mesh"].rank_in(axis)


def psum(x, axis: str):
    """``lax.psum`` over one axis of the installed mesh."""
    return _AllReduce.apply(x, _STATE["mesh"], axis, 1)


def pmean(x, axes):
    """``lax.pmean`` over the installed mesh's ``axes`` (one or several)."""
    mesh = _STATE["mesh"]
    for a in (axes,) if isinstance(axes, str) else tuple(axes):
        x = _AllReduce.apply(x, mesh, a, 1.0 / mesh.shape[a])
    return x
