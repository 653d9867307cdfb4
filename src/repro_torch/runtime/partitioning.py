"""Logical-axis partitioning (maxtext-style rules, simplified).

Model code names the axes of its activations with *logical* names; the
runtime installs a mesh and a logical -> mesh-axis mapping, and
:func:`resolve` turns the names of a shape into a partition spec, dropping
mesh axes that do not divide. The rules are the JAX package's
(``repro.runtime.partitioning``). Here a mesh is anything with an
axis -> size ``.shape`` mapping, which is all the rules read; nothing is
placed on a device yet, so :func:`shard` returns its input and
:func:`named_sharding` returns ``None``, as the JAX ones do with no mesh
installed.
"""
from __future__ import annotations

import math
from contextlib import contextmanager

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

_STATE: dict = {"mesh": None, "rules": dict(DEFAULT_RULES), "off": 0}


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


def shard(x, *names: str | None):
    """Annotate activation ``x`` with logical axes. One device holds the
    whole array, so ``x`` comes back unchanged (the names are checked
    against its rank while a mesh is installed)."""
    if _STATE["mesh"] is not None and not _STATE["off"]:
        assert len(names) == x.ndim, f"shard(): {len(names)} names for rank-{x.ndim} array"
    return x


def named_sharding(*names: str, shape: tuple):
    """The placement of an array with these logical axes: ``None``, as the
    JAX package's with no mesh; placements come with the port's mesh."""
    return None
