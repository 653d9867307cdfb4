"""Dataset model for :mod:`repro_torch.io` — named variables over named dims.

The JAX package's model (``repro.io.dataset``): variables hold host numpy
arrays, and the manifest a file carries is the same in both packages.

The shape is deliberately the small common denominator of the
netCDF/xarray/zarr family: a :class:`Dataset` is an ordered mapping of
name -> :class:`Variable`, a variable is an array + dimension names +
attributes, and the dataset carries its own attribute dict. That is
enough to round-trip the archival/ensemble workloads the facade targets
without dragging in a dependency; the adapters below convert to/from the
on-disk shapes we can actually open in this environment (npz always,
HDF5 when ``h5py`` is importable, zarr's directory layout read-only).
"""
from __future__ import annotations

import dataclasses
import os

import numpy as np


def _default_dims(name: str, ndim: int) -> tuple[str, ...]:
    return tuple(f"{name}_d{i}" for i in range(ndim))


@dataclasses.dataclass
class Variable:
    """One named array: data + dimension names + attributes."""

    data: np.ndarray
    dims: tuple[str, ...] = ()
    attrs: dict = dataclasses.field(default_factory=dict)

    def __post_init__(self):
        self.data = np.asarray(self.data)
        if not self.dims:
            self.dims = _default_dims("dim", self.data.ndim)
        self.dims = tuple(str(d) for d in self.dims)
        if len(self.dims) != self.data.ndim:
            raise ValueError(
                f"{len(self.dims)} dims for a {self.data.ndim}-d array: {self.dims}")

    @property
    def shape(self) -> tuple[int, ...]:
        return self.data.shape

    @property
    def dtype(self) -> np.dtype:
        return self.data.dtype


class Dataset:
    """An ordered mapping of variable name -> :class:`Variable` + attrs.

    Construct directly from arrays (dims auto-named), from Variables, or
    through the adapters (:meth:`from_npz`, :meth:`from_hdf5`,
    :meth:`from_zarr`). Mapping-style access: ``ds["t2m"]`` is the
    Variable, ``ds.arrays()`` the plain name -> ndarray view.
    """

    def __init__(self, variables: dict | None = None, attrs: dict | None = None):
        self.variables: dict[str, Variable] = {}
        self.attrs: dict = dict(attrs or {})
        for name, v in (variables or {}).items():
            self[name] = v

    # ------------------------------------------------------------- mapping
    def __setitem__(self, name: str, v) -> None:
        if not isinstance(v, Variable):
            arr = np.asarray(v)
            v = Variable(arr, _default_dims(name, arr.ndim))
        self.variables[str(name)] = v

    def __getitem__(self, name: str) -> Variable:
        return self.variables[name]

    def __contains__(self, name: str) -> bool:
        return name in self.variables

    def __iter__(self):
        return iter(self.variables)

    def __len__(self) -> int:
        return len(self.variables)

    def keys(self):
        return self.variables.keys()

    def items(self):
        return self.variables.items()

    def arrays(self) -> dict[str, np.ndarray]:
        return {k: v.data for k, v in self.variables.items()}

    def __repr__(self) -> str:
        vs = ", ".join(
            f"{k}{list(v.shape)}:{v.dtype}" for k, v in self.variables.items())
        return f"Dataset({vs})"

    # ------------------------------------------------------------ adapters
    @classmethod
    def from_arrays(cls, arrays: dict, attrs: dict | None = None) -> "Dataset":
        return cls(dict(arrays), attrs)

    @classmethod
    def from_npz(cls, path) -> "Dataset":
        """An ``np.savez`` archive as a Dataset (dims auto-named)."""
        with np.load(path) as z:
            return cls({k: np.asarray(z[k]) for k in z.files})

    def to_npz(self, path) -> None:
        np.savez(path, **self.arrays())

    @classmethod
    def from_hdf5(cls, path) -> "Dataset":
        """Every dataset in an HDF5 file (recursively), with HDF5 attrs
        and dimension labels carried over. Needs ``h5py``."""
        h5py = _require("h5py")
        ds = cls()
        with h5py.File(path, "r") as f:
            ds.attrs = {k: _plain(v) for k, v in f.attrs.items()}

            def visit(name, obj):
                if isinstance(obj, h5py.Dataset):
                    dims = tuple(
                        d.label or f"{name}_d{i}" for i, d in enumerate(obj.dims)
                    ) if obj.ndim else ()
                    ds[name] = Variable(obj[()], dims or _default_dims(name, obj.ndim),
                                        {k: _plain(v) for k, v in obj.attrs.items()})

            f.visititems(visit)
        return ds

    def to_hdf5(self, path) -> None:
        h5py = _require("h5py")
        with h5py.File(path, "w") as f:
            for k, v in self.attrs.items():
                f.attrs[k] = v
            for name, var in self.variables.items():
                d = f.create_dataset(name, data=var.data)
                for i, dim in enumerate(var.dims):
                    d.dims[i].label = dim
                for k, v in var.attrs.items():
                    d.attrs[k] = v

    @classmethod
    def from_zarr(cls, path) -> "Dataset":
        """A zarr group as a Dataset. Uses the ``zarr`` package when
        importable; raises a clear error otherwise (the environment this
        repo targets does not ship it)."""
        zarr = _require("zarr")
        g = zarr.open_group(str(path), mode="r")
        ds = cls(attrs=dict(g.attrs))
        for name, arr in g.arrays():
            dims = tuple(arr.attrs.get("_ARRAY_DIMENSIONS", ())) or None
            ds[name] = Variable(np.asarray(arr), dims or _default_dims(name, arr.ndim),
                                {k: v for k, v in arr.attrs.items()
                                 if k != "_ARRAY_DIMENSIONS"})
        return ds


def _require(mod: str):
    try:
        return __import__(mod)
    except ImportError as e:  # pragma: no cover - depends on environment
        raise ImportError(
            f"Dataset adapter needs the optional '{mod}' package, which is not "
            f"installed in this environment; use the npz adapter or install it."
        ) from e


def _plain(v):
    """HDF5 attr values into serial-codec-safe plain Python."""
    if isinstance(v, np.generic):
        return v.item()
    if isinstance(v, np.ndarray):
        return v.tolist()
    if isinstance(v, bytes):
        return v.decode("utf-8", "replace")
    return v


def open_dataset(path) -> Dataset:
    """Open ``path`` by extension: ``.npz`` / ``.h5``/``.hdf5`` / a zarr
    directory. The repro container format itself is handled by
    :func:`repro_torch.io.read`, not here."""
    p = str(path)
    if os.path.isdir(p):
        return Dataset.from_zarr(p)
    ext = os.path.splitext(p)[1].lower()
    if ext == ".npz":
        return Dataset.from_npz(p)
    if ext in (".h5", ".hdf5", ".nc"):
        return Dataset.from_hdf5(p)
    raise ValueError(f"don't know how to open {p!r}; expected .npz/.h5/.hdf5 or a zarr dir")
