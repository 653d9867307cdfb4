"""The cells' fields, made on the device.

One recipe serves every configuration: white noise filtered by a power-law
|k|^-alpha spectrum (anisotropic where the configuration says so),
normalised to [-1, 1], then passed through the configuration's point-wise
transform (``exp`` or ``tanh`` with a gain). This is the synthetic
datasets' recipe, the Nyx one (alpha 2, ``exp(2 f)``) as the port's smoke
script ran it on the card, and the Miranda one (alpha 2.6, ``tanh(4 f)``),
written here for torch on the device.

Two sets of fields per run:

- the resident fields that the window times: field ``i`` from the
  recipe's ``base_seed`` and ``i``, the same in every run, so that every
  seed asks the same work of the program. Miranda fields drawn anew led the
  per-level planner to other plans, with other costs and memory peaks
  (``PERF.md``);
- the seed's snapshot, which the reference judges after the window: field
  ``i`` from the run's seed and ``i``, new data in every run.
"""
from __future__ import annotations

import hashlib

import torch

_POST = {"exp": torch.exp, "tanh": torch.tanh}


def field_seed(seed: int, index: int) -> int:
    """A 63-bit generator seed from any whole ``seed`` and a field index."""
    digest = hashlib.blake2b(f"{int(seed)}/{int(index)}".encode(), digest_size=8).digest()
    return int.from_bytes(digest, "little") & ((1 << 63) - 1)


def spectral_field(shape, alpha: float, seed: int, device, aniso=None) -> torch.Tensor:
    """White noise under a |k|^-alpha filter, normalised to [-1, 1] (float32)."""
    shape = tuple(int(s) for s in shape)
    g = torch.Generator(device=device).manual_seed(seed)
    white = torch.randn(shape, generator=g, device=device, dtype=torch.float32)
    spec = torch.fft.rfftn(white)
    del white
    freqs = [torch.fft.fftfreq(n, device=device) for n in shape[:-1]] + [torch.fft.rfftfreq(shape[-1], device=device)]
    aniso = aniso or (1.0,) * len(shape)
    k2 = torch.zeros(spec.shape, device=device, dtype=torch.float32)
    for axis, (a, k) in enumerate(zip(aniso, freqs)):
        view = [1] * len(shape)
        view[axis] = -1
        k2 += (a * k.reshape(view)) ** 2
    filt = (k2 + 1e-6) ** (-alpha / 2.0)
    del k2
    filt.reshape(-1)[0] = 0.0
    spec *= filt
    del filt
    out = torch.fft.irfftn(spec, s=shape)
    del spec
    out /= out.abs().max().clamp(min=1e-12)
    return out


def make_field(recipe: dict, shape, seed: int, index: int, device) -> torch.Tensor:
    """Field ``index`` of a configuration's recipe from ``seed``: the
    recipe's ``base_seed`` for a resident field, the run's seed for one of
    its snapshot."""
    f = spectral_field(shape, float(recipe["alpha"]), field_seed(seed, index), device, recipe.get("aniso"))
    return _POST[recipe["post"]](float(recipe.get("gain", 1.0)) * f).contiguous()
