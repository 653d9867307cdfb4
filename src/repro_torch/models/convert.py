"""Carry parameter and cache trees between numpy and the port's tensors.

``params_from_numpy`` takes a nested dict/list of numpy arrays (for
example the JAX package's parameters after ``np.asarray`` on every leaf)
and returns the same tree of tensors on ``device``; ``tree_to_numpy`` is
its inverse. A bfloat16 leaf crosses as its 16-bit pattern: numpy's
``bfloat16`` (an extension dtype, named "bfloat16") becomes
``torch.bfloat16``, and a ``torch.bfloat16`` tensor comes back as float32
numpy (exact; plain numpy has no bfloat16).
"""
from __future__ import annotations

import numpy as np
import torch

from ..core.tree import tree_map


def _to_tensor(a, device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(np.ascontiguousarray(a).view(np.int16).copy()).view(torch.bfloat16).to(device)
    return torch.from_numpy(np.array(a, copy=True)).to(device)


def _to_numpy(t) -> np.ndarray:
    if not isinstance(t, torch.Tensor):
        return np.asarray(t)
    t = t.detach().cpu()
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


def params_from_numpy(tree, device):
    """``tree`` with every array leaf as a tensor on ``device``."""
    return tree_map(lambda a: _to_tensor(a, device), tree)


def tree_to_numpy(tree):
    """``tree`` with every tensor leaf as a host numpy array (bf16 as float32)."""
    return tree_map(_to_numpy, tree)
