"""Carry kernels and hyperparameters over from the JAX package.

Both functions are duck-typed and import nothing of JAX: a JAX kernel is
recognised by its class name and dataclass fields, and a JAX array by the
``__array__`` protocol that numpy reads.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Union

import numpy as np
import torch

from gaussian_process_tpu_torch.ops import kernels as _k

_KERNELS = {
    cls.__name__: cls
    for cls in (
        _k.RBF,
        _k.Linear,
        _k.Periodic,
        _k.DecayedPeriodic,
        _k.RationalQuadratic,
        _k.Matern,
        _k.White,
        _k.Sum,
        _k.Product,
        _k.Scaled,
    )
}


def kernel_from_reference(kernel) -> _k.Kernel:
    """The port's kernel tree for a kernel tree of the JAX package (or of
    this package), matched by class name and dataclass fields."""
    cls = _KERNELS.get(type(kernel).__name__)
    if cls is None or not dataclasses.is_dataclass(kernel):
        raise TypeError(f"no counterpart for kernel {type(kernel).__name__}")
    fields = {}
    for f in dataclasses.fields(cls):
        value = getattr(kernel, f.name)
        if isinstance(value, tuple):
            value = tuple(kernel_from_reference(c) for c in value)
        elif dataclasses.is_dataclass(value):
            value = kernel_from_reference(value)
        fields[f.name] = value
    return cls(**fields)


def params_from_numpy(
    params,
    device: Union[str, torch.device, None] = None,
    dtype: Optional[torch.dtype] = None,
):
    """A params tree (dicts, tuples, lists) of numpy arrays, scalars, JAX
    arrays or tensors, as the same tree of tensors on ``device`` (None:
    where each leaf is, the CPU for non-tensors) in ``dtype`` (None: each
    leaf's own; Python floats become float64)."""

    def leaf(x):
        if not isinstance(x, torch.Tensor):
            x = torch.from_numpy(np.array(x))  # a copy: the source may be read-only
        return x.to(device=x.device if device is None else device, dtype=dtype or x.dtype)

    return _k.tree_map_params(leaf, params)
