"""Carry kernels, hyperparameters and fitted classifier states between the
JAX package and the port.

The functions are duck-typed and import nothing of JAX: a JAX kernel is
recognised by its class name and dataclass fields, and a JAX array by the
``__array__`` protocol that numpy reads.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Union

import numpy as np
import torch

from gaussian_process_tpu_torch.gp import classification as _cls
from gaussian_process_tpu_torch.gp import multiclass as _mc
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


def params_to_numpy(params):
    """A params tree of tensors (or anything numpy reads) as the same tree
    of numpy arrays, detached and on the host: the form the JAX package
    takes back."""

    def leaf(x):
        if isinstance(x, torch.Tensor):
            x = x.detach().cpu().numpy()
        return np.asarray(x)

    return _k.tree_map_params(leaf, params)


def _state_from_numpy(cls, state, device, dtype):
    """``cls`` (a NamedTuple of the port) from a state with the same field
    names: arrays become tensors on ``device`` in ``dtype`` (None: each
    array's own), iteration counts ints and ``converged`` a bool."""
    fields = {}
    for name in cls._fields:
        if name in cls._field_defaults and not hasattr(state, name):
            continue  # a field the source does not record keeps its default
        value = np.array(getattr(state, name))  # a copy: the source may be read-only
        if name in ("iters", "inner_iters"):
            fields[name] = int(value)
        elif name == "converged":
            fields[name] = bool(value)
        else:
            t = torch.from_numpy(value)
            fields[name] = t.to(device=device, dtype=dtype or t.dtype)
    return cls(**fields)


def binary_state_from_numpy(state, device: Union[str, torch.device, None] = None,
                            dtype: Optional[torch.dtype] = None):
    """The port's ``BinaryLaplaceState`` (or ``BinaryLaplaceCGState``, for a
    state with a Nyström factor ``U``) from a fitted binary state of the JAX
    package (f_mode, grad_at_mode, sqrt_w, chol_B or U, ...), so the port's
    predict functions run on the JAX package's own mode."""
    cls = _cls.BinaryLaplaceCGState if hasattr(state, "U") else _cls.BinaryLaplaceState
    return _state_from_numpy(cls, state, device, dtype)


def multiclass_state_from_numpy(state, device: Union[str, torch.device, None] = None,
                                dtype: Optional[torch.dtype] = None):
    """The port's ``MulticlassLaplaceState`` (or ``MulticlassLaplaceCGState``,
    for a state with ``inner_iters``) from a fitted multi-class state of the
    JAX package (f_mode, pi, ...)."""
    cls = (_mc.MulticlassLaplaceCGState if hasattr(state, "inner_iters")
           else _mc.MulticlassLaplaceState)
    return _state_from_numpy(cls, state, device, dtype)
