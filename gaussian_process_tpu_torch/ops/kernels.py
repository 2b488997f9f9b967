"""Covariance-function (kernel) algebra (torch counterpart of ``ops/kernels.py``).

A kernel is a frozen dataclass (hashable, no tensors inside) evaluated
against a params tree of tensors: dicts for leaves, tuples for ``Sum`` and
``Product``, ``{"amplitude", "base"}`` for ``Scaled``. Autograd flows
through the params tensors. All kernels of one gram share a single
pairwise-distance computation.

Stationary kernels are evaluated from precomputed distances, which is what
lets the fused CUDA matvec (``ops/cuda``) evaluate the same tree per tile.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Optional, Tuple

import torch

from gaussian_process_tpu_torch.ops import distance as _dist

Params = Any  # tree of torch scalars / tensors


class _DistCache:
    """Lazily computes pairwise distances shared by all kernels in a tree."""

    def __init__(self, x1: torch.Tensor, x2: torch.Tensor, method: str):
        self.x1 = _dist._as_2d(x1)
        self.x2 = _dist._as_2d(x2)
        self.method = method
        self.shape = (self.x1.shape[0], self.x2.shape[0])
        self.dtype = self.x1.dtype
        self.device = self.x1.device
        self._sq: Optional[torch.Tensor] = None
        self._l2: Optional[torch.Tensor] = None

    @property
    def sq(self) -> torch.Tensor:
        if self._sq is None:
            self._sq = _dist.sqdist(self.x1, self.x2, method=self.method)
        return self._sq

    @property
    def l2(self) -> torch.Tensor:
        if self._l2 is None:
            self._l2 = torch.sqrt(self.sq)
        return self._l2


class TileDistCache:
    """Distance 'cache' over a precomputed tile: lets the same kernel tree
    evaluate on distances computed elsewhere (the plain versions of the
    fused matvec). Only stationary kernels can be evaluated this way."""

    def __init__(self, sq: torch.Tensor, l2: Optional[torch.Tensor] = None):
        self._sq = sq
        self._l2 = l2
        self.shape = tuple(sq.shape)
        self.dtype = sq.dtype
        self.device = sq.device
        self.x1 = None
        self.x2 = None

    @property
    def sq(self) -> torch.Tensor:
        return self._sq

    @property
    def l2(self) -> torch.Tensor:
        if self._l2 is None:
            self._l2 = torch.sqrt(self._sq)
        return self._l2


def _full(x: torch.Tensor, value) -> torch.Tensor:
    x = _dist._as_2d(x)
    return torch.ones(x.shape[0], dtype=x.dtype, device=x.device) * value


@dataclasses.dataclass(frozen=True)
class Kernel:
    """Base class. Subclasses implement ``_eval``, ``_eval_diag`` and
    ``init_params``."""

    def init_params(self) -> Params:
        raise NotImplementedError

    def _eval(self, params: Params, cache, same: bool) -> torch.Tensor:
        raise NotImplementedError

    def _eval_diag(self, params: Params, x: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def __add__(self, other: "Kernel") -> "Sum":
        return Sum(children=(self, other))

    def __mul__(self, other: "Kernel") -> "Product":
        return Product(children=(self, other))


def _one(value: float = 1.0) -> torch.Tensor:
    return torch.tensor(value, dtype=torch.float64)


@dataclasses.dataclass(frozen=True)
class RBF(Kernel):
    """Squared-exponential: sigma^2 * exp(-0.5 d^2 / l^2)."""

    def init_params(self) -> Params:
        return {"sigma": _one(), "lengthscale": _one()}

    def _eval(self, params, cache, same):
        sig, ell = params["sigma"], params["lengthscale"]
        return (sig**2) * torch.exp(-0.5 * cache.sq / ell**2)

    def _eval_diag(self, params, x):
        return _full(x, params["sigma"] ** 2)


@dataclasses.dataclass(frozen=True)
class Linear(Kernel):
    """Dot-product kernel (a - c) . (b - c), unit variance, zero mean."""

    def init_params(self) -> Params:
        return {"offset": _one(0.0)}

    def _eval(self, params, cache, same):
        c = params["offset"]
        return (cache.x1 - c) @ (cache.x2 - c).T

    def _eval_diag(self, params, x):
        a = _dist._as_2d(x) - params["offset"]
        return torch.sum(a * a, dim=-1)


@dataclasses.dataclass(frozen=True)
class Periodic(Kernel):
    """exp(-2 sin^2(pi d / p) / l^2) with unit output variance."""

    def init_params(self) -> Params:
        return {"period": _one(), "lengthscale": _one()}

    def _eval(self, params, cache, same):
        p, ell = params["period"], params["lengthscale"]
        s = torch.sin(math.pi * cache.l2 / p)
        return torch.exp(-2.0 * s * s / ell**2)

    def _eval_diag(self, params, x):
        return _full(x, 1.0)


@dataclasses.dataclass(frozen=True)
class DecayedPeriodic(Kernel):
    """RBF-decayed periodic: a^2 exp(-0.5 d^2/decay^2 - 2 sin^2(pi d/p)/s^2)."""

    def init_params(self) -> Params:
        return {
            "amplitude": _one(),
            "decay": _one(),
            "smoothness": _one(),
            "period": _one(),
        }

    def _eval(self, params, cache, same):
        a, dec, sm = params["amplitude"], params["decay"], params["smoothness"]
        p = params.get("period", 1.0)
        decay_term = -0.5 * cache.sq / dec**2
        s = torch.sin(math.pi * cache.l2 / p) / sm
        return a**2 * torch.exp(decay_term - 2.0 * s * s)

    def _eval_diag(self, params, x):
        return _full(x, params["amplitude"] ** 2)


@dataclasses.dataclass(frozen=True)
class RationalQuadratic(Kernel):
    """a^2 (1 + 0.5 d^2 / (alpha l^2))^(-alpha)."""

    def init_params(self) -> Params:
        return {"amplitude": _one(), "lengthscale": _one(), "alpha": _one()}

    def _eval(self, params, cache, same):
        a, ell, alpha = params["amplitude"], params["lengthscale"], params["alpha"]
        base = 1.0 + 0.5 * cache.sq / (alpha * ell**2)
        return a**2 * torch.pow(base, -alpha)

    def _eval_diag(self, params, x):
        return _full(x, params["amplitude"] ** 2)


@dataclasses.dataclass(frozen=True)
class Matern(Kernel):
    """Matérn covariance at nu in {1/2, 3/2, 5/2}:

        nu=1/2: sigma^2 exp(-d/l)
        nu=3/2: sigma^2 (1 + sqrt3 d/l) exp(-sqrt3 d/l)
        nu=5/2: sigma^2 (1 + sqrt5 d/l + 5 d^2/(3 l^2)) exp(-sqrt5 d/l)
    """

    nu: float = 2.5

    def __post_init__(self):
        if self.nu not in (0.5, 1.5, 2.5):
            raise ValueError("Matern supports nu in {0.5, 1.5, 2.5}")

    def init_params(self) -> Params:
        return {"sigma": _one(), "lengthscale": _one()}

    def _eval(self, params, cache, same):
        sig, ell = params["sigma"], params["lengthscale"]
        r = cache.l2 / ell
        if self.nu == 0.5:
            body = torch.exp(-r)
        elif self.nu == 1.5:
            s = math.sqrt(3.0) * r
            body = (1.0 + s) * torch.exp(-s)
        else:
            s = math.sqrt(5.0) * r
            body = (1.0 + s + s * s / 3.0) * torch.exp(-s)
        return (sig**2) * body

    def _eval_diag(self, params, x):
        return _full(x, params["sigma"] ** 2)


@dataclasses.dataclass(frozen=True)
class White(Kernel):
    """Independent noise a^2 * delta_ij: contributes only to same-set grams."""

    def init_params(self) -> Params:
        return {"amplitude": _one()}

    def _eval(self, params, cache, same):
        n, m = cache.shape
        if not same:
            return torch.zeros((n, m), dtype=cache.dtype, device=cache.device)
        return (params["amplitude"] ** 2) * torch.eye(
            n, dtype=cache.dtype, device=cache.device
        )

    def _eval_diag(self, params, x):
        return _full(x, params["amplitude"] ** 2)


@dataclasses.dataclass(frozen=True)
class Sum(Kernel):
    children: Tuple[Kernel, ...]

    def init_params(self) -> Params:
        return tuple(c.init_params() for c in self.children)

    def _eval(self, params, cache, same):
        out = self.children[0]._eval(params[0], cache, same)
        for c, p in zip(self.children[1:], params[1:]):
            out = out + c._eval(p, cache, same)
        return out

    def _eval_diag(self, params, x):
        out = self.children[0]._eval_diag(params[0], x)
        for c, p in zip(self.children[1:], params[1:]):
            out = out + c._eval_diag(p, x)
        return out


@dataclasses.dataclass(frozen=True)
class Product(Kernel):
    children: Tuple[Kernel, ...]

    def init_params(self) -> Params:
        return tuple(c.init_params() for c in self.children)

    def _eval(self, params, cache, same):
        out = self.children[0]._eval(params[0], cache, same)
        for c, p in zip(self.children[1:], params[1:]):
            out = out * c._eval(p, cache, same)
        return out

    def _eval_diag(self, params, x):
        out = self.children[0]._eval_diag(params[0], x)
        for c, p in zip(self.children[1:], params[1:]):
            out = out * c._eval_diag(p, x)
        return out


@dataclasses.dataclass(frozen=True)
class Scaled(Kernel):
    """amplitude^2 * base(params)."""

    base: Kernel

    def init_params(self) -> Params:
        return {"amplitude": _one(), "base": self.base.init_params()}

    def _eval(self, params, cache, same):
        return (params["amplitude"] ** 2) * self.base._eval(params["base"], cache, same)

    def _eval_diag(self, params, x):
        return (params["amplitude"] ** 2) * self.base._eval_diag(params["base"], x)


def gram(
    kernel: Kernel,
    params: Params,
    x1: torch.Tensor,
    x2: Optional[torch.Tensor] = None,
    *,
    method: str = "dot",
) -> torch.Tensor:
    """Dense kernel (Gram) matrix K(x1, x2).

    When ``x2`` is None the gram is the symmetric same-set matrix and white
    noise contributes its diagonal.
    """
    same = x2 is None
    if same:
        x2 = x1
    return kernel._eval(params, _DistCache(x1, x2, method), same)


def gram_diag(kernel: Kernel, params: Params, x: torch.Tensor) -> torch.Tensor:
    """diag(K(x, x)) without materialising the matrix."""
    return kernel._eval_diag(params, x)


def co2_kernel() -> Sum:
    """The Mauna Loa composite kernel of GPML sec. 5.4.3:
    RBF + DecayedPeriodic + RQ + RBF + White (11 hyperparameters)."""
    return Sum(
        children=(RBF(), DecayedPeriodic(), RationalQuadratic(), RBF(), White())
    )


def co2_params_from_vector(theta) -> Params:
    """Map the flat 11-vector [theta_1..theta_11] onto the composite's
    params tree."""
    theta = torch.as_tensor(theta)
    return (
        {"sigma": theta[0], "lengthscale": theta[1]},
        {
            "amplitude": theta[2],
            "decay": theta[3],
            "smoothness": theta[4],
            "period": torch.ones((), dtype=theta.dtype, device=theta.device),
        },
        {"amplitude": theta[5], "lengthscale": theta[6], "alpha": theta[7]},
        {"sigma": theta[8], "lengthscale": theta[9]},
        {"amplitude": theta[10]},
    )


def is_stationary(kernel: Kernel) -> bool:
    """True if every leaf depends on inputs only through pairwise distances."""
    if isinstance(kernel, (Sum, Product)):
        return all(is_stationary(c) for c in kernel.children)
    if isinstance(kernel, Scaled):
        return is_stationary(kernel.base)
    return isinstance(
        kernel, (RBF, Matern, Periodic, DecayedPeriodic, RationalQuadratic, White)
    )


def needs_l2(kernel: Kernel) -> bool:
    """True if any leaf reads the l2 (not squared) distance."""
    if isinstance(kernel, (Sum, Product)):
        return any(needs_l2(c) for c in kernel.children)
    if isinstance(kernel, Scaled):
        return needs_l2(kernel.base)
    return isinstance(kernel, (Matern, Periodic, DecayedPeriodic))


def split_white(kernel: Kernel, params: Params):
    """Split top-level White terms out of a Sum: returns
    (kernel_without_white, params_without_white, white_variance_or_None).

    The fused matvec adds the white diagonal as ``white * v`` instead of
    evaluating an identity per tile.
    """
    if isinstance(kernel, White):
        return None, None, params["amplitude"] ** 2
    if isinstance(kernel, Sum):
        keep_k, keep_p, white = [], [], None
        for c, p in zip(kernel.children, params):
            if isinstance(c, White):
                w = p["amplitude"] ** 2
                white = w if white is None else white + w
            else:
                keep_k.append(c)
                keep_p.append(p)
        if white is None:
            return kernel, params, None
        if not keep_k:
            return None, None, white
        if len(keep_k) == 1:
            return keep_k[0], keep_p[0], white
        return Sum(children=tuple(keep_k)), tuple(keep_p), white
    return kernel, params, None


def eval_from_distances(
    kernel: Kernel, params: Params, sq: torch.Tensor, l2: Optional[torch.Tensor] = None
) -> torch.Tensor:
    """Evaluate a stationary kernel tree on precomputed distance tiles
    (same=False semantics: White contributes zero; callers add the white
    diagonal themselves)."""
    return kernel._eval(params, TileDistCache(sq, l2), same=False)


def tree_map_params(fn, params: Params) -> Params:
    """Apply ``fn`` to every leaf of a params tree (dicts, tuples, lists)."""
    if isinstance(params, dict):
        return {key: tree_map_params(fn, val) for key, val in params.items()}
    if isinstance(params, (tuple, list)):
        return type(params)(tree_map_params(fn, val) for val in params)
    return fn(params)


def tree_leaves(params: Params) -> list:
    """The leaves of a params tree, in the order ``tree_map_params`` visits
    them."""
    leaves = []
    tree_map_params(leaves.append, params)
    return leaves


def tree_unflatten(structure: Params, leaves) -> Params:
    """A tree shaped like ``structure`` holding ``leaves`` in
    :func:`tree_leaves` order."""
    it = iter(leaves)
    return tree_map_params(lambda _: next(it), structure)
