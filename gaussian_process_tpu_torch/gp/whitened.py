"""Whitened exact-GP posterior and LML: the fp32 path for ill-conditioned
small workloads such as the Mauna Loa CO2 pipeline (torch counterpart of
``gp/whitened.py``).

The CO2 composite at the book hyperparameters has amplitudes near 66, so
K's entries sit near 4.4e3 against an observation noise of 5e-4, and the
raw time coordinate is near 2e3, which ruins the fp32 dot-trick squared
distance. Two exact reparameterisations make the fp32 ranges sane without
changing the model:

1. Centre the inputs, ``x -> x - mean(x)``: a stationary kernel's values do
   not change.
2. Standardise the targets, ``y -> y / s`` with ``s = std(y)``, and scale
   the kernel and the noise by 1 / s^2. The posterior transforms back
   exactly: ``mean = s mean_hat``, ``std = s std_hat``,
   ``lml = lml_hat - n log s``.

The whitened kernel is ``Sum(Scaled(k), White)``, with ``k`` the kernel
less its top-level White terms (``ops.kernels.split_white``), Scaled's
amplitude 1/s and White's amplitude sqrt(white variance)/s. That is the
same K / s^2 as the JAX package's one ``Scaled`` over the whole kernel, but
White stays a term of the top-level sum, where the tile gram (K1) places it
on the diagonal: a White leaf below the top level would send every gram to
the plain version (``ops.cuda.kernel_ops.nested_white``).

Whitening cannot change kappa(K + s I), which is scale-invariant. The port
factors fp32 grams in float64 (``linalg.cholesky.solve_dtype``), so its
fp32 results carry the gram's rounding and not an fp32 factorization's.

Entry points run on the card unless ``device`` names another
(``device=None`` means ``"cuda"``). Inputs arrive as NumPy arrays or
tensors and are whitened on the host in float64.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import numpy as np
import torch

from gaussian_process_tpu_torch import config as _config
from gaussian_process_tpu_torch.gp import regression as _reg
from gaussian_process_tpu_torch.linalg import cholesky as _chol
from gaussian_process_tpu_torch.ops import kernels as _k
from gaussian_process_tpu_torch.ops.cuda import kernel_ops as _kops


class WhitenedPosterior(NamedTuple):
    mean: torch.Tensor  # (n_test,) posterior mean, original units
    var: torch.Tensor  # (n_test,) posterior variance, original units
    std: torch.Tensor  # sqrt(var), original units
    lml: float  # LML of the original model, de-whitened in host float64
    y_scale: float  # s, the target standardisation applied
    x_shift: np.ndarray  # the input centring applied
    jitter: torch.Tensor  # jitter safe_cholesky applied, in whitened units


def _device(device) -> torch.device:
    return torch.device("cuda") if device is None else torch.device(device)


def _host64(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        a = a.detach().cpu().numpy()
    return np.asarray(a, np.float64)


def _require_stationary(kernel: _k.Kernel, name: str) -> None:
    if not _k.is_stationary(kernel):
        raise ValueError(
            f"{name} requires a stationary kernel: input centring would change a "
            "non-stationary kernel's values"
        )


def _constants(x: np.ndarray, y: np.ndarray, x_shift, y_scale):
    shift = x.mean(axis=0) if x_shift is None else np.asarray(x_shift)
    s = float(np.std(y)) if y_scale is None else float(y_scale)
    return shift, (1.0 if s <= 0.0 else s)


def whitened_kernel(kernel: _k.Kernel, params: _k.Params, y_scale: float, *,
                    dtype: torch.dtype, device) -> tuple:
    """``(kernel, params)`` of K / y_scale^2 as ``Sum(Scaled(k), White)``,
    params cast to ``dtype`` on ``device`` (see the module docstring)."""
    cast = lambda p: torch.as_tensor(p, dtype=dtype, device=device)  # noqa: E731
    k_nw, p_nw, white_var = _k.split_white(kernel, params)
    terms, term_params = [], []
    if k_nw is not None:
        terms.append(_k.Scaled(base=k_nw))
        term_params.append({"amplitude": cast(1.0 / y_scale),
                            "base": _k.tree_map_params(cast, p_nw)})
    if white_var is not None:
        terms.append(_k.White())
        amplitude = torch.sqrt(torch.as_tensor(white_var, dtype=torch.float64)) / y_scale
        term_params.append({"amplitude": cast(amplitude)})
    if len(terms) == 1:
        return terms[0], term_params[0]
    return _k.Sum(children=tuple(terms)), tuple(term_params)


def whitened_posterior(
    kernel: _k.Kernel,
    params: _k.Params,
    x,
    y,
    x_test,
    *,
    noise_variance: float,
    dtype: torch.dtype = torch.float32,
    x_shift: Optional[np.ndarray] = None,
    y_scale: Optional[float] = None,
    cfg: Optional[_config.SolveConfig] = None,
    device=None,
) -> WhitenedPosterior:
    """Exact-GP posterior computed in ``dtype`` on whitened data, returned
    in original units. ``kernel`` must be stationary (``ValueError``
    otherwise). The whitening constants default to the data's and are
    returned, so a caller can reuse them.

    [ref: CO2_example.py:182-214 (make_prediction), 404-423 (the 20-year
    extrapolation)]
    """
    _require_stationary(kernel, "whitened_posterior")
    device = _device(device)
    x, y, x_test = _host64(x), _host64(y), _host64(x_test)
    n = x.shape[0]
    shift, s = _constants(x, y, x_shift, y_scale)
    as_t = lambda a: torch.as_tensor(a, dtype=dtype, device=device)  # noqa: E731
    wkernel, wparams = whitened_kernel(kernel, params, s, dtype=dtype, device=device)
    post = _reg.posterior(
        wkernel, wparams, as_t(x - shift), as_t(y / s), as_t(x_test - shift),
        noise_variance=noise_variance / (s * s), cfg=cfg,
    )
    return WhitenedPosterior(
        mean=post.mean * s,
        var=post.var * (s * s),
        std=post.std * s,
        lml=float(post.lml) - n * math.log(s),
        y_scale=s,
        x_shift=shift,
        jitter=post.jitter,
    )


def whitened_lml(
    kernel: _k.Kernel,
    params: _k.Params,
    x,
    y,
    *,
    noise_variance: float,
    dtype: torch.dtype = torch.float32,
    x_shift: Optional[np.ndarray] = None,
    y_scale: Optional[float] = None,
    cfg: Optional[_config.SolveConfig] = None,
    device=None,
) -> float:
    """Original-units log marginal likelihood through the whitened solve,
    as a host float.

    [ref: CO2_example.py:131-149 (compute_mar_likelihood)]
    """
    _require_stationary(kernel, "whitened_lml")
    device = _device(device)
    x, y = _host64(x), _host64(y)
    shift, s = _constants(x, y, x_shift, y_scale)
    as_t = lambda a: torch.as_tensor(a, dtype=dtype, device=device)  # noqa: E731
    wkernel, wparams = whitened_kernel(kernel, params, s, dtype=dtype, device=device)
    lml_hat = _reg.log_marginal_likelihood(
        wkernel, wparams, as_t(x - shift), as_t(y / s),
        noise_variance=noise_variance / (s * s), cfg=cfg,
    )
    return float(lml_hat) - x.shape[0] * math.log(s)


def make_whitened_lml_fn(
    kernel: _k.Kernel,
    params_from_vector,
    x,
    y,
    *,
    noise_variance: float,
    dtype: torch.dtype = torch.float32,
    chunk: int = 128,
    device=None,
):
    """Batched LML over hyperparameter vectors: the CO2 11-D search
    surface on the card.

    Returns ``batch_lml(thetas (B, p)) -> np.ndarray (B,)`` of
    original-units LML values. The whitening constants are computed once.
    For each chunk of ``chunk`` candidates, each candidate's gram is built
    by ``ops.cuda.kernel_ops.gram`` (the tile gram K1 for fp32 card
    inputs), the grams are stacked and factored in one batched call in
    ``linalg.cholesky.solve_dtype(dtype)`` (a candidate whose factor fails
    retries alone under ``safe_cholesky``'s jitter schedule, as the JAX
    package's vmapped retry does), and the constant -n log s is added in
    host float64.

    ``dtype=torch.float64`` is the search surface; ``torch.float32`` the
    prescreen, whose grams carry fp32 rounding.

    [ref: CO2_example.py:330-379 (the search this feeds), :131-149]
    """
    _require_stationary(kernel, "make_whitened_lml_fn")
    cfg = _config.DEFAULT_SOLVE
    device = _device(device)
    x, y = _host64(x), _host64(y)
    n = x.shape[0]
    shift, s = _constants(x, y, None, None)
    work = _chol.solve_dtype(dtype)
    xc = torch.as_tensor(x - shift, dtype=dtype, device=device)
    yh = torch.as_tensor(y / s, dtype=work, device=device)
    nv = noise_variance / (s * s)
    const = -n * math.log(s) - 0.5 * n * math.log(2.0 * math.pi)
    retry = dict(initial_jitter=nv, min_retry_jitter=_reg._min_retry(dtype),
                 jitter_growth=cfg.jitter_growth, max_attempts=cfg.max_chol_attempts)

    def factor(K: torch.Tensor) -> torch.Tensor:
        L, info = torch.linalg.cholesky_ex(_chol.add_diagonal(K, nv))
        d = torch.diagonal(L, dim1=-2, dim2=-1)
        ok = (info == 0) & torch.all(torch.isfinite(d) & (d > 0), dim=-1)
        for i in torch.nonzero(~ok).flatten().tolist():
            L[i] = _chol.safe_cholesky(K[i], **retry).factor
        return L

    def batch_lml(thetas) -> np.ndarray:
        thetas = torch.as_tensor(np.atleast_2d(np.asarray(thetas, np.float64)))
        thetas = thetas.to(device=device, dtype=dtype)
        out = []
        for i in range(0, thetas.shape[0], chunk):
            grams = []
            for theta in thetas[i:i + chunk]:
                wk, wp = whitened_kernel(kernel, params_from_vector(theta), s,
                                         dtype=dtype, device=device)
                grams.append(_kops.gram(wk, wp, xc))
            L = factor(torch.stack(grams).to(work))
            yb = yh.expand(L.shape[0], n)
            alpha = _chol.cholesky_solve(L, yb)
            lml_hat = (-0.5 * torch.sum(yb * alpha, dim=-1)
                       - torch.sum(torch.log(torch.diagonal(L, dim1=-2, dim2=-1)), dim=-1))
            out.append(lml_hat.cpu().numpy().astype(np.float64))
        return np.concatenate(out) + const

    return batch_lml
