"""Bayesian-optimisation hyperparameter search with four acquisition
functions (torch counterpart of ``opt/bo.py``).

Rebuild of the reference's BO pipelines, the 1-D lengthscale search
[ref: tune_hyperparms_regression.py:165-289,316-395] and the 11-D CO2
search [ref: CO2_example.py:109-128,217-314,330-379], with the JAX
package's two fixes: all four acquisitions (PI / EI / UCB / TS) dispatch
(the reference's dispatchers always fall through to PI, quirk Q5), and each
objective value is computed once per point.

The surrogate is the exact GP posterior on the k evaluated points, in
float64 on the CPU through ``linalg.cholesky.safe_cholesky``: the JAX
package pads that set to a power of two only so that XLA compiles once per
bucket, which eager PyTorch does not need. The proposal loop is host
Python. Candidates come from a CPU ``torch.Generator`` seeded from
``seed``, so a search draws the same candidates wherever its objective
runs; its state is the checkpoint's ``"key"`` leaf.
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple, Optional, Tuple

import numpy as np
import torch

from gaussian_process_tpu_torch import config as _config
from gaussian_process_tpu_torch.gp import regression as _reg
from gaussian_process_tpu_torch.linalg import cholesky as _chol
from gaussian_process_tpu_torch.ops import kernels as _k
from gaussian_process_tpu_torch.utils import checkpoint as _ckpt

_STOP = None  # sentinel: the acquisition asks the search to stop


def _f64(a) -> torch.Tensor:
    return torch.as_tensor(a, dtype=torch.float64, device="cpu").detach()


def _argmax_valid(score: torch.Tensor, mask) -> int:
    """argmax over candidates, restricted to ``mask`` (True = scoreable)."""
    if mask is not None:
        score = torch.where(torch.as_tensor(mask), score,
                            torch.tensor(-math.inf, dtype=score.dtype))
    return int(torch.argmax(score))


def _normal_pdf(z: torch.Tensor) -> torch.Tensor:
    return torch.exp(-0.5 * z * z) / math.sqrt(2.0 * math.pi)


def _pi_scores(mean, std, best_y, improvement_margin: float = 5e-4) -> torch.Tensor:
    """P(f > best_y + margin) per candidate."""
    mean, std = _f64(mean), _f64(std)
    return torch.special.ndtr((mean - (best_y + improvement_margin)) / std)


def _ei_scores(mean, std, best_y, improvement_margin: float = 5e-4) -> torch.Tensor:
    """E[max(f - best_y - margin, 0)] per candidate."""
    mean, std = _f64(mean), _f64(std)
    f_max = best_y + improvement_margin
    z = (mean - f_max) / std
    return (mean - f_max) * torch.special.ndtr(z) + std * _normal_pdf(z)


def acquisition_pi(mean, std, best_y, *, improvement_margin: float = 5e-4,
                   stop_threshold: float = 1e-3, mask=None):
    """Probability of Improvement. Returns ``_STOP`` (None) when even the
    best candidate's improvement probability is negligible
    [ref: tune_hyperparms_regression.py:165-203, margin s=5e-4 at :178,
    stop at :183-188]."""
    p = _pi_scores(mean, std, best_y, improvement_margin)
    if mask is not None:
        p = torch.where(torch.as_tensor(mask), p, torch.zeros_like(p))
    if float(torch.max(p)) <= stop_threshold or float(torch.sum(p)) <= stop_threshold:
        return _STOP
    return int(torch.argmax(p))


def acquisition_ei(mean, std, best_y, *, improvement_margin: float = 5e-4, mask=None):
    """Expected Improvement [ref: tune_hyperparms_regression.py:251-273]."""
    return _argmax_valid(_ei_scores(mean, std, best_y, improvement_margin), mask)


def acquisition_ucb(mean, std, *, kappa: float = 0.001, mask=None):
    """Upper Confidence Bound [ref: tune_hyperparms_regression.py:206-229
    (kappa=0.001); the CO2 variant uses kappa=7, CO2_example.py:228]."""
    return _argmax_valid(_f64(mean) + kappa * _f64(std), mask)


def acquisition_ts(post_sample, *, mask=None):
    """Thompson Sampling: argmax of one joint posterior draw
    [ref: tune_hyperparms_regression.py:232-248]."""
    return _argmax_valid(_f64(post_sample), mask)


class BOResult(NamedTuple):
    best_params: np.ndarray  # (d,) argmax point
    best_value: float  # objective at the best point
    points: np.ndarray  # (k, d) every evaluated point
    values: np.ndarray  # (k,) objective at each
    iterations: int
    stopped_early: bool


def _surrogate_posterior(kernel: _k.Kernel, sp, pts: np.ndarray, vals: np.ndarray,
                         cands: np.ndarray, noise_variance: float) -> _reg.Posterior:
    """The exact surrogate-GP posterior over the candidates, trained on the
    k evaluated points, in float64 on the CPU: the JAX package's padded
    surrogate without its padding (mean = v^T z_y, from the forward solve
    z = L^-1 [y | K_s], as there)."""
    sp = _k.tree_map_params(_f64, sp)
    x, y, xc = _f64(pts), _f64(vals), _f64(cands)
    res = _chol.safe_cholesky(_chol.add_diagonal(_k.gram(kernel, sp, x), noise_variance))
    L = res.factor
    z = _chol.tri_solve(L, torch.cat([y[:, None], _k.gram(kernel, sp, x, xc)], dim=1))
    z_y, v = z[:, 0], z[:, 1:]
    var = torch.clamp(_k.gram_diag(kernel, sp, xc) - torch.sum(v * v, dim=0), min=0.0)
    lml = (-0.5 * torch.dot(z_y, z_y) - torch.sum(torch.log(torch.diagonal(L)))
           - 0.5 * x.shape[0] * math.log(2.0 * math.pi))
    return _reg.Posterior(mean=v.T @ z_y, var=var, std=torch.sqrt(var), lml=lml, chol=L,
                          alpha=_chol.tri_solve(L, z_y, trans=True), v=v, jitter=res.jitter)


def _default_candidates(generator: torch.Generator, bounds, n: int, d: int) -> np.ndarray:
    """``n`` uniform draws in the box ``bounds`` = (lo, hi)."""
    lo, hi = (np.asarray(b, np.float64) for b in bounds)
    u = torch.rand((n, d), generator=generator, dtype=torch.float64).numpy()
    return lo + u * (hi - lo)


def fresh_mask(cands: np.ndarray, pts: np.ndarray, *, rel_tol: float = 1e-6) -> np.ndarray:
    """Boolean mask of proposals that do not coincide with evaluated points
    (the reference's ``overlap`` [ref: tune_hyperparms_regression.py:
    316-329]), so the search never spends an iteration on a known point."""
    if len(pts) == 0 or len(cands) == 0:
        return np.ones(len(cands), dtype=bool)
    diff = np.abs(cands[:, None, :] - pts[None, :, :])  # (c, k, d)
    scale = np.maximum(np.abs(pts), 1.0)[None, :, :]
    dup = (diff <= rel_tol * scale).all(axis=-1).any(axis=-1)
    return ~dup


def dedup_candidates(cands: np.ndarray, pts: np.ndarray, *,
                     rel_tol: float = 1e-6) -> np.ndarray:
    """Drop proposals that coincide with evaluated points
    (:func:`fresh_mask` as a filter)."""
    return cands[fresh_mask(cands, pts, rel_tol=rel_tol)]


def tune_bayesian_opt(
    objective: Callable[[np.ndarray], float],
    initial_points: np.ndarray,
    bounds: Tuple[np.ndarray, np.ndarray],
    *,
    n_iterations: Optional[int] = None,
    n_candidates: Optional[int] = None,
    acquisition: Optional[str] = None,
    surrogate_kernel: Optional[_k.Kernel] = None,
    surrogate_params=None,
    surrogate_params_fn: Optional[Callable[[np.ndarray], _k.Params]] = None,
    surrogate_noise: Optional[float] = None,
    ucb_kappa: Optional[float] = None,
    seed: Optional[int] = None,
    checkpoint_dir: Optional[str] = None,
    resume: bool = True,
    cfg: Optional[_config.BOConfig] = None,
) -> BOResult:
    """Maximise a black-box ``objective`` (for example the LML as a
    function of a hyperparameter vector) over the box ``bounds``.

    ``surrogate_params_fn`` maps the evaluated points to the surrogate
    kernel's params (the CO2 pipeline keys its surrogate on the first point
    [ref: CO2_example.py:162]); the default surrogate is a unit RBF
    [ref: tune_hyperparms_regression.py:81-83]. Proposals that coincide
    with evaluated points are masked out (:func:`fresh_mask`), so each
    point is evaluated at most once; a box with no fresh candidate in four
    draws ends the search.

    ``checkpoint_dir``: after every evaluation, (points, values, generator
    state) are saved there by ``utils.checkpoint`` (step = iteration); with
    ``resume`` a stopped search continues from the last saved iteration
    without evaluating the objective again.
    """
    base = _config.DEFAULT_BO if cfg is None else cfg
    if n_iterations is None:
        n_iterations = base.n_iterations
    if n_candidates is None:
        n_candidates = base.n_candidates
    if acquisition is None:
        acquisition = base.acquisition
    if surrogate_noise is None:
        surrogate_noise = base.surrogate_noise
    if ucb_kappa is None:
        ucb_kappa = base.ucb_kappa
    if seed is None:
        seed = base.seed

    gen = torch.Generator().manual_seed(seed)
    pts = np.atleast_2d(np.asarray(initial_points, dtype=np.float64))
    d = pts.shape[1]
    start_iter = 0
    if checkpoint_dir is not None and resume:
        step = _ckpt.latest_step(checkpoint_dir)
        if step is not None:
            like = {"points": np.zeros((0, d)), "values": np.zeros((0,)),
                    "key": gen.get_state()}
            state = _ckpt.restore(checkpoint_dir, like, step=step)
            pts = np.atleast_2d(state["points"])
            vals = np.asarray(state["values"])
            gen.set_state(state["key"])
            start_iter = step
    if start_iter == 0:
        vals = np.array([float(objective(p)) for p in pts])
        if checkpoint_dir is not None:
            _ckpt.save(checkpoint_dir, {"points": pts, "values": vals,
                                        "key": gen.get_state()}, step=0)

    if surrogate_kernel is None:
        surrogate_kernel = _k.RBF()
        surrogate_params = surrogate_kernel.init_params()

    stopped = False
    it = start_iter
    last_pick: Optional[np.ndarray] = None
    for it in range(start_iter + 1, n_iterations + 1):
        fresh = np.zeros(0, dtype=bool)
        cands = np.zeros((0, d))
        for _attempt in range(4):  # draw again until fresh points appear
            cands = _default_candidates(gen, bounds, n_candidates, d)
            fresh = fresh_mask(cands, pts)
            if fresh.any():
                break
        if not fresh.any():  # box exhausted (tiny or discrete search spaces)
            stopped = True
            break

        sp = surrogate_params_fn(pts) if surrogate_params_fn else surrogate_params
        post = _surrogate_posterior(surrogate_kernel, sp, pts, vals, cands,
                                    float(surrogate_noise))
        std = torch.clamp(post.std, min=1e-12)
        best_y = float(np.max(vals))

        if acquisition == "PI":
            idx = acquisition_pi(post.mean, std, best_y, mask=fresh)
        elif acquisition == "EI":
            idx = acquisition_ei(post.mean, std, best_y, mask=fresh)
        elif acquisition == "UCB":
            idx = acquisition_ucb(post.mean, std, kappa=ucb_kappa, mask=fresh)
        elif acquisition == "TS":
            sample = _reg.sample_posterior(
                surrogate_kernel, _k.tree_map_params(_f64, sp), post, _f64(cands), gen,
                num_functions=1,
            )[:, 0]
            idx = acquisition_ts(sample, mask=fresh)
        else:
            raise ValueError(f"unknown acquisition {acquisition!r}")

        if idx is _STOP:
            stopped = True
            break
        pick = cands[idx]
        # UCB's stop rule: the same proposal twice ends the search
        # [ref: tune_hyperparms_regression.py:224-226]
        if last_pick is not None and np.allclose(pick, last_pick):
            stopped = True
            break
        last_pick = pick
        pts = np.vstack([pts, pick])
        vals = np.append(vals, float(objective(pick)))
        if checkpoint_dir is not None:
            _ckpt.save(checkpoint_dir, {"points": pts, "values": vals,
                                        "key": gen.get_state()}, step=it)

    best = int(np.argmax(vals))
    return BOResult(
        best_params=pts[best],
        best_value=float(vals[best]),
        points=pts,
        values=vals,
        iterations=it,
        stopped_early=stopped,
    )
