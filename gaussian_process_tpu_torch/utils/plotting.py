"""Diagnostic plots as files (torch counterpart of ``utils/plotting.py``).

The reference blocks on ``plt.show()`` windows; here every plot writes a file
(Agg backend, no display needed) and returns the path. Matplotlib is
imported when a plot is drawn, not with this module, so a machine without
it imports the package and gets ``ImportError`` only from a plot call.
Arguments may be tensors (on any device), arrays or sequences. Covered
figures:

- GP prior/posterior sample bands  [ref: GP_regression.py:218-265
  (plot_prior / plot_posterior), :159-201 (plot_true_diff)]
- kernel-matrix heatmap  [ref: GP_regression.py:204-215 (plot_kernel)]
- Newton error-decay curves  [ref: GP_multi_classification.py:168-175;
  commented variant GP_binary_classification.py:123-132]
- binary-classification scatter  [ref: GP_binary_classification.py:171-226,243-249]
- BO progress curves  [ref: tune_hyperparms_regression.py:200-272,
  CO2_example.py:373-379]
- CO2 extrapolation band  [ref: CO2_example.py:382-401 (plot_prediction)]
"""

from __future__ import annotations

import os
from typing import Optional, Sequence

import numpy as np
import torch


def _plt():
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def _np(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        a = a.detach().cpu().numpy()
    return np.asarray(a)


def _save(fig, path: str) -> str:
    os.makedirs(os.path.dirname(os.path.abspath(path)) or ".", exist_ok=True)
    fig.savefig(path, dpi=120, bbox_inches="tight")
    _plt().close(fig)
    return path


def plot_gp_band(
    x_test,
    mean,
    std,
    path: str,
    *,
    x_train=None,
    y_train=None,
    samples=None,
    true_fn=None,
    title: str = "GP posterior",
) -> str:
    """Posterior mean ± 2σ band with optional sampled paths and train points.

    [ref: GP_regression.py:233-265 (plot_posterior: mean line, ±2 stdev fill,
    sampled functions, training scatter)]
    """
    plt = _plt()
    x = _np(x_test).reshape(-1)
    order = np.argsort(x)
    x, mean, std = x[order], _np(mean)[order], _np(std)[order]
    fig, ax = plt.subplots(figsize=(8, 5))
    ax.fill_between(x, mean - 2 * std, mean + 2 * std, alpha=0.25, label="±2σ")
    ax.plot(x, mean, lw=2, label="posterior mean")
    if samples is not None:
        samp = _np(samples)[:, order] if np.ndim(samples) == 2 else _np(samples)[order][None]
        for s in samp:
            ax.plot(x, s, lw=0.7, alpha=0.6)
    if true_fn is not None:
        ax.plot(x, _np(true_fn(x[:, None])).reshape(-1), "k--", lw=1, label="true f")
    if x_train is not None:
        ax.plot(_np(x_train).reshape(-1), _np(y_train).reshape(-1), "r+", ms=12, label="train")
    ax.set_title(title)
    ax.legend(loc="best")
    return _save(fig, path)


def plot_kernel_matrix(K, path: str, *, title: str = "kernel matrix") -> str:
    """[ref: GP_regression.py:204-215 (plot_kernel imshow)]"""
    plt = _plt()
    fig, ax = plt.subplots(figsize=(5, 4))
    im = ax.imshow(_np(K), cmap="viridis")
    fig.colorbar(im, ax=ax)
    ax.set_title(title)
    return _save(fig, path)


def plot_convergence(errors: Sequence[float], path: str, *, title: str = "Newton convergence") -> str:
    """Error-decay curve. [ref: GP_multi_classification.py:168-175]"""
    plt = _plt()
    errs = _np([e for e in _np(errors).reshape(-1) if np.isfinite(e)])
    fig, ax = plt.subplots(figsize=(6, 4))
    ax.semilogy(np.arange(1, len(errs) + 1), errs, "o-")
    ax.set_xlabel("iteration")
    ax.set_ylabel("error")
    ax.set_title(title)
    return _save(fig, path)


def plot_classification_2d(
    X_train, y_train, X_test, y_pred, path: str, *, title: str = "GP classification"
) -> str:
    """Train scatter + predicted-label test scatter.

    [ref: GP_binary_classification.py:171-178,243-249 (train/test scatter)]
    """
    plt = _plt()
    fig, ax = plt.subplots(figsize=(6, 5))
    Xtr, Xte = _np(X_train), _np(X_test)
    ax.scatter(Xtr[:, 0], Xtr[:, 1], c=_np(y_train), cmap="coolwarm", marker="o",
               edgecolors="k", label="train")
    ax.scatter(Xte[:, 0], Xte[:, 1], c=_np(y_pred), cmap="coolwarm", marker="s",
               alpha=0.6, label="test (pred)")
    ax.set_title(title)
    ax.legend(loc="best")
    return _save(fig, path)


def plot_bo_progress(
    history_lml: Sequence[float], path: str, *, best_line: Optional[float] = None,
    title: str = "BO progress",
) -> str:
    """Best-so-far LML per BO iteration, with optional reference line.

    [ref: CO2_example.py:373-379 (per-acquisition LML curves vs book value)]
    """
    plt = _plt()
    h = _np(history_lml).astype(float)
    fig, ax = plt.subplots(figsize=(6, 4))
    ax.plot(np.arange(1, len(h) + 1), np.maximum.accumulate(h), "o-", label="best so far")
    ax.plot(np.arange(1, len(h) + 1), h, ".", alpha=0.5, label="per-iter")
    if best_line is not None:
        ax.axhline(best_line, color="k", ls="--", lw=1, label="reference")
    ax.set_xlabel("BO iteration")
    ax.set_ylabel("log marginal likelihood")
    ax.set_title(title)
    ax.legend(loc="best")
    return _save(fig, path)


def plot_acquisition_comparison(
    curves, path: str, *, best_line: Optional[float] = None,
    title: str = "BO acquisition comparison",
) -> str:
    """Best-so-far curves for several acquisitions on one axis — the
    reference's four-acquisition comparison figure [ref: CO2_example.py:
    373-379], except the four curves here really are PI/EI/UCB/TS (the
    reference's dispatcher always falls through to PI — quirk Q5).

    ``curves``: {label: sequence of best-so-far objective values}.
    """
    plt = _plt()
    fig, ax = plt.subplots(figsize=(6.5, 4.5))
    for label, h in curves.items():
        h = _np(h).astype(float)
        ax.plot(np.arange(1, len(h) + 1), h, "o-", label=label, ms=3)
    if best_line is not None:
        ax.axhline(best_line, color="k", ls="--", lw=1, label="book theta")
    ax.set_xlabel("objective evaluation")
    ax.set_ylabel("best log marginal likelihood so far")
    ax.set_title(title)
    ax.legend(loc="best")
    return _save(fig, path)
