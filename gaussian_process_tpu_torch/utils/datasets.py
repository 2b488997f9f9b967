"""The reference's datasets with fixed seeds, in NumPy only (torch
counterpart of ``utils/datasets.py``).

[ref: GP_regression.py:53-68 (sine + noise), GP_binary_classification.py:
13-32 (moons / circles / linsep), GP_multi_classification.py:200-211
(3 blobs), CO2_example.py:405-412 (Mauna Loa)]

The JAX package draws moons, circles, blobs and the linearly separable set
with scikit-learn, and splits and scales with it. This module reproduces
those draws on ``np.random.RandomState`` call for call (``_make_moons``,
``_make_circles``, ``_make_blobs``, ``_make_classification``,
``_train_test_split``, ``_standard_scale``), so the arrays equal the JAX
functions' arrays without scikit-learn, which the card's machine lacks.

The Mauna Loa series is this package's own copy of the JAX package's
vendored CSV (``data/mauna_loa_co2.csv``, the same bytes), reconstructed
from the public NOAA GML record; see the JAX package's
``data/make_mauna_loa.py`` for its provenance.
"""

from __future__ import annotations

import math
import os

import numpy as np

_DATA_DIR = os.path.join(os.path.dirname(os.path.dirname(__file__)), "data")

NOISE_VARIANCE = 5e-4  # [ref: GP_regression.py:58]


# ---------------------------------------------- scikit-learn's draws, in NumPy


def _shuffle(generator: np.random.RandomState, *arrays):
    """``sklearn.utils.shuffle``: one permutation of the rows of every array."""
    idx = np.arange(arrays[0].shape[0])
    generator.shuffle(idx)
    return tuple(a[idx] for a in arrays)


def _make_moons(n_samples: int = 100, *, noise=None, random_state=None):
    """``sklearn.datasets.make_moons`` (shuffled)."""
    generator = np.random.RandomState(random_state)
    n_out = n_samples // 2
    n_in = n_samples - n_out
    X = np.vstack([
        np.append(np.cos(np.linspace(0, np.pi, n_out)),
                  1 - np.cos(np.linspace(0, np.pi, n_in))),
        np.append(np.sin(np.linspace(0, np.pi, n_out)),
                  1 - np.sin(np.linspace(0, np.pi, n_in)) - 0.5),
    ]).T
    y = np.hstack([np.zeros(n_out, dtype=np.intp), np.ones(n_in, dtype=np.intp)])
    X, y = _shuffle(generator, X, y)
    if noise is not None:
        X += generator.normal(scale=noise, size=X.shape)
    return X, y


def _make_circles(n_samples: int = 100, *, noise=None, random_state=None,
                  factor: float = 0.8):
    """``sklearn.datasets.make_circles`` (shuffled)."""
    generator = np.random.RandomState(random_state)
    n_out = n_samples // 2
    n_in = n_samples - n_out
    t_out = np.linspace(0, 2 * np.pi, n_out, endpoint=False)
    t_in = np.linspace(0, 2 * np.pi, n_in, endpoint=False)
    X = np.vstack([np.append(np.cos(t_out), np.cos(t_in) * factor),
                   np.append(np.sin(t_out), np.sin(t_in) * factor)]).T
    y = np.hstack([np.zeros(n_out, dtype=np.intp), np.ones(n_in, dtype=np.intp)])
    X, y = _shuffle(generator, X, y)
    if noise is not None:
        X += generator.normal(scale=noise, size=X.shape)
    return X, y


def _make_blobs(n_samples: int = 100, n_features: int = 2, *, centers: int = 3,
                cluster_std: float = 1.0, center_box=(-10.0, 10.0), random_state=None):
    """``sklearn.datasets.make_blobs`` with an integer count of centres
    (shuffled)."""
    generator = np.random.RandomState(random_state)
    means = generator.uniform(center_box[0], center_box[1], size=(centers, n_features))
    per_center = [n_samples // centers] * centers
    for i in range(n_samples % centers):
        per_center[i] += 1
    X = np.empty((n_samples, n_features), dtype=np.float64)
    y = np.empty((n_samples,), dtype=int)
    start = 0
    for i, count in enumerate(per_center):
        X[start:start + count] = generator.normal(loc=means[i], scale=cluster_std,
                                                  size=(count, n_features))
        y[start:start + count] = i
        start += count
    return _shuffle(generator, X, y)


def _hypercube_vertices(samples: int, dimensions: int, generator) -> np.ndarray:
    """Distinct vertices of the unit hypercube: scikit-learn's
    ``_generate_hypercube``, whose ``sample_without_replacement`` takes a
    permutation's head when the sampled fraction lies in (0.01, 0.99), the
    only case reproduced here."""
    population = 2 ** dimensions
    if not 0.01 < samples / population < 0.99:
        raise ValueError("only a sampled fraction in (0.01, 0.99) is reproduced")
    out = generator.permutation(population)[:samples]
    bits = np.unpackbits(out.astype(">u4").view(">u1")).reshape((-1, 32))
    return bits[:, -dimensions:]


def _make_classification(n_samples: int = 100, n_features: int = 2, *,
                         n_informative: int = 2, n_redundant: int = 0,
                         n_clusters_per_class: int = 1, n_classes: int = 2,
                         flip_y: float = 0.01, class_sep: float = 1.0, random_state=None):
    """``sklearn.datasets.make_classification`` with every feature
    informative (``n_features == n_informative``, no redundant, repeated or
    noise features), equal class weights, the hypercube, no shift or scale,
    shuffled: the arguments of the reference's linearly separable set."""
    if n_redundant != 0 or n_features != n_informative:
        raise ValueError("only informative features are reproduced")
    generator = np.random.RandomState(random_state)
    n_clusters = n_classes * n_clusters_per_class
    per_cluster = [int(n_samples * (1.0 / n_classes) / n_clusters_per_class)
                   for _ in range(n_clusters)]
    for i in range(n_samples - sum(per_cluster)):
        per_cluster[i % n_clusters] += 1
    X = np.zeros((n_samples, n_features))
    y = np.zeros(n_samples, dtype=int)
    centroids = _hypercube_vertices(n_clusters, n_informative, generator).astype(float)
    centroids *= 2 * class_sep
    centroids -= class_sep
    X[:, :n_informative] = generator.standard_normal(size=(n_samples, n_informative))
    stop = 0
    for k, centroid in enumerate(centroids):
        start, stop = stop, stop + per_cluster[k]
        y[start:stop] = k % n_classes
        X_k = X[start:stop, :n_informative]
        A = 2 * generator.uniform(size=(n_informative, n_informative)) - 1
        X_k[...] = np.dot(X_k, A)
        X_k += centroid
    if flip_y >= 0.0:
        flip = generator.uniform(size=n_samples) < flip_y
        y[flip] = generator.randint(n_classes, size=flip.sum())
    X, y = _shuffle(generator, X, y)
    features = np.arange(n_features)
    generator.shuffle(features)
    X[:, :] = X[:, features]
    return X, y


def _train_test_split(X, y, *, test_size: float, random_state: int):
    """``sklearn.model_selection.train_test_split`` with a fractional test
    size: (X_train, X_test, y_train, y_test)."""
    n = X.shape[0]
    n_test = math.ceil(test_size * n)
    perm = np.random.RandomState(random_state).permutation(n)
    test, train = perm[:n_test], perm[n_test:]
    return X[train], X[test], y[train], y[test]


def _standard_scale(X: np.ndarray) -> np.ndarray:
    """``StandardScaler().fit_transform(X)``, with scikit-learn's
    two-pass corrected variance."""
    n = float(X.shape[0])
    mean = np.sum(X, axis=0) / n
    temp = X - mean
    correction = np.sum(temp, axis=0)
    var = (np.sum(temp ** 2, axis=0) - correction ** 2 / n) / n
    scale = np.sqrt(var)
    scale[scale < 10 * np.finfo(scale.dtype).eps] = 1.0
    return (X - mean) / scale


# ------------------------------------------------------------------ datasets


def sine_regression(n_train: int = 5, n_test: int = 100, *, seed: int = 0,
                    noise: float = NOISE_VARIANCE):
    """f(x) = sin(0.9 x) on [-5, 5] with Gaussian observation noise.

    [ref: GP_regression.py:53-68 (dataset_generator); N=5, n=100 at :301-302]
    Returns (true_fn, x_train (N,1), y_train (N,), x_test (n,1)).
    """
    rng = np.random.default_rng(seed)
    f = lambda x: np.sin(0.9 * np.asarray(x)).reshape(np.shape(x)[0], -1)[:, 0]  # noqa: E731
    x_train = rng.uniform(-5, 5, size=(n_train, 1))
    y_train = f(x_train) + np.sqrt(noise) * rng.standard_normal(n_train)
    x_test = np.linspace(-5, 5, n_test).reshape(-1, 1)
    return f, x_train, y_train, x_test


def moons_binary(*, noise: float = 0.3, test_size: float = 0.4, seed: int = 0):
    """Two moons with {-1, +1} labels, standardised, 60/40 split:
    (X_train, X_test, y_train, y_test).

    [ref: GP_binary_classification.py:13-32,160-161 (make_moons(noise=.3,
    random_state=0), StandardScaler, train_test_split random_state=42)]
    """
    X, y = _make_moons(noise=noise, random_state=seed)
    y = np.where(y == 0, -1, 1)
    return _train_test_split(_standard_scale(X), y, test_size=test_size, random_state=42)


def binary_dataset(kind: str = "moons", *, test_size: float = 0.4, seed: int = 0):
    """The reference's three binary datasets: moons / circles / linsep,
    labels in {-1, +1}, standardised, 60/40 split.

    [ref: GP_binary_classification.py:13-32]
    """
    if kind == "moons":
        X, y = _make_moons(noise=0.3, random_state=seed)
    elif kind == "circles":
        X, y = _make_circles(noise=0.2, factor=0.5, random_state=1)
    elif kind == "linsep":
        X, y = _make_classification(n_features=2, n_redundant=0, n_informative=2,
                                    random_state=1, n_clusters_per_class=1)
        X += 2 * np.random.default_rng(2).uniform(size=X.shape)
    else:
        raise ValueError(f"unknown binary dataset {kind!r}")
    y = np.where(y == 0, -1, 1)
    return _train_test_split(_standard_scale(X), y, test_size=test_size, random_state=42)


def blobs_multiclass(*, centers: int = 3, n_samples: int = 100, test_size: float = 0.4,
                     seed: int = 7):
    """Gaussian blobs, C classes, 60/40 split.

    [ref: GP_multi_classification.py:200-211 (make_blobs(centers=3)),
    :221-222 (train_test_split random_state=42)]
    """
    X, y = _make_blobs(n_features=2, centers=centers, n_samples=n_samples,
                       random_state=seed)
    return _train_test_split(X, y, test_size=test_size, random_state=42)


def mauna_loa(*, center: bool = True):
    """(x_train (n,1) year, y_train (n,) CO2 ppm [mean-centred], mean).

    [ref: CO2_example.py:405-412: X = data[:, [1]] (time), y = data[:, 0],
    y mean-centred]
    """
    data = np.loadtxt(os.path.join(_DATA_DIR, "mauna_loa_co2.csv"), delimiter=",",
                      skiprows=1)
    x = data[:, [0]]
    y = data[:, 1]
    mean = float(y.mean())
    if center:
        y = y - mean
    return x, y, mean


def mauna_loa_test_grid(x_train: np.ndarray, years: int = 20) -> np.ndarray:
    """Monthly extrapolation grid for ``years`` past the last training year.

    [ref: CO2_example.py:408 (np.arange(max//1+1, max//1+21, 1/12))]
    """
    start = np.floor(x_train.max()) + 1
    return np.arange(start, start + years, 1.0 / 12.0)[:, None]


def large_scale_regression(n: int, d: int = 8, *, seed: int = 0, noise: float = 1e-2):
    """Synthetic large-n regression for the scaling runs (fp32)."""
    rng = np.random.default_rng(seed)
    x = rng.uniform(-5, 5, size=(n, d)).astype(np.float32)
    w = rng.standard_normal(d).astype(np.float32)
    y = np.sin(x @ w) + np.sqrt(noise) * rng.standard_normal(n).astype(np.float32)
    return x, y.astype(np.float32)
