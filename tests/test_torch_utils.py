"""The port's ``utils`` (datasets, logging, checkpoint, profiling,
plotting) against the JAX package's, on the CPU: the datasets equal the
JAX functions' arrays (which draw with scikit-learn), the vendored CSV is
byte-equal, and a checkpoint written by either package restores in the
other."""

import filecmp
import json
import os
import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gaussian_process_tpu.utils import checkpoint as jcheckpoint
from gaussian_process_tpu.utils import datasets as jdatasets
from gaussian_process_tpu_torch import gp as tgp
from gaussian_process_tpu_torch import ops as tops
from gaussian_process_tpu_torch.utils import checkpoint, datasets, plotting, profiling
from gaussian_process_tpu_torch.utils.logging import JsonlLogger, read_jsonl

ROOT = pathlib.Path(__file__).resolve().parents[1]


# ---------------------------------------------------------------- datasets


@pytest.mark.parametrize("name,kwargs", [
    ("moons_binary", {}),
    ("binary_dataset", {"kind": "moons"}),
    ("binary_dataset", {"kind": "circles"}),
    ("binary_dataset", {"kind": "linsep"}),
    ("blobs_multiclass", {}),
    ("blobs_multiclass", {"centers": 4, "n_samples": 203, "seed": 3}),
])
def test_datasets_equal_the_jax_package_arrays(name, kwargs):
    want = getattr(jdatasets, name)(**kwargs)
    got = getattr(datasets, name)(**kwargs)
    assert len(got) == len(want) == 4
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)


def test_datasets_regression_and_co2_equal_the_jax_package():
    _, *got = datasets.sine_regression(7, 30, seed=2)
    _, *want = jdatasets.sine_regression(7, 30, seed=2)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    for g, w in zip(datasets.large_scale_regression(64, 3, seed=1),
                    jdatasets.large_scale_regression(64, 3, seed=1)):
        np.testing.assert_array_equal(g, w)
    x, y, mean = datasets.mauna_loa()
    assert x.shape == (526, 1) and abs(y.mean()) < 1e-6 and mean > 300
    np.testing.assert_array_equal(datasets.mauna_loa_test_grid(x, years=20),
                                  jdatasets.mauna_loa_test_grid(x, years=20))
    np.testing.assert_array_equal(datasets.mauna_loa(center=False)[1],
                                  jdatasets.mauna_loa(center=False)[1])


def test_mauna_loa_csv_is_a_byte_equal_copy():
    port = ROOT / "gaussian_process_tpu_torch" / "data" / "mauna_loa_co2.csv"
    ref = ROOT / "gaussian_process_tpu" / "data" / "mauna_loa_co2.csv"
    assert filecmp.cmp(port, ref, shallow=False)


def test_mauna_loa_generator_writes_the_vendored_csv(tmp_path):
    """The port's generator writes the port's CSV byte for byte (and that CSV
    is the JAX package's, above); it imports neither numpy nor torch."""
    from gaussian_process_tpu_torch.data import make_mauna_loa

    out = tmp_path / "co2.csv"
    make_mauna_loa.main(str(out))
    port = ROOT / "gaussian_process_tpu_torch" / "data" / "mauna_loa_co2.csv"
    assert out.read_bytes() == port.read_bytes()
    assert len(make_mauna_loa.rows()) == 526
    src = (ROOT / "gaussian_process_tpu_torch" / "data" / "make_mauna_loa.py").read_text()
    assert "numpy" not in src.split('"""')[2] and "torch" not in src.split('"""')[2]


def test_datasets_draw_without_sklearn():
    """The module reads nothing of scikit-learn (the card's machine has
    none)."""
    src = (ROOT / "gaussian_process_tpu_torch" / "utils" / "datasets.py").read_text()
    assert "import sklearn" not in src and "from sklearn" not in src


# ----------------------------------------------------------------- logging


def test_jsonl_logger_round_trip(tmp_path):
    path = str(tmp_path / "run.jsonl")
    with JsonlLogger(path) as log:
        log.newton_step(1, 0.5)
        log.newton_step(2, torch.tensor(0.25))
        log.bo_step(1, best_lml=-3.2, candidate=torch.tensor([1.0, 2.0], dtype=torch.float64))
        log.log("arrays", v=np.array([3, 4]), s=np.float32(0.5), nested={"t": torch.ones(2)})
    records = read_jsonl(path)
    assert [r["event"] for r in records] == ["newton_step", "newton_step", "bo_step", "arrays"]
    assert records[1]["error"] == 0.25
    assert records[2]["candidate"] == [1.0, 2.0]
    assert records[3]["v"] == [3, 4] and records[3]["nested"] == {"t": [1.0, 1.0]}
    assert all(r["rank"] == 0 and r["logger"] == "gp" for r in records)


# -------------------------------------------------------------- checkpoint


def _tree():
    return {
        "theta": {"sigma": torch.tensor(1.5, dtype=torch.float32), "l": torch.tensor(0.7)},
        "alpha": torch.arange(8, dtype=torch.float32),
        "step": 3,
        "pair": (torch.ones(2, 3, dtype=torch.float64), None, np.arange(4)),
        "flag": True,
    }


def test_checkpoint_round_trip(tmp_path):
    tree = _tree()
    path = checkpoint.save(str(tmp_path / "ckpt"), tree)
    like = {**tree, "alpha": torch.zeros(8, dtype=torch.float64), "step": 0, "flag": False}
    got = checkpoint.restore(path, like)
    assert list(got) == list(tree)
    assert got["alpha"].dtype == torch.float64
    np.testing.assert_array_equal(got["alpha"].numpy(), np.arange(8))
    assert got["step"] == 3 and isinstance(got["step"], int) and got["flag"] is True
    assert got["pair"][1] is None and torch.equal(got["pair"][0], tree["pair"][0])
    assert float(got["theta"]["sigma"]) == 1.5
    with pytest.raises(ValueError, match="leaves"):
        checkpoint.restore(path, {"alpha": torch.zeros(8)})


def test_checkpoint_steps_and_latest(tmp_path):
    root = str(tmp_path / "run")
    assert checkpoint.latest_step(root) is None
    for s in (1, 5, 12):
        checkpoint.save(root, {"x": torch.full((3,), float(s))}, step=s)
    assert checkpoint.latest_step(root) == 12
    got = checkpoint.restore(root, {"x": torch.zeros(3)}, step=12)
    assert torch.equal(got["x"], torch.full((3,), 12.0))


def test_checkpoint_written_by_jax_restores_in_the_port(tmp_path):
    tree = {"points": np.arange(6.0).reshape(3, 2), "values": jnp.asarray([0.5, 1.5, 2.5]),
            "key": jnp.asarray([7, 9], jnp.uint32), "nested": ({"b": 2.0, "a": 1}, None)}
    path = jcheckpoint.save(str(tmp_path / "jax"), tree, step=4)
    like = {"points": np.zeros((0, 2)), "values": torch.zeros(3, dtype=torch.float64),
            "key": torch.zeros(2, dtype=torch.int64), "nested": ({"b": 0.0, "a": 0}, None)}
    got = checkpoint.restore(str(tmp_path / "jax"), like, step=checkpoint.latest_step(
        str(tmp_path / "jax")))
    assert path.endswith("step_00000004")
    np.testing.assert_array_equal(got["points"], tree["points"])
    assert torch.equal(got["values"], torch.tensor([0.5, 1.5, 2.5], dtype=torch.float64))
    assert got["key"].tolist() == [7, 9] and got["nested"][0] == {"b": 2.0, "a": 1}


def test_checkpoint_written_by_the_port_restores_in_jax(tmp_path):
    snaps = []
    x = torch.tensor(np.random.default_rng(0).uniform(-3, 3, (40, 1)))
    y = torch.sin(x[:, 0])
    tgp.posterior_cg_segmented(tops.RBF(), {"sigma": torch.tensor(1.0, dtype=torch.float64),
                                            "lengthscale": torch.tensor(1.0, dtype=torch.float64)},
                               x, y, x[:6] + 0.1, noise_variance=1e-2, tol=1e-8,
                               segment_iters=3, test_chunk=4, snapshot_cb=snaps.append)
    snap = [s for s in snaps if s.chunk == 1][0]
    path = checkpoint.save(str(tmp_path / "port"), snap)
    import jax

    like = jax.tree_util.tree_map(lambda a: jnp.zeros_like(jnp.asarray(
        a.numpy() if isinstance(a, torch.Tensor) else a)), snap)
    got = jcheckpoint.restore(path, like)
    np.testing.assert_array_equal(np.asarray(got.state.x), snap.state.x.numpy())
    np.testing.assert_array_equal(np.asarray(got.alpha), snap.alpha.numpy())
    assert int(got.total_iters) == snap.total_iters and int(got.n) == 40


def test_checkpoint_saved_shard_by_shard_by_jax_restores_in_both(tmp_path, monkeypatch):
    """A leaf that the JAX package saved shard by shard (its layout for an
    array no single process can address whole; forced here on a one-process
    mesh of 4 CPU devices): both packages assemble it densely where this
    rank's file covers it, and both refuse a file that holds only part."""
    import json

    import jax
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

    arr = np.arange(32.0).reshape(8, 4)
    mesh = Mesh(np.asarray(jax.devices()[:4]).reshape(2, 2), ("a", "b"))
    tree = {"K": jax.device_put(jnp.asarray(arr), NamedSharding(mesh, P("a", "b"))),
            "step": np.asarray(3)}
    monkeypatch.setattr(jcheckpoint, "_is_global_sharded",
                        lambda leaf: isinstance(leaf, jax.Array) and leaf.ndim == 2)
    path = jcheckpoint.save(str(tmp_path / "sharded"), tree)
    manifest_path = os.path.join(path, "manifest.json")
    with open(manifest_path) as fh:
        manifest = json.load(fh)
    assert manifest["leaves"][0]["shard_keys"] == ["0:4,0:2", "0:4,2:4", "4:8,0:2", "4:8,2:4"]

    want = jcheckpoint.restore(path, {"K": np.zeros((8, 4)), "step": np.asarray(0)})
    got = checkpoint.restore(path, {"K": torch.zeros(8, 4, dtype=torch.float64), "step": 0})
    np.testing.assert_array_equal(want["K"], arr)
    assert torch.equal(got["K"], torch.from_numpy(arr)) and got["step"] == 3

    manifest["leaves"][0]["shard_keys"] = manifest["leaves"][0]["shard_keys"][:3]
    with open(manifest_path, "w") as fh:
        json.dump(manifest, fh)
    for restore, like in ((jcheckpoint.restore, {"K": np.zeros((8, 4)), "step": np.asarray(0)}),
                          (checkpoint.restore, {"K": torch.zeros(8, 4), "step": 0})):
        with pytest.raises(ValueError, match="leaf 0: this rank's checkpoint holds only part "
                                             "of the sharded array"):
            restore(path, like)


def test_dataset_cache(tmp_path):
    path = str(tmp_path / "cache.npz")
    assert checkpoint.load_dataset_cache(path) is None
    X = np.random.default_rng(0).standard_normal((10, 2))
    checkpoint.save_dataset_cache(path, X=X, y=np.arange(10))
    out = checkpoint.load_dataset_cache(path)
    np.testing.assert_array_equal(out["X"], X)
    np.testing.assert_array_equal(out["y"], np.arange(10))


# --------------------------------------------------------------- profiling


def test_time_fn_and_device_time_chained_on_the_host_clock():
    x = torch.ones((128, 128))
    stats = profiling.time_fn(lambda a: (a @ a.T).sum(), x, warmup=1, iters=3)
    assert stats["iters"] == 3
    assert 0 < stats["min_s"] <= stats["mean_s"] < 5.0
    chained = profiling.device_time_chained(lambda c: c @ x * 1e-3, x, repeats=4, trials=2)
    assert chained["repeats"] == 4 and len(chained["trials_s"]) == 2
    assert chained["device_s"] > 0 and chained["t_2r_s"] > 0


def test_compile_cache_points_the_kernel_build_at_its_directory(tmp_path, monkeypatch):
    """``enable_persistent_compile_cache(dir)`` makes the CUDA build look in
    and write to ``dir``; with no argument the package's ``_build/``."""
    from gaussian_process_tpu_torch.ops.cuda import _build

    monkeypatch.setattr(_build, "BUILD_DIR", _build.BUILD_DIR)
    monkeypatch.setattr(_build, "build_info", {})
    profiling.enable_persistent_compile_cache(str(tmp_path / "cache"))
    assert _build.BUILD_DIR == tmp_path / "cache"
    # a library for these exact sources is loaded from there, not rebuilt
    (tmp_path / "cache").mkdir()
    lib = tmp_path / "cache" / f"libgp_kernels_{_build._digest()}.so"
    lib.write_bytes(b"")
    assert _build.build() == lib
    # and a build writes there: it makes the directory before it asks for nvcc
    profiling.enable_persistent_compile_cache(str(tmp_path / "fresh"))

    def no_nvcc():
        raise RuntimeError("no nvcc in this test")

    monkeypatch.setattr(_build, "nvcc_path", no_nvcc)
    with pytest.raises(RuntimeError, match="no nvcc in this test"):
        _build.build()
    assert (tmp_path / "fresh").is_dir()
    profiling.enable_persistent_compile_cache()
    assert _build.BUILD_DIR == _build.DEFAULT_BUILD_DIR == (
        ROOT / "gaussian_process_tpu_torch" / "_build")


@pytest.mark.parametrize("example", sorted(
    f.stem for f in (ROOT / "examples_torch").glob("*.py")))
def test_examples_enable_the_compile_cache_first(example):
    """Each example's ``main`` calls the cache first, as each JAX example
    does."""
    import ast

    tree = ast.parse((ROOT / "examples_torch" / f"{example}.py").read_text())
    main = next(f for f in tree.body if isinstance(f, ast.FunctionDef) and f.name == "main")
    first = main.body[0]
    assert isinstance(first, ast.Expr) and isinstance(first.value, ast.Call)
    assert ast.unparse(first.value.func) == "profiling.enable_persistent_compile_cache"


def test_stopwatch_phases_and_trace(tmp_path):
    """The phases of a traced block are the port's spans: each lands in
    ``profiling.trace``'s Chrome trace as a user annotation, once a use."""
    with profiling.trace(str(tmp_path / "trace")) as prof:
        for name in ("gp.build", "gp.build", "gp.solve"):
            with profiling.span(name):
                torch.ones(64, 64) @ torch.ones(64, 64)
    events = json.loads((tmp_path / "trace" / "trace.json").read_text())["traceEvents"]
    names = [e["name"] for e in events if e.get("cat") == "user_annotation"]
    assert names.count("gp.build") == 2 and names.count("gp.solve") == 1
    counts = {e.key: e.count for e in prof.key_averages()}
    assert counts["gp.build"] == 2 and counts["gp.solve"] == 1


# ---------------------------------------------------------------- plotting


def test_plots_write_each_figure(tmp_path):
    pytest.importorskip("matplotlib")
    f, xtr, ytr, xte = datasets.sine_regression(5, 50, seed=0)
    kernel = tops.RBF()
    params = kernel.init_params()
    post = tgp.posterior(kernel, params, *(torch.tensor(a) for a in (xtr, ytr, xte)),
                         noise_variance=5e-4)
    paths = [
        plotting.plot_gp_band(xte, post.mean, post.std, str(tmp_path / "band.png"),
                              x_train=xtr, y_train=ytr, true_fn=f, samples=post.mean[None]),
        plotting.plot_kernel_matrix(tops.gram(kernel, params, torch.tensor(xtr)),
                                    str(tmp_path / "K.png")),
        plotting.plot_convergence(torch.tensor([1.0, 0.1, 1e-3, float("nan")]),
                                  str(tmp_path / "conv.png")),
        plotting.plot_bo_progress([-5.0, -3.0, -4.0], str(tmp_path / "bo.png"),
                                  best_line=-2.5),
        plotting.plot_acquisition_comparison({"PI": [1.0, 2.0], "EI": np.array([0.5, 3.0])},
                                             str(tmp_path / "acq.png"), best_line=2.5),
    ]
    Xtr, Xte, ytr2, yte2 = datasets.moons_binary()
    paths.append(plotting.plot_classification_2d(Xtr, ytr2, Xte, yte2,
                                                 str(tmp_path / "cls.png")))
    for p in paths:
        assert os.path.exists(p) and os.path.getsize(p) > 0
