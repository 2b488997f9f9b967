"""The port's process mesh, sharded kernel blocks and ring matvec
(``gaussian_process_tpu_torch.parallel``) against the JAX package's on a
mesh of as many devices, with 1, 2 and 4 gloo ranks; and the analytic
communication model. The ranks run in subprocesses (tests/torch_parallel_ranks.py),
all cases in one start per group size."""

import dataclasses
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parallel_ranks as ranks
from gaussian_process_tpu import config as jax_config
from gaussian_process_tpu import ops, parallel
from gaussian_process_tpu.parallel import comm_model as jax_cm
from gaussian_process_tpu_torch import config as torch_config
from gaussian_process_tpu_torch import parallel as tparallel
from gaussian_process_tpu_torch.parallel import comm_model as torch_cm

WORLDS = (1, 2, 4)
CASES = {
    "layout": ("mesh_layout", {}),
    "gram": ("sharded_gram", dict(n=64, d=3, seed=0, kernel="rbf_white")),
    "ring": ("ring_matvec", dict(n=64, d=3, seed=0, kernel="rbf_white5", cols=0)),
    "ring_block": ("ring_matvec", dict(n=64, d=3, seed=1, kernel="rbf", cols=3)),
    "ring_small": ("ring_matvec", dict(n=32, d=3, seed=2, kernel="rbf", cols=0)),
}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return ranks.run_worlds(WORLDS, CASES, tmp_path_factory.mktemp("blocks"))


def _jax_mesh(p):
    return parallel.make_mesh(restart=1, data=p, devices=jax.devices()[:p])


def _jax_kernel(name):
    spec = ranks.kernel_spec(name)
    if name == "rbf":
        return ops.RBF(), jax.tree_util.tree_map(jnp.asarray, spec)
    return ops.RBF() + ops.White(), jax.tree_util.tree_map(jnp.asarray, spec)


def test_torch_mesh_config_matches_jax():
    fields = lambda cls: [(f.name, f.default) for f in dataclasses.fields(cls)]
    assert fields(torch_config.MeshConfig) == fields(jax_config.MeshConfig)
    assert torch_config.DEFAULT_MESH == torch_config.MeshConfig()


@pytest.mark.parametrize("P", WORLDS)
def test_torch_mesh_layout(runs, P):
    for r, res in enumerate(ranks.ok(runs[P]["layout"])):
        assert res["names"] == ["restart", "data"]
        assert res["shape"] == [1, P]
        assert res["cfg_shape"] == [P, 1] and res["restart_index"] == r
        assert "restart" in res["oversized"]
        np.testing.assert_array_equal(res["block"], np.arange(6.0 * r, 6.0 * r + 6).reshape(3, 2))
        np.testing.assert_array_equal(res["gathered"], np.arange(6.0 * P).reshape(3 * P, 2))
        np.testing.assert_array_equal(res["replicated"], [0.0, 0.0])  # rank 0's value
        assert res["padded"] == ([8, 2], 7, 0.0)


def test_torch_mesh_defaults_to_the_card():
    """``device=None`` means the card; without CUDA the mesh refuses rather
    than open a CPU group."""
    if torch.cuda.is_available():
        pytest.skip("CUDA is available here")
    with pytest.raises(RuntimeError, match="CUDA"):
        tparallel.make_mesh()
    assert not torch.distributed.is_initialized()


@pytest.mark.parametrize("P", WORLDS)
def test_torch_sharded_gram_matches_jax(runs, P):
    x, _ = ranks.data(64, 3, 0)
    k, p = _jax_kernel("rbf_white")
    want = np.asarray(parallel.sharded_gram(k, p, jnp.asarray(x), mesh=_jax_mesh(P)))
    for res in ranks.ok(runs[P]["gram"]):
        assert res["block_rows"] == 64 // P
        np.testing.assert_allclose(res["K"], want, rtol=1e-10)


@pytest.mark.parametrize("key,cols", [("ring", 0), ("ring_block", 3)])
@pytest.mark.parametrize("P", WORLDS)
def test_torch_ring_matvec_matches_jax(runs, P, key, cols):
    _, kw = CASES[key]
    x, _ = ranks.data(kw["n"], kw["d"], kw["seed"])
    v = np.random.default_rng(kw["seed"] + 1).standard_normal((kw["n"], cols) if cols else kw["n"])
    k, p = _jax_kernel(kw["kernel"])
    want = np.asarray(parallel.ring_matvec(k, p, jnp.asarray(x), jnp.asarray(v),
                                           mesh=_jax_mesh(P)))
    for res in ranks.ok(runs[P][key]):
        np.testing.assert_allclose(res["Kv"], want, rtol=1e-9, atol=1e-11)


def test_torch_ring_matvec_mesh_size_invariance(runs):
    one = ranks.ok(runs[1]["ring_small"])[0]["Kv"]
    for res in ranks.ok(runs[4]["ring_small"]):
        np.testing.assert_allclose(res["Kv"], one, rtol=1e-12)


@pytest.mark.parametrize("p,n,t,d", [(2, 1024, 16, 4), (8, 1024, 16, 4), (8, 2048, 32, 4),
                                     (4, 102400, 64, 4)])
def test_torch_comm_model_one_column_equals_jax(p, n, t, d):
    """At r = 1 the factor and solve move the JAX model's elements, each of
    8 bytes where the JAX model's are 4 (fp32 inputs factor and solve in
    float64 in the port), and p ring steps of the port's payload are the
    JAX model's iteration (the JAX ring moves p blocks a matvec, the
    port's p - 1)."""
    want = jax_cm.ici_comm_model(p, n, t, d)
    got = torch_cm.ici_comm_model(p, n, t, d, r=1)
    assert got["chol_bytes_per_device"] == 2 * want["chol_bytes_per_device"]
    assert got["solve_bytes_per_device"] == 2 * want["solve_bytes_per_device"]
    assert p * got["cg_ring_bytes_per_device_per_step"] == want["cg_ring_bytes_per_device_per_iter"]
    assert got["cg_ring_bytes_per_device_per_iter"] == (
        (p - 1) * got["cg_ring_bytes_per_device_per_step"])


@pytest.mark.parametrize("p,n", [(8, 1024), (4, 102400)])
def test_torch_comm_model_counts_the_rhs_width(p, n):
    """At r = 65 (make_posterior_cg with 64 test points) a ring step moves
    m * 64 more elements than the JAX model's one-column payload."""
    m, d, B = n // p, 4, 4
    jax_step = jax_cm.ici_comm_model(p, n, 64, d)["cg_ring_bytes_per_device_per_iter"] // p
    got = torch_cm.ici_comm_model(p, n, 64, d, r=65)
    assert got["cg_ring_bytes_per_device_per_step"] == jax_step + m * 64 * B


def test_torch_comm_model_takes_the_element_size_from_the_dtype():
    """The ring moves elements of the inputs' dtype; the factor and the
    solves elements of ``solve_dtype`` (float64 for fp32 and float64
    inputs, the dtype itself for half precision)."""
    f16 = torch_cm.ici_comm_model(4, 4096, 16, 4, r=9, dtype=torch.float16)
    f32 = torch_cm.ici_comm_model(4, 4096, 16, 4, r=9, dtype=torch.float32)
    f64 = torch_cm.ici_comm_model(4, 4096, 16, 4, r=9, dtype="float64")
    for key in ("cg_ring_bytes_per_device_per_step", "cg_ring_bytes_per_device_per_iter"):
        assert f64[key] == 2 * f32[key] == 4 * f16[key]
    for key in ("chol_bytes_per_device", "solve_bytes_per_device"):
        assert f64[key] == f32[key] == 4 * f16[key]
    assert torch_cm.ici_comm_model(1, 4096, 16, 4)["cg_ring_bytes_per_device_per_iter"] == 0


def test_torch_parallel_loads_no_jax():
    """The parallel package, and the rank helper that the multi-rank tests
    start, import neither JAX nor the JAX package."""
    code = (
        "import sys\n"
        "sys.path.insert(0, 'tests')\n"
        "import gaussian_process_tpu_torch.parallel, torch_parallel_ranks\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'gaussian_process_tpu' or m.startswith('gaussian_process_tpu.'))\n"
        "assert not bad, bad\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=ranks.REPO, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
