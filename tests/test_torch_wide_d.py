"""The port's matrix-free paths at a wide d (160 and 512), on the CPU,
against the JAX package, in float64.

The CUDA sweeps take any d (K2, K3 and both K4 sweeps stage x in slices
past the widths at which they hold it in registers or at full width); on
the CPU the port runs their plain versions, which these tests hold against
the JAX functions on the same NumPy inputs:

- ``gram_matvec`` (both sweeps, r = 1, 9, 65) against the Pallas
  ``gram_matvec`` in interpret mode, rtol 1e-9 (the float64 tolerance of
  tests/test_torch_kernel_ops.py);
- its VJP in the params and in x1 against the Pallas custom VJP, rtol 1e-6,
  atol 1e-10 (tests/test_torch_grad.py's);
- ``posterior_cg`` (mean rtol 1e-6, var rtol 1e-3), ``laplace_fit_cg`` +
  ``predict_binary_cg`` (f and prob rtol 1e-5, var rtol 1e-4), and one
  gradient of ``tune_large_scale``'s surrogate on the JAX package's probes
  (rtol 1e-6), with the tolerances of the narrow-d twins.

x spreads as 10 / sqrt(d), so squared distances are those of d = 4 at
spread 5: at the usual spread K would be nearly sigma^2 I and CG would stop
in one step.
"""

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gaussian_process_tpu import gp as jgp
from gaussian_process_tpu import ops as jops
from gaussian_process_tpu.opt import large_scale as jls
from gaussian_process_tpu.ops import pallas as pops
from gaussian_process_tpu_torch import convert
from gaussian_process_tpu_torch import gp as tgp
from gaussian_process_tpu_torch.ops import kernels as tk
from gaussian_process_tpu_torch.ops.cuda import kernel_ops as kops
from gaussian_process_tpu_torch.opt import large_scale as tls

WIDE_D = [160, 512]
RBF_PARAMS = {"sigma": 1.2, "lengthscale": 1.5}


def _x(rng, n, d):
    s = 10.0 / np.sqrt(d)
    return rng.uniform(-s, s, (n, d))


def _t(*arrays):
    return tuple(torch.tensor(np.asarray(a)) for a in arrays)


def _pairs(a, b):
    """Matching leaves of two params trees (dict keys matched by name)."""
    if isinstance(a, dict):
        for key in a:
            yield from _pairs(a[key], b[key])
    else:
        yield a, b


@pytest.mark.parametrize("d", WIDE_D)
@pytest.mark.parametrize("r", [1, 9, 65])
@pytest.mark.parametrize("symmetric", [True, False])
def test_matvec_matches_pallas_at_wide_d(d, r, symmetric):
    rng = np.random.default_rng(d + r)
    kernel = jops.Matern(nu=2.5) if r == 9 else jops.RBF()
    jparams = {"sigma": 1.1, "lengthscale": 1.3}
    x = _x(rng, 300, d)
    v = rng.standard_normal((300, r))
    want = np.asarray(pops.gram_matvec(kernel, jparams, x, None, v, tile_m=128, tile_n=128,
                                       interpret=True, dtype=jnp.float64, symmetric=symmetric))
    got = kops.gram_matvec(convert.kernel_from_reference(kernel),
                           convert.params_from_numpy(jparams), *_t(x), None, *_t(v),
                           symmetric=symmetric)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-9, atol=1e-12)


@pytest.mark.parametrize("d", WIDE_D)
def test_matvec_vjp_matches_pallas_at_wide_d(d):
    """The gradient in the params and in x1 of sum(w * K(x1, x2) V)."""
    rng = np.random.default_rng(d)
    kernel = jops.RBF()
    x1, x2 = _x(rng, 150, d), _x(rng, 130, d)
    v, w = rng.standard_normal((130, 9)), rng.standard_normal((150, 9))

    def loss(p, a):
        return jnp.sum(pops.gram_matvec(kernel, p, a, jnp.asarray(x2), jnp.asarray(v),
                                        tile_m=128, tile_n=128, interpret=True,
                                        dtype=jnp.float64) * w)

    jp = jax.tree_util.tree_map(jnp.asarray, RBF_PARAMS)
    want_p, want_x = jax.grad(loss, argnums=(0, 1))(jp, jnp.asarray(x1))
    tp = tk.tree_map_params(lambda a: a.requires_grad_(True),
                            convert.params_from_numpy(RBF_PARAMS, dtype=torch.float64))
    tx1 = torch.tensor(x1, requires_grad=True)
    out = kops.gram_matvec(convert.kernel_from_reference(kernel), tp, tx1, *_t(x2, v))
    torch.sum(out * torch.from_numpy(w)).backward()
    for t, g in _pairs(tp, want_p):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(g), rtol=1e-6, atol=1e-10)
    np.testing.assert_allclose(tx1.grad.numpy(), np.asarray(want_x), rtol=1e-6, atol=1e-10)


@pytest.mark.parametrize("d", WIDE_D)
def test_posterior_cg_matches_jax_at_wide_d(d):
    rng = np.random.default_rng(d + 1)
    kernel = jops.RBF()
    x, xs = _x(rng, 300, d), _x(rng, 21, d)
    y = np.sin(x.sum(axis=1) * np.sqrt(d) / 4) + 0.02 * rng.standard_normal(300)
    kw = dict(noise_variance=1e-2, tol=1e-10, test_chunk=16, precond_rank=128)
    want = jax.jit(lambda a, b, c: jgp.posterior_cg(kernel, RBF_PARAMS, a, b, c,
                                                    use_pallas=False, **kw))(x, y, xs)
    got = tgp.posterior_cg(convert.kernel_from_reference(kernel),
                           convert.params_from_numpy(RBF_PARAMS), *_t(x, y, xs),
                           use_kernel=True, **kw)
    assert got.iters > 1
    np.testing.assert_allclose(got.mean.numpy(), np.asarray(want.mean), rtol=1e-6, atol=1e-8)
    np.testing.assert_allclose(got.var.numpy(), np.asarray(want.var), rtol=1e-3, atol=1e-8)


@pytest.mark.parametrize("d", WIDE_D)
def test_binary_cg_matches_jax_at_wide_d(d):
    rng = np.random.default_rng(d + 2)
    kernel = jops.RBF()
    x, xt = _x(rng, 300, d), _x(rng, 40, d)
    y = np.where(np.sin(x.sum(axis=1) * np.sqrt(d) / 4) + 0.3 * rng.standard_normal(300) > 0,
                 1.0, -1.0)
    # jitted, as test_posterior_cg_matches_jax: the eager JAX loops spend
    # seconds dispatching
    jst = jax.jit(lambda a, b: jgp.laplace_fit_cg(kernel, RBF_PARAMS, a, b, precond_rank=64,
                                                  use_pallas=False))(x, y)
    jpred = jax.jit(lambda st, a, b: jgp.predict_binary_cg(kernel, RBF_PARAMS, st, a, b,
                                                           use_pallas=False))(jst, x, xt)
    tkernel = convert.kernel_from_reference(kernel)
    tparams = convert.params_from_numpy(RBF_PARAMS)
    st = tgp.laplace_fit_cg(tkernel, tparams, *_t(x, y), precond_rank=64, use_kernel=True)
    pred = tgp.predict_binary_cg(tkernel, tparams, st, *_t(x, xt), use_kernel=True)
    assert st.converged and st.iters == int(jst.iters) and st.inner_iters > 1
    np.testing.assert_allclose(st.f_mode.numpy(), np.asarray(jst.f_mode), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(pred.prob.numpy(), np.asarray(jpred.prob), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(pred.var.numpy(), np.asarray(jpred.var), rtol=1e-4, atol=1e-7)


@pytest.mark.parametrize("d", WIDE_D)
def test_large_scale_gradient_matches_jax_at_wide_d(d, monkeypatch):
    """One gradient of the surrogate that ``tune_large_scale`` ascends,
    through the port's matvec autograd Function (its plain backward sweep),
    on the JAX package's own Rademacher probes."""
    rng = np.random.default_rng(d + 3)
    kernel = jops.RBF()
    x = _x(rng, 250, d)
    y = np.sin(x.sum(axis=1) * np.sqrt(d) / 4) + 0.05 * rng.standard_normal(250)
    kw = dict(noise_variance=1e-2, num_probes=8, cg_tol=1e-11, cg_max_iters=2000,
              precond_rank=64)
    key = jax.random.key(7)
    jp = jax.tree_util.tree_map(jnp.asarray, RBF_PARAMS)
    want = jax.jit(jax.grad(lambda p: jls.lml_surrogate(
        kernel, p, jnp.asarray(x), jnp.asarray(y), key, use_pallas=False, **kw)))(jp)
    z = torch.tensor(np.asarray(jax.random.rademacher(key, (250, 8), dtype=jnp.float64)))
    monkeypatch.setattr(tls, "_rademacher", lambda shape, gen, like: z)
    tp = tk.tree_map_params(lambda a: a.requires_grad_(True),
                            convert.params_from_numpy(RBF_PARAMS, dtype=torch.float64))
    val = tls.lml_surrogate(convert.kernel_from_reference(kernel), tp, *_t(x, y),
                            use_kernel=True, **kw)
    val.backward()
    for t, g in _pairs(tp, want):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(g), rtol=1e-6)


@pytest.mark.parametrize("route,d,held_d,want", [
    (kops.OP_RBF, 4, kops.FULL_HELD_D, False), (kops.OP_RBF, 8, kops.FULL_HELD_D, False),
    (kops.OP_RBF, 9, kops.FULL_HELD_D, True), (kops.OP_MATERN32, 5, kops.FULL_HELD_D, False),
    (kops.OP_MATERN52, 8, kops.SYM_HELD_D, False), (kops.OP_MATERN52, 9, kops.SYM_HELD_D, True),
    (0, 8, kops.BWD_FULL_HELD_D, False), (0, 9, kops.BWD_SYM_HELD_D, True),
    (kops.OP_RBF, 5, kops.BWD_FULL_HELD_D, True), (kops.OP_RBF, 512, kops.BWD_SYM_HELD_D, True)])
def test_layout_is_full_width_where_it_fits(route, d, held_d, want):
    """The wrappers' layout by d: x in registers for a compiled leaf up to
    the widths its sweep compiles, at full width for the interpreter up to
    d = 8, sliced past them, whatever the sweep's shared memory."""
    assert kops.sliced_layout(route, d, held_d) is want


@pytest.mark.parametrize("d,sliced", [(8, 0), (9, 1)])
def test_full_sweep_counts_its_sliced_calls(d, sliced, monkeypatch):
    """Every K2 call counts in "gram_matvec_full"; one that the wrapper
    sends to the sliced layout (a compiled leaf past FULL_HELD_D) counts in
    "gram_matvec_full_sliced" too. The library is a stub that records the
    layout it is handed, so the count runs without a card."""
    handed = []

    class Lib:
        def gm_full_tc_x_width(self, route, d, sliced):
            return kops.X_SLICE if sliced else 8

        def gm_matvec_full_tc(self, *args):
            handed.append(args[-2])  # the layout, before the stream
            return 0

    counts = dict.fromkeys(kops.launch_counts, 0)
    monkeypatch.setattr(kops, "launch_counts", counts)
    monkeypatch.setattr(kops, "_check_cuda_f32", lambda **tensors: None)
    monkeypatch.setattr(kops, "_forward_args", lambda program, coef, x: (Lib(), x))
    monkeypatch.setattr(kops, "_stream", lambda device: None)
    monkeypatch.setattr(torch.cuda, "device", lambda device: contextlib.nullcontext())
    p = {"sigma": torch.tensor(1.0), "lengthscale": torch.tensor(2.0)}
    program, coefs = kops.encode(tk.RBF(), p)
    coef = kops.coef_vector(coefs, dtype=torch.float32, device="cpu")
    x = torch.zeros((130, d), dtype=torch.float32)
    kops.matvec_full_cuda(program, coef, x, x[:70], torch.zeros((70, 65)), need_l2=False)
    assert handed == [sliced]
    assert counts == {**dict.fromkeys(counts, 0), "gram_matvec_full": 1,
                      "gram_matvec_full_sliced": sliced}


@pytest.mark.parametrize("source,held_d,rule", [
    ("gram_matvec.cu", kops.FULL_HELD_D, "d <= 4 ? 4 : d <= {0} ? {0} : 0"),
    ("gram_matvec_sym.cu", kops.SYM_HELD_D, "d <= {0} ? {0} : 0"),
    ("gram_matvec_bwd_sym.cu", kops.BWD_SYM_HELD_D, "d <= {0} ? {0} : 0"),
    ("gram_matvec_bwd.cu", kops.BWD_FULL_HELD_D, "leaf != 0 && d <= {0} ? {0} : 0")])
def test_held_widths_match_the_kernels(source, held_d, rule):
    """The widest d a sweep's compiled leaf holds in registers, by which the
    wrapper picks the layout, is the one its source instantiates: past it
    the launcher finds no full-width instantiation and fails."""
    from pathlib import Path

    text = (Path(kops.__file__).resolve().parents[2] / "csrc" / source).read_text()
    assert rule.format(held_d) in text


def test_slice_width_matches_the_kernels():
    """X_SLICE, which sizes the wrappers' prescaled copies, is the kernels'
    (csrc/gram_matvec_slice.cuh)."""
    from pathlib import Path

    header = (Path(kops.__file__).resolve().parents[2] / "csrc"
              / "gram_matvec_slice.cuh").read_text()
    assert f"constexpr int X_SLICE = {kops.X_SLICE};" in header
