"""The tile gram (K1) and its differentiable wrapper (K5) of the port,
against the JAX package, in float64 on the CPU.

- The tile gram's plain version (``ops.cuda.kernel_ops.gram_reference``, the
  plain ``ops.gram``) against the Pallas ``gram`` run in interpret mode in
  float64, and the CUDA kernel's own arithmetic (its postfix program on
  direct differences of centred inputs, White on the diagonal) against the
  same: rtol 1e-9 (the two form the squared distance differently, which
  costs a few ulps of the inputs' squared spread).
- ``gram_ad``'s gradients in float64 against ``jax.grad`` through the XLA
  gram, which is what the JAX ``gram_ad``'s backward differentiates: rtol
  1e-9; and in float32 against ``jax.grad`` through the JAX ``gram_ad``
  itself: rtol 1e-4, as ``TestGramAD`` holds it.
- The dispatcher takes the plain gram on a CPU tensor, and a CUDA-only
  wrapper refuses a CPU tensor.
The tile gram itself runs only on the card (``tests/test_torch_cuda.py``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gaussian_process_tpu import ops as jops
from gaussian_process_tpu.ops import pallas as pops
from gaussian_process_tpu_torch import convert
from gaussian_process_tpu_torch.ops import kernels as tk
from gaussian_process_tpu_torch.ops.cuda import kernel_ops as kops

BOOK = np.array([66, 67, 2.4, 90, 1.3, 0.66, 1.2, 0.78, 0.18, 1.6, 0.19])

CASES = {
    "rbf": (jops.RBF(), {"sigma": 1.5, "lengthscale": 0.8}),
    "matern12": (jops.Matern(nu=0.5), {"sigma": 1.2, "lengthscale": 0.9}),
    "matern32": (jops.Matern(nu=1.5), {"sigma": 1.2, "lengthscale": 0.9}),
    "matern52": (jops.Matern(nu=2.5), {"sigma": 1.2, "lengthscale": 0.9}),
    "periodic": (jops.Periodic(), {"period": 1.7, "lengthscale": 0.9}),
    "rq": (jops.RationalQuadratic(), {"amplitude": 0.9, "lengthscale": 1.4, "alpha": 0.6}),
    "rbf_white": (jops.RBF() + jops.White(),
                  ({"sigma": 1.0, "lengthscale": 1.1}, {"amplitude": 0.3})),
    "co2": (jops.co2_kernel(), jops.co2_params_from_vector(jnp.asarray(BOOK))),
}
SHAPES = [(300, 200, 3), (256, 256, 1), (40, 513, 7)]  # TestPallasGram's


def _port(name):
    jkernel, jparams = CASES[name]
    return (jkernel, jparams, convert.kernel_from_reference(jkernel),
            convert.params_from_numpy(jparams, dtype=torch.float64))


def _x(rng, n, d, scale=5.0):
    return rng.uniform(-scale, scale, size=(n, d))


def _pallas(jkernel, jparams, a, b=None):
    return np.asarray(pops.gram(jkernel, jparams, jnp.asarray(a),
                                None if b is None else jnp.asarray(b),
                                interpret=True, dtype=jnp.float64))


def _program_gram(kernel, params, a, b=None):
    """The CUDA tile gram's arithmetic, op for op, in float64: centre on
    mean(x1), direct squared differences, the postfix program, White's
    coefficient on the diagonal of a same-set gram."""
    x1 = torch.from_numpy(a)
    c = torch.mean(x1, dim=0, keepdim=True)
    x1c = x1 - c
    x2c = x1c if b is None else torch.from_numpy(b) - c
    program, coefs, white_idx = kops.gram_program(kernel, params, b is None)
    coef = kops.coef_vector(coefs, dtype=torch.float64, device="cpu")
    sq = sum((x1c[:, k:k + 1] - x2c[None, :, k]) ** 2 for k in range(x1c.shape[1]))
    K = kops.eval_program(program, coef, sq)
    if white_idx >= 0:
        K = K + coef[white_idx] * torch.eye(K.shape[0], dtype=K.dtype)
    return K


@pytest.mark.parametrize("name", sorted(CASES))
@pytest.mark.parametrize("n,m,d", SHAPES)
def test_plain_gram_matches_pallas_cross_set(rng, name, n, m, d):
    jkernel, jparams, tkernel, tparams = _port(name)
    a, b = _x(rng, n, d), _x(rng, m, d)
    want = _pallas(jkernel, jparams, a, b)
    got = kops.gram_reference(tkernel, tparams, torch.from_numpy(a), torch.from_numpy(b))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-9, atol=1e-12)
    np.testing.assert_allclose(_program_gram(tkernel, tparams, a, b).numpy(), want,
                               rtol=1e-9, atol=1e-12)


@pytest.mark.parametrize("name", sorted(CASES))
def test_plain_gram_matches_pallas_same_set(rng, name):
    """Same-set: White's variance on the diagonal (rbf_white, co2), and the
    zero-distance diagonal of every other family."""
    jkernel, jparams, tkernel, tparams = _port(name)
    a = _x(rng, 200, 2)
    want = _pallas(jkernel, jparams, a)
    got = kops.gram_reference(tkernel, tparams, torch.from_numpy(a))
    # on the diagonal the norm expansion leaves a squared distance of a few
    # ulps of |x|^2 (about 1e-14) where direct differences give 0; a family
    # that reads l2 = sqrt(sq) linearly (Matern 1/2, the periodic ones) turns
    # that into about 1e-7
    atol = 1e-6 if tk.needs_l2(tkernel) else 1e-12
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-9, atol=atol)
    np.testing.assert_allclose(_program_gram(tkernel, tparams, a).numpy(), want,
                               rtol=1e-9, atol=atol)


def test_gram_program_places_white():
    kernel = tk.Sum(children=(tk.RBF(), tk.White(), tk.Matern(nu=1.5), tk.White()))
    params = convert.params_from_numpy(({"sigma": 1.0, "lengthscale": 1.0},
                                        {"amplitude": 0.5}, {"sigma": 1.0, "lengthscale": 1.0},
                                        {"amplitude": 0.2}))
    program, coefs, white_idx = kops.gram_program(kernel, params, same=True)
    assert white_idx == len(coefs) - 1 == 4
    np.testing.assert_allclose(float(coefs[white_idx]), 0.25 + 0.04, rtol=1e-15)
    assert kops.gram_program(kernel, params, same=False)[2] == -1
    # a pure-White same-set gram: a zero program plus the diagonal
    program, coefs, white_idx = kops.gram_program(tk.White(), {"amplitude": 0.5}, same=True)
    assert program == [(kops.OP_ZERO, 0)] and white_idx == 0


@pytest.mark.parametrize("kernel,nested", [
    (tk.RBF(), False),
    (tk.RBF() + tk.White(), False),
    (tk.White(), False),
    (tk.RBF() * tk.White(), True),
    (tk.Scaled(base=tk.White()), True),
    (tk.Sum(children=(tk.RBF() + tk.White(), tk.RBF())), True),
])
def test_nested_white_rule(kernel, nested):
    assert kops.nested_white(kernel) == nested


# (case, same-set): x-gradients of a same-set Matern or Periodic gram pass
# sqrt through the zero diagonal (NaN in both packages), so those cases
# differentiate cross-set
GRAD_CASES = [("rbf", True), ("rbf", False), ("rbf_white", True), ("matern52", False),
              ("periodic", False), ("rq", True), ("co2", False)]


def _port_grads(tkernel, tparams, a, b, w, dtype):
    p = tk.tree_map_params(lambda t: t.to(dtype).clone().requires_grad_(True), tparams)
    x1 = torch.from_numpy(a).to(dtype).requires_grad_(True)
    x2 = None if b is None else torch.from_numpy(b).to(dtype).requires_grad_(True)
    out = kops.gram_ad(tkernel, p, x1, x2)
    # the CPU forward is the plain gram
    np.testing.assert_allclose(out.detach().numpy(),
                               kops.gram_reference(tkernel, p, x1, x2).detach().numpy(),
                               rtol=0, atol=0)
    inputs = [*tk.tree_leaves(p), x1] + ([] if b is None else [x2])
    return torch.autograd.grad(torch.sum(torch.from_numpy(w).to(dtype) * out), inputs)


def _jax_grads(gram_fn, jparams, a, b, w, dtype):
    def loss(p, x1, x2):
        return jnp.sum(jnp.asarray(w, dtype) * gram_fn(p, x1, x2))

    p = jax.tree_util.tree_map(lambda v: jnp.asarray(v, dtype), jparams)
    argnums = (0, 1) if b is None else (0, 1, 2)
    g = jax.grad(loss, argnums=argnums)(p, jnp.asarray(a, dtype),
                                        None if b is None else jnp.asarray(b, dtype))
    # the params gradient's leaves in the port's order (JAX sorts dict keys)
    return [*tk.tree_leaves(_in_order(g[0], jparams)), *g[1:]]


def _in_order(tree, like):
    """``tree`` rebuilt with the key order of ``like``."""
    if isinstance(like, dict):
        return {k: _in_order(tree[k], v) for k, v in like.items()}
    if isinstance(like, (tuple, list)):
        return type(like)(_in_order(t, v) for t, v in zip(tree, like))
    return tree


@pytest.mark.parametrize("name,same", GRAD_CASES)
def test_gram_ad_gradients_match_jax(rng, name, same):
    """In float64 against ``jax.grad`` through the XLA gram, which is what
    the JAX ``gram_ad``'s backward differentiates (its float32 Pallas
    forward refuses a float64 cotangent): rtol 1e-9."""
    jkernel, jparams, tkernel, tparams = _port(name)
    a = _x(rng, 32, 2)
    b = None if same else _x(rng, 21, 2)
    w = rng.standard_normal((32, 32 if same else 21))
    got = _port_grads(tkernel, tparams, a, b, w, torch.float64)
    want = _jax_grads(lambda p, x1, x2: jops.gram(jkernel, p, x1, x2), jparams, a, b, w,
                      jnp.float64)
    assert len(want) == len(got)
    for g, jg in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(jg), rtol=1e-9, atol=1e-12)


@pytest.mark.parametrize("name,same", [("rbf", True), ("rbf_white", False)])
def test_gram_ad_gradients_match_jax_gram_ad_float32(rng, name, same):
    """In float32 against ``jax.grad`` through the JAX ``gram_ad`` itself
    (Pallas forward in interpret mode), at TestGramAD's tolerances (rtol
    1e-4; atol 1e-5 on x)."""
    jkernel, jparams, tkernel, tparams = _port(name)
    a = _x(rng, 32, 2).astype(np.float32)
    b = None if same else _x(rng, 17, 3)[:, :2].astype(np.float32)
    w = rng.standard_normal((32, 32 if same else 17)).astype(np.float32)
    got = _port_grads(tkernel, tparams, a, b, w, torch.float32)
    want = _jax_grads(lambda p, x1, x2: pops.gram_ad(jkernel, p, x1, x2), jparams, a, b, w,
                      jnp.float32)
    assert len(want) == len(got)
    for g, jg in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(jg), rtol=1e-4, atol=1e-5)


def test_gram_ad_differentiates_only_what_is_asked(rng):
    _, _, tkernel, tparams = _port("rbf")
    p = {"sigma": tparams["sigma"].clone().requires_grad_(True),
         "lengthscale": tparams["lengthscale"]}
    x = torch.from_numpy(_x(rng, 20, 2))
    out = kops.gram_ad(tkernel, p, x)
    (g,) = torch.autograd.grad(out.sum(), [p["sigma"]])
    want = torch.autograd.grad(tk.gram(tkernel, p, x).sum(), [p["sigma"]])[0]
    np.testing.assert_allclose(float(g), float(want), rtol=1e-12)


def test_gram_ad_promotes_1d_inputs(rng):
    _, _, tkernel, tparams = _port("rbf")
    x = torch.from_numpy(_x(rng, 15, 1)[:, 0])
    got = kops.gram_ad(tkernel, tparams, x)
    assert got.shape == (15, 15)
    np.testing.assert_allclose(got.numpy(), tk.gram(tkernel, tparams, x[:, None]).numpy(),
                               rtol=0, atol=0)


@pytest.mark.parametrize("name", ["rbf", "co2"])
def test_dispatcher_takes_the_plain_gram_on_the_cpu(rng, name):
    _, _, tkernel, tparams = _port(name)
    x32 = torch.from_numpy(_x(rng, 30, 2)).float()
    assert not kops.use_gram_kernel(tkernel, x32)
    before = dict(kops.launch_counts)
    got = kops.gram(tkernel, tparams, x32)
    assert kops.launch_counts == before
    np.testing.assert_allclose(got.numpy(), tk.gram(tkernel, tparams, x32).numpy(),
                               rtol=0, atol=0)


def test_cuda_wrapper_refuses_cpu_tensors():
    x = torch.zeros((8, 2), dtype=torch.float32)
    coef = torch.ones(2, dtype=torch.float32)
    with pytest.raises(ValueError, match="CUDA tensor"):
        kops.gram_cuda([(kops.OP_RBF, 0)], coef, x, None, white_idx=-1, need_l2=False)
