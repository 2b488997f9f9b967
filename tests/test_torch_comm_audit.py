"""The port's collective audit (``parallel/comm_model.py``: the recorder and
the two verifiers) against the JAX package's HLO audit of the same
programs on a mesh of as many CPU devices, with 2 and 4 gloo ranks, at
n = 256, t = 8, d = 2. The ranks run in subprocesses
(tests/torch_parallel_ranks.py), all cases in one start per group size.

The port issues the JAX program's collectives one for one, with two
differences the tests spell out: its ring moves p - 1 blocks a matvec
where the JAX ring moves p, and fp32 inputs factor and solve in float64
(``linalg.cholesky.solve_dtype``), so the factor's and the solves'
payloads have 8-byte elements where the JAX program's have 4."""

import collections

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parallel_ranks as ranks
from gaussian_process_tpu import ops, parallel
from gaussian_process_tpu.parallel import cg as jax_pcg
from gaussian_process_tpu.parallel import comm_model as jax_cm
from gaussian_process_tpu_torch.parallel import comm_model as torch_cm

WORLDS = (2, 4)
N, T, D, ITERS = 256, 8, 2, 50
PROBLEM = dict(n=N, d=D, t=T, seed=0)
CASES = {
    "post32": ("comm_posterior", dict(PROBLEM, dtype="float32")),
    "post64": ("comm_posterior", dict(PROBLEM, dtype="float64")),
    "mean_cg": ("comm_cg", dict(PROBLEM, solver="distributed_posterior_mean_cg",
                                max_iters=ITERS)),
    "block_cg": ("comm_cg", dict(PROBLEM, solver="distributed_posterior_cg",
                                 max_iters=ITERS)),
    "kinds": ("comm_kinds", {}),
    "reduce_scatter": ("comm_train_reduce_scatter", dict(n=32, d=2, seed=3)),
}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return ranks.run_worlds(WORLDS, CASES, tmp_path_factory.mktemp("comm"))


@pytest.fixture(scope="module")
def jax_reports():
    """The JAX verifiers' reports on the programs compiled for p CPU
    devices, fp32 (the JAX audit prices 4-byte elements)."""
    x, y, xt = (jnp.asarray(a, jnp.float32) for a in ranks.problem(N, D, T, 0))
    k = ops.RBF()
    prm = {"sigma": jnp.float32(1.0), "lengthscale": jnp.float32(1.0)}
    out = {}
    for p in WORLDS:
        mesh = parallel.make_mesh(restart=1, data=p, devices=jax.devices()[:p])
        post = parallel.make_distributed_posterior(k, mesh=mesh)
        cg = jax_pcg.make_posterior_mean_cg(k, mesh=mesh, max_iters=ITERS)
        out[p] = {
            "post": jax_cm.verify_posterior_model(
                post.lower(prm, x, y, xt).compile().as_text(), p, N, T, D),
            "cg": jax_cm.verify_cg_iteration_model(
                cg.lower(prm, x, y, xt).compile().as_text(), p, N, D, r=1),
        }
    return out


def _x_gather_bytes(p, element):
    """One rank's share of the x all-gather, (n, d) elements."""
    return (p - 1) * N * D * element // p


@pytest.mark.parametrize("P", WORLDS)
def test_torch_comm_posterior_bytes_match_jax(runs, jax_reports, P):
    """float64 inputs: every payload has 8-byte elements, so each class of
    bytes is exactly twice the JAX program's. fp32 inputs: the factor and
    the solves are the float64 run's; of the rest, the x gather carries fp32
    and the LML's reductions float64. Both verify against the model."""
    want = jax_reports[P]["post"]
    assert want["verified"]
    for res in ranks.ok(runs[P]["post64"]):
        rep = torch_cm.verify_posterior_model(res["records"], P, N, T, D, dtype=torch.float64)
        assert rep["verified"]
        for cls in ("chol", "solve", "other"):
            assert (rep[f"issued_{cls}_bytes_per_device"]
                    == 2 * want[f"hlo_{cls}_bytes_per_device"]), cls
        assert rep["model_chol_bytes_per_device"] == 2 * want["model_chol_bytes_per_device"]
    for res in ranks.ok(runs[P]["post32"]):
        rep = torch_cm.verify_posterior_model(res["records"], P, N, T, D, dtype=torch.float32)
        assert rep["verified"]
        assert rep["issued_chol_bytes_per_device"] == 2 * want["hlo_chol_bytes_per_device"]
        assert rep["issued_solve_bytes_per_device"] == 2 * want["hlo_solve_bytes_per_device"]
        assert rep["issued_other_bytes_per_device"] == (
            2 * want["hlo_other_bytes_per_device"] - _x_gather_bytes(P, 4))


@pytest.mark.parametrize("key", ["post32", "post64"])
@pytest.mark.parametrize("P", WORLDS)
def test_torch_comm_posterior_issues_the_jax_collectives(runs, P, key):
    """Each rank runs, in order of the model: p (m, m) all-reduces and p
    (n, m) all-gathers (the panels), p (m, t) and 3p (m, 1) all-reduces
    (the solves), and once each the x gather and the LML's reductions."""
    m = N // P
    want = {("all-reduce", (m, m)): P, ("all-gather", (N, m)): P,
            ("all-reduce", (m, T)): P, ("all-reduce", (m, 1)): 3 * P,
            ("all-gather", (N, D)): 1, ("all-reduce", ()): 2, ("all-reduce", (T,)): 2}
    work = "float64"
    for res in ranks.ok(runs[P][key]):
        recs = res["records"]
        got = collections.Counter((r["kind"], r["shapes"][0]) for r in recs)
        assert got == want
        x_gather = [r for r in recs if r["shapes"][0] == (N, D)]
        assert [r["dtype"] for r in x_gather] == [key.replace("post", "float")]
        assert {r["dtype"] for r in recs if r not in x_gather} == {work}


@pytest.mark.parametrize("P", WORLDS)
def test_torch_comm_cg_ring_bytes_match_jax(runs, jax_reports, P):
    """The mean solver's ring moves (p - 1) / p of the JAX ring's bytes an
    iteration, exactly, and its inner products stay under 1% of them."""
    want = jax_reports[P]["cg"]
    assert want["verified"]
    for res in ranks.ok(runs[P]["mean_cg"]):
        iters = res["iters"]
        rep = torch_cm.verify_cg_iteration_model(res["records"], P, N, D, r=1, iters=iters)
        assert rep["verified"]
        ring = rep["issued_cg_ring_bytes_per_device_per_iter"]
        assert ring * P == want["hlo_cg_ring_bytes_per_device_per_iter"] * (P - 1)
        assert rep["issued_per_iter_psum_bytes_excluded_by_model"] < 0.01 * ring
        kinds = collections.Counter(r["kind"] for r in res["records"])
        # two blocks (x, v) a ring step, p - 1 steps a matvec, no matvec
        # outside the iterations
        assert kinds["collective-permute"] == kinds["recv"] == 2 * (P - 1) * iters
        assert set(kinds) == {"collective-permute", "recv", "all-reduce"}


@pytest.mark.parametrize("P", WORLDS)
def test_torch_comm_block_cg_ring_prices_the_rhs_width(runs, jax_reports, P):
    """``distributed_posterior_cg`` solves [y | K_s]: its ring carries 1 + t
    columns, and prices to the model at r = 1 + t (the JAX ring's bytes at
    (p - 1) / p plus the t extra columns of each of the p - 1 steps)."""
    m = N // P
    jax_ring = jax_reports[P]["cg"]["hlo_cg_ring_bytes_per_device_per_iter"]
    for res in ranks.ok(runs[P]["block_cg"]):
        rep = torch_cm.verify_cg_iteration_model(res["records"], P, N, D, r=1 + T,
                                                 iters=res["iters"])
        assert rep["verified"]
        assert rep["issued_cg_ring_bytes_per_device_per_iter"] == (
            jax_ring * (P - 1) // P + (P - 1) * m * T * 4)
        sends = {r["shapes"][0] for r in res["records"] if r["kind"] == "collective-permute"}
        assert sends == {(m, D), (m, 1 + T)}


@pytest.mark.parametrize("P", WORLDS)
def test_torch_comm_verifiers_detect_an_injected_mismatch(runs, P):
    """Lying to the verifiers about the problem (n x 2, the ring's width,
    a matvec outside the iterations) fails them, as the JAX test's lie
    fails the JAX verifier."""
    res = ranks.ok(runs[P]["post64"])[0]
    with pytest.raises(AssertionError):
        torch_cm.verify_posterior_model(res["records"], P, 2 * N, T, D, dtype=torch.float64)
    cg = ranks.ok(runs[P]["mean_cg"])[0]
    with pytest.raises(AssertionError):
        torch_cm.verify_cg_iteration_model(cg["records"], P, 2 * N, D, iters=cg["iters"])
    with pytest.raises(AssertionError):
        torch_cm.verify_cg_iteration_model(cg["records"], P, N, D, r=2, iters=cg["iters"])
    with pytest.raises(AssertionError):  # a matvec outside the iterations that is not there
        torch_cm.verify_cg_iteration_model(cg["records"], P, N, D, iters=cg["iters"],
                                           extra_matvecs=1)


@pytest.mark.parametrize("key", ["post32", "post64", "mean_cg", "block_cg"])
@pytest.mark.parametrize("P", WORLDS)
def test_torch_comm_audit_leaves_results_unchanged(runs, P, key):
    """Results under the recorder have the bits of a run without it, and
    the recorder is gone after its block."""
    for res in ranks.ok(runs[P][key]):
        assert res["bitwise_equal"]
        assert not res["mode_left"]


@pytest.mark.parametrize("P", WORLDS)
def test_torch_comm_record_kinds(runs, P):
    """Each c10d operation gets the JAX audit's name and the bytes of its
    result; nothing is recorded after the block."""
    for res in ranks.ok(runs[P]["kinds"]):
        got = [(r["kind"], r["op"], r["shapes"], r["out_bytes"]) for r in res["records"]]
        assert got[:4] == [
            ("all-reduce", "allreduce_", [(3, 2)], 24),
            ("all-gather", "_allgather_base_", [(2 * P, 3)], 2 * P * 3 * 4),
            ("reduce-scatter", "_reduce_scatter_base_", [(2,)], 8),
            ("broadcast", "broadcast_", [(2,)], 8),
        ]
        assert got[4][:2] == ("other", "barrier")  # its payload is gloo's own token
        assert sorted(got[5:]) == [("collective-permute", "send", [(4,)], 32),
                                   ("recv", "recv_", [(4,)], 32)]
        assert res["after"] == 0


@pytest.mark.parametrize("P", WORLDS)
def test_torch_comm_train_step_reduce_scatter(runs, P):
    """The training step's gather, backward through ``reduce_scatter_tensor``
    (the NCCL branch, ``parallel/train.py``), records one (n/p, n)
    reduce-scatter of the cotangent, and steps as the gloo branch does."""
    n = CASES["reduce_scatter"][1]["n"]
    for res in ranks.ok(runs[P]["reduce_scatter"]):
        rs = [r for r in res["records"] if r["kind"] == "reduce-scatter"]
        assert [(r["op"], r["shapes"], r["dtype"]) for r in rs] == [
            ("_reduce_scatter_base_", [(n // P, n)], "float64")]
        assert torch_cm._per_device_bytes("reduce-scatter", rs[0]["out_bytes"], P) == (
            (P - 1) * (n // P) * n * 8)
        assert res["max_abs_diff"] <= 1e-12


@pytest.mark.parametrize("p", [1, 2, 4, 8])
@pytest.mark.parametrize("kind", ["all-reduce", "all-gather", "reduce-scatter",
                                  "collective-permute"])
def test_torch_comm_per_device_bytes_equals_jax(kind, p):
    assert torch_cm._per_device_bytes(kind, 4096, p) == jax_cm._per_device_bytes(kind, 4096, p)


def test_torch_comm_recv_and_broadcast_pricing():
    """A receive is priced at nothing (its send carries the payload); a
    broadcast and an unnamed operation at their payload."""
    assert torch_cm._per_device_bytes("recv", 4096, 4) == 0.0
    assert torch_cm._per_device_bytes("broadcast", 4096, 4) == 4096.0
    assert torch_cm._per_device_bytes("other", 4096, 4) == 4096.0


def test_torch_comm_model_exports():
    for name in ("record_collectives", "audit_collectives", "verify_posterior_model",
                 "verify_cg_iteration_model", "ici_comm_model"):
        assert name in torch_cm.__all__ and callable(getattr(torch_cm, name))


def test_torch_comm_verifiers_at_one_rank_verify_nothing_moved():
    """At one rank every collective is a local copy: the model is zero and
    so are the issued bytes, whatever the records hold."""
    recs = [{"kind": "all-reduce", "out_bytes": 256 * 256 * 8, "shapes": [(256, 256)]},
            {"kind": "all-gather", "out_bytes": 256 * 256 * 8, "shapes": [(256, 256)]}]
    rep = torch_cm.verify_posterior_model(recs, 1, 256, 8, 2)
    assert rep["verified"] and rep["issued_chol_bytes_per_device"] == 0
    rep = torch_cm.verify_cg_iteration_model(recs, 1, 256, 2, iters=5)
    assert rep["verified"] and rep["issued_cg_ring_bytes_per_device_per_iter"] == 0
