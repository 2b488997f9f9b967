"""Rank bodies for the port's multi-rank tests (``tests/test_torch_parallel_*.py``;
not collected by pytest).

``run_worlds(worlds, cases, workdir)`` starts, for each group size in
``worlds``, that many CPU processes that join one gloo group through a file
store, runs every case in each, and returns each case's per-rank results. A rank imports torch, numpy and the
port only, never JAX or the test modules, so the cases and the input
generators live here; the test modules import the generators to build the
same inputs for the JAX package.

Run one rank by hand:
    python tests/torch_parallel_ranks.py <rank> <world> <init file> <cases.json> <out dir>
"""

from __future__ import annotations

import json
import os
import pickle
import subprocess
import sys
import traceback
from datetime import timedelta
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parents[1]


# ---------------------------------------------------------------- inputs
# numpy only: the JAX side of each test builds the same arrays


def data(n, d, seed):
    rng = np.random.default_rng(seed)
    return rng.uniform(-5, 5, (n, d)), rng.standard_normal(n)


def problem(n, d, t, seed):
    rng = np.random.default_rng(seed)
    x = rng.uniform(-5, 5, (n, d))
    y = rng.standard_normal(n)
    return x, y, rng.uniform(-5, 5, (t, d))


def ill_conditioned(n, d, seed):
    """The JAX suite's n ~ 1e5 regime at a small n: a slowly decaying RBF
    spectrum (lengthscale 2), where Jacobi CG stalls and Nyström does not."""
    rng = np.random.default_rng(seed)
    x = rng.uniform(-5, 5, (n, d))
    y = np.sin(0.9 * x.sum(axis=1)) + 0.02 * rng.standard_normal(n)
    return x, y, rng.uniform(-5, 5, (8, d))


def binary_problem(n, m, seed):
    """The JAX suite's distributed Laplace problem: x in [-3, 3]^2, labels
    sign(sin(x0 + x1) + 0.3 noise), m test points."""
    rng = np.random.default_rng(seed)
    x = rng.uniform(-3, 3, (n, 2))
    y = np.where(np.sin(x.sum(axis=1)) + 0.3 * rng.standard_normal(n) > 0, 1.0, -1.0)
    return x, y, rng.uniform(-3, 3, (m, 2))


def blobs(n, num_classes, seed, d=2):
    """The JAX suite's multi-class blobs: n // C points round each of C
    centres in [-4, 4]^d, labelled by centre."""
    rng = np.random.default_rng(seed)
    centers = rng.uniform(-4, 4, size=(num_classes, d))
    x = np.concatenate([centers[c] + 0.5 * rng.standard_normal((n // num_classes, d))
                        for c in range(num_classes)])
    return x, np.repeat(np.arange(num_classes), n // num_classes)


def spd(n, seed):
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((n, n))
    return a @ a.T + n * np.eye(n)


def kernel_spec(name):
    """(kernel factory name, params as numpy): "rbf", "rbf_white" (White
    amplitude 0.3) or "rbf_white5" (0.5)."""
    rbf = {"sigma": 1.0, "lengthscale": 1.0}
    if name == "rbf":
        return rbf
    amp = {"rbf_white": 0.3, "rbf_white5": 0.5, "rbf_white2": 0.2}[name]
    return (rbf, {"amplitude": amp})


# ---------------------------------------------------------------- cases

CASES = {}


def case(fn):
    CASES[fn.__name__] = fn
    return fn


def _t(a):
    import torch

    return torch.as_tensor(np.asarray(a), dtype=torch.float64)


def _kernel(name):
    import torch

    from gaussian_process_tpu_torch import convert, ops

    k = ops.RBF() if name == "rbf" else ops.RBF() + ops.White()
    return k, convert.params_from_numpy(kernel_spec(name), dtype=torch.float64)


def _np(t):
    import torch

    if isinstance(t, torch.Tensor):
        return t.detach().cpu().numpy()
    return np.asarray(t)


_MESHES = {}
_WORKDIR = [""]  # this group's directory, set by _rank_main


def _mesh(restart=1, data=None):
    from gaussian_process_tpu_torch import parallel

    key = (restart, data)
    if key not in _MESHES:
        _MESHES[key] = parallel.make_mesh(restart=restart, data=data, device="cpu")
    return _MESHES[key]


@case
def mesh_layout(world):
    import torch
    import torch.distributed as dist

    from gaussian_process_tpu_torch import config, parallel

    out = {}
    mesh = _mesh()
    out["names"] = list(mesh.mesh_dim_names)
    out["shape"] = list(mesh.shape)
    cfg_mesh = parallel.make_mesh(cfg=config.MeshConfig(restart_axis_size=world), device="cpu")
    out["cfg_shape"] = list(cfg_mesh.shape)
    out["restart_index"] = cfg_mesh.get_local_rank("restart")
    try:
        parallel.make_mesh(restart=world + 1, device="cpu")
        out["oversized"] = "no error"
    except ValueError as e:
        out["oversized"] = str(e)
    x = torch.arange(world * 3 * 2, dtype=torch.float64).reshape(world * 3, 2)
    block = parallel.shard_rows(mesh, x)
    out["block"] = _np(block)
    out["gathered"] = _np(parallel.gather_rows(mesh, block))
    out["replicated"] = _np(parallel.replicated(mesh, torch.full((2,), float(dist.get_rank()))))
    padded, n = parallel.pad_to_multiple(torch.ones(7, 2), 4)
    out["padded"] = (list(padded.shape), n, float(padded[7:].abs().sum()))
    return out


@case
def sharded_gram(world, n, d, seed, kernel):
    from gaussian_process_tpu_torch import parallel

    x, _ = data(n, d, seed)
    k, p = _kernel(kernel)
    mesh = _mesh()
    block = parallel.sharded_gram(k, p, _t(x), mesh=mesh)
    return {"block_rows": block.shape[0], "K": _np(parallel.gather_rows(mesh, block))}


@case
def ring_matvec(world, n, d, seed, kernel, cols):
    from gaussian_process_tpu_torch import parallel

    x, _ = data(n, d, seed)
    v = np.random.default_rng(seed + 1).standard_normal((n, cols) if cols else n)
    k, p = _kernel(kernel)
    mesh = _mesh()
    out = parallel.ring_matvec(k, p, _t(x), _t(v), mesh=mesh)
    return {"Kv": _np(parallel.gather_rows(mesh, out))}


@case
def mean_cg(world, n, d, t, seed, noise, tol, max_iters):
    from gaussian_process_tpu_torch import parallel

    x, y, xt = problem(n, d, t, seed)
    k, p = _kernel("rbf")
    mesh = _mesh()
    mean, alpha, iters, res = parallel.distributed_posterior_mean_cg(
        k, p, _t(x), _t(y), _t(xt), mesh=mesh, noise_variance=noise, tol=tol,
        max_iters=max_iters)
    return {"mean": _np(mean), "iters": iters, "alpha": _np(parallel.gather_rows(mesh, alpha))}


@case
def posterior_cg(world, n, d, t, seed, noise, tol, max_iters, kernel="rbf",
                 preconditioner="jacobi", precond_rank=512, ill=False):
    from gaussian_process_tpu_torch import parallel

    x, y, xt = ill_conditioned(n, d, seed) if ill else problem(n, d, t, seed)
    k, p = _kernel(kernel)
    if ill:
        p = {"sigma": _t(1.0), "lengthscale": _t(2.0)}
    mean, var, alpha, iters, res = parallel.distributed_posterior_cg(
        k, p, _t(x), _t(y), _t(xt), mesh=_mesh(), noise_variance=noise, tol=tol,
        max_iters=max_iters, preconditioner=preconditioner, precond_rank=precond_rank)
    return {"mean": _np(mean), "var": _np(var), "iters": iters, "resnorm": float(res)}


def _segmented(n, d, seed, noise, tol, max_iters, segment_iters, preconditioner, precond_rank,
               **kw):
    from gaussian_process_tpu_torch import ops, parallel

    x, y, xt = ill_conditioned(n, d, seed)
    k = ops.RBF()
    p = {"sigma": _t(1.0), "lengthscale": _t(2.0)}
    return parallel.distributed_posterior_cg_segmented(
        k, p, _t(x), _t(y), _t(xt), mesh=_mesh(), noise_variance=noise, tol=tol,
        max_iters=max_iters, segment_iters=segment_iters, preconditioner=preconditioner,
        precond_rank=precond_rank, **kw)


@case
def segmented(world, **kw):
    seen = []
    mean, var, alpha, iters, res, state = _segmented(
        checkpoint_cb=lambda i, st: seen.append(st.iters), **kw)
    return {"mean": _np(mean), "var": _np(var), "iters": iters, "segments": seen,
            "state_rows": state.x.shape[0], "shard": state.shard}


@case
def resume(world, stop_after, **kw):
    import torch

    from gaussian_process_tpu_torch.utils import checkpoint as ckpt

    ref = _segmented(**kw)

    class Stop(Exception):
        pass

    saved = []

    ckpt_dir = os.path.join(_WORKDIR[0], "ckpt")

    def cb(i, st):
        saved.append(ckpt.save(os.path.join(ckpt_dir, f"seg{i}"), st, per_host=True))
        if i == stop_after:
            raise Stop()

    try:
        _segmented(checkpoint_cb=cb, **kw)
        stopped = False
    except Stop:
        stopped = True
    like = ref[5]._replace(**{f: torch.zeros_like(getattr(ref[5], f))
                              for f in ("x", "r", "p", "z", "rz", "resnorm")},
                           iters=0, n=0, mesh_size=0, shard=0)
    restored = ckpt.restore(os.path.join(ckpt_dir, f"seg{stop_after}"), like)
    resumed = _segmented(resume_state=restored, **kw)
    out = {"stopped": stopped, "files": [os.path.basename(s) for s in saved],
           "restored_iters": restored.iters, "ref_iters": ref[3], "resumed_iters": resumed[3],
           "mean_equal": bool(torch.equal(ref[0], resumed[0])),
           "var_equal": bool(torch.equal(ref[1], resumed[1])),
           "alpha_equal": bool(torch.equal(ref[2], resumed[2]))}
    # a state of another problem: other n, and another mesh size
    errors = []
    for wrong, kw2 in ((restored, dict(kw, n=kw["n"] - 8)),
                       (restored._replace(mesh_size=world + 1), kw)):
        try:
            _segmented(resume_state=wrong, **kw2)
            errors.append("no error")
        except ValueError as e:
            errors.append(str(e))
    out["errors"] = errors
    return out


@case
def chol(world, n, seed):
    from gaussian_process_tpu_torch import parallel

    mesh = _mesh()
    L = parallel.distributed_cholesky(_t(spd(n, seed)), mesh=mesh)
    return {"L": _np(parallel.gather_rows(mesh, L)), "rows": L.shape[0]}


@case
def chol_solve(world, n, seed, cols):
    from gaussian_process_tpu_torch import parallel

    mesh = _mesh()
    K = _t(spd(n, seed))
    rng = np.random.default_rng(seed + 1)
    b = rng.standard_normal(n)
    B = rng.standard_normal((n, cols))
    # the factor takes the rank's block-row, as sharded_gram returns it
    L = parallel.distributed_cholesky(parallel.shard_rows(mesh, K), mesh=mesh)
    x = parallel.distributed_cholesky_solve(L, _t(b), mesh=mesh)
    X = parallel.distributed_cholesky_solve(L, _t(B), mesh=mesh)
    return {"x": _np(parallel.gather_rows(mesh, x)), "X": _np(parallel.gather_rows(mesh, X))}


@case
def posterior(world, n, d, t, seed, noise, kernel):
    from gaussian_process_tpu_torch import parallel

    x, y, xt = problem(n, d, t, seed)
    k, p = _kernel(kernel)
    mesh = _mesh()
    mean, var, lml, alpha = parallel.distributed_posterior(
        k, p, _t(x), _t(y), _t(xt), mesh=mesh, noise_variance=noise)
    return {"mean": _np(mean), "var": _np(var), "lml": float(lml),
            "alpha": _np(parallel.gather_rows(mesh, alpha)), "alpha_rows": alpha.shape[0]}


@case
def restarts(world, n, d, seed, ells, max_iters):
    import torch

    from gaussian_process_tpu_torch import ops, parallel

    x, y = data(n, d, seed)
    mesh = _mesh(restart=world, data=1)
    k = ops.RBF()
    batch = {"sigma": torch.ones(len(ells), dtype=torch.float64), "lengthscale": _t(ells)}
    lml = parallel.sharded_lml(k, batch, _t(x), _t(y), mesh=mesh)
    params, lml_out, iters, conv = parallel.sharded_gradient_restarts(
        k, batch, _t(x[:16]), _t(y[:16]), mesh=mesh, max_iters=max_iters,
        trainable={"sigma": False, "lengthscale": True})
    lml_in = parallel.sharded_lml(k, batch, _t(x[:16]), _t(y[:16]), mesh=mesh)
    best, best_v = parallel.best_restart(params, lml_out)
    return {"lml": _np(lml), "params": {key: _np(v) for key, v in params.items()},
            "lml_out": _np(lml_out), "lml_in": _np(lml_in), "iters": _np(iters),
            "converged": _np(conv), "best": float(best["lengthscale"]), "best_v": best_v}


@case
def train(world, n, d, seed, steps, restart, lengthscales, kernel, lr):
    import torch

    from gaussian_process_tpu_torch import ops, parallel

    x, y = data(n, d, seed)
    mesh = _mesh(restart=restart, data=world // restart)
    k = ops.RBF() if kernel == "rbf" else ops.RBF() + ops.White()
    R = len(lengthscales)
    rbf = {"sigma": torch.ones(R, dtype=torch.float64), "lengthscale": _t(lengthscales)}
    batch = rbf if kernel == "rbf" else (rbf, {"amplitude": torch.full((R,), 0.1,
                                                                        dtype=torch.float64)})
    step, init = parallel.make_distributed_train_step(k, mesh=mesh, learning_rate=lr)
    opt_state = init(batch)
    lmls, params = [], []
    for _ in range(steps):
        res = step(batch, opt_state, _t(x), _t(y))
        batch, opt_state = res.params, res.opt_state
        lmls.append(_np(res.lml))
        params.append([_np(leaf) for leaf in ops.kernels.tree_leaves(batch)])
    return {"lml": np.stack(lmls), "params": params, "local_optimisers": len(opt_state)}


@case
def binary(world, n, m, seed, kernel, precond_rank, cg_tol):
    from gaussian_process_tpu_torch import parallel

    x, y, xt = binary_problem(n, m, seed)
    k, p = _kernel(kernel)
    mesh = _mesh()
    kw = dict(mesh=mesh, precond_rank=precond_rank, cg_tol=cg_tol)
    prob, pavg, label, mean, var, iters, inner, conv = parallel.distributed_fit_predict_binary(
        k, p, _t(x), _t(y), _t(xt), **kw)
    x_p, _ = parallel.pad_to_multiple(_t(x), world)
    y_p, _ = parallel.pad_to_multiple(_t(y), world)
    fit = parallel.make_distributed_laplace_fit(
        k, n_true=None if x_p.shape[0] == n else n, **kw)
    f, grad, sw, fit_iters, _, _ = fit(p, x_p, y_p)
    out = {"prob": _np(prob), "pavg": _np(pavg), "label": _np(label), "mean": _np(mean),
           "var": _np(var), "iters": iters, "inner": inner, "converged": conv,
           "fit_iters": fit_iters, "rows": f.shape[0]}
    out.update({name: _np(parallel.gather_rows(mesh, t))
                for name, t in (("f", f), ("grad", grad), ("sqrt_w", sw))})
    return out


@case
def multiclass(world, num_classes, seed, max_iters):
    from gaussian_process_tpu_torch import parallel

    x, y = blobs(num_classes * 8, num_classes, seed)
    k, p = _kernel("rbf")
    st = parallel.fit_multiclass_sharded(k, p, _t(x), y, num_classes, mesh=_mesh(),
                                         max_iters=max_iters)
    return {"f_mode": _np(st.f_mode), "pi": _np(st.pi), "lml": float(st.lml),
            "iters": st.iters, "converged": st.converged, "trace": _np(st.error_trace)}


@case
def multiclass_accuracy(world, seed, max_iters):
    """The JAX suite's held-out blobs: 45 points of 3 classes, 30 to fit on
    the ranks, 15 to classify by the single-card prediction."""
    from gaussian_process_tpu_torch import gp, parallel

    xa, ya = blobs(45, 3, seed)
    perm = np.random.default_rng(seed + 1).permutation(len(ya))
    x, y, xt, yt = xa[perm[:30]], ya[perm[:30]], xa[perm[30:]], ya[perm[30:]]
    k, p = _kernel("rbf")
    st = parallel.fit_multiclass_sharded(k, p, _t(x), y, 3, mesh=_mesh(), max_iters=max_iters)
    pred = gp.predict_multiclass(k, p, st, _t(x), y, _t(xt), 3)
    return {"accuracy": float(np.mean(_np(pred.label) == yt)), "converged": st.converged}


def _records(records):
    """The audit's records, their dtypes as names ("float32")."""
    return [dict(rec, dtype=str(rec["dtype"]).replace("torch.", "")) for rec in records]


def _equal(a, b):
    import torch

    return all(torch.equal(u, v) if isinstance(u, torch.Tensor) else u == v
               for u, v in zip(a, b))


def _audited(fn):
    """``fn()`` unaudited and under the collective recorder: the audited
    result, the records, whether the two results have equal bits, and
    whether the recorder is gone afterwards."""
    from torch.utils._python_dispatch import _get_current_dispatch_mode

    from gaussian_process_tpu_torch.parallel import comm_model

    plain = fn()
    out, records = comm_model.audit_collectives(fn)
    return out, {"records": _records(records), "bitwise_equal": _equal(plain, out),
                 "mode_left": _get_current_dispatch_mode() is not None}


@case
def comm_posterior(world, n, d, t, seed, dtype):
    import torch

    from gaussian_process_tpu_torch import ops, parallel

    x, y, xt = problem(n, d, t, seed)
    dt = getattr(torch, dtype)
    on = lambda a: torch.as_tensor(np.asarray(a), dtype=dt)  # noqa: E731
    p = {"sigma": on(1.0), "lengthscale": on(1.0)}
    _, res = _audited(lambda: parallel.distributed_posterior(
        ops.RBF(), p, on(x), on(y), on(xt), mesh=_mesh()))
    return res


@case
def comm_cg(world, n, d, t, seed, solver, max_iters):
    import torch

    from gaussian_process_tpu_torch import ops, parallel

    x, y, xt = problem(n, d, t, seed)
    on = lambda a: torch.as_tensor(np.asarray(a), dtype=torch.float32)  # noqa: E731
    p = {"sigma": on(1.0), "lengthscale": on(1.0)}
    fn = getattr(parallel, solver)
    out, res = _audited(lambda: fn(ops.RBF(), p, on(x), on(y), on(xt), mesh=_mesh(),
                                   max_iters=max_iters))
    res["iters"] = out[-2]
    return res


@case
def comm_kinds(world):
    """One of each collective the tier issues, under the recorder, then one
    more after it."""
    import torch
    import torch.distributed as dist

    from gaussian_process_tpu_torch.parallel import comm_model, mesh as pmesh

    me = dist.get_rank()
    with comm_model.record_collectives() as records:
        pmesh.all_reduce(torch.ones(3, 2), None)
        pmesh.all_gather_rows(torch.ones(2, 3), None)
        out = torch.empty(2)
        dist.reduce_scatter_tensor(out, torch.ones(2 * world))
        dist.broadcast(out, src=0)
        dist.barrier()
        recv = torch.empty(4, dtype=torch.float64)
        for req in dist.batch_isend_irecv([
                dist.P2POp(dist.isend, torch.ones(4, dtype=torch.float64), (me + 1) % world),
                dist.P2POp(dist.irecv, recv, (me - 1) % world)]):
            req.wait()
    seen = len(records)
    dist.all_reduce(torch.ones(1))
    return {"records": _records(records), "after": len(records) - seen}


@case
def comm_train_reduce_scatter(world, n, d, seed):
    """One training step whose gather's backward takes the NCCL branch
    (``reduce_scatter_tensor``, which gloo runs too), audited, against the
    same step through the gloo branch."""
    import types
    from unittest import mock

    import torch
    import torch.distributed as dist

    from gaussian_process_tpu_torch import ops, parallel
    from gaussian_process_tpu_torch.parallel import comm_model
    from gaussian_process_tpu_torch.parallel import train as ptrain

    x, y = data(n, d, seed)

    def one_step():
        step, init = parallel.make_distributed_train_step(ops.RBF(), mesh=_mesh())
        batch = {"sigma": torch.ones(1, dtype=torch.float64), "lengthscale": _t([1.0])}
        res = step(batch, init(batch), _t(x), _t(y))
        return [res.lml] + ops.kernels.tree_leaves(res.params)

    gloo_branch = one_step()
    as_nccl = types.SimpleNamespace(**{k: getattr(dist, k) for k in dir(dist)
                                       if not k.startswith("__")})
    as_nccl.get_backend = lambda group=None: dist.Backend.NCCL
    with mock.patch.object(ptrain, "dist", as_nccl):
        out, records = comm_model.audit_collectives(one_step)
    return {"records": _records(records), "max_abs_diff": max(
        float(torch.max(torch.abs(a - b))) for a, b in zip(out, gloo_branch))}


# ---------------------------------------------------------- running the ranks


def _rank_main(rank, world, init_file, spec_file, out_dir):
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    _WORKDIR[0] = out_dir
    dist.init_process_group("gloo", init_method=f"file://{init_file}", rank=rank,
                            world_size=world, timeout=timedelta(seconds=120))
    with open(spec_file) as fh:
        cases = json.load(fh)
    results = []
    for name, kwargs in cases:
        try:
            results.append(CASES[name](world, **kwargs))
        except Exception:
            results.append({"error": traceback.format_exc()})
    with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as fh:
        pickle.dump(results, fh)
    # drop the meshes' sub-groups before the group goes: a gloo group that
    # outlives destroy_process_group to the interpreter's exit can abort it
    # ("terminate called without an active exception", about one start in
    # 40 here)
    _MESHES.clear()
    dist.destroy_process_group()


def run_worlds(worlds, cases, workdir) -> dict:
    """Run ``cases`` (a dict key -> (case name, kwargs) or (case name,
    kwargs, the group sizes it runs at)) in one gloo group of each size in
    ``worlds``, all groups at once. Returns ``{world: {key: [result of
    rank 0, rank 1, ...]}}``; a case that raised in a rank has
    ``{"error": traceback}`` there."""
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=os.pathsep.join(
        [str(REPO)] + [p for p in os.environ.get("PYTHONPATH", "").split(os.pathsep) if p]))
    procs, keys = {}, {}
    for world in worlds:
        keys[world] = [key for key, c in cases.items() if len(c) < 3 or world in c[2]]
        wdir = Path(workdir) / f"world{world}"
        wdir.mkdir(parents=True, exist_ok=True)
        spec = wdir / "cases.json"
        spec.write_text(json.dumps([list(cases[key][:2]) for key in keys[world]]))
        procs[world] = [
            subprocess.Popen([sys.executable, __file__, str(r), str(world), str(wdir / "init"),
                              str(spec), str(wdir)], env=env, stdout=subprocess.PIPE,
                             stderr=subprocess.STDOUT)
            for r in range(world)]
    out = {}
    for world, ranks in procs.items():
        logs = [proc.communicate(timeout=300)[0].decode(errors="replace") for proc in ranks]
        if any(proc.returncode for proc in ranks):
            raise RuntimeError(f"a rank of the {world}-rank group failed:\n" + "\n".join(logs))
        per_rank = []
        for r in range(world):
            with open(Path(workdir) / f"world{world}" / f"rank{r}.pkl", "rb") as fh:
                per_rank.append(pickle.load(fh))
        out[world] = {key: [per_rank[r][i] for r in range(world)]
                      for i, key in enumerate(keys[world])}
    return out


def ok(results):
    """The ranks' results of one case; fails on a rank that raised."""
    for r, res in enumerate(results):
        if "error" in res:
            raise AssertionError(f"rank {r} raised:\n{res['error']}")
    return results


if __name__ == "__main__":
    _rank_main(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4], sys.argv[5])
