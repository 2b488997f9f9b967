"""Serve traffic: a closed loop of posterior queries, one client. Each query
asks for the mean and the variance at ``m`` fresh points of the training
distribution, through ``GPRegressor.posterior_cg`` (the estimator facade's
matrix-free route: CG with a Nyström preconditioner over the CUDA matvec
sweeps).

Traffic parameters: ``m`` (points a query), ``tol`` (the CG tolerance),
``max_iters`` (its cap), ``check_queries`` (the window's queries, drawn
from the seed, that the reference recomputes). Every query's solve has to
stop by the tolerance: one that runs all ``max_iters`` iterations counts
in ``capped_solves`` (a query of m <= 512 points is one solve in
``posterior_cg``, whose ``iters`` sums its solves).
"""

from __future__ import annotations

import numpy as np
import torch

from gpbench import data
from gpbench.jobs import checks_from
from gpbench.reference import gp as ref

# queries made in set-up; a window cycles through them
POOL = 4096


class PortServe:
    """The system under test."""

    def __init__(self, config, traffic, x, y, device):
        from gaussian_process_tpu_torch import convert, ops
        from gaussian_process_tpu_torch.models.estimators import GPRegressor

        k = config["kernel"]
        params = convert.params_from_numpy(
            {"sigma": k["sigma"], "lengthscale": k["lengthscale"]}, device=device, dtype=x.dtype)
        model = GPRegressor(ops.RBF(), params, noise_variance=config["noise"], device=device)
        # what fit() stores; fit() would also compute the exact LML, whose
        # dense float64 K does not fit on the card at n = 102400
        model.x_train, model.y_train, model.params = x, y, params
        self.model = model
        self.traffic, self.rank = traffic, config["rank"]

    def query(self, xs):
        t = self.traffic
        post = self.model.posterior_cg(xs, tol=t["tol"], max_iters=t["max_iters"],
                                       precond_rank=self.rank)
        return post.mean, post.var, int(post.iters)


class ControlServe:
    """The plain reference in the program's place, at the cell's own
    tolerance, rank and stopping rule, computed in TF32."""

    def __init__(self, config, traffic, x, y, device):
        self.x, self.y, self.config = x, y, config
        self.settings = ref.Settings(ref.TF32, traffic["tol"], config["rank"],
                                     traffic["max_iters"], "worst")

    def query(self, xs):
        k = self.config["kernel"]
        post = ref.posterior(self.x, self.y, xs, sigma=k["sigma"], lengthscale=k["lengthscale"],
                             noise=self.config["noise"], settings=self.settings)
        return post.mean, post.var, post.iters


SYSTEMS = {"port": PortServe, "control": ControlServe}


class Job:
    unit = "query"
    end_to_end = "query_s"

    def __init__(self, config, traffic, seed, device, system="port"):
        self.config, self.traffic, self.seed, self.device = config, traffic, seed, device
        self.system_name = system
        self.answers = []

    def setup(self, warm: bool = True):
        c, m = self.config, self.traffic["m"]
        self.x, self.y = data.training_set(c, self.device)
        gen = data.generator(self.device, self.seed, "queries")
        self.pool = data.points(c, POOL * m, gen, self.device).view(POOL, m, c["d"])
        self.system = SYSTEMS[self.system_name](c, self.traffic, self.x, self.y, self.device)
        if warm:
            self.system.query(self.pool[0])  # warm-up: the window's one shape
        self.next = 1
        _sync(self.device)

    def call(self) -> int:
        i = self.next % POOL
        mean, var, iters = self.system.query(self.pool[i])
        _sync(self.device)
        self.answers.append((i, mean, var, iters))
        self.next += 1
        return 1

    def failed(self) -> int:
        return sum(not bool(torch.isfinite(mean).all() and torch.isfinite(var).all())
                   for _, mean, var, _ in self.answers)

    def products(self) -> dict:
        c = self.config
        return {"family": c["kernel"]["family"], "n": c["n"], "d": c["d"],
                "r": 1 + self.traffic["m"]}

    def release(self):
        self.system = None

    def check(self, limits):
        """Mean and variance of ``check_queries`` of the window's queries,
        drawn from the seed, against the float64 reference; and
        ``capped_solves``, the window's queries whose solve ran all
        ``max_iters`` iterations."""
        if not self.answers:
            return checks_from({"mean_err": float("inf"), "var_err": float("inf"),
                                "capped_solves": float("inf")}, limits), {}
        capped = sum(a[3] >= self.traffic["max_iters"] for a in self.answers)
        rng = np.random.default_rng(data.sub_seed(self.seed, "check"))
        count = min(self.traffic["check_queries"], len(self.answers))
        picked = sorted(rng.choice(len(self.answers), size=count, replace=False).tolist())
        xs = torch.cat([self.pool[self.answers[j][0]] for j in picked])
        mean = torch.cat([self.answers[j][1] for j in picked]).double()
        var = torch.cat([self.answers[j][2] for j in picked]).double()
        c, r = self.config, self.config["reference"]
        k = c["kernel"]
        oracle = ref.posterior(self.x, self.y, xs, sigma=k["sigma"], lengthscale=k["lengthscale"],
                               noise=c["noise"], settings=ref.Settings(
                                   ref.FLOAT64, r["tol"], r["rank"], r["max_iters"], "column"))
        if not oracle.converged:
            raise RuntimeError(f"the reference's CG did not converge in {oracle.iters} iterations")
        values = {"mean_err": float(torch.max(torch.abs(mean - oracle.mean))),
                  "var_err": float(torch.max(torch.abs(var - oracle.var))),
                  "capped_solves": capped}
        return checks_from(values, limits), {"queries_checked": count,
                                             "reference_iters": oracle.iters,
                                             "program_iters": sorted({a[3] for a in self.answers})}


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)
