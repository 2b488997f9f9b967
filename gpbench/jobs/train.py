"""Train traffic: matrix-free hyperparameter training, one client. Each call
is ``opt.tune_large_scale`` for ``steps`` Adam steps of the LML surrogate
(a Nyström-preconditioned block CG on [y | probes], then one matvec and its
backward sweep). The first call, in set-up, starts from the cell's
``start``; each later call goes on from the params the last call returned,
as a user's tuning moves through its params. A call's probes come from its
own seed, made from the run's seed and the call's index.

Traffic parameters: ``steps`` (a call's Adam steps), ``num_probes``,
``cg_tol``, ``cg_max_iters``, ``learning_rate`` and ``start``
({"sigma", "lengthscale"}).

The check: the reference follows two calls with the same probes (drawn
again from the seed the same way): set-up's call, from the start, and one
call of the window, drawn from the seed, from the params the program
handed to it. For each, every step's surrogate value and the change of
each param over the call. Besides, every block solve of every call has to
stop by the tolerance: one that runs all ``cg_max_iters`` iterations
counts in ``capped_solves``.
"""

from __future__ import annotations

import math
import statistics
from typing import List, NamedTuple

import numpy as np
import torch

from gpbench import data
from gpbench.jobs import checks_from
from gpbench.reference import gp as ref

NAMES = ("sigma", "lengthscale")  # the order of the reference's grads


def probe_seed(seed: int, call: int) -> int:
    return data.sub_seed(seed, "probes", call)


def rademacher_blocks(n: int, num_probes: int, steps: int, seed: int, device) -> list:
    """The probes a call with ``seed`` draws, one n x num_probes block a step,
    as ``opt.tune_large_scale`` draws them: a generator on the data's device,
    ``torch.randint(0, 2)`` mapped to +-1."""
    gen = torch.Generator(device=device).manual_seed(seed)
    return [(2 * torch.randint(0, 2, (n, num_probes), generator=gen, device=device) - 1)
            for _ in range(steps)]


class Call(NamedTuple):
    start: dict  # the params the call was handed, as floats
    values: List[float]  # each step's surrogate
    end: dict  # the params it returned
    cg_iters: List[int]  # each step's block-CG iterations


class PortTrain:
    """The system under test."""

    def __init__(self, config, traffic, x, y, device):
        from gaussian_process_tpu_torch import ops, opt

        self.opt, self.kernel = opt, ops.RBF()
        self.config, self.traffic, self.x, self.y = config, traffic, x, y

    def tune(self, params: dict, seed: int):
        t = self.traffic
        res = self.opt.tune_large_scale(
            self.kernel, params, self.x, self.y, noise_variance=self.config["noise"],
            learning_rate=t["learning_rate"], steps=t["steps"], num_probes=t["num_probes"],
            cg_tol=t["cg_tol"], cg_max_iters=t["cg_max_iters"],
            precond_rank=self.config["rank"], seed=seed)
        return res.params, [float(v) for v in res.lml_trace], [int(i) for i in res.cg_iters]


class ControlTrain:
    """The plain reference in the program's place, at the cell's own
    tolerance, rank and stopping rule, computed in TF32."""

    def __init__(self, config, traffic, x, y, device):
        self.config, self.traffic, self.x, self.y, self.device = config, traffic, x, y, device
        self.settings = ref.Settings(ref.TF32, traffic["cg_tol"], config["rank"],
                                     traffic["cg_max_iters"], "worst")

    def tune(self, params: dict, seed: int):
        t = self.traffic
        start = {k: float(v) for k, v in params.items()}
        probes = rademacher_blocks(self.x.shape[0], t["num_probes"], t["steps"], seed, self.device)
        run = ref.train(self.x, self.y, start, probes, noise=self.config["noise"],
                        learning_rate=t["learning_rate"], settings=self.settings)
        last = {k: torch.tensor(v, dtype=self.x.dtype, device=self.device)
                for k, v in run.params[-1].items()}
        return last, run.values, list(run.iters)


SYSTEMS = {"port": PortTrain, "control": ControlTrain}


class Job:
    unit = "step"
    end_to_end = "train_step_s"

    def __init__(self, config, traffic, seed, device, system="port"):
        self.config, self.traffic, self.seed, self.device = config, traffic, seed, device
        self.system_name = system
        self.log: List[Call] = []  # every call, set-up's first

    def setup(self, warm: bool = True):
        """``warm`` is always taken: the first call is a checked one."""
        self.x, self.y = data.training_set(self.config, self.device)
        self.system = SYSTEMS[self.system_name](self.config, self.traffic, self.x, self.y,
                                                self.device)
        self.params = {k: torch.tensor(float(v), dtype=self.x.dtype, device=self.device)
                       for k, v in self.traffic["start"].items()}
        self._call()  # warms every shape
        _sync(self.device)

    def _call(self):
        start = {k: float(v) for k, v in self.params.items()}
        params, values, iters = self.system.tune(self.params, probe_seed(self.seed, len(self.log)))
        self.params = params
        self.log.append(Call(start, values, {k: float(v) for k, v in params.items()}, iters))

    def call(self) -> int:
        self._call()
        _sync(self.device)
        return self.traffic["steps"]

    def failed(self) -> int:
        return sum(not all(math.isfinite(v) for v in c.values) for c in self.log[1:])

    def products(self) -> dict:
        c = self.config
        return {"family": c["kernel"]["family"], "n": c["n"], "d": c["d"],
                "r": 1 + self.traffic["num_probes"]}

    def release(self):
        self.system = None

    def checked_calls(self) -> List[int]:
        """Set-up's call, and one window call drawn from the seed."""
        window = len(self.log) - 1
        if window < 1:
            return [0]
        rng = np.random.default_rng(data.sub_seed(self.seed, "check"))
        return [0, 1 + int(rng.integers(window))]

    def follow(self, index: int):
        """One call against the float64 reference over the same steps:
        ``loss_gap``, the largest relative gap of a step's surrogate value;
        ``change_gap``, the largest gap between the program's and the
        reference's change of a param over the call, against the larger of
        that param's and the median param's reference change. A param whose
        reference gradient at the call's first step is under a thousandth of
        the median param's moves by round-off alone and is left out."""
        t, c, r = self.traffic, self.config, self.config["reference"]
        call = self.log[index]
        probes = rademacher_blocks(c["n"], t["num_probes"], t["steps"],
                                   probe_seed(self.seed, index), self.device)
        oracle = ref.train(self.x, self.y, call.start, probes, noise=c["noise"],
                           learning_rate=t["learning_rate"], settings=ref.Settings(
                               ref.FLOAT64, r["tol"], r["rank"], r["max_iters"], "column"))
        if not oracle.converged:
            raise RuntimeError(f"the reference's CG did not converge ({oracle.iters})")
        loss_gap = max(abs(p - q) / abs(q) for p, q in zip(call.values, oracle.values))
        if len(call.values) != len(oracle.values):
            loss_gap = float("inf")
        grad0 = [abs(g) for g in oracle.grads[0]]
        kept = [k for k, g in zip(NAMES, grad0) if g >= 1e-3 * statistics.median(grad0)]
        ref_change = {k: abs(oracle.params[-1][k] - call.start[k]) for k in kept}
        median_change = statistics.median(ref_change.values())
        change_gap = max(abs(abs(call.end[k] - call.start[k]) - ref_change[k])
                         / max(ref_change[k], median_change) for k in kept)
        extra = {"call": index, "start": call.start, "reference_iters": oracle.iters,
                 "program_cg_iters": call.cg_iters, "reference_values": oracle.values,
                 "program_values": call.values, "reference_grad0": oracle.grads[0],
                 "program_params": call.end, "reference_params": oracle.params[-1]}
        return loss_gap, change_gap, extra

    def check(self, limits):
        """The worst of the followed calls, and ``capped_solves``: the block
        solves, of every call, that ran all ``cg_max_iters`` iterations (a
        solve that stopped by the tolerance on the last one counts too)."""
        cap = self.traffic["cg_max_iters"]
        capped = sum(i >= cap for c in self.log for i in c.cg_iters)
        followed = [self.follow(i) for i in self.checked_calls()]
        values = {"loss_gap": max(f[0] for f in followed),
                  "change_gap": max(f[1] for f in followed), "capped_solves": capped}
        return checks_from(values, limits), {"cg_iters": [c.cg_iters for c in self.log],
                                             "followed": [f[2] for f in followed]}


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)
