"""Classify traffic: a closed loop of multi-class Laplace fits, one client.
Each call fits ``GPMulticlassClassifier`` on the configuration's labelled
points from f = 0 (R&W Alg. 3.3: Newton steps, each one stacked
B = I + W^1/2 K W^1/2 solve by CG with a Nyström-Woodbury preconditioner
past the facade's CG threshold) and reads its class probabilities at ``m``
points, the next of a pool of ``pool`` test sets drawn from the run's seed.
The unit is the fit's Newton steps.

Traffic parameters: ``solver`` (the estimator's), ``m``, ``pool``,
``cg_tol`` and ``cg_max_iters`` (each Newton step's CG), ``max_iters`` (the
Newton cap; the Newton tolerance is the estimator's default).

The check: one call, drawn from the seed among the window's (set-up's
where the window ran none), against the float64 reference
(``reference/multiclass.py``): ``mode_err``, the largest gap of the mode at
a training point; ``prob_err``, the largest gap of a class probability at
that call's test points; ``predict_err``, the largest gap of those
probabilities from the ones float64 arithmetic gives for the call's own
mode (the prediction path alone: ``prob_err`` also holds the gap that the
Newton stopping rule leaves in the mode, which K(x, xs)^T (y - pi) sums
over thousands of points). Besides, over every call: ``capped_solves``,
Newton steps whose CG ran all ``cg_max_iters`` iterations. A fit that did
not converge is a failed call (:meth:`Job.failed`).
"""

from __future__ import annotations

import math
from typing import NamedTuple, Tuple

import numpy as np
import torch

from gpbench import data
from gpbench.jobs import checks_from
from gpbench.reference import multiclass as ref


def training_set(config: dict, device: torch.device):
    """(x, labels): n points and their angle classes
    floor((atan2(x_1, x_0) + pi) / (2 pi) C) mod C, from the
    configuration's own seed."""
    d = config["data"]
    if d["labels"] != "angle":
        raise ValueError(f"unknown labels {d['labels']!r}")
    classes = config["num_classes"]
    x = data.points(config, config["n"], data.generator(device, d["seed"], "train"), device)
    angle = torch.atan2(x[:, 1].double(), x[:, 0].double())
    labels = torch.floor((angle + math.pi) / (2.0 * math.pi) * classes).long() % classes
    return x, labels


class Answer(NamedTuple):
    test_set: int  # index into the pool
    f: torch.Tensor  # (C, n) the mode
    prob: torch.Tensor  # (C, m) class probabilities
    steps: int  # Newton steps
    cg_iters: Tuple[int, ...]  # each step's CG iterations
    converged: bool


class PortClassify:
    """The system under test."""

    def __init__(self, config, traffic, x, labels, device):
        from gaussian_process_tpu_torch import convert, ops
        from gaussian_process_tpu_torch.models.estimators import GPMulticlassClassifier

        k = config["kernel"]
        params = convert.params_from_numpy(
            {"sigma": k["sigma"], "lengthscale": k["lengthscale"]}, device=device, dtype=x.dtype)
        self.model = lambda: GPMulticlassClassifier(ops.RBF(), config["num_classes"], params,
                                                    device=device)
        self.config, self.traffic, self.x, self.labels = config, traffic, x, labels

    def fit_predict(self, xs):
        t = self.traffic
        model = self.model().fit(self.x, self.labels, max_iters=t["max_iters"],
                                 solver=t["solver"], cg_tol=t["cg_tol"],
                                 cg_max_iters=t["cg_max_iters"],
                                 precond_rank=self.config["rank"])
        prob = model.predict_proba(xs)
        st = model.state
        return st.f_mode, prob, int(st.iters), tuple(st.cg_iters), bool(st.converged)


class ControlClassify:
    """The plain reference in the program's place, at the cell's own
    tolerances (the Newton one the estimator's default), rank and stopping
    rule, computed in TF32."""

    def __init__(self, config, traffic, x, labels, device):
        self.config, self.x, self.labels = config, x, labels
        newton_tol = max(10.0 * math.sqrt(torch.finfo(x.dtype).eps), traffic["cg_tol"])
        self.settings = ref.Settings(ref.TF32, newton_tol, traffic["max_iters"],
                                     traffic["cg_tol"], traffic["cg_max_iters"], config["rank"],
                                     "worst", config["reference"]["landmark_seed"])

    def fit_predict(self, xs):
        c = self.config
        k = c["kernel"]
        fit = ref.blocked_fit(self.x, self.labels, c["num_classes"], sigma=k["sigma"],
                              lengthscale=k["lengthscale"], settings=self.settings)
        prob = ref.probabilities(self.x, self.labels, fit.pi, xs, sigma=k["sigma"],
                                 lengthscale=k["lengthscale"], prec=self.settings.prec)
        return fit.f, prob, fit.iters, tuple(fit.cg_iters), fit.converged


SYSTEMS = {"port": PortClassify, "control": ControlClassify}


class Job:
    unit = "step"
    end_to_end = "train_step_s"

    def __init__(self, config, traffic, seed, device, system="port"):
        self.config, self.traffic, self.seed, self.device = config, traffic, seed, device
        self.system_name = system
        self.answers = []  # every call's, set-up's first

    def setup(self, warm: bool = True):
        """``warm`` is always taken: set-up's call is checked where the
        window runs none."""
        c, t = self.config, self.traffic
        self.x, self.labels = training_set(c, self.device)
        gen = data.generator(self.device, self.seed, "queries")
        self.pool = data.points(c, t["pool"] * t["m"], gen, self.device).view(
            t["pool"], t["m"], c["d"])
        self.system = SYSTEMS[self.system_name](c, t, self.x, self.labels, self.device)
        self._call()  # warms every shape
        _sync(self.device)

    def _call(self) -> int:
        i = len(self.answers) % self.traffic["pool"]
        answer = Answer(i, *self.system.fit_predict(self.pool[i]))
        self.answers.append(answer)
        return answer.steps

    def call(self) -> int:
        steps = self._call()
        _sync(self.device)
        return steps

    def failed(self) -> int:
        """Window calls whose fit did not converge or whose answers are not
        finite."""
        return sum(not (a.converged and bool(torch.isfinite(a.f).all())
                        and bool(torch.isfinite(a.prob).all())) for a in self.answers[1:])

    def products(self) -> dict:
        c = self.config
        return {"family": c["kernel"]["family"], "n": c["n"], "d": c["d"],
                "r": c["num_classes"]}

    def release(self):
        self.system = None

    def checked_call(self) -> int:
        """One window call drawn from the seed; set-up's where there is none."""
        window = len(self.answers) - 1
        if window < 1:
            return 0
        rng = np.random.default_rng(data.sub_seed(self.seed, "check"))
        return 1 + int(rng.integers(window))

    def check(self, limits):
        c, t, r = self.config, self.traffic, self.config["reference"]
        k = c["kernel"]
        index = self.checked_call()
        answer = self.answers[index]
        oracle = ref.blocked_fit(self.x, self.labels, c["num_classes"], sigma=k["sigma"],
                                 lengthscale=k["lengthscale"], settings=ref.Settings(
                                     ref.FLOAT64, r["newton_tol"], r["newton_max_iters"],
                                     r["cg_tol"], r["cg_max_iters"], r["rank"], "column",
                                     r["landmark_seed"]))
        if not (oracle.converged and oracle.solved):
            raise RuntimeError(f"the reference did not converge: {oracle.iters} Newton steps, "
                               f"CG iterations {oracle.cg_iters}")
        xs = self.pool[answer.test_set]
        kw = {"sigma": k["sigma"], "lengthscale": k["lengthscale"], "prec": ref.FLOAT64}
        prob = ref.probabilities(self.x, self.labels, oracle.pi, xs, **kw)
        own = ref.probabilities(self.x, self.labels, torch.softmax(answer.f.double(), dim=0),
                                xs, **kw)
        cap = t["cg_max_iters"]
        p = answer.prob.double()
        values = {"mode_err": float(torch.max(torch.abs(answer.f.double() - oracle.f))),
                  "prob_err": float(torch.max(torch.abs(p - prob))),
                  "predict_err": float(torch.max(torch.abs(p - own))),
                  "capped_solves": sum(i >= cap for a in self.answers for i in a.cg_iters)}
        return checks_from(values, limits), {
            "call": index, "test_set": answer.test_set,
            "program_steps": sorted({a.steps for a in self.answers}),
            "program_cg_iters": sorted({a.cg_iters for a in self.answers}),
            "reference_steps": oracle.iters, "reference_cg_iters": oracle.cg_iters,
            "mode_abs_max": float(torch.max(torch.abs(oracle.f)))}


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)
