"""Serving: back-to-back folded ensemble requests from one client through
``serving.build_experiment_predict_fn``'s ``predict(batch, seed)``, each on
the next batch of a pool made from the run's seed and with a sampler seed
of its own. One completed request, drawn from the seed as the window runs
(a reservoir of one), is kept and compared with the reference's answer to
the same batch and seed once the window has closed.

Traffic keys: ``rows`` (the request's batch), ``pool`` (distinct batches),
``split`` (the eval function served: 'predict', or 'val' for one window
where 'predict' chains autoregressive windows).
"""
from __future__ import annotations

import random

import torch

from benchmark import inputs, system
from benchmark.reference import compare
from benchmark.reference import model as ref_model


class Session:
    unit_syncs = True  # a request ends when its answer is on the device: the host clock times it

    def __init__(self, cell, run):
        from dyffusion_tpu_torch.interface import build_experiment
        from dyffusion_tpu_torch.serving import build_experiment_predict_fn

        tr, conf = cell.traffic, cell.config
        self.run, self.conf = run, conf
        rows = int(tr["rows"])
        self.sys = system.System(cell, run, [f"datamodule.eval_batch_size={rows}"])
        exp, _, _, eval_fns, _ = build_experiment(self.sys.c2, self.sys.dm, interpolator=self.sys.interpolator,
                                                  device=run.device)
        exp.model.load_state_dict(self.sys.weights["forecaster"])
        self.exp = exp
        self.predict, _, info = build_experiment_predict_fn(exp, eval_fns, self.sys.dm, None, split=tr["split"],
                                                            batch_size=rows)
        self.members = int(info["ensemble_members"])
        g = inputs.generator(run.seed, run.device, "batches")
        self.pool = inputs.make_batches(conf["data"], g, int(tr["pool"]), rows, conf["reference"].get("window", 1),
                                        tuple(conf["grid"]), conf["reference"]["channels"], run.device)
        self.predict(self.pool[0], inputs.sub_seed(run.seed, "warm-up"))  # warm-up: every shape of a request
        system.sync(run.device)
        run.work["frames"] = float(self.members * rows * conf["reference"]["horizon"])
        self.rows = rows
        self._pick = random.Random(inputs.sub_seed(run.seed, "reservoir"))
        self.kept = None

    def unit(self, i: int) -> None:
        b, seed = i % len(self.pool), system.request_seed(self.run.seed, i)
        out = self.predict(self.pool[b], seed)
        system.sync(self.run.device)
        if self._pick.random() * (i + 1) < 1.0:
            self.kept = (b, seed, out)

    def finish(self) -> None:
        system.sync(self.run.device)

    def work(self) -> dict:
        return ref_model.flops_and_bytes(self.conf["reference"], "serve", self.rows, self.members,
                                         tuple(self.conf["grid"]))

    def check(self):
        """(numbers, limits): the kept answer against the reference's."""
        b, seed, out = self.kept
        batch, weights = self.pool[b], self.sys.weights
        self.predict = self.exp = None
        self.sys.interpolator = None
        self.sys.close()
        system.free_device_memory()
        system.reference_numerics()
        return judge(self.conf["reference"], weights, batch, seed, self.members, out), self.conf["limits"]["serve"]


def judge(ref: dict, weights, batch, seed: int, members: int, out: torch.Tensor, fp8: bool = False) -> dict:
    """The numbers of an answer ``out`` (or, with ``fp8``, of the control)
    against the reference: followed step by step where the configuration's
    reference says ``stepwise`` (the sampler's rounding grows over its
    steps), else whole."""
    if ref.get("stepwise"):
        if fp8:
            out = ref_model.serve(ref, weights, batch, seed, members, fp8=True)
        want = ref_model.serve(ref, weights, batch, seed, members, forced=out)
        return compare.stepwise_numbers(out, want)
    want = ref_model.serve(ref, weights, batch, seed, members)
    if fp8:
        out = ref_model.serve(ref, weights, batch, seed, members, fp8=True)
    return compare.serve_numbers(out, want)
