"""Training: stage-2 optimizer steps of ``interface.build_trainer``'s
trainer back to back, each micro-batch the next of a pool made from the
run's seed. Set-up drives the trainer through its first ``checked_steps``
optimizer steps on distinct batches (also the warm-up) and keeps their
losses, the first step's gradient as the optimizer took it (AdamW's first
moment after one step over 1 - beta1) and the change of the weights after
them; the same trainer then runs the window. The reference follows those
steps from the same weights, batches and step seed once the window has
closed.

Traffic keys: ``rows`` (a micro-batch), ``pool`` (distinct micro-batches,
more than the checked steps take), ``checked_steps``.
"""
from __future__ import annotations

import torch

from benchmark import inputs, system
from benchmark.reference import compare
from benchmark.reference import model as ref_model


class Session:
    unit_syncs = False  # steps are queued back to back; CUDA events time them

    def __init__(self, cell, run):
        from dyffusion_tpu_torch.interface import build_trainer

        tr, conf = cell.traffic, cell.config
        self.run, self.conf = run, conf
        self.rows = int(tr["rows"])
        self.sys = system.System(cell, run, [f"datamodule.batch_size={self.rows}"])
        self.trainer = build_trainer(self.sys.c2, self.sys.dm, interpolator=self.sys.interpolator, device=run.device)
        state = self.trainer.state
        state.model.load_state_dict(self.sys.weights["forecaster"])
        self.step_seed = inputs.sub_seed(run.seed, "steps")
        state.generator.manual_seed(self.step_seed)
        self.acc = int(state.optimizer.accumulate_grad_batches)
        ref = conf["reference"]
        g = inputs.generator(run.seed, run.device, "batches")
        self.pool = inputs.make_batches(conf["data"], g, int(tr["pool"]), self.rows,
                                        ref.get("window", 1) + ref["horizon"], tuple(conf["grid"]),
                                        ref["channels"], run.device)
        self.checked = int(tr["checked_steps"])
        if self.checked * self.acc >= len(self.pool):
            raise ValueError("the pool must hold more micro-batches than the checked steps take")
        start = {k: p.detach().clone() for k, p in state.params.items()}
        b1 = state.optimizer.optimizer.defaults["betas"][0]
        self.losses, self.grads = [], None
        self.next = 0
        for step in range(self.checked):
            for _ in range(self.acc):
                self.losses.append(self._micro()["loss"].detach().float())
            if step == 0:
                opt = state.optimizer.optimizer
                # no first moment: the optimizer took no gradient
                self.grads = {k: opt.state[p].get("exp_avg", torch.zeros_like(p)).detach() / (1.0 - b1)
                              for k, p in state.params.items()}
        self.change = {k: p.detach() - start[k] for k, p in state.params.items()}
        self.last = self.losses[-1]
        system.sync(run.device)
        run.work["samples"] = float(self.rows * self.acc)

    def _micro(self):
        batch = self.pool[self.next % len(self.pool)]
        self.next += 1
        return self.trainer.train_step(self.trainer.state, batch)

    def unit(self, i: int) -> None:
        for _ in range(self.acc):
            self.last = self._micro()["loss"]

    def finish(self) -> None:
        system.sync(self.run.device)
        float(self.last)

    def work(self) -> dict:
        return ref_model.flops_and_bytes(self.conf["reference"], "train", self.rows, 1, tuple(self.conf["grid"]),
                                         self.acc)

    def check(self):
        """(numbers, limits): the checked steps against the reference's."""
        losses = [float(v) for v in self.losses]
        grads = {k: v.float() for k, v in self.grads.items()}
        batches = self.pool[: self.checked * self.acc]
        weights = self.sys.weights
        self.trainer = None
        self.sys.interpolator = None
        self.sys.close()
        system.free_device_memory()
        system.reference_numerics()
        ref = ref_model.train(self.conf["reference"], weights, batches, self.step_seed, self.checked, self.acc)
        numbers = compare.train_numbers(losses, ref["losses"], grads, ref["grads"], self.change, ref["change"])
        return numbers, self.conf["limits"]["train"]
