"""The port's spans (``utils.profiling.span``) on the CPU, at a tiny width.

Under ``torch.profiler`` a folded SST request records one
``serving.request`` holding an ``engine.forecaster`` per sampler step and
the interpolator calls its schedule implies; a Navier-Stokes request records
``UNetSimple``'s resamples and norms inside the network calls; a train step
records ``trainer.forward``, ``trainer.backward`` and ``trainer.update`` in
order. With no profiler running no span is entered; an export while a
profiler records holds the same graph as one without; and a request gives
the same answer bit for bit with the profiler on and off.
"""
from collections import Counter

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from dyffusion_tpu_torch import serving
from dyffusion_tpu_torch.config import get_config
from dyffusion_tpu_torch.data import write_fake_benchmark_dir
from dyffusion_tpu_torch.interface import build_experiment, build_trainer, get_datamodule
from dyffusion_tpu_torch.models.base import BatchNorm2d
from dyffusion_tpu_torch.utils import profiling
from tests._torch_port_helpers import torch_threads_share_of_cores  # noqa: F401 (autouse fixture)

SST = ["datamodule.spatial=(8,8)", "datamodule.channels=1", "datamodule.horizon=4", "model.dim=8",
       "model.dim_mults=(1,)", "model.block_dropout=0.3", "model.attn_dropout=0.1", "module.num_predictions=2",
       "diffusion.additional_interpolation_steps=3", "module.fold_members_into_batch=True",
       "datamodule.n_traj=2", "datamodule.n_time=12", "datamodule.batch_size=2", "datamodule.eval_batch_size=2",
       "trainer.save_checkpoints=False"]
NS = ["model.dim=4", "model.upsample_dims=(64,64)", "datamodule.horizon=4", "datamodule.prediction_horizon=8",
      "datamodule.batch_size=2", "datamodule.eval_batch_size=2", "module.num_predictions=2",
      "module.fold_members_into_batch=True", "trainer.save_checkpoints=False"]
SPANS = ("serving.", "engine.", "backbone.", "trainer.")


class Built:
    """A stage-2 experiment over a stage-1 interpolator, neither trained,
    its served predict and a batch of its split."""

    def __init__(self, system: str, overrides, split: str):
        self.c1 = get_config(f"{system}_interpolation", overrides)
        self.c2 = get_config(f"{system}_dyffusion", overrides)
        self.dm = get_datamodule(self.c1)
        self.dm.setup()
        _, self.interpolator, _, _, _ = build_experiment(self.c1, self.dm, device="cpu")
        self.exp, _, _, self.eval_fns, _ = build_experiment(self.c2, self.dm, interpolator=self.interpolator,
                                                            device="cpu")
        self.split = split
        self.predict, _, _ = serving.build_experiment_predict_fn(self.exp, self.eval_fns, self.dm, None, split=split)
        self.batch = next(iter(self.dm.split(split).batches(2)))


@pytest.fixture(scope="module")
def sst():
    return Built("synthetic", SST, "predict")


@pytest.fixture(scope="module")
def ns(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("ns"))
    write_fake_benchmark_dir(root, "navier-stokes", n_traj={"train": 2, "val": 1, "test": 1}, n_time=12)
    return Built("navier_stokes", NS + [f"datamodule.data_dir={root}"], "val")


def _spans(fn):
    """(result of ``fn()``, the spans it recorded as (name, start, end) in
    order of start) under a CPU profiler."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    events = [(e.name, e.time_range.start, e.time_range.end) for e in prof.events() if e.name.startswith(SPANS)]
    return out, sorted(events, key=lambda e: e[1])


def _inside(inner, outer) -> bool:
    return outer[1] <= inner[1] and inner[2] <= outer[2]


def test_sst_request_spans(sst):
    _, spans = _spans(lambda: sst.predict(sst.batch, 3))
    counts = Counter(name for name, _, _ in spans)
    requests = [s for s in spans if s[0] == "serving.request"]
    assert len(requests) == 1
    assert all(_inside(s, requests[0]) for s in spans)
    engine = sst.exp.engine
    steps, cfg = engine._steps, engine.cfg
    assert counts["engine.forecaster"] == len(steps.s) + 1  # the loop's steps and the peeled one
    last = steps.last_is_N_minus_1 and cfg.sampling_type == "cold" and cfg.use_cold_sampling_for_last_step
    refine = len(engine.mapping.dynamical_steps) if cfg.refine_intermediate_predictions else 0
    assert counts["engine.interpolator"] == len(steps.s) + int(last) + refine
    nets = [s for s in spans if s[0].startswith("engine.")]
    norms = [s for s in spans if s[0] == "backbone.norm"]
    assert norms and all(any(_inside(n, net) for net in nets) for n in norms)
    per_call = sum(isinstance(m, (torch.nn.GroupNorm,)) or type(m).__name__ == "ChannelLayerNorm"
                   for m in sst.exp.model.modules())
    assert counts["backbone.norm"] == per_call * len(nets)


def test_ns_request_resample_and_norm_spans(ns):
    _, spans = _spans(lambda: ns.predict(ns.batch, 5))
    counts = Counter(name for name, _, _ in spans)
    assert counts["serving.request"] == 1
    nets = [s for s in spans if s[0].startswith("engine.")]
    assert counts["engine.forecaster"] and counts["engine.interpolator"]
    backbone = [s for s in spans if s[0].startswith("backbone.")]
    assert all(any(_inside(b, net) for net in nets) for b in backbone)
    model = ns.exp.model
    upsamples = sum(isinstance(m, torch.nn.Upsample) for m in model.modules())
    norms = sum(isinstance(m, (BatchNorm2d, torch.nn.GroupNorm)) for m in model.modules())
    assert upsamples and counts["backbone.upsample"] == upsamples * len(nets)
    assert counts["backbone.resize"] == 2 * len(nets)  # to the working grid and back
    assert counts["backbone.norm"] == norms * len(nets)


def test_train_step_spans_in_order(sst):
    trainer = build_trainer(sst.c2, sst.dm, interpolator=sst.interpolator, device="cpu")
    batch = {k: torch.as_tensor(v) for k, v in next(iter(sst.dm.split("train").batches(2))).items()}
    _, spans = _spans(lambda: trainer.train_step(trainer.state, batch))
    phases = [s for s in spans if s[0].startswith("trainer.")]
    assert [s[0] for s in phases] == ["trainer.forward", "trainer.backward", "trainer.update"]
    assert all(a[2] <= b[1] for a, b in zip(phases, phases[1:]))
    interpolations = [s for s in spans if s[0] == "engine.interpolator"]
    assert interpolations and all(_inside(s, phases[0]) for s in interpolations)
    assert any(_inside(s, phases[0]) for s in spans if s[0] == "engine.forecaster")


def test_no_profiler_no_span_entered(sst, monkeypatch):
    entered = Counter()
    fast, annotate = profiling._record, torch.autograd.profiler.record_function.__enter__

    def count_fast(name):
        entered["fast"] += 1
        return fast(name)

    def count_annotate(self):  # torch's optimizers annotate their steps themselves
        entered["annotation"] += self.name.startswith(SPANS)
        return annotate(self)

    monkeypatch.setattr(profiling, "_record", count_fast)
    monkeypatch.setattr(torch.autograd.profiler.record_function, "__enter__", count_annotate)
    trainer = build_trainer(sst.c2, sst.dm, interpolator=sst.interpolator, device="cpu")
    batch = {k: torch.as_tensor(v) for k, v in next(iter(sst.dm.split("train").batches(2))).items()}
    sst.predict(sst.batch, 3)
    trainer.train_step(trainer.state, batch)
    assert entered == Counter()
    _spans(lambda: sst.predict(sst.batch, 3))  # the counted entry point is the one spans take
    assert entered["fast"] > 0 and entered["annotation"] == 0


def test_export_while_profiling_adds_no_node(sst):
    def export():
        exported, manifest = serving.export_experiment(sst.exp, sst.eval_fns, sst.dm, None, split="predict")
        return {k: manifest["graph"][k] for k in ("nodes", "loops", "b1_nodes")}

    plain = export()
    traced, spans = _spans(export)
    assert traced == plain and plain["loops"] >= 1
    assert not spans


def test_request_bit_identical_with_profiler(sst, ns):
    for built, seed in ((sst, 11), (ns, 12)):
        plain = built.predict(built.batch, seed)
        traced, spans = _spans(lambda: built.predict(built.batch, seed))
        assert spans and torch.equal(plain, traced)
