"""The port's Navier-Stokes and spring-mesh paths end to end on the CPU, at a
small width, through the CLI as a user runs it: stage 1, stage 2 from the
registry by run id, ``mode=test`` over full test trajectories through the
autoregressive chain, and serving by run id; and an exact resume with a
BatchNorm backbone, its running statistics included."""
import numpy as np
import pytest
import torch

from chip_smoke import _boundary_error
from dyffusion_tpu_torch import train
from dyffusion_tpu_torch.config import get_config
from dyffusion_tpu_torch.data import write_fake_benchmark_dir
from dyffusion_tpu_torch.interface import reload_trainer, run_experiment
from dyffusion_tpu_torch.serving import build_predict_fn
from dyffusion_tpu_torch.training import TrainState
from dyffusion_tpu_torch.training.checkpoint import CheckpointManager
from dyffusion_tpu_torch.utils.naming import get_run_id
from tests._torch_port_helpers import torch_threads_share_of_cores  # noqa: F401 (autouse fixture)

SYSTEMS = {"navier_stokes": "navier-stokes", "spring_mesh": "spring-mesh"}
TINY = {
    "navier_stokes": ["model.dim=4", "model.upsample_dims=(64,64)"],
    "spring_mesh": ["model.dim=32"],
}
COMMON = [
    "datamodule.horizon=4", "datamodule.prediction_horizon=8", "datamodule.batch_size=4",
    "datamodule.eval_batch_size=4", "module.num_predictions=3", "module.num_predictions_test=2",
    "trainer.max_epochs=2",
]


def _archive(tmp_path, preset):
    root = str(tmp_path / "data")
    write_fake_benchmark_dir(root, SYSTEMS[preset], n_traj={"train": 2, "val": 1, "test": 1}, n_time=12)
    return root


def _running_stats(model):
    return {k: v.clone() for k, v in model.state_dict().items() if "running" in k}


@pytest.mark.parametrize("preset", ["navier_stokes", "spring_mesh"])
def test_cli_two_stages_test_mode_and_serving(tmp_path, preset):
    """Training moves the running statistics; evaluation and serving leave
    them as they are; the served forecast meets the boundary conditions in
    every frame of both autoregressive windows (and the untouched sampler
    output does not: the negative control); a seed repeats its answer and
    another seed does not."""
    registry = str(tmp_path / "runs")
    common = COMMON + TINY[preset] + [f"datamodule.data_dir={_archive(tmp_path, preset)}", f"registry_dir={registry}"]
    best1 = train.main([f"experiment={preset}_interpolation", *common, "--device=cpu"])
    id1 = get_run_id(get_config(f"{preset}_interpolation", common))
    stage2 = common + [f"diffusion.interpolator_run_id={id1}"]
    best2 = train.main([f"experiment={preset}_dyffusion", *stage2, "--device=cpu"])
    id2 = get_run_id(get_config(f"{preset}_dyffusion", stage2))
    assert np.isfinite(best1) and np.isfinite(best2)
    for run_id in (id1, id2):  # the checkpoints hold trained running statistics (fresh: mean 0, var 1)
        stats = {k: v for k, v in CheckpointManager(f"{registry}/{run_id}", "val/crps").restore("last")["model"].items()
                 if "running_mean" in k}
        assert stats and all(float(v.abs().max()) > 0 for v in stats.values()), run_id

    crps = train.main(["mode=test", f"run_id={id2}", f"registry_dir={registry}", "--device=cpu"])
    assert np.isfinite(crps)

    trainer = reload_trainer(registry, id2, device="cpu")
    before = _running_stats(trainer.experiment.model)
    ip_before = _running_stats(trainer.experiment.engine.interpolator)
    assert ip_before and any(float(v.abs().max()) > 0 for k, v in ip_before.items() if "mean" in k)
    trainer.evaluate("val")
    predict, _, _ = build_predict_fn(registry, id2, device="cpu")
    batch = next(trainer.datamodule.predict_batches())
    a, b, other = predict(batch, 0), predict(batch, 0), predict(batch, 1)
    for model, was in ((trainer.experiment.model, before), (trainer.experiment.engine.interpolator, ip_before)):
        assert all(torch.equal(v, was[k]) for k, v in _running_stats(model).items())
    assert tuple(a.shape)[:3] == (3, batch["dynamics"].shape[0], 8) and bool(torch.isfinite(a).all())
    assert torch.equal(a, b) and not torch.allclose(a, other)
    for i in range(1, 9):
        time = batch["metadata_t0"] + batch["metadata_dt"] * i
        assert _boundary_error(preset, a[:, :, i - 1].numpy(), batch, time) <= 1e-6, i

    # negative control: the same sampler without the boundary hook misses them
    trainer.experiment.boundary_fn = None
    out = trainer.eval_fns["predict"](batch, torch.Generator().manual_seed(0), trainer.state.eval_params())
    assert _boundary_error(preset, out["t5_preds"].numpy(), batch, batch["metadata_t0"] + batch["metadata_dt"] * 5) > 1e-3


def _state_and_next_loss(trainer):
    state = {k: v.clone() for k, v in trainer.experiment.model.state_dict().items()}
    batch = next(trainer.datamodule.train_batches(rng=np.random.default_rng(0)))
    return trainer.state.step, state, float(trainer.train_step(trainer.state, trainer._put(batch))["loss"])


@pytest.mark.parametrize("restore_buffers", [True, False])
def test_resume_with_batchnorm_is_exact(tmp_path, monkeypatch, restore_buffers):
    """Stage 1 with a BatchNorm backbone (spring mesh): two epochs in one run
    == one epoch, a restart, one more epoch: weights, running statistics,
    step and the next step's loss, bit for bit. The negative control
    restarts with fresh running statistics: the runs part. One train row per
    split (the trainer's shuffle order is not part of a checkpoint, in the
    JAX package neither)."""
    data = str(tmp_path / "data")
    write_fake_benchmark_dir(data, "spring-mesh", n_traj={"train": 1, "val": 1, "test": 1}, n_time=5)
    one_row = ["datamodule.prediction_horizon=4", "datamodule.batch_size=1", "datamodule.eval_batch_size=1"]

    def run(registry, epochs):
        config = get_config("spring_mesh_interpolation", COMMON + TINY["spring_mesh"] + one_row + [
            f"datamodule.data_dir={data}", f"registry_dir={registry}", f"trainer.max_epochs={epochs}"])
        return run_experiment(config, device="cpu")[0]

    whole = _state_and_next_loss(run(tmp_path / "whole", 2))
    run(tmp_path / "split", 1)
    if not restore_buffers:
        load = TrainState.load_state_dict

        def load_without_buffers(self, state):
            kept = {k: v.clone() for k, v in self.model.named_buffers()}
            load(self, state)
            with torch.no_grad():
                for k, v in self.model.named_buffers():
                    v.copy_(kept[k])

        monkeypatch.setattr(TrainState, "load_state_dict", load_without_buffers)
    resumed = run(tmp_path / "split", 2)
    assert [h["epoch"] for h in resumed.history] == [1]
    split = _state_and_next_loss(resumed)
    assert any("running_var" in k for k in whole[1])
    same = [torch.equal(whole[1][k], split[1][k]) for k in whole[1] if "running" in k]
    if restore_buffers:
        assert split[0] == whole[0] and split[2] == whole[2] and all(same)
        assert all(torch.equal(whole[1][k], split[1][k]) for k in whole[1])
    else:
        assert split[0] == whole[0] and not all(same)
