"""The five baselines through the port's CLI on the CPU (port only): for
every ``{synthetic, navier_stokes, spring_mesh}_{time_conditioned,
simultaneous, ddpm, ddpm_v2, mcvd}`` preset, at tiny widths, train one
epoch, ``mode=test``, and serve the run by id (``serving.build_predict_fn``):
finite scores, the (N, B, T, H, W, C) forecast, and the same seed answering
the same. Then, on the synthetic presets, another seed answers otherwise
(MC dropout, or the diffusion noise) and the command with one more epoch
resumes the run; the LDM-DDPM's learned logvar resumes exactly: one epoch, a restart, one more epoch equals two epochs in
one run, the logvar, the weights and the EMA bit for bit.
"""
import json
import os

import numpy as np
import pytest
import torch

from dyffusion_tpu_torch import train
from dyffusion_tpu_torch.config import get_config
from dyffusion_tpu_torch.data import write_fake_benchmark_dir
from dyffusion_tpu_torch.interface import get_datamodule, reload_trainer, run_experiment
from dyffusion_tpu_torch.serving import build_predict_fn
from dyffusion_tpu_torch.utils import registry_api
from dyffusion_tpu_torch.utils.naming import get_run_id
from tests._torch_port_helpers import torch_threads_share_of_cores  # noqa: F401 (autouse fixture)

METHODS = ("time_conditioned", "simultaneous", "ddpm", "ddpm_v2", "mcvd")
DIFFUSION = ("ddpm", "ddpm_v2", "mcvd")
TINY = {
    "synthetic": [
        "datamodule.spatial=(8,8)", "datamodule.channels=1", "datamodule.horizon=2",
        "datamodule.prediction_horizon=4", "datamodule.n_traj=5", "datamodule.n_time=8",
        "datamodule.batch_size=4", "datamodule.eval_batch_size=2", "model.dim=8", "model.dim_mults=(1,)",
        "model.block_dropout=0.2",
    ],
    "navier_stokes": [
        "datamodule.horizon=2", "datamodule.prediction_horizon=4", "datamodule.batch_size=4",
        "datamodule.eval_batch_size=4", "model.dim=4", "model.upsample_dims=(64,64)", "trainer.accumulate_grad_batches=1",
    ],
    "spring_mesh": [
        "datamodule.horizon=2", "datamodule.prediction_horizon=4", "datamodule.batch_size=4",
        "datamodule.eval_batch_size=4", "model.dim=16",
    ],
}
COMMON = ["module.num_predictions=2", "module.num_predictions_test=3", "trainer.max_epochs=1"]


@pytest.fixture(scope="module")
def archives(tmp_path_factory):
    out = {}
    for dataset, system in (("navier_stokes", "navier-stokes"), ("spring_mesh", "spring-mesh")):
        root = str(tmp_path_factory.mktemp(dataset))
        write_fake_benchmark_dir(root, system, n_traj={"train": 2, "val": 1, "test": 1}, n_time=5, seed=1)
        out[dataset] = root
    return out


def _args(dataset, method, registry, archives):
    args = TINY[dataset] + COMMON + [f"registry_dir={registry}"]
    if dataset in archives:
        args.append(f"datamodule.data_dir={archives[dataset]}")
    if method in DIFFUSION:
        args.append("diffusion.timesteps=6")
    return args


@pytest.mark.parametrize("method", METHODS)
@pytest.mark.parametrize("dataset", ["synthetic", "navier_stokes", "spring_mesh"])
def test_cli_train_test_and_serve(dataset, method, tmp_path, archives, capsys):
    preset = f"{dataset}_{method}"
    args = _args(dataset, method, str(tmp_path), archives)
    best = train.main([f"experiment={preset}", *args, "--device=cpu"])
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    config = get_config(preset, args)
    run_id = get_run_id(config)
    assert np.isfinite(best) and out["run_dir"] == os.path.join(str(tmp_path), run_id)
    assert {"best", "last", "config.json", "meta.json"} <= set(os.listdir(out["run_dir"]))
    crps = train.main(["mode=test", f"run_id={run_id}", f"registry_dir={tmp_path}", "--device=cpu"])
    assert np.isfinite(crps)

    predict, specs, info = build_predict_fn(str(tmp_path), run_id, device="cpu")
    dm = get_datamodule(config)
    dm.setup()
    batch = next(dm.predict_batches())
    a, b = predict(batch, 0), predict(batch, 0)
    h = config["datamodule"]["prediction_horizon"]
    assert tuple(a.shape) == (2, batch["dynamics"].shape[0], h) + tuple(batch["dynamics"].shape[2:])
    assert a.dtype == torch.float32 and bool(torch.isfinite(a).all()) and torch.equal(a, b)
    assert info["experiment"] == ("TimeConditioned" if method == "time_conditioned" else "Simultaneous") + \
        "ForecastingExperiment" and info["dynamics_frames_read"] == [0]
    if dataset == "synthetic":  # MC dropout or diffusion noise: members and seeds differ
        assert float(a.std(dim=0).max()) > 0 and not torch.equal(a, predict(batch, 1))
        # the same command with one more epoch resumes the run from its last slot
        first = registry_api.get_run_meta(str(tmp_path), run_id)
        train.main([f"experiment={preset}", *args, "trainer.max_epochs=2", "--device=cpu"])
        meta = registry_api.get_run_meta(str(tmp_path), run_id)
        assert first["epochs_done"] == 1 and meta["epochs_done"] == 2 and meta["last_step"] == 2 * first["last_step"]


# one train row, so each epoch is one batch whatever the (not checkpointed) shuffle
ONE_ROW = TINY["synthetic"] + [
    "datamodule.n_traj=2", "datamodule.n_time=3", "datamodule.prediction_horizon=null", "datamodule.batch_size=1",
    "module.use_ema=true",
    "module.optimizer.lr=1e-2", "diffusion.timesteps=6", "diffusion.learn_logvar=true",
]


def test_learned_logvar_resumes_exactly(tmp_path):
    def run(registry, epochs):
        config = get_config("synthetic_ddpm_v2", ONE_ROW + [f"registry_dir={registry}", f"trainer.max_epochs={epochs}"])
        return run_experiment(config, device="cpu")[0]

    whole = run(tmp_path / "whole", 2)
    first = run(tmp_path / "split", 1)
    lv0 = first.experiment.model._diffusion_logvar.detach().clone()
    assert float(lv0.abs().max()) > 0  # trained away from logvar_init 0
    resumed = run(tmp_path / "split", 2)
    assert [h["epoch"] for h in resumed.history] == [1] and resumed.state.step == whole.state.step == 2
    for name, x, y in (("weights", resumed.experiment.model.state_dict(), whole.experiment.model.state_dict()),
                       ("ema", resumed.state.ema, whole.state.ema)):
        assert "_diffusion_logvar" in x and all(torch.equal(x[k], y[k]) for k in y), name
    # a reload (mode=test, serving) restores the trained logvar
    run_id = os.path.basename(resumed.ckpt.run_dir)
    reloaded = reload_trainer(str(tmp_path / "split"), run_id, slot="last", device="cpu")
    assert torch.equal(reloaded.experiment.model._diffusion_logvar, resumed.experiment.model._diffusion_logvar)
    assert not torch.equal(reloaded.experiment.model._diffusion_logvar, lv0)
