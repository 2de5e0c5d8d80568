"""MCVD over NCSN++ through the port's CLI on the CPU:
``experiment=synthetic_mcvd model.name=ncsnpp`` (and ``ncsnpp_spade``) at
tiny widths trains one epoch into the run directory the JAX package names
(same config, same run id), resumes with one more epoch, runs
``mode=test``, and serves the run by id (``serving.build_predict_fn``):
finite scores, the (N, B, T, H, W, C) forecast, one seed answering the
same and another seed otherwise."""
import json
import os

import numpy as np
import pytest
import torch

from dyffusion_tpu import config as jax_config
from dyffusion_tpu.utils import naming as jax_naming
from dyffusion_tpu_torch import train
from dyffusion_tpu_torch.config import get_config
from dyffusion_tpu_torch.interface import get_datamodule
from dyffusion_tpu_torch.serving import build_predict_fn
from dyffusion_tpu_torch.utils import registry_api
from dyffusion_tpu_torch.utils.naming import get_run_id
from tests._torch_port_helpers import torch_threads_share_of_cores  # noqa: F401 (autouse fixture)

TINY = [
    "datamodule.spatial=(8,8)", "datamodule.channels=1", "datamodule.horizon=2", "datamodule.prediction_horizon=4",
    "datamodule.n_traj=5", "datamodule.n_time=8", "datamodule.batch_size=4", "datamodule.eval_batch_size=2",
    "model.dim=8", "model.dim_mults=(1,2)", "model.num_res_blocks=1", "model.attn_resolutions=(4,)",
    "model.n_head_channels=8", "model.dropout=0.1", "module.num_predictions=2", "module.num_predictions_test=3",
    "trainer.max_epochs=1", "diffusion.timesteps=6",
]
MODELS = {
    "ncsnpp": ["model.name=ncsnpp", "model.embedding_type=fourier", "model.cond_emb=true"],
    "ncsnpp_spade": ["model.name=ncsnpp_spade", "model.spade_dim=8"],
}


@pytest.mark.parametrize("model", list(MODELS))
def test_cli_train_resume_test_and_serve(model, tmp_path, capsys):
    args = TINY + MODELS[model] + [f"registry_dir={tmp_path}"]
    config = get_config("synthetic_mcvd", args)
    want = jax_config.get_config("synthetic_mcvd", args)
    run_id = get_run_id(config)
    assert config == want and run_id == jax_naming.get_run_id(want)

    best = train.main(["experiment=synthetic_mcvd", *args, "--device=cpu"])
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert np.isfinite(best) and out["run_dir"] == os.path.join(str(tmp_path), run_id)
    assert {"best", "last", "config.json", "meta.json"} <= set(os.listdir(out["run_dir"]))
    first = registry_api.get_run_meta(str(tmp_path), run_id)
    train.main(["experiment=synthetic_mcvd", *args, "trainer.max_epochs=2", "--device=cpu"])
    meta = registry_api.get_run_meta(str(tmp_path), run_id)
    assert first["epochs_done"] == 1 and meta["epochs_done"] == 2 and meta["last_step"] == 2 * first["last_step"]

    crps = train.main(["mode=test", f"run_id={run_id}", f"registry_dir={tmp_path}", "--device=cpu"])
    assert np.isfinite(crps)

    predict, specs, info = build_predict_fn(str(tmp_path), run_id, device="cpu")
    dm = get_datamodule(config)
    dm.setup()
    batch = next(dm.predict_batches())
    a, b = predict(batch, 0), predict(batch, 0)
    assert tuple(a.shape) == (2, batch["dynamics"].shape[0], 4) + tuple(batch["dynamics"].shape[2:])
    assert a.dtype == torch.float32 and bool(torch.isfinite(a).all()) and torch.equal(a, b)
    assert info["experiment"] == "SimultaneousForecastingExperiment"
    assert float(a.std(dim=0).max()) > 0 and not torch.equal(a, predict(batch, 1))
