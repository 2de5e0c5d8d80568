"""The port's training loop on the CPU: ``Trainer.evaluate`` for both stages
against the JAX package's, then, on the port alone, ``run_experiment`` for
both stages, the fit loop's stopping rules and log cadence, folded
accumulation in ``build_trainer``, mixed precision's casts, and the streamed
metric sums. The train step's arithmetic is held against the JAX package in
``test_torch_port_train*.py``."""
import jax
import numpy as np
import pytest
import torch

from dyffusion_tpu import config as jax_config
from dyffusion_tpu import interface as jax_interface
from dyffusion_tpu.models import make_apply_fn
from dyffusion_tpu.training.trainer import Trainer as JaxTrainer
from dyffusion_tpu_torch.config import get_config
from dyffusion_tpu_torch.interface import build_trainer, run_experiment
from dyffusion_tpu_torch.models import unet_state_dict_from_jax
from dyffusion_tpu_torch.training import metric_sums, mixed_precision_loss
from dyffusion_tpu_torch.utils.evaluation import evaluate_ensemble_prediction
from tests._torch_port_helpers import to_numpy_tree
from tests._torch_port_helpers import torch_threads_share_of_cores  # noqa: F401 (autouse fixture)

TINY = [
    "datamodule.spatial=(8,8)", "datamodule.channels=1", "datamodule.horizon=3",
    "datamodule.n_traj=5", "datamodule.n_time=8", "datamodule.batch_size=2",
    "datamodule.eval_batch_size=2", "model.dim=8", "model.dim_mults=(1,)",
    "module.num_predictions=2", "diffusion.additional_interpolation_steps=1",
]
# 3 train trajectories x 5 windows each = 15 rows: 7 batches of 2 per epoch
BATCHES_PER_EPOCH = 7
PRESETS = {1: "synthetic_interpolation", 2: "synthetic_dyffusion"}


@pytest.fixture(scope="module")
def evaluations(tmp_path_factory):
    """{stage: (JAX metrics, port metrics)} of one ``evaluate("val")`` per
    stage, both packages' trainers built from the same config, the port's
    weights converted from the JAX ones; stage 2 runs over its own stage-1
    model as the in-memory interpolator. Dropout rates are 0 (the tiny
    config's), so both sides compute the same deterministic metrics."""
    out, j_ip, p_ip = {}, None, None
    for stage, preset in PRESETS.items():
        jc, pc = jax_config.get_config(preset, TINY), get_config(preset, TINY)
        jdm = jax_interface.get_datamodule(jc)
        jdm.setup()
        exp, model, variables, loss_fn, eval_fns, _ = jax_interface.build_experiment(jc, jdm, interpolator=j_ip)
        jt = JaxTrainer(exp, jdm, jax_interface.create_train_state(jc, variables), loss_fn, eval_fns,
                        run_dir=str(tmp_path_factory.mktemp(f"stage{stage}")), seed=jc["seed"],
                        save_checkpoints=False)
        pt = build_trainer(pc, interpolator=p_ip, device="cpu")
        pt.experiment.model.load_state_dict(unet_state_dict_from_jax(to_numpy_tree(variables)))
        out[stage] = (jt.evaluate("val"), pt.evaluate("val"))
        j_ip, p_ip = (make_apply_fn(model), variables), pt.experiment.model
    return out


@pytest.mark.parametrize("stage", sorted(PRESETS))
def test_evaluate_matches_jax(evaluations, stage):
    """Every metric key and value of one validation pass (several batches,
    streamed sums over batches of 2, 2 and 1 rows), within 1e-5 relative:
    f32 on both sides, sums in another order (measured: 1.2e-7). With
    dropout off the members agree, so the SSR reads 0 on both sides, up to
    float noise, and is compared at 1e-6 absolute."""
    want, got = evaluations[stage]
    timing = "val/frames_per_sec_per_chip"
    assert sorted(got) == sorted(want) and timing in got
    n_t = 2 if stage == 1 else 3  # stage 1 interpolates i = 1..h-1; stage 2 forecasts t = 1..h
    assert {f"val/t{i}/{m}" for i in range(1, n_t + 1) for m in ("mse", "crps", "ssr")} < set(got)
    for k in sorted(want):
        if k != timing:
            np.testing.assert_allclose(got[k], want[k], rtol=1e-5, atol=1e-6 if k.endswith("ssr") else 0, err_msg=k)
    assert got["val/crps"] > 0 and got["val/mse"] > 0


def test_run_experiment_trains_both_stages_and_logs(tmp_path):
    logs = []
    overrides = TINY + ["trainer.max_epochs=2", "trainer.log_every_n_steps=4", "module.use_ema=true",
                        f"registry_dir={tmp_path}"]
    tr1, best1 = run_experiment(get_config("synthetic_interpolation", overrides), device="cpu",
                                log_fn=lambda m, step: logs.append((step, m)))
    tr2, best2 = run_experiment(get_config("synthetic_dyffusion", overrides), interpolator=tr1.experiment.model,
                                device="cpu")
    assert np.isfinite(best1) and np.isfinite(best2)
    assert best1 == min(h["val/crps"] for h in tr1.history)
    assert tr1.state.step == tr2.state.step == 2 * BATCHES_PER_EPOCH
    assert tr1.state.ema_num_updates == 2 * BATCHES_PER_EPOCH
    assert [h["epoch"] for h in tr2.history] == [0, 1]
    assert {"val/t1/mse", "val/t3/crps", "val/avg/ssr", "val/crps"} <= set(tr2.history[-1])
    # stage 2 trains against a frozen copy of the interpolator; stage 1's own model stays trainable
    assert all(not p.requires_grad for p in tr2.experiment.engine.interpolator.parameters())
    assert all(p.requires_grad for p in tr1.experiment.model.parameters())
    # in-epoch logs at every 4th step, and one epoch line per epoch
    assert [s for s, m in logs if "train/loss" in m] == [4, 8, 12]
    assert [s for s, m in logs if "train/loss_epoch" in m] == [7, 14]


def test_fit_stops_at_max_steps():
    trainer = build_trainer(get_config("synthetic_interpolation", TINY + ["trainer.max_steps=3"]), device="cpu")
    trainer.fit()
    assert trainer.state.step == 3 and len(trainer.history) == 1


def test_fit_stops_early_when_the_monitor_does_not_improve():
    """lr 0: the weights never move, the seeded validation repeats its score,
    so patience 1 stops the run after its second epoch."""
    overrides = TINY + ["trainer.max_epochs=5", "trainer.early_stopping_patience=1",
                        "module.optimizer={'name': 'adamw', 'lr': 0.0}"]
    trainer = build_trainer(get_config("synthetic_interpolation", overrides), device="cpu")
    trainer.fit()
    assert len(trainer.history) == 2
    assert trainer.history[0]["val/crps"] == trainer.history[1]["val/crps"]


def test_folded_accumulation_runs_micro_batches_as_one_batch():
    overrides = TINY + ["trainer.max_epochs=1", "trainer.accumulate_grad_batches=2",
                        "trainer.fold_accumulation_into_batch=true"]
    trainer = build_trainer(get_config("synthetic_interpolation", overrides), device="cpu")
    assert trainer.datamodule.batch_size == 4 and trainer.state.fold_factor == 2
    assert trainer.state.optimizer.accumulate_grad_batches == 1
    trainer.fit()
    # 15 rows make 3 folded batches of 4; step counts the 6 micro-batches
    assert trainer.state.step == 6


def test_mixed_precision_loss_casts_weights_and_batch_and_returns_f32_grads():
    seen = {}
    model = torch.nn.Linear(3, 2)

    def loss_fn(params, batch, generator):
        seen["params"] = {k: v.dtype for k, v in params.items()}
        seen["batch"] = {k: v.dtype for k, v in batch.items()}
        out = torch.func.functional_call(model, params, (batch["x"],))
        return out.float().square().mean(), {}

    loss, _ = mixed_precision_loss(loss_fn, model)(None, {"x": torch.ones(4, 3), "i": torch.arange(4)}, None)
    loss.backward()
    assert set(seen["params"].values()) == {torch.bfloat16}
    assert seen["batch"] == {"x": torch.bfloat16, "i": torch.int64}
    assert model.weight.grad.dtype == torch.float32 and loss.dtype == torch.float32


@pytest.mark.parametrize("n_batches", [1, 3])
def test_metric_sums_reproduce_the_ensemble_metrics(n_batches):
    """Streamed per-batch sums, added over batches, give the same MSE, CRPS
    and SSR as the metrics of the whole split at once."""
    g = np.random.default_rng(n_batches)
    preds = g.normal(size=(5, 3 * n_batches, 4, 4, 1)).astype(np.float32)
    targets = g.normal(size=(3 * n_batches, 4, 4, 1)).astype(np.float32)
    total = None
    for b in range(n_batches):
        sl = slice(3 * b, 3 * b + 3)
        part = metric_sums(torch.from_numpy(preds[:, sl]), torch.from_numpy(targets[sl]))
        total = part if total is None else {k: total[k] + part[k] for k in part}
    n = float(total["n"])
    mse, crps = float(total["sq"]) / n, float(total["crps"]) / n
    want = evaluate_ensemble_prediction(preds, targets)
    np.testing.assert_allclose(mse, want["mse"], rtol=1e-5)
    np.testing.assert_allclose(crps, want["crps"], rtol=1e-5)
    np.testing.assert_allclose(np.sqrt(float(total["var"]) / n) / np.sqrt(mse), want["ssr"], rtol=1e-5)
