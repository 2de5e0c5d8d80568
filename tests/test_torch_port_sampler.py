"""The port's DYffusion sampler and serving slice against the JAX package.

Same numpy inputs and converted weights on both sides, f32, dropout rates 0
(the two frameworks cannot draw the same dropout masks); the stochastic
behaviour is checked on the port alone. Sampler outputs are compared at
1e-4: f32 sums in another order, carried through a few sampler steps.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dyffusion_tpu import config as jax_config
from dyffusion_tpu import interface as jax_interface
from dyffusion_tpu.data.synthetic import SyntheticDataModule as JaxSynthetic
from dyffusion_tpu.diffusion import dyffusion as jd
from dyffusion_tpu.models import Unet as JaxUnet
from dyffusion_tpu.models import make_apply_fn
from dyffusion_tpu.models.base import BackboneSpec as JaxSpec
from dyffusion_tpu.models.base import init_backbone
from dyffusion_tpu.utils import evaluation as jax_eval
from dyffusion_tpu.utils.workloads import SST_FAST_EVAL as JAX_SST_FAST_EVAL
from dyffusion_tpu.utils.workloads import sst_overrides as jax_sst_overrides
from dyffusion_tpu_torch import config as port_config
from dyffusion_tpu_torch import interface as port_interface
from dyffusion_tpu_torch import serving as port_serving
from dyffusion_tpu_torch.data.synthetic import SyntheticDataModule as PortSynthetic
from dyffusion_tpu_torch.diffusion import dyffusion as pd
from dyffusion_tpu_torch.models import Unet, unet_state_dict_from_jax
from dyffusion_tpu_torch.utils import evaluation as port_eval
from dyffusion_tpu_torch.utils.workloads import SST_FAST_EVAL, sst_overrides
from tests._torch_port_helpers import nhwc_to_nchw, to_numpy_tree
from tests._torch_port_helpers import torch_threads_share_of_cores  # noqa: F401 (autouse fixture)

TOL = dict(atol=1e-4, rtol=1e-4)

# ---------------------------------------------------------------------------
# step mapping, schedule DSL, precomputed steps
# ---------------------------------------------------------------------------
MAPPINGS = {
    "sst_k25": dict(timesteps=7, schedule="before_t1_only", additional_interpolation_steps=25),
    "linear_f2": dict(timesteps=4, schedule="linear", additional_interpolation_steps_factor=2,
                      interpolate_before_t1=False),
    "linear_f1_before_t1": dict(timesteps=4, schedule="linear", additional_interpolation_steps_factor=1),
}
SCHEDULES = [None, "only_dynamics", "only_dynamics_plus3", "only_dynamics_plus3_discrete", "every2", "every3rd",
             "first3", "first0.5", (0, 1, 3)]


@pytest.mark.parametrize("mapping", sorted(MAPPINGS))
@pytest.mark.parametrize("schedule", SCHEDULES, ids=str)
def test_schedule_and_precomputed_steps_match(mapping, schedule):
    kw = dict(MAPPINGS[mapping], sampling_schedule=schedule)
    try:
        j = jd.DyffusionEngine(jd.DyffusionConfig(**kw), None, None)
    except (AssertionError, ValueError) as e:
        with pytest.raises(type(e)):
            pd.DyffusionEngine(pd.DyffusionConfig(**kw), None, None)
        return
    p = pd.DyffusionEngine(pd.DyffusionConfig(**kw), None, None)
    assert dataclasses.asdict(p.mapping) == dataclasses.asdict(j.mapping)
    assert p.mapping.d_to_i == j.mapping.d_to_i
    assert p.mapping.dynamical_steps == j.mapping.dynamical_steps
    assert p.sampling_schedule == j.sampling_schedule
    assert pd.parse_sampling_schedule(schedule, p.mapping) == jd.parse_sampling_schedule(schedule, j.mapping)
    for f in dataclasses.fields(j._steps):
        a, b = getattr(p._steps, f.name), getattr(j._steps, f.name)
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b), err_msg=f.name)
        assert np.asarray(a).dtype == np.asarray(b).dtype, f.name
    d = np.arange(p.num_timesteps, dtype=np.float32)
    np.testing.assert_allclose(
        p.mapping.to_interpolation_step(torch.from_numpy(d)).numpy(),
        np.asarray(j.mapping.to_interpolation_step(jnp.asarray(d))), rtol=1e-7,
    )


# ---------------------------------------------------------------------------
# the engine's sampler
# ---------------------------------------------------------------------------
def _unet_pair(n_in, n_out, n_cond, seed):
    kw = dict(dim=8, dim_mults=(1, 2), resnet_block_groups=4, with_time_emb=True,
              num_input_channels=n_in, num_output_channels=n_out, num_conditional_channels=n_cond)
    jm = JaxUnet(**kw)
    v = to_numpy_tree(init_backbone(jm, JaxSpec(n_in, n_out, n_cond, (16, 16), True), jax.random.key(seed)))
    tm = Unet(**kw)
    tm.load_state_dict(unet_state_dict_from_jax(v))
    return make_apply_fn(jm), v, tm


@pytest.mark.parametrize("extra", [
    {},
    {"refine_intermediate_predictions": True},
    {"sampling_type": "naive"},
    {"use_cold_sampling_for_last_step": True, "sampling_schedule": "every2"},
    {"sampling_schedule": "only_dynamics_plus1"},
], ids=lambda e: ",".join(f"{k}={v}" for k, v in e.items()) or "cold")
def test_engine_sample_matches(extra):
    C = 2
    kw = dict(timesteps=3, additional_interpolation_steps=2, num_input_channels=C, **extra)
    fc_apply, fc_vars, fc = _unet_pair(C, C, C, seed=1)
    ip_apply, ip_vars, ip = _unet_pair(2 * C, C, 0, seed=2)
    j = jd.DyffusionEngine(jd.DyffusionConfig(**kw), fc_apply, ip_apply, interpolator_horizon=3)
    p = pd.DyffusionEngine(pd.DyffusionConfig(**kw), fc, ip, interpolator_horizon=3)
    ic = np.random.default_rng(0).normal(size=(2, 16, 16, C)).astype(np.float32)
    want = np.asarray(jax.jit(lambda a, b, c: j.sample(a, b, jax.random.key(0), c))(fc_vars, ip_vars, ic))
    with torch.no_grad():
        got = p.sample(None, None, torch.Generator().manual_seed(0), nhwc_to_nchw(ic))
    assert tuple(got.shape) == (2, 3, C, 16, 16)
    np.testing.assert_allclose(got.permute(0, 1, 3, 4, 2).numpy(), want, **TOL)


# ---------------------------------------------------------------------------
# the whole slice: experiment eval function and serving.predict
# ---------------------------------------------------------------------------
SMALL = [
    "datamodule.spatial=(16,16)", "datamodule.channels=2", "datamodule.horizon=3",
    "datamodule.n_traj=5", "datamodule.n_time=10", "datamodule.batch_size=2",
    "datamodule.eval_batch_size=2", "model.dim=8", "model.dim_mults=(1,2)",
    "module.num_predictions=3", "diffusion.additional_interpolation_steps=2",
    "trainer.save_checkpoints=False",
]


def _build_jax(overrides):
    c1 = jax_config.get_config("synthetic_interpolation", overrides)
    dm = jax_interface.get_datamodule(c1)
    dm.setup()
    _, ip_model, ip_vars, _, _, _ = jax_interface.build_experiment(c1, dm)
    c2 = jax_config.get_config("synthetic_dyffusion", overrides)
    _, _, fc_vars, _, eval_fns, _ = jax_interface.build_experiment(
        c2, dm, interpolator=(make_apply_fn(ip_model), ip_vars)
    )
    return dm, to_numpy_tree(ip_vars), to_numpy_tree(fc_vars), eval_fns


def _build_port(overrides, ip_vars=None, fc_vars=None):
    c1 = port_config.get_config("synthetic_interpolation", overrides)
    dm = port_interface.get_datamodule(c1)
    dm.setup()
    _, ip, _, _, _ = port_interface.build_experiment(c1, dm, device="cpu")
    if ip_vars is not None:
        ip.load_state_dict(unet_state_dict_from_jax(ip_vars))
    c2 = port_config.get_config("synthetic_dyffusion", overrides)
    exp, fc, _, eval_fns, engine = port_interface.build_experiment(c2, dm, interpolator=ip, device="cpu")
    if fc_vars is not None:
        fc.load_state_dict(unet_state_dict_from_jax(fc_vars))
    return dm, exp, eval_fns


@pytest.mark.parametrize("split,extra", [("val", []), ("predict", ["datamodule.prediction_horizon=6"])])
def test_eval_fn_and_serving_match_jax(split, extra):
    """Folded f32 eval of the JAX experiment == the port's eval function ==
    serving.predict; the predict split chains two autoregressive windows."""
    overrides = SMALL + extra
    jdm, ip_vars, fc_vars, jax_eval_fns = _build_jax(overrides)
    pdm, exp, eval_fns = _build_port(overrides, ip_vars, fc_vars)
    batch = next(jdm.predict_batches() if split == "predict" else jdm.val_batches())
    pbatch = next(pdm.predict_batches() if split == "predict" else pdm.val_batches())
    np.testing.assert_array_equal(pbatch["dynamics"], batch["dynamics"])

    want = jax.jit(jax_eval_fns[split])(fc_vars, batch, jax.random.key(0))
    got = eval_fns[split](pbatch, torch.Generator().manual_seed(0))
    assert sorted(got) == sorted(want)
    for k in want:
        assert tuple(got[k].shape) == tuple(want[k].shape), k
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), **TOL, err_msg=k)

    predict, specs, info = port_serving.build_experiment_predict_fn(exp, eval_fns, pdm, None, split=split)
    assert specs["dynamics"].shape == (2, 1, 16, 16, 2) and info["ensemble_members"] == 3
    served = predict({"dynamics": pbatch["dynamics"][:, :1]}, 0)
    n_t = 6 if split == "predict" else 3
    want_members = np.stack([np.asarray(want[f"t{i}_preds"]) for i in range(1, n_t + 1)], axis=2)
    assert tuple(served.shape) == (3, 2, n_t, 16, 16, 2)
    np.testing.assert_allclose(served.numpy(), want_members, **TOL)


def test_bf16_eval_runs_and_stays_close_to_f32():
    """eval_dtype=bfloat16 (the serving path's precision) returns f32
    predictions close to the f32 run; bf16 rounding through the sampler
    moves them by a few percent of their scale."""
    pdm, exp, eval_fns = _build_port(SMALL)
    batch = next(pdm.val_batches())
    ref = eval_fns["val"](batch, torch.Generator().manual_seed(0))
    pdm16, exp16, eval_fns16 = _build_port(SMALL + list(SST_FAST_EVAL))
    got = eval_fns16["val"](batch, torch.Generator().manual_seed(0))
    for k in ref:
        assert got[k].dtype == torch.float32
        scale = float(ref[k].abs().max())
        assert float((got[k] - ref[k]).abs().max()) <= 0.1 * scale, k


def test_dropout_ensemble_is_seeded_and_diverse():
    overrides = SMALL + list(SST_FAST_EVAL) + ["model.block_dropout=0.3", "model.attn_dropout=0.1"]
    pdm, exp, eval_fns = _build_port(overrides)
    predict, _, _ = port_serving.build_experiment_predict_fn(exp, eval_fns, pdm, None, split="val")
    predict_ms, _, _ = port_serving.build_experiment_predict_fn(exp, eval_fns, pdm, None, split="val", reduce="mean_std")
    batch = next(pdm.val_batches())
    a, b, c = predict(batch, 1), predict(batch, 1), predict(batch, 2)
    assert torch.equal(a, b)
    assert not torch.allclose(a, c)
    assert float(a.std(dim=0).min()) >= 0 and float(a.std(dim=0).mean()) > 0  # members differ
    assert not torch.allclose(a[0], a[1])
    stats = predict_ms(batch, 1)
    assert tuple(stats.shape) == (2,) + tuple(a.shape[1:])
    torch.testing.assert_close(stats[0], a.mean(dim=0))
    torch.testing.assert_close(stats[1], a.std(dim=0, unbiased=False))


# ---------------------------------------------------------------------------
# metrics, data, config
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("mean_over_samples", [True, False])
def test_metrics_match(mean_over_samples):
    rng = np.random.default_rng(4)
    preds = rng.normal(size=(5, 3, 4, 6, 1)).astype(np.float32)
    targets = rng.normal(size=(3, 4, 6, 1)).astype(np.float32)
    for name in ("crps_ensemble_sorted", "mse_ensemble", "spread_skill_ratio"):
        got = getattr(port_eval, name)(torch.from_numpy(preds), torch.from_numpy(targets),
                                       mean_over_samples=mean_over_samples)
        want = getattr(jax_eval, name)(preds, targets, mean_over_samples=mean_over_samples)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-6, err_msg=name)
    got = port_eval.evaluate_ensemble_prediction(preds, targets, mean_over_samples)
    want = jax_eval.evaluate_ensemble_prediction(preds, targets, mean_over_samples)
    for k in ("mse", "crps", "ssr"):
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, atol=1e-6, err_msg=k)


def test_synthetic_data_identical():
    kw = dict(n_traj=5, n_time=12, spatial=(9, 7), channels=2, conditional_channels=1, seed=3,
              window=2, horizon=3, prediction_horizon=5, batch_size=4, eval_batch_size=3)
    j, p = JaxSynthetic(**kw), PortSynthetic(**kw)
    j.setup()
    p.setup()
    assert p.dims == j.dims
    for split in ("train", "val", "test", "predict"):
        jt, pt = j.split(split).tensors, p.split(split).tensors
        assert sorted(pt) == sorted(jt)
        for k in jt:
            np.testing.assert_array_equal(pt[k], jt[k], err_msg=f"{split}/{k}")
    for jb, pb in zip(j.val_batches(), p.val_batches()):
        np.testing.assert_array_equal(pb["dynamics"], jb["dynamics"])


def test_sst_config_matches():
    extra = ["datamodule.n_traj=5", "datamodule.n_time=13", "datamodule.eval_batch_size=6"]
    for preset in ("synthetic_interpolation", "synthetic_dyffusion"):
        want = jax_config.get_config(preset, jax_sst_overrides(extra + list(JAX_SST_FAST_EVAL)))
        got = port_config.get_config(preset, sst_overrides(extra + list(SST_FAST_EVAL)))
        for key in ("seed", "experiment", "datamodule", "model", "diffusion", "module"):
            assert got[key] == want[key], key
    with pytest.raises(ValueError, match="did you mean"):
        port_config.get_config("synthetic_dyffusion", ["module.num_prediction=3"])


@pytest.mark.parametrize("window", [1, 2])
def test_experiment_channel_arithmetic_and_inputs_match(window):
    from dyffusion_tpu.experiments import DyffusionForecastingExperiment as JaxDyff
    from dyffusion_tpu.experiments import ExperimentConfig as JaxExpConfig
    from dyffusion_tpu.experiments import InterpolationExperiment as JaxInterp
    from dyffusion_tpu.experiments.base import stack_window as jax_stack_window
    from dyffusion_tpu_torch.experiments import DyffusionForecastingExperiment as PortDyff
    from dyffusion_tpu_torch.experiments import ExperimentConfig as PortExpConfig
    from dyffusion_tpu_torch.experiments import InterpolationExperiment as PortInterp
    from dyffusion_tpu_torch.experiments import stack_window as port_stack_window

    dims = {"input": 2, "output": 2, "conditional": 1, "spatial": (5, 4)}
    kw = dict(window=window, horizon=3)
    ji, pi = JaxInterp(JaxExpConfig(**kw), dims), PortInterp(PortExpConfig(**kw), dims, device="cpu")
    assert pi.actual_num_input_channels() == ji.actual_num_input_channels()
    for fc in ("data", "none"):
        jf = JaxDyff(JaxExpConfig(**kw), dims, forward_conditioning=fc)
        pf = PortDyff(PortExpConfig(**kw), dims, forward_conditioning=fc, device="cpu")
        assert pf.backbone_spec().num_conditional_channels == jf.backbone_spec().num_conditional_channels
        assert pf.backbone_spec().num_input_channels == jf.backbone_spec().num_input_channels
    dyn = np.random.default_rng(8).normal(size=(3, window + 3, 5, 4, 2)).astype(np.float32)
    np.testing.assert_array_equal(
        pi.get_inputs(torch.from_numpy(dyn)).permute(0, 2, 3, 1).numpy(), np.asarray(ji.get_inputs(dyn))
    )
    np.testing.assert_array_equal(
        port_stack_window(torch.from_numpy(dyn), window).permute(0, 2, 3, 1).numpy(),
        np.asarray(jax_stack_window(dyn, window)),
    )
    # the autoregressive chain's next inputs, from (N, B, h, H, W, C) predictions
    preds = np.random.default_rng(9).normal(size=(2, 3, 3, 5, 4, 2)).astype(np.float32)
    want = np.asarray(jf.next_window_inputs(preds))  # (N, B, H, W, w*C)
    got = pf.next_window_inputs(torch.from_numpy(preds))  # (N, B, w*C, H, W)
    np.testing.assert_array_equal(got.permute(0, 1, 3, 4, 2).numpy(), want)


def test_entry_points_default_to_cuda():
    """The port runs on the GPU unless asked for the CPU: where CUDA is not
    available, the defaults raise instead of running on the CPU."""
    from dyffusion_tpu_torch.experiments import ExperimentConfig as PortExpConfig
    from dyffusion_tpu_torch.experiments import InterpolationExperiment as PortInterp

    c1 = port_config.get_config("synthetic_interpolation", SMALL)
    dm = port_interface.get_datamodule(c1)
    if torch.cuda.is_available():
        assert port_interface.build_experiment(c1, dm)[0].device.type == "cuda"
        return
    for call in (
        lambda: port_interface.build_experiment(c1, dm),
        lambda: port_interface.run_experiment(c1, dm),
        lambda: PortInterp(PortExpConfig(horizon=3), dm.dims),
    ):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
