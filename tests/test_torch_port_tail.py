"""The trainer's tail and the small gaps, on the CPU, against the JAX package:
``watch_gradients`` (per-module gradient norms and log10|g| histograms),
the learned sinusoidal time embedding in the ``Unet``, the ensemble metrics
(pairwise CRPS, NLL, correlation, per-member MSE, growing ensembles),
``StepMapping.validate``, and the profiling helpers."""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dyffusion_tpu import config as jax_config
from dyffusion_tpu import interface as jax_interface
from dyffusion_tpu.diffusion import dyffusion as jd
from dyffusion_tpu.models import Unet as JaxUnet
from dyffusion_tpu.models.base import BackboneSpec as JaxSpec
from dyffusion_tpu.models.base import init_backbone
from dyffusion_tpu.models.modules import LearnedSinusoidalPosEmb as JaxLearnedEmb
from dyffusion_tpu.training import trainer as jax_trainer
from dyffusion_tpu.utils import evaluation as jax_eval
from dyffusion_tpu_torch.config import get_config
from dyffusion_tpu_torch.diffusion import dyffusion as pd
from dyffusion_tpu_torch.interface import build_trainer
from dyffusion_tpu_torch.models import Unet, unet_state_dict_from_jax
from dyffusion_tpu_torch.models.modules import LearnedSinusoidalPosEmb
from dyffusion_tpu_torch.training.trainer import GRAD_HIST_BINS, GRAD_HIST_EDGES
from dyffusion_tpu_torch.utils import evaluation as port_eval
from dyffusion_tpu_torch.utils.profiling import device_memory_report, profiler_trace, timing_scope
from tests._torch_port_helpers import nchw_to_nhwc, nhwc_to_nchw, to_numpy_tree
from tests._torch_port_helpers import torch_threads_share_of_cores  # noqa: F401 (autouse fixture)
from tests.test_torch_parity import _port_unet_weights

# ---------------------------------------------------------------------------
# watch_gradients
# ---------------------------------------------------------------------------
# horizon 2: stage 1 interpolates i = 1 only, so both packages' train steps
# draw the same i; dropout rates are 0, so the gradients are the same
WATCH = [
    "datamodule.spatial=(8,8)", "datamodule.channels=1", "datamodule.horizon=2", "datamodule.n_traj=4",
    "datamodule.n_time=6", "datamodule.batch_size=4", "model.dim=8", "model.dim_mults=(1,2)",
    "trainer.watch_gradients=true", "trainer.log_every_n_steps=1", "trainer.max_steps=2",
]
# Gradients below 1e-7 of the gradient norm are float noise (mathematically
# zero ones, such as a conv bias that feeds a GroupNorm): their magnitudes
# depend on the order of the sums, so only their number is compared. Above
# that floor, log10|g| within an ulp of a bin edge may land on either side:
# HIST_SLACK counts may move, in all (measured when this test was written: 2
# above the floor; the noise bins' total equal).
NOISE_FLOOR = 1e-7
HIST_SLACK = 4


@pytest.fixture(scope="module")
def watched():
    """One stage-1 train step of each package with watch_gradients on, the
    port's weights converted from the JAX ones, on the same batch."""
    jc, pc = jax_config.get_config("synthetic_interpolation", WATCH), get_config("synthetic_interpolation", WATCH)
    jdm = jax_interface.get_datamodule(jc)
    jdm.setup()
    _, _, variables, loss_fn, _, _ = jax_interface.build_experiment(jc, jdm)
    variables = to_numpy_tree(variables)  # the JAX step donates its state
    step = jax_trainer.make_train_step(loss_fn, watch_gradients=True)
    batch = next(jdm.train_batches(np.random.default_rng(0)))
    _, jm = step(jax_interface.create_train_state(jc, variables), batch)
    trainer = build_trainer(pc, device="cpu")
    trainer.experiment.model.load_state_dict(unet_state_dict_from_jax(variables))
    pm = trainer.train_step(trainer.state, trainer._put(batch))
    return {k: np.asarray(v) for k, v in jm.items()}, pm, trainer


def test_watch_gradients_norms_and_counts(watched):
    """The port's per-module squared norms add up to grad_norm squared, each
    module's histogram counts its weights, and the modules are the model's
    top-level children."""
    _, pm, trainer = watched
    params = trainer.state.params
    modules = {n.split(".")[0] for n in params}
    assert modules == {n for n, c in trainer.experiment.model.named_children() if any(True for _ in c.parameters())}
    assert {k for k in pm if k.startswith("grads/")} == {f"grads/{m}/{s}" for m in modules for s in ("norm", "hist")}
    norm2 = sum(float(pm[f"grads/{m}/norm"]) ** 2 for m in modules)
    np.testing.assert_allclose(norm2, float(pm["grad_norm"]) ** 2, rtol=1e-5)
    for m in modules:
        hist = pm[f"grads/{m}/hist"]
        assert hist.shape == (GRAD_HIST_BINS,) and hist.dtype == torch.int64
        assert int(hist.sum()) == sum(p.numel() for n, p in params.items() if n.split(".")[0] == m)
    assert len(GRAD_HIST_EDGES) == GRAD_HIST_BINS + 1
    assert GRAD_HIST_EDGES == jax_trainer.GRAD_HIST_EDGES


def test_watch_gradients_match_jax(watched):
    """Summed over modules (the two packages name them differently), the
    histograms equal the JAX package's: bin by bin within HIST_SLACK counts
    above the noise floor, in their total below it. The norms agree: the
    squared norms add up to the same total."""
    jm, pm, _ = watched
    j_hist = sum(v for k, v in jm.items() if k.endswith("/hist")).astype(np.int64)
    p_hist = sum(v for k, v in pm.items() if k.endswith("/hist")).numpy()
    assert j_hist.sum() == p_hist.sum()
    # the first bin whose lower edge is at or above the floor
    floor = int(np.searchsorted(GRAD_HIST_EDGES, np.log10(NOISE_FLOOR * float(jm["grad_norm"]))))
    assert 0 < floor < GRAD_HIST_BINS and j_hist[floor:].sum() > 0.9 * j_hist.sum()
    assert abs(int(j_hist[:floor].sum()) - int(p_hist[:floor].sum())) <= HIST_SLACK, (j_hist, p_hist)
    assert int(np.abs(j_hist[floor:] - p_hist[floor:]).sum()) <= HIST_SLACK, (j_hist, p_hist)
    j_norm2 = sum(float(v) ** 2 for k, v in jm.items() if k.endswith("/norm"))
    p_norm2 = sum(float(v) ** 2 for k, v in pm.items() if k.endswith("/norm"))
    np.testing.assert_allclose(p_norm2, j_norm2, rtol=1e-4)
    np.testing.assert_allclose(float(pm["grad_norm"]), float(jm["grad_norm"]), rtol=1e-5)


def test_watch_gradients_reach_the_log():
    """fit logs the norms as floats and the counts as int lists at each log
    point; without watch_gradients there are none."""
    for watch in (True, False):
        logs = []
        overrides = WATCH + [f"trainer.watch_gradients={str(watch).lower()}", "trainer.save_checkpoints=false"]
        trainer = build_trainer(get_config("synthetic_interpolation", overrides), device="cpu",
                                log_fn=lambda m, step: logs.append(m))
        trainer.fit()
        steps = [m for m in logs if "train/loss" in m]
        assert len(steps) == 2
        for m in steps:
            keys = [k for k in m if k.startswith("grads/")]
            assert bool(keys) == watch
            for k in keys:
                v = m[k]
                assert (isinstance(v, list) and len(v) == GRAD_HIST_BINS) if k.endswith("hist") else isinstance(v, float)
            json.dumps(m)


# ---------------------------------------------------------------------------
# the learned sinusoidal time embedding
# ---------------------------------------------------------------------------
def test_learned_sinusoidal_pos_emb_matches_jax():
    jm = JaxLearnedEmb(16)
    t = np.random.default_rng(0).uniform(0, 7, size=(5,)).astype(np.float32)
    v = jm.init(jax.random.key(3), jnp.asarray(t))
    want = np.asarray(jm.apply(v, jnp.asarray(t)))
    pm = LearnedSinusoidalPosEmb(16)
    pm.load_state_dict({"weights": torch.from_numpy(np.asarray(v["params"]["weights"]))})
    got = pm(torch.from_numpy(t))
    assert got.shape == (5, 17) and want.shape == (5, 17)
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-5, atol=1e-5)
    with pytest.raises(ValueError, match="even"):
        LearnedSinusoidalPosEmb(15)


UNET_KW = dict(dim=8, dim_mults=(1, 2), resnet_block_groups=4, with_time_emb=True, num_input_channels=2,
               num_output_channels=2, num_conditional_channels=1, learned_sinusoidal_cond=True,
               learned_sinusoidal_dim=8)


def test_unet_with_learned_sinusoidal_cond_matches_jax():
    """Weights converted from JAX (the learned frequencies at the reference's
    key ``time_emb_mlp.0.weights``) give the JAX output within 1e-5 of its
    scale; the reference's torch->flax porter reads the port's state dict
    back into the JAX model (the learned frequencies added to its tree)."""
    jm = JaxUnet(**UNET_KW)
    v = to_numpy_tree(init_backbone(jm, JaxSpec(2, 2, 1, (12, 12), True), jax.random.key(1)))
    g = np.random.default_rng(4)
    x = g.normal(size=(3, 12, 12, 2)).astype(np.float32)
    cond = g.normal(size=(3, 12, 12, 1)).astype(np.float32)
    t = np.asarray([0.0, 1.5, 3.0], np.float32)
    apply = jax.jit(lambda v, x, t, c: jm.apply(v, x, time=t, condition=c))
    want = np.asarray(apply(v, x, t, cond))
    pm = Unet(**UNET_KW)
    sd = unet_state_dict_from_jax(v)
    assert sd["time_emb_mlp.0.weights"].shape == (4,)
    pm.load_state_dict(sd)
    got = pm(nhwc_to_nchw(x), time=torch.from_numpy(t), condition=nhwc_to_nchw(cond))
    scale = float(np.abs(want).max())
    np.testing.assert_allclose(nchw_to_nhwc(got), want, atol=1e-5 * scale, rtol=0)
    # the port's weights, read back by the reference's porter
    with torch.no_grad():
        for p in pm.parameters():
            p.add_(0.01 * torch.randn(p.shape, generator=torch.Generator().manual_seed(p.numel())))
    params = _port_unet_weights(pm, n_levels=2)
    params["time_emb"]["LearnedSinusoidalPosEmb_0"] = {"weights": pm.state_dict()["time_emb_mlp.0.weights"].numpy()}
    back = np.asarray(apply({"params": params}, x, t, cond))
    got2 = nchw_to_nhwc(pm(nhwc_to_nchw(x), time=torch.from_numpy(t), condition=nhwc_to_nchw(cond)))
    np.testing.assert_allclose(got2, back, atol=1e-5 * float(np.abs(back).max()), rtol=0)
    assert float(np.abs(got2 - want).max()) > 1e-3 * scale  # the perturbation moved the output


def test_unet_learned_frequencies_train():
    """The learned frequencies get a gradient (they are a weight of the
    model, decayed and EMA'd as the others)."""
    pm = Unet(**UNET_KW)
    x = torch.randn(2, 2, 12, 12)
    pm(x, time=torch.tensor([0.5, 2.0]), condition=torch.randn(2, 1, 12, 12)).square().mean().backward()
    w = dict(pm.named_parameters())["time_emb_mlp.0.weights"]
    assert w.grad is not None and float(w.grad.abs().sum()) > 0


# ---------------------------------------------------------------------------
# the ensemble metrics
# ---------------------------------------------------------------------------
def _ensemble(seed, m=5, n=4):
    g = np.random.default_rng(seed)
    preds = g.normal(size=(m, n, 3, 6, 6, 1)).astype(np.float32)
    targets = g.normal(size=(n, 3, 6, 6, 1)).astype(np.float32)
    return preds, targets


def _close(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6 * float(np.abs(want).max()))


@pytest.mark.parametrize("mean_over_samples", [True, False])
def test_crps_pairwise_matches_jax_and_the_sorted_form(mean_over_samples):
    preds, targets = _ensemble(0)
    got = port_eval.crps_ensemble(torch.from_numpy(preds), torch.from_numpy(targets), mean_over_samples)
    _close(got.numpy(), jax_eval.crps_ensemble(preds, targets, mean_over_samples))
    _close(got.numpy(), port_eval.crps_ensemble_sorted(preds, targets, mean_over_samples).numpy())


@pytest.mark.parametrize("mean_over_samples", [True, False])
def test_nll_matches_jax(mean_over_samples):
    preds, targets = _ensemble(1)
    mean, var = preds.mean(0), preds.var(0) + 0.1
    got = port_eval.nll_ensemble(torch.from_numpy(mean), torch.from_numpy(var), torch.from_numpy(targets),
                                 mean_over_samples)
    _close(got.numpy(), jax_eval.nll_ensemble(mean, var, targets, mean_over_samples))


def test_corr_matches_jax():
    preds, targets = _ensemble(2)
    targets = targets + preds.mean(0)  # a correlation well away from 0
    got = port_eval.corr_ensemble(torch.from_numpy(preds), torch.from_numpy(targets))
    _close(got.numpy(), jax_eval.corr_ensemble(preds, targets))
    assert 0.3 < float(got) < 1


@pytest.mark.parametrize("per_member", [False, True])
def test_evaluate_ensemble_prediction_matches_jax(per_member):
    preds, targets = _ensemble(3)
    want = jax_eval.evaluate_ensemble_prediction(preds, targets, also_per_member_metrics=per_member)
    got = port_eval.evaluate_ensemble_prediction(preds, targets, also_per_member_metrics=per_member)
    assert sorted(got) == sorted(want)
    assert ("mse_per_mem" in got) == per_member
    for k in want:
        _close(got[k], want[k])


def test_metrics_for_varying_members_match_jax():
    preds, targets = _ensemble(4)
    want = jax_eval.evaluate_ensemble_prediction_for_varying_members(preds, targets)
    got = port_eval.evaluate_ensemble_prediction_for_varying_members(preds, targets)
    assert sorted(got) == sorted(want) == ["crps", "mse", "ssr"]
    for k in want:
        assert got[k].shape == (5,)
        _close(got[k], want[k])


# ---------------------------------------------------------------------------
# StepMapping.validate
# ---------------------------------------------------------------------------
DYFFUSION_PRESETS = ("synthetic_dyffusion", "navier_stokes_dyffusion", "spring_mesh_dyffusion",
                     "oisst_pacific_dyffusion")


def _mapping_kw(preset, extra=()):
    diff = get_config(preset, list(extra))["diffusion"]
    return dict(horizon=diff["timesteps"], schedule=diff["schedule"],
                additional_interpolation_steps=diff["additional_interpolation_steps"],
                additional_interpolation_steps_factor=diff["additional_interpolation_steps_factor"],
                interpolate_before_t1=diff["interpolate_before_t1"])


@pytest.mark.parametrize("preset", DYFFUSION_PRESETS)
def test_step_mapping_validates_on_the_presets(preset):
    """The presets' mappings (OISST: h 7, k 25) and a linear schedule pass,
    in both packages, with the same steps."""
    for extra in ((), ("diffusion.schedule=linear", "diffusion.additional_interpolation_steps=0",
                       "diffusion.additional_interpolation_steps_factor=1")):
        kw = _mapping_kw(preset, extra)
        mp, mj = pd.StepMapping.create(**kw), jd.StepMapping.create(**kw)
        mp.validate()
        mj.validate()
        assert mp.d_to_i == mj.d_to_i
    if preset == "oisst_pacific_dyffusion":
        assert pd.StepMapping.create(**_mapping_kw(preset)).num_timesteps == 32


def test_step_mapping_validate_fails_on_a_corrupted_mapping():
    class Corrupted(pd.StepMapping):
        def i_of(self, d):  # the scalar map off by 0.25 at one step
            return super().i_of(d) + (0.25 if d == 3 else 0.0)

    kw = _mapping_kw("oisst_pacific_dyffusion")
    good = pd.StepMapping.create(**kw)
    bad = Corrupted(**{f: getattr(good, f) for f in good.__dataclass_fields__})
    with pytest.raises(ValueError, match="d=3"):
        bad.validate()


# ---------------------------------------------------------------------------
# profiling
# ---------------------------------------------------------------------------
def test_profiler_trace_writes_a_trace(tmp_path):
    with profiler_trace(str(tmp_path / "prof")) as prof:
        torch.ones(64, 64).matmul(torch.ones(64, 64)).sum()
    files = os.listdir(tmp_path / "prof")
    assert len(files) == 1 and files[0].startswith("trace_") and files[0].endswith(".json")
    with open(tmp_path / "prof" / files[0]) as f:
        trace = json.load(f)
    assert any("matmul" in e.get("name", "") for e in trace["traceEvents"])
    assert any("matmul" in row.key for row in prof.key_averages())


def test_timing_scope_and_memory_report(capsys):
    results = {}
    with timing_scope("step", results):
        sum(range(1000))
    assert results["step"] > 0
    with timing_scope("printed"):
        pass
    assert "Elapsed ``printed``" in capsys.readouterr().out
    with timing_scope("skipped", results, no_op=True):
        pass
    assert "skipped" not in results
    report = device_memory_report()
    if torch.cuda.is_available():
        assert report.startswith("cuda:0")
    else:
        assert report == "no CUDA device: device memory not reported"
