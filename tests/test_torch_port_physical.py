"""The port's physical-systems path (Navier-Stokes, spring mesh) against the
JAX package on the CPU.

Fake nn-benchmark archives at the real grids (221x42 with C=3 and 2
condition channels; 10x10 with C=4 and 1), written by each package's
``write_fake_benchmark_dir``; small backbones; converted variables with
random running statistics; dropout off (the two frameworks cannot draw the
same masks). Tolerances, relative to max|JAX|: data and boundary conditions
exact or 1e-6, forwards and sampler outputs 1e-5 (f32 both sides, convs in
another order), losses and gradients 1e-4.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import _boundary_error
from dyffusion_tpu import config as jax_config
from dyffusion_tpu import interface as jax_interface
from dyffusion_tpu.data import physical_systems as jax_ps
from dyffusion_tpu.models import make_apply_fn
from dyffusion_tpu.utils import naming as jax_naming
from dyffusion_tpu_torch import config as port_config
from dyffusion_tpu_torch import interface as port_interface
from dyffusion_tpu_torch.data import physical_systems as port_ps
from dyffusion_tpu_torch.models import simple_conv_net_state_dict_from_jax, unet_simple_state_dict_from_jax
from dyffusion_tpu_torch.models.base import MODEL_STATE_UPDATES
from dyffusion_tpu_torch.utils.naming import get_run_id
from tests._torch_port_helpers import nhwc_to_nchw, to_numpy_tree
from tests._torch_port_helpers import torch_threads_share_of_cores  # noqa: F401 (autouse fixture)

SYSTEMS = {"ns": "navier-stokes", "spring": "spring-mesh"}
PRESET = {"ns": "navier_stokes", "spring": "spring_mesh"}
CONVERT = {"ns": unet_simple_state_dict_from_jax, "spring": simple_conv_net_state_dict_from_jax}
N_TRAJ = {"train": 2, "val": 1, "test": 1}
N_TIME = 12
# small widths; the presets' shapes, conditioning, refinement and losses
TINY = {
    "ns": ["model.dim=4", "model.upsample_dims=(64,64)"],
    "spring": ["model.dim=32"],
}
COMMON = [
    "datamodule.horizon=4", "datamodule.prediction_horizon=8", "datamodule.batch_size=4",
    "datamodule.eval_batch_size=4", "model.dropout=0.0", "module.num_predictions=2",
    "module.num_predictions_test=2", "trainer.save_checkpoints=False",
]
REL, LOSS_REL, GRAD_REL, GRAD_FLOOR = 1e-5, 1e-4, 1e-4, 0.1


def _close(got, want, r, what=""):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err, scale = float(np.abs(got - want).max()), float(np.abs(want).max())
    assert err <= r * scale, f"{what}: max abs err {err:.3e} > {r} x {scale:.3e}"


@pytest.fixture(scope="module")
def archives(tmp_path_factory):
    """{system: (port's archive root, JAX package's archive root)}."""
    out = {}
    for key, system in SYSTEMS.items():
        a, b = tmp_path_factory.mktemp(f"port_{key}"), tmp_path_factory.mktemp(f"jax_{key}")
        port_ps.write_fake_benchmark_dir(str(a), system, n_traj=dict(N_TRAJ), n_time=N_TIME, seed=3)
        jax_ps.write_fake_benchmark_dir(str(b), system, n_traj=dict(N_TRAJ), n_time=N_TIME, seed=3)
        out[key] = (str(a), str(b))
    return out


def _datamodules(key, archives, **kw):
    a, b = archives[key]
    kw = dict(physical_system=SYSTEMS[key], horizon=4, prediction_horizon=8, batch_size=4, **kw)
    port, jax_dm = port_ps.PhysicalSystemsDataModule(data_dir=a, **kw), jax_ps.PhysicalSystemsDataModule(data_dir=b, **kw)
    port.setup()
    jax_dm.setup()
    return port, jax_dm


@pytest.mark.parametrize("key", ["ns", "spring"])
def test_datamodule_splits_and_metadata_match_jax(key, archives):
    port, jdm = _datamodules(key, archives)
    assert port.dims == jdm.dims and port.subdirs == jdm.subdirs and port.test_set_name == jdm.test_set_name
    for split in ("train", "val", "test", "predict"):
        assert port.get_horizon(split) == jdm.get_horizon(split)
        got, want = port.split(split).tensors, jdm.split(split).tensors
        assert sorted(got) == sorted(want), split
        for k in want:
            assert got[k].dtype == want[k].dtype, (split, k)
            np.testing.assert_array_equal(got[k], want[k], err_msg=f"{split}/{k}")
    # test batches: one full trajectory window (1 + prediction horizon frames) each
    batches = list(port.test_batches())
    assert len(batches) == len(port.split("test")) and all(b["dynamics"].shape[:2] == (1, 9) for b in batches)
    b = batches[0]
    kw, jkw = port.get_boundary_condition_kwargs(b, 0, "test"), jdm.get_boundary_condition_kwargs(b, 0, "test")
    assert all(np.array_equal(kw[k], jkw[k]) for k in ("t0", "dt"))
    # other test sets: the out-of-distribution and multi-obstacle names
    for kw in (dict(test_out_of_distribution=True), dict(num_test_obstacles=4)):
        p = port_ps.PhysicalSystemsDataModule(data_dir="x", physical_system=SYSTEMS[key], **kw)
        j = jax_ps.PhysicalSystemsDataModule(data_dir="x", physical_system=SYSTEMS[key], **kw)
        assert p.subdirs == j.subdirs and p.test_set_name == j.test_set_name


@pytest.mark.parametrize("key", ["ns", "spring"])
def test_boundary_conditions_match_jax(key, archives):
    """Both hooks on (N, B, H, W, C) predictions with an ensemble axis and
    per-row times; the unadjusted predictions fail the same check."""
    port, jdm = _datamodules(key, archives)
    batch = next(port.split("train").batches(3))
    g = np.random.default_rng(7)
    preds = g.normal(size=(2,) + batch["dynamics"].shape[:1] + batch["dynamics"].shape[2:]).astype(np.float32)
    time = batch["metadata_t0"] + batch["metadata_dt"] * 3.0
    want = np.asarray(jdm.boundary_conditions(jnp.asarray(preds), None, metadata=batch, time=jnp.asarray(time)))
    got = port.boundary_conditions(torch.from_numpy(preds), metadata=batch, time=torch.from_numpy(time)).numpy()
    _close(got, want, 1e-6, "boundary conditions")
    assert _boundary_error(PRESET[key], got, batch, time) <= 1e-6
    assert _boundary_error(PRESET[key], preds, batch, time) > 1e-3


def _stage_pair(key, archives, seed=5):
    """The JAX package's and the port's stage-2 experiments over the same
    (converted) interpolator and forecaster variables, random running
    statistics included. Returns (jax parts, port parts, datamodule)."""
    a, b = archives[key]
    ov = COMMON + TINY[key]
    cfgs = {}
    for pkg, cfg_mod, root in (("jax", jax_config, b), ("port", port_config, a)):
        cfgs[pkg] = [cfg_mod.get_config(f"{PRESET[key]}_{m}", ov + [f"datamodule.data_dir={root}"])
                     for m in ("interpolation", "dyffusion")]
    jdm = jax_interface.get_datamodule(cfgs["jax"][0])
    pdm = port_interface.get_datamodule(cfgs["port"][0])
    rng = np.random.default_rng(seed)

    def randomize(v):
        v = to_numpy_tree(v)
        v["batch_stats"] = jax.tree_util.tree_map_with_path(
            lambda p, x: (rng.normal(size=x.shape) * 0.3).astype(np.float32) if p[-1].key == "mean"
            else rng.uniform(0.5, 1.5, size=x.shape).astype(np.float32), v["batch_stats"])
        return v

    _, jip, ip_vars, _, _, _ = jax_interface.build_experiment(cfgs["jax"][0], jdm)
    ip_vars = randomize(ip_vars)
    jexp, _, fc_vars, _, jeval, jeng = jax_interface.build_experiment(
        cfgs["jax"][1], jdm, interpolator=(make_apply_fn(jip), ip_vars))
    fc_vars = randomize(fc_vars)
    jexp.interpolator_params = ip_vars

    _, pip, _, _, _ = port_interface.build_experiment(cfgs["port"][0], pdm, device="cpu")
    pip.load_state_dict(CONVERT[key](ip_vars))
    pexp, pfc, _, peval, peng = port_interface.build_experiment(cfgs["port"][1], pdm, interpolator=pip, device="cpu")
    pfc.load_state_dict(CONVERT[key](fc_vars))
    return (jexp, jeng, jeval, fc_vars, ip_vars), (pexp, peng, peval, pfc), pdm


@pytest.mark.parametrize("key", ["ns", "spring"])
def test_stage2_loss_with_a_batchnorm_forecaster_matches_jax(key, archives):
    """``p_losses`` at fixed t over every branch (t = 0, the middle, N-1):
    the loss terms, every forecaster gradient, and the running-statistics
    updates of the forecaster's train-mode first pass (the l2 pass and the
    interpolator read the running averages)."""
    (jexp, jeng, _, fc_vars, ip_vars), (pexp, peng, _, pfc), pdm = _stage_pair(key, archives)
    batch = next(pdm.split("train").batches(4))
    dyn = batch["dynamics"]
    x_last, cond, static = dyn[:, -1], dyn[:, 0], batch["condition"]
    n = jeng.num_timesteps
    t = np.asarray([0, 1, n // 2, n - 1], np.float32)

    def f(params):
        loss, aux = jeng.p_losses({"params": params, "batch_stats": fc_vars["batch_stats"]}, ip_vars,
                                  jax.random.key(0), x_last, cond, jnp.asarray(t), static)
        return loss, aux

    (jloss, jaux), jgrads = jax.jit(jax.value_and_grad(f, has_aux=True))(fc_vars["params"])
    ploss, paux = peng.p_losses(None, None, None, nhwc_to_nchw(x_last), nhwc_to_nchw(cond), torch.from_numpy(t),
                                nhwc_to_nchw(static))
    ploss.backward()
    for name in ("loss", "loss_forward", "loss_forward2"):
        _close(float(paux[name].detach()), float(jaux[name]), LOSS_REL, name)
    assert float(jaux["loss_forward2"]) > 0
    want_grads = CONVERT[key]({"params": to_numpy_tree(jgrads)})
    top = max(float(w.abs().max()) for w in want_grads.values())
    got_grads = {k: p.grad for k, p in pfc.named_parameters()}
    assert sorted(got_grads) == sorted(want_grads)
    for k, w in want_grads.items():
        limit = GRAD_REL * max(float(w.abs().max()), GRAD_FLOOR * top)
        assert float((got_grads[k] - w).abs().max()) <= limit, k
    want_stats = CONVERT[key]({"params": fc_vars["params"],
                               "batch_stats": to_numpy_tree(jaux["_model_state_updates"]["batch_stats"])})
    updates = paux[MODEL_STATE_UPDATES]
    assert {k for k in updates if "running" in k} == {k for k in want_stats if "running" in k}
    for k in updates:
        if "running" in k:
            _close(updates[k].numpy(), want_stats[k].numpy(), REL, k)


@pytest.mark.parametrize("key", ["ns", "spring"])
def test_autoregressive_chain_with_boundaries_matches_jax(key, archives):
    """The test split's eval: the folded 2-member sampler with refinement
    over 2 windows (prediction horizon 8 = 2 x 4), the second continuing
    from the first's boundary-adjusted predictions; NS with
    forward_conditioning=none, spring with data and no cold last step.
    Every frame's predictions, and its boundary conditions."""
    (jexp, _, jeval, fc_vars, _), (pexp, peng, peval, _), pdm = _stage_pair(key, archives)
    assert peng.cfg.refine_intermediate_predictions and jexp.cfg.prediction_horizon == 8
    assert peng.cfg.forward_conditioning == ("none" if key == "ns" else "data")
    batch = next(pdm.test_batches())
    want = jax.jit(jeval["test"])(fc_vars, {k: jnp.asarray(v) for k, v in batch.items()}, jax.random.key(0))
    got = peval["test"](batch, None, None)
    assert sorted(got) == sorted(want) and "t8_preds" in got and "t8_targets" in got
    for k in want:
        _close(got[k].numpy(), want[k], REL, k)
    for i in range(1, 9):
        time = batch["metadata_t0"] + batch["metadata_dt"] * i
        assert _boundary_error(PRESET[key], got[f"t{i}_preds"].numpy(), batch, time) <= 1e-6, i


@pytest.mark.parametrize("key", ["ns", "spring"])
@pytest.mark.parametrize("method", ["interpolation", "dyffusion"])
@pytest.mark.parametrize("overrides", [[], ["seed=3", "datamodule.data_dir=/data", "trainer.max_epochs=1"],
                                       ["model.dim=32", "module.use_ema=true"]], ids=["preset", "volatile", "science"])
def test_presets_and_run_ids_match_jax(key, method, overrides):
    preset = f"{PRESET[key]}_{method}"
    want = jax_config.get_config(preset, overrides)
    got = port_config.get_config(preset, overrides)
    assert got == want
    assert get_run_id(got) == jax_naming.get_run_id(want)
