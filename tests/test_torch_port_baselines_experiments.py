"""The port's baseline experiments against the JAX package on the CPU: the
time-conditioned and simultaneous forecasters (alone, and hosting the DDPM,
LDM-DDPM and MCVD engines), built by each package's
``interface.build_experiment`` from the same preset and overrides, the JAX
variables converted into the port's backbone.

Tiny shapes (8x8, C=1, horizon 2, a dim-8 ``Unet`` with one level, or the
spring mesh's ``SimpleConvNet`` at dim 32 on a fake archive), dropout rates
0, the JAX draws replayed where the port draws (the engines' ``draw`` and
``draw_steps``). Tolerances, relative to max|JAX|: losses 1e-5, gradients
1e-4 of the larger of the tensor's own and 0.1 of the model's largest,
eval predictions 1e-5 (f32; under ``eval_dtype=bfloat16`` against the JAX
eval on the bf16-rounded weights, and 1e-2 against the bf16 weights: see
the test), train-step weights 1e-2 of their change (relative L2; the logvar
elementwise).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dyffusion_tpu import config as jax_config
from dyffusion_tpu import interface as jax_interface
from dyffusion_tpu.data import physical_systems as jax_ps
from dyffusion_tpu.training import trainer as jax_trainer
from dyffusion_tpu_torch import config as port_config
from dyffusion_tpu_torch import interface as port_interface
from dyffusion_tpu_torch.data import physical_systems as port_ps
from dyffusion_tpu_torch.models import simple_conv_net_state_dict_from_jax, unet_state_dict_from_jax
from dyffusion_tpu_torch.models.base import MODEL_STATE_UPDATES, apply_model
from dyffusion_tpu_torch.training import trainer as port_trainer
from tests._torch_port_helpers import to_numpy_tree
from tests._torch_port_helpers import torch_threads_share_of_cores  # noqa: F401 (autouse fixture)
from tests.test_torch_port_baselines import Replay

REL, LOSS_REL, GRAD_REL, GRAD_FLOOR, CHANGE_REL = 1e-5, 1e-5, 1e-4, 0.1, 1e-2
H = 2  # horizon
TINY = [
    "datamodule.spatial=(8,8)", "datamodule.channels=1", f"datamodule.horizon={H}",
    f"datamodule.prediction_horizon={2 * H}", "datamodule.conditional_channels=1", "datamodule.n_traj=5",
    "datamodule.n_time=10", "datamodule.batch_size=3", "datamodule.eval_batch_size=2", "model.dim=8",
    "model.dim_mults=(1,)", "module.num_predictions=2", "module.num_predictions_test=2",
    "diffusion.timesteps=10", "trainer.save_checkpoints=False",
]
SPRING = ["datamodule.horizon=4", "datamodule.prediction_horizon=8", "datamodule.batch_size=4",
          "datamodule.eval_batch_size=4", "model.dim=32", "model.dropout=0.0", "module.num_predictions=2",
          "module.num_predictions_test=2", "trainer.save_checkpoints=False", "diffusion.timesteps=10"]


def _close(got, want, r, what=""):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err, scale = float(np.abs(got - want).max()), float(np.abs(want).max())
    assert err <= r * scale, f"{what}: max abs err {err:.3e} > {r} x {scale:.3e}"


def _overrides(preset):
    """TINY for the synthetic presets; the diffusion key only where the preset has that section."""
    keep = jax_config.get_config(preset).get("diffusion") is not None
    return [o for o in TINY if keep or not o.startswith("diffusion.")]


@pytest.fixture(scope="module")
def spring_archive(tmp_path_factory):
    a, b = tmp_path_factory.mktemp("port_spring"), tmp_path_factory.mktemp("jax_spring")
    n_traj = {"train": 2, "val": 1, "test": 1}
    port_ps.write_fake_benchmark_dir(str(a), "spring-mesh", n_traj=dict(n_traj), n_time=12, seed=3)
    jax_ps.write_fake_benchmark_dir(str(b), "spring-mesh", n_traj=dict(n_traj), n_time=12, seed=3)
    return str(a), str(b)


def _pair(preset, extra=(), archive=None, randomize_stats=False):
    """Both packages' experiments from ``preset``; the port's model holds the
    JAX variables (a BatchNorm backbone's running statistics drawn at
    random first). Returns (jax parts dict, port parts dict, port datamodule)."""
    if archive is None:
        ov, roots = _overrides(preset) + list(extra), (None, None)
    else:
        ov, roots = SPRING + list(extra), archive
    jcfg = jax_config.get_config(preset, ov + ([f"datamodule.data_dir={roots[1]}"] if roots[1] else []))
    pcfg = port_config.get_config(preset, ov + ([f"datamodule.data_dir={roots[0]}"] if roots[0] else []))
    jdm, pdm = jax_interface.get_datamodule(jcfg), port_interface.get_datamodule(pcfg)
    jdm.setup()
    pdm.setup()
    jexp, _, jvars, jloss, jeval, jeng = jax_interface.build_experiment(jcfg, jdm)
    jvars = to_numpy_tree(jvars)
    if randomize_stats:
        g = np.random.default_rng(4)
        jvars["batch_stats"] = jax.tree_util.tree_map_with_path(
            lambda p, x: (g.normal(size=x.shape) * 0.3).astype(np.float32) if p[-1].key == "mean"
            else g.uniform(0.5, 1.5, size=x.shape).astype(np.float32), jvars["batch_stats"])
    pexp, pmodel, ploss, peval, peng = port_interface.build_experiment(pcfg, pdm, device="cpu")
    convert = simple_conv_net_state_dict_from_jax if archive else unet_state_dict_from_jax
    pmodel.load_state_dict(convert(jvars))
    j = dict(exp=jexp, vars=jvars, loss=jloss, eval=jeval, eng=jeng, cfg=jcfg)
    p = dict(exp=pexp, model=pmodel, loss=ploss, eval=peval, eng=peng, cfg=pcfg, convert=convert)
    return j, p, pdm


def _jbatch(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _jax_value_and_grad(j, batch, rng):
    def f(params):
        loss, (aux, updates) = j["loss"]({**j["vars"], "params": params}, _jbatch(batch), rng)
        return loss, (aux, updates)

    (loss, (aux, updates)), grads = jax.value_and_grad(f, has_aux=True)(j["vars"]["params"])
    return loss, aux, updates, grads


def _assert_grads_match(p, jgrads, jvars):
    want = p["convert"]({**jvars, "params": to_numpy_tree(jgrads)})
    got = {k: v.grad for k, v in p["model"].named_parameters()}
    assert sorted(got) == sorted(k for k in want if k in got) and all(g is not None for g in got.values())
    top = max(float(want[k].abs().max()) for k in got)
    for k, g in got.items():
        limit = GRAD_REL * max(float(want[k].abs().max()), GRAD_FLOOR * top)
        err = float((g - want[k]).abs().max())
        assert err <= limit, f"{k}: max abs err {err:.3e} > {limit:.3e}"


def _assert_updates_match(p, paux, jupdates, jvars):
    """A BatchNorm backbone's train-mode running-statistics updates."""
    want = p["convert"]({**jvars, "batch_stats": to_numpy_tree(jupdates["batch_stats"])})
    got = paux[MODEL_STATE_UPDATES]
    names = {k for k in want if "running" in k}
    assert names and {k for k in got if "running" in k} == names
    for k in names:
        _close(got[k].numpy(), want[k].numpy(), REL, k)


# ---------------------------------------------------------------------------
# losses
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("backbone", ["unet", "spring"])
def test_time_conditioned_loss_matches_jax(backbone, spring_archive):
    """At the lead times the JAX loss draws (t ~ U{1..h} from its key), the
    loss and every gradient; on the spring mesh's BatchNorm backbone also the
    running-statistics updates."""
    spring = backbone == "spring"
    preset = "spring_mesh_time_conditioned" if spring else "synthetic_time_conditioned"
    j, p, pdm = _pair(preset, archive=spring_archive if spring else None, randomize_stats=spring)
    batch = next(pdm.split("train").batches(3))
    rng = jax.random.key(1)
    loss, aux, updates, grads = _jax_value_and_grad(j, batch, rng)
    t = np.asarray(jax.random.randint(jax.random.split(rng)[0], (3,), 1, p["exp"].cfg.horizon + 1))
    got, paux = p["exp"].p_losses(None, batch, torch.from_numpy(t), None)
    got.backward()
    _close(float(got.detach()), float(loss), LOSS_REL, "loss")
    _assert_grads_match(p, grads, j["vars"])
    if spring:
        _assert_updates_match(p, paux, updates, j["vars"])
    else:
        assert MODEL_STATE_UPDATES not in paux and not updates


@pytest.mark.parametrize("backbone", ["unet", "spring"])
def test_simultaneous_loss_matches_jax(backbone, spring_archive):
    """The network on the stacked window against the h stacked targets
    (time-major channels); the Unet without its time embedding."""
    spring = backbone == "spring"
    preset = "spring_mesh_simultaneous" if spring else "synthetic_simultaneous"
    j, p, pdm = _pair(preset, archive=spring_archive if spring else None, randomize_stats=spring)
    assert p["model"].time_emb_mlp is None if not spring else True
    batch = next(pdm.split("train").batches(3))
    loss, aux, updates, grads = _jax_value_and_grad(j, batch, jax.random.key(2))
    got, paux = p["loss"](None, batch, None)
    got.backward()
    _close(float(got.detach()), float(loss), LOSS_REL, "loss")
    _assert_grads_match(p, grads, j["vars"])
    if spring:
        _assert_updates_match(p, paux, updates, j["vars"])


def _replay_engine_loss(j, p, rng, batch):
    """Feed the port's engine the t and noise the JAX engine's ``loss``
    draws from ``rng`` (targets: the stacked frames, NHWC)."""
    k_t, k_loss = jax.random.split(rng)
    B = batch["dynamics"].shape[0]
    t = np.asarray(jax.random.randint(k_t, (B,), 0, p["eng"].num_timesteps))
    C = p["exp"].actual_num_output_channels()
    shape = (B,) + tuple(batch["dynamics"].shape[2:4]) + (C,)
    k_noise = jax.random.split(k_loss, 3 if j["cfg"]["diffusion"]["name"] == "mcvd" else 2)[0]
    p["eng"].draw_steps = lambda n, generator, device: torch.from_numpy(t).to(device)
    p["eng"].draw = Replay([np.asarray(jax.random.normal(k_noise, shape))])


@pytest.mark.parametrize("method", ["ddpm", "ddpm_v2", "mcvd"])
def test_simultaneous_diffusion_loss_matches_jax(method):
    """The experiment's loss through its engine: targets stacked time-major,
    the condition the window then the static channels, t and noise replayed;
    the loss and every gradient."""
    j, p, pdm = _pair(f"synthetic_{method}")
    assert p["exp"].actual_num_input_channels() == p["exp"].actual_num_output_channels() == H
    assert p["exp"].num_conditional_channels() == 2
    batch = next(pdm.split("train").batches(3))
    rng = jax.random.key(3)
    loss, aux, updates, grads = _jax_value_and_grad(j, batch, rng)
    _replay_engine_loss(j, p, rng, batch)
    got, paux = p["loss"](None, batch, None)
    got.backward()
    _close(float(got.detach()), float(loss), LOSS_REL, "loss")
    _assert_grads_match(p, grads, j["vars"])
    assert not updates and MODEL_STATE_UPDATES not in paux


@pytest.mark.parametrize("method", ["ddpm", "mcvd"])
def test_diffusion_loss_keeps_batchnorm_on_running_averages(method, spring_archive):
    """spring_mesh_{ddpm,mcvd}: the engine calls its SimpleConvNet as the JAX
    package does, on the running averages (randomized here), and returns no
    running-statistics updates; the denoiser has no time embedding."""
    j, p, pdm = _pair(f"spring_mesh_{method}", archive=spring_archive, randomize_stats=True)
    assert p["cfg"]["model"]["with_time_emb"] is False and p["model"].time_emb_mlp is None
    batch = next(pdm.split("train").batches(4))
    rng = jax.random.key(4)
    loss, aux, updates, grads = _jax_value_and_grad(j, batch, rng)
    _replay_engine_loss(j, p, rng, batch)
    before = {k: v.clone() for k, v in p["model"].named_buffers()}
    got, paux = p["loss"](None, batch, None)
    got.backward()
    _close(float(got.detach()), float(loss), LOSS_REL, "loss")
    _assert_grads_match(p, grads, j["vars"])
    assert not updates and MODEL_STATE_UPDATES not in paux
    assert all(torch.equal(v, before[k]) for k, v in p["model"].named_buffers())


# ---------------------------------------------------------------------------
# evals: the ensemble over two autoregressive windows
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("preset", ["synthetic_time_conditioned", "synthetic_simultaneous",
                                    "spring_mesh_time_conditioned", "spring_mesh_simultaneous"])
def test_eval_over_two_windows_matches_jax(preset, spring_archive):
    """The test split's 2-member eval (dropout off) over 2 windows, the
    second from the first's boundary-adjusted predictions: every frame's
    predictions and targets; the spring mesh with its boundary hook and its
    BatchNorm backbone on random running statistics."""
    spring = preset.startswith("spring")
    j, p, pdm = _pair(preset, archive=spring_archive if spring else None, randomize_stats=spring)
    assert p["exp"].num_autoregressive_steps == 1 and (p["exp"].boundary_fn is not None) == spring
    batch = next(pdm.test_batches())
    want = jax.jit(j["eval"]["test"])(j["vars"], _jbatch(batch), jax.random.key(0))
    got = p["eval"]["test"](batch, None, None)
    h = p["exp"].cfg.horizon
    assert sorted(got) == sorted(want) and f"t{2 * h}_preds" in got and f"t{2 * h}_targets" in got
    for k in want:
        assert got[k].dtype == torch.float32
        _close(got[k].numpy(), want[k], REL, k)


def test_ddpm_eval_replays_jax_over_two_windows():
    """One member, the ancestral DDPM sampler over 2 windows: the JAX
    draws of each window's sampler key replayed, the second window
    conditioned on the first's last frame and the static condition."""
    j, p, pdm = _pair("synthetic_ddpm", ["module.num_predictions_test=1"])
    batch = next(pdm.test_batches())
    B = batch["dynamics"].shape[0]
    rng = jax.random.key(5)
    want = jax.jit(j["eval"]["test"])(j["vars"], _jbatch(batch), rng)
    T = p["eng"].num_timesteps
    shape = (B, 8, 8, H)
    draws, key = [], jax.random.split(rng, 1)[0]
    for ar in range(2):
        if ar:
            key = jax.random.fold_in(key, ar)
        k_init, k_loop = jax.random.split(jax.random.split(key)[1])
        draws.append(np.asarray(jax.random.normal(k_init, shape)))
        draws += [np.asarray(jax.random.normal(jax.random.fold_in(k_loop, t), shape)) for t in range(T - 1, 0, -1)]
    p["eng"].draw = Replay(draws)
    got = p["eval"]["test"](batch, None, None)
    assert sorted(got) == sorted(want) and not p["eng"].draw.q
    for k in want:
        _close(got[k].numpy(), want[k], REL, k)


def test_eval_dtype_bf16_runs_f32_compute_on_bf16_weights():
    """module.eval_dtype=bfloat16 in a baseline: the JAX trainer casts only
    the weights and the eval casts no input, so flax computes in f32 on the
    bf16-rounded weights. The port's eval equals the JAX eval on the
    bf16-rounded weights held in f32 (1e-5); the JAX eval on the f32 weights
    and a port forward with its inputs cast to bf16 too both miss that by
    far. Against the JAX eval on bf16 weights itself the port stays within
    1e-2: flax standardizes each weight-standardized conv's bf16 kernel in
    bf16 (at roundings XLA picks: its eager and jitted results differ by
    0.4% of the output here), the port standardizes the rounded kernel in f32."""
    j, p, pdm = _pair("synthetic_time_conditioned", ["module.eval_dtype=bfloat16"])
    batch = next(pdm.val_batches())
    jeval = jax.jit(j["eval"]["val"])

    def jax_eval(cast):
        return jeval(jax.tree_util.tree_map(cast, j["vars"]), _jbatch(batch), jax.random.key(0))

    want = jax_eval(lambda x: jnp.asarray(x, jnp.bfloat16).astype(jnp.float32))
    got = p["eval"]["val"](batch, None, None)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == torch.float32
        _close(got[k].numpy(), want[k], REL, k)
    for k, v in jax_eval(lambda x: jnp.asarray(x, jnp.bfloat16)).items():
        _close(got[k].numpy(), v, 1e-2, f"{k} vs the bf16 weights")
    # negative controls: the f32 weights, and bf16 compute
    f32 = jax_eval(jnp.asarray)["t1_preds"][0]
    exp, model = p["exp"], p["model"]
    x = torch.from_numpy(batch["dynamics"][:, 0]).permute(0, 3, 1, 2)
    w16 = {k: v.bfloat16() for k, v in model.state_dict().items()}
    t = torch.full((x.shape[0],), 1.0)
    all_bf16 = apply_model(model, w16, x.bfloat16(), t, exp.static_condition(batch).bfloat16())
    scale = float(np.abs(np.asarray(want["t1_preds"])).max())
    for name, other in (("the f32 weights", np.asarray(f32)), ("bf16 compute", all_bf16.float().permute(0, 2, 3, 1).numpy())):
        err = float(np.abs(other - np.asarray(want["t1_preds"][0])).max())
        assert err > 10 * REL * scale, f"the check cannot tell {name} apart: {err:.3e}"


# ---------------------------------------------------------------------------
# the learned logvar through three AdamW + EMA steps
# ---------------------------------------------------------------------------
def test_learned_logvar_three_adamw_ema_steps_match_jax():
    """ddpm_v2 with diffusion.learn_logvar=true: the (T,) logvar is a
    trainable leaf beside the denoiser's weights (JAX: params leaf
    ``_diffusion_logvar``; port: the model's parameter of that name), decayed
    by AdamW, kept by the EMA. Three steps of AdamW (weight decay 0.1) + clip
    + EMA at fixed t with replayed noise: weights, logvar and EMA. The loss is
    l2 here: an l1 loss's gradient flips sign with float noise near zero,
    and Adam turns that into whole steps on the weights whose gradient
    vanishes mathematically (a conv bias before a GroupNorm)."""
    extra = ["diffusion.learn_logvar=true", "diffusion.logvar_init=2.0", "diffusion.original_elbo_weight=0.2",
             "diffusion.loss_function=mse",
             "module.use_ema=true",
             "module.ema_decay=0.9", "module.optimizer.weight_decay=0.1", "module.optimizer.lr=1e-3"]
    j, p, pdm = _pair("synthetic_ddpm_v2", extra)
    T = p["eng"].num_timesteps
    assert j["vars"]["params"]["_diffusion_logvar"].shape == (T,)
    assert dict(p["model"].named_parameters())["_diffusion_logvar"].shape == (T,)
    init = {k: v.detach().clone() for k, v in p["model"].named_parameters()}
    exp = j["exp"]
    batches = [next(pdm.split("train").batches(3)) for _ in range(3)]
    t_rows = np.asarray([0, 4, T - 1], np.int32)

    def key(i):
        return jax.random.fold_in(jax.random.key(0), i)

    def j_loss(variables, batch, rng):
        variables, logvar = exp._split_logvar(variables)
        dyn = batch["dynamics"]
        targets = jnp.moveaxis(dyn[:, 1:1 + H], 1, -2).reshape(dyn.shape[:1] + dyn.shape[2:4] + (H,))
        cond = jnp.concatenate([dyn[:, 0], batch["condition"]], axis=-1)
        loss, aux = j["eng"].p_losses(variables, key(batch["i"]), targets, cond, t_rows, logvar=logvar)
        return loss, (aux, {})

    def p_loss(params, batch, generator):
        pb = {k: v for k, v in batch.items() if k != "i"}
        p["eng"].draw_steps = lambda n, g, d: torch.from_numpy(t_rows).long()
        return p["loss"](params, pb, generator)

    j_state = jax_interface.create_train_state(j["cfg"], j["vars"])
    p_state = port_interface.create_train_state(p["cfg"], p["model"])
    j_step = jax.jit(jax_trainer.make_train_step(j_loss))
    p_step = port_trainer.make_train_step(p_loss)
    shape = (3, 8, 8, H)
    for i, batch in enumerate(batches):
        j_state, jm = j_step(j_state, {**_jbatch(batch), "i": jnp.int32(i)})
        p["eng"].draw = Replay([np.asarray(jax.random.normal(jax.random.split(key(i))[0], shape))])
        pm = p_step(p_state, {**batch, "i": i})
        _close(float(pm["loss"]), float(jm["loss"]), LOSS_REL, f"loss {i}")
    want = p["convert"]({"params": to_numpy_tree(j_state.params)})
    want_ema = p["convert"]({"params": to_numpy_tree(j_state.ema_params)})
    got = dict(p["model"].named_parameters())
    lv = "_diffusion_logvar"
    assert lv in want and lv in p_state.ema and p_state.ema_num_updates == int(j_state.ema_num_updates) == 3
    for name, g, w in (("params", {k: v.detach() for k, v in got.items()}, want), ("ema", p_state.ema, want_ema)):
        # the logvar elementwise; the weights together (relative L2): a few
        # weights' gradients are tiny cancellation results that Adam, below
        # its eps, moves in proportion to their rounding
        _close((g[lv] - init[lv]).numpy(), (w[lv] - init[lv]).numpy(), CHANGE_REL, f"{name} logvar change")
        num = sum(float(((g[k] - w[k]) ** 2).sum()) for k in w)
        den = sum(float(((w[k] - init[k]) ** 2).sum()) for k in w)
        assert (num / den) ** 0.5 <= CHANGE_REL, f"{name}: relative L2 {(num / den) ** 0.5:.3e}"
    # the logvar moved; from logvar_init 2 the decay (lr x 0.1 x 2 per step)
    # is a fifth of an Adam step, far above the 1e-2 tolerance of the change
    assert float((got[lv] - init[lv]).abs().max()) > 1e-3
