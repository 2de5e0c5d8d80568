"""The port's optimizer, schedules, EMA and train step against the JAX package.

The LR schedules, the EMA warmup decay and the global-norm clip are compared
value by value. Then three full train steps (AdamW + warmup-cosine schedule
+ clip + EMA on a DYffusion ``p_losses`` at fixed t, dropout rates 0) run in
both packages from the same converted weights: in f32, in bf16 mixed
precision, and with ``accumulate_grad_batches=2`` unfolded and folded into
the batch. The port's weights, EMA and step count must equal the JAX
package's; in bf16, within a bound that the port's f32 run fails.
"""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from dyffusion_tpu import interface as jax_interface
from dyffusion_tpu.diffusion import dyffusion as jd
from dyffusion_tpu.models import Unet as JaxUnet
from dyffusion_tpu.models import make_apply_fn
from dyffusion_tpu.models.base import BackboneSpec as JaxSpec
from dyffusion_tpu.models.base import init_backbone
from dyffusion_tpu.training import ema as jax_ema
from dyffusion_tpu.training import optim as jax_optim
from dyffusion_tpu.training import trainer as jax_trainer
from dyffusion_tpu.utils import loss as jax_loss
from dyffusion_tpu_torch import interface as port_interface
from dyffusion_tpu_torch.diffusion import dyffusion as pd
from dyffusion_tpu_torch.models import Unet, unet_state_dict_from_jax
from dyffusion_tpu_torch.training import ema as port_ema
from dyffusion_tpu_torch.training import optim as port_optim
from dyffusion_tpu_torch.training import trainer as port_trainer
from dyffusion_tpu_torch.utils import loss as port_loss
from tests._torch_port_helpers import nhwc_to_nchw, to_numpy_tree
from tests._torch_port_helpers import torch_threads_share_of_cores  # noqa: F401 (autouse fixture)

SCHEDULES = {
    "warmup_cosine": dict(warm_up_steps=5, lr_min=0.1, lr_max=1.0, lr_start=0.01, max_decay_steps=30),
    "warmup_cosine2": dict(warm_up_steps=[3, 4], f_min=[0.1, 0.05], f_max=[1.0, 0.5], f_start=[0.0, 0.2],
                           cycle_lengths=[10, 20]),
    "linear_warmup": dict(warm_up_steps=[3, 2], f_min=[0.1, 0.2], f_max=[1.0, 0.8], f_start=[0.0, 0.1],
                          cycle_lengths=[12, 15]),
}


@pytest.mark.parametrize("name", sorted(SCHEDULES))
def test_lr_schedules_match(name):
    kw = SCHEDULES[name]
    want = jax_optim.make_lr_schedule(name, base_lr=1.0, **kw)
    got = port_optim.make_lr_multiplier(name, **kw)
    steps = np.arange(0, 45)
    np.testing.assert_allclose([got(int(n)) for n in steps], [float(want(n)) for n in steps], rtol=1e-6, atol=1e-7)


def test_ema_warmup_decay_and_update_match():
    g = np.random.default_rng(0)
    shadow = {"a": g.normal(size=(3, 4)).astype(np.float32), "b": g.normal(size=(5,)).astype(np.float32)}
    want, n_want = dict(shadow), jnp.zeros((), jnp.int32)
    got, n_got = port_ema.init_ema({k: torch.from_numpy(v) for k, v in shadow.items()}), 0
    for i in range(15):
        params = {k: g.normal(size=v.shape).astype(np.float32) for k, v in shadow.items()}
        want, n_want = jax_ema.ema_update(want, params, n_want, decay=0.9)
        n_got = port_ema.ema_update(got, [torch.from_numpy(params[k]) for k in got], n_got, decay=0.9)
        assert n_got == int(n_want)
        for k in shadow:
            np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=1e-6, atol=1e-7)
    d, n = port_ema.ema_decay(3, decay=0.9999)
    assert n == 4 and d == np.float32(5.0) / np.float32(14.0)


@pytest.mark.parametrize("max_norm", [0.5, 100.0], ids=["clips", "keeps"])
def test_clip_by_global_norm_matches_optax(max_norm):
    g = np.random.default_rng(1)
    grads = [g.normal(size=s).astype(np.float32) for s in ((4, 3), (7,), (2, 2, 2))]
    want, _ = optax.clip_by_global_norm(max_norm).update([jnp.asarray(x) for x in grads], optax.EmptyState())
    got = [torch.from_numpy(x.copy()) for x in grads]
    norm = port_optim.clip_by_global_norm(got, max_norm)
    np.testing.assert_allclose(float(norm), float(optax.global_norm(grads)), rtol=1e-6)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6, atol=1e-7)


# ---------------------------------------------------------------------------
# three full train steps
# ---------------------------------------------------------------------------
C, HW, B = 1, 8, 2
T_ROWS = np.asarray([1, 4], np.int32)  # fixed t per micro-batch row: the l2 term on one row, masked on the other
ENGINE_KW = dict(timesteps=3, additional_interpolation_steps=2, num_input_channels=C,
                 lambda_reconstruction=0.5, lambda_reconstruction2=0.5)
CONFIG = {
    "seed": 0,
    "module": {
        "use_ema": True, "ema_decay": 0.9999,
        "optimizer": {"name": "adamw", "lr": 1e-3, "weight_decay": 0.1},
        "scheduler": {"name": "warmup_cosine", "warm_up_steps": 2, "lr_min": 0.1, "lr_max": 1.0, "lr_start": 0.5,
                      "max_decay_steps": 10},
    },
    "trainer": {"gradient_clip_val": 0.5},
}
LAYOUTS = {
    "f32": dict(train_dtype=None, accumulate=1, fold=False),
    "bf16": dict(train_dtype="bfloat16", accumulate=1, fold=False),
    "accumulate2": dict(train_dtype=None, accumulate=2, fold=False),
    "accumulate2_folded": dict(train_dtype=None, accumulate=2, fold=True),
}
N_UPDATES = 3


def _unet_pair(n_in, n_out, n_cond, seed):
    kw = dict(dim=8, dim_mults=(1, 2), resnet_block_groups=4, with_time_emb=True,
              num_input_channels=n_in, num_output_channels=n_out, num_conditional_channels=n_cond)
    jm = JaxUnet(**kw)
    v = to_numpy_tree(init_backbone(jm, JaxSpec(n_in, n_out, n_cond, (HW, HW), True), jax.random.key(seed)))
    tm = Unet(**kw)
    tm.load_state_dict(unet_state_dict_from_jax(v))
    return jm, v, tm


def _run_layout(layout):
    """(JAX state, port state, port model, the grad_norm metrics of both)
    after N_UPDATES optimizer updates in ``layout``."""
    lay = LAYOUTS[layout]
    config = {**CONFIG, "trainer": {**CONFIG["trainer"], "accumulate_grad_batches": lay["accumulate"],
                                    "fold_accumulation_into_batch": lay["fold"]}}
    fjm, fc_vars, fc = _unet_pair(C, C, C, seed=1)
    ijm, ip_vars, ip = _unet_pair(2 * C, C, 0, seed=2)
    ip.requires_grad_(False)
    j = jd.DyffusionEngine(jd.DyffusionConfig(**ENGINE_KW), make_apply_fn(fjm), make_apply_fn(ijm),
                           interpolator_horizon=3, criterion=jax_loss.mse_loss)
    p = pd.DyffusionEngine(pd.DyffusionConfig(**ENGINE_KW), fc, ip, interpolator_horizon=3,
                           criterion=port_loss.mse_loss)

    def j_loss(variables, batch, rng):
        t = np.tile(T_ROWS, batch["x_last"].shape[0] // B)
        loss, aux = j.p_losses(variables, ip_vars, rng, batch["x_last"], batch["cond"], t)
        return loss, (aux, {})

    def p_loss(params, batch, generator):
        t = torch.from_numpy(np.tile(T_ROWS, batch["x_last"].shape[0] // B))
        return p.p_losses(params, None, generator, batch["x_last"], batch["cond"], t)

    if lay["train_dtype"]:
        j_loss = jax_trainer.mixed_precision_loss(j_loss)
        p_loss = port_trainer.mixed_precision_loss(p_loss, fc)
    j_state = jax_interface.create_train_state(config, fc_vars)
    p_state = port_interface.create_train_state(config, fc)
    j_step, p_step = jax_trainer.make_train_step(j_loss), port_trainer.make_train_step(p_loss)

    # the same data in every layout: k micro-batches per update, run one by
    # one or folded into one batch
    k = lay["accumulate"]
    chunks = 1 if lay["fold"] else k
    g = np.random.default_rng(0)
    norms = []
    for _ in range(N_UPDATES):
        x_all, cond_all = (g.normal(size=(k * B, HW, HW, C)).astype(np.float32) for _ in range(2))
        for x_last, cond in zip(np.split(x_all, chunks), np.split(cond_all, chunks)):
            j_state, j_metrics = j_step(j_state, {"x_last": jnp.asarray(x_last), "cond": jnp.asarray(cond)})
            p_metrics = p_step(p_state, {"x_last": nhwc_to_nchw(x_last), "cond": nhwc_to_nchw(cond)})
            norms.append((float(j_metrics["grad_norm"]), float(p_metrics["grad_norm"])))
            np.testing.assert_allclose(float(p_metrics["loss"]), float(j_metrics["loss"]),
                                       rtol=1e-2 if lay["train_dtype"] else 1e-5)
    return j_state, p_state, fc, norms


def _assert_changes_match(got: dict, want: dict, init: dict, r: float, what: str):
    """Elementwise: each tensor's change since ``init`` within ``r`` of the
    larger of its own largest |change| and 0.1 of the largest |change| of
    the model (some gradients are float noise, and Adam moves their weights
    by a full step of either sign)."""
    want = {k: v.detach() for k, v in want.items()}
    top = max(float((want[k] - init[k]).abs().max()) for k in want)
    for k in want:
        err = float((got[k].detach() - want[k]).abs().max())
        limit = r * max(float((want[k] - init[k]).abs().max()), 0.1 * top)
        assert err <= limit, f"{what} {k}: max abs err {err:.3e} > {limit:.3e}"


def _relative_l2(got: dict, want: dict, init: dict) -> float:
    """|got - want| / |want - init| over all tensors together."""
    num = sum(float(((got[k].detach() - want[k]) ** 2).sum()) for k in want)
    return (num / sum(float(((want[k] - init[k]) ** 2).sum()) for k in want)) ** 0.5


@pytest.fixture(scope="module")
def runs():
    return {}


# Tolerances after three updates (lr 1e-3; the largest change is ~2.5e-3).
# f32: both sides f32, sums in another order; measured at most 1.1e-3 of
# the change elementwise when this test was written. bf16: the losses run in
# bf16 on both sides and round at different places (measured: losses 0.25%
# apart, gradient norms 0.55%); Adam turns that into a relative L2 of 0.065
# between the port's and JAX's weight changes. That is about the 0.074 by
# which bf16 and f32 runs differ within either package, so closeness to the
# JAX bf16 run alone cannot tell a bf16 run from an f32 one. The bf16 check
# also requires the run to depart from the JAX f32 run by at least half as
# much as the JAX bf16 run does (measured: the port's bf16 run 0.074, its f32
# run 0.0000); the port's f32 run is its negative control.
CHANGE_REL, BF16_L2, BF16_MIN_DEPARTURE = 1e-2, 0.1, 0.5


def _run(runs, layout):
    if layout not in runs:
        runs[layout] = _run_layout(layout)
    return runs[layout]


def _bf16_misses(got: dict, want_bf16: dict, want_f32: dict, init: dict) -> list:
    """What keeps ``got`` from passing as the JAX bf16 run: too far from it,
    or too close to the JAX f32 run (a run that ignored train_dtype)."""
    misses = []
    near = _relative_l2(got, want_bf16, init)
    if near > BF16_L2:
        misses.append(f"relative L2 to the JAX bf16 run {near:.4f} > {BF16_L2}")
    departure, jax_departure = _relative_l2(got, want_f32, init), _relative_l2(want_bf16, want_f32, init)
    if departure < BF16_MIN_DEPARTURE * jax_departure:
        misses.append(f"departs from the JAX f32 run by {departure:.4f} < {BF16_MIN_DEPARTURE} x {jax_departure:.4f}")
    return misses


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_three_train_steps_match_jax(layout, runs):
    j_state, p_state, fc, norms = _run(runs, layout)
    assert p_state.step == int(j_state.step) == N_UPDATES * LAYOUTS[layout]["accumulate"]
    assert p_state.ema_num_updates == int(j_state.ema_num_updates)
    # the clip is live: the gradient norms exceed it
    assert min(n for n, _ in norms) > CONFIG["trainer"]["gradient_clip_val"]
    np.testing.assert_allclose([n for _, n in norms], [n for n, _ in norms], rtol=1e-2 if layout == "bf16" else 1e-5)
    init = unet_state_dict_from_jax(to_numpy_tree(_unet_pair(C, C, C, seed=1)[1]))
    want_params = unet_state_dict_from_jax(to_numpy_tree(j_state.params))
    want_ema = unet_state_dict_from_jax(to_numpy_tree(j_state.ema_params))
    got_params = dict(fc.named_parameters())
    if layout == "bf16":
        j_f32, p_f32, fc_f32, _ = _run(runs, "f32")
        f32_params = unet_state_dict_from_jax(to_numpy_tree(j_f32.params))
        f32_ema = unet_state_dict_from_jax(to_numpy_tree(j_f32.ema_params))
        assert _bf16_misses(got_params, want_params, f32_params, init) == []
        assert _bf16_misses(p_state.ema, want_ema, f32_ema, init) == []
        # negative control: the port's f32 run must not pass as the bf16 one
        assert _bf16_misses(dict(fc_f32.named_parameters()), want_params, f32_params, init)
        assert _bf16_misses(p_f32.ema, want_ema, f32_ema, init)
    else:
        _assert_changes_match(got_params, want_params, init, CHANGE_REL, "params")
        _assert_changes_match(p_state.ema, want_ema, init, CHANGE_REL, "ema")


def test_folded_accumulation_equals_unfolded(runs):
    """Two micro-batches through the accumulating optimizer == one folded
    step over both: the same weights, EMA trajectory and step count."""
    (_, acc, acc_fc, _), (_, fold, fold_fc, _) = _run(runs, "accumulate2"), _run(runs, "accumulate2_folded")
    assert acc.step == fold.step and acc.ema_num_updates == fold.ema_num_updates
    init = unet_state_dict_from_jax(to_numpy_tree(_unet_pair(C, C, C, seed=1)[1]))
    _assert_changes_match(dict(acc_fc.named_parameters()), dict(fold_fc.named_parameters()), init, CHANGE_REL, "params")
    _assert_changes_match(acc.ema, fold.ema, init, CHANGE_REL, "ema")


def test_time_train_steps_runs_a_warm_up_then_the_timed_steps():
    from dyffusion_tpu_torch.utils.workloads import time_train_steps

    calls = []

    def step(state, batch):
        calls.append(batch)
        return {"loss": torch.tensor(float(len(calls)))}

    dt = time_train_steps(step, None, "b", steps=3)
    assert calls == ["b"] * 4 and dt >= 0.0
