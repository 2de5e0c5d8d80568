"""The port's training losses against the JAX package, and its remat.

Same numpy inputs and converted weights on both sides, f32, dropout rates 0
(the two frameworks cannot draw the same dropout masks): the loss functions,
the DYffusion two-term ``p_losses`` with every forecaster gradient at a fixed
t, the stage-1 loss and gradients at a fixed i, and the stage-1 eval
function. Remat is checked on the port alone, with dropout on.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dyffusion_tpu import config as jax_config
from dyffusion_tpu import interface as jax_interface
from dyffusion_tpu.diffusion import dyffusion as jd
from dyffusion_tpu.models import Unet as JaxUnet
from dyffusion_tpu.models import make_apply_fn
from dyffusion_tpu.models.base import BackboneSpec as JaxSpec
from dyffusion_tpu.models.base import init_backbone
from dyffusion_tpu.utils import loss as jax_loss
from dyffusion_tpu_torch import config as port_config
from dyffusion_tpu_torch import interface as port_interface
from dyffusion_tpu_torch.diffusion import dyffusion as pd
from dyffusion_tpu_torch.models import Unet, unet_state_dict_from_jax
from dyffusion_tpu_torch.utils import loss as port_loss
from tests._torch_port_helpers import nhwc_to_nchw, to_numpy_tree
from tests._torch_port_helpers import torch_threads_share_of_cores  # noqa: F401 (autouse fixture)

C, HW, B = 2, 16, 2
# diffusion steps of the engine below: horizon 3 + 2 auxiliary steps
N_STEPS = 5
# gradient tolerance: f32 on both sides, sums (over batch, pixels and the
# two loss terms) taken in another order. Each tensor is held to GRAD_REL of
# the larger of its own largest |gradient| and GRAD_FLOOR of the model's
# largest: some gradients vanish mathematically (a conv bias feeding a
# GroupNorm) and are float noise. When this test was written every error was
# at most 3.8e-7 of the model's largest gradient, and tensors above 1% of it
# matched to 5e-6 of their own largest.
GRAD_REL, GRAD_FLOOR = 1e-4, 0.1


def assert_grads_match(got: dict, want: dict, r: float = GRAD_REL):
    assert sorted(got) == sorted(want)
    top = max(float(np.abs(w.numpy()).max()) for w in want.values())
    for k in want:
        w, g = want[k].numpy(), got[k].numpy()
        limit = r * max(float(np.abs(w).max()), GRAD_FLOOR * top)
        err = float(np.abs(g - w).max())
        assert err <= limit, f"{k}: max abs err {err:.3e} > {limit:.3e}"


# ---------------------------------------------------------------------------
# loss functions
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name", ["mse", "l1", "smooth_l1"])
@pytest.mark.parametrize("mask", [None, [1.0, 0.0, 1.0], [0.0, 0.0, 0.0]], ids=["nomask", "mask", "allmasked"])
def test_loss_functions_match(name, mask):
    g = np.random.default_rng(1)
    preds = g.normal(size=(3, 2, 4, 4)).astype(np.float32) * 2
    targets = g.normal(size=(3, 2, 4, 4)).astype(np.float32)
    m = None if mask is None else np.asarray(mask, np.float32)
    want = jax_loss.get_loss_fn(name)(preds, targets, None if m is None else jnp.asarray(m))
    got = port_loss.get_loss_fn(name)(
        torch.from_numpy(preds).bfloat16(), torch.from_numpy(targets).bfloat16(),
        None if m is None else torch.from_numpy(m),
    )
    assert got.dtype == torch.float32  # reductions in f32, even from bf16 inputs
    want16 = jax_loss.get_loss_fn(name)(
        jnp.asarray(preds, jnp.bfloat16), jnp.asarray(targets, jnp.bfloat16), None if m is None else jnp.asarray(m)
    )
    np.testing.assert_allclose(float(got), float(want16), rtol=1e-6, atol=1e-7)
    got32 = port_loss.get_loss_fn(name)(torch.from_numpy(preds), torch.from_numpy(targets),
                                        None if m is None else torch.from_numpy(m))
    np.testing.assert_allclose(float(got32), float(want), rtol=1e-6, atol=1e-7)
    with pytest.raises(ValueError, match="Unknown loss"):
        port_loss.get_loss_fn("l3")


# ---------------------------------------------------------------------------
# the DYffusion two-term loss at fixed t
# ---------------------------------------------------------------------------
def _unet_pair(n_in, n_out, n_cond, seed, **kw):
    kw = dict(dim=8, dim_mults=(1, 2), resnet_block_groups=4, with_time_emb=True,
              num_input_channels=n_in, num_output_channels=n_out, num_conditional_channels=n_cond, **kw)
    jm = JaxUnet(**kw)
    v = to_numpy_tree(init_backbone(jm, JaxSpec(n_in, n_out, n_cond, (HW, HW), True), jax.random.key(seed)))
    tm = Unet(**kw)
    tm.load_state_dict(unet_state_dict_from_jax(v))
    return jm, v, tm


ENGINE_KW = dict(timesteps=3, additional_interpolation_steps=2, num_input_channels=C,
                 lambda_reconstruction=0.5, lambda_reconstruction2=0.5)


@pytest.fixture(scope="module")
def engines():
    """One JAX and one port engine over the same weights, and a jitted JAX
    (loss, grads) of ``p_losses`` shared by the fixed-t cases."""
    fjm, fc_vars, fc = _unet_pair(C, C, C, seed=1)
    ijm, ip_vars, ip = _unet_pair(2 * C, C, 0, seed=2)
    ip.requires_grad_(False)
    j = jd.DyffusionEngine(jd.DyffusionConfig(**ENGINE_KW), make_apply_fn(fjm), make_apply_fn(ijm),
                           interpolator_horizon=3, criterion=jax_loss.mse_loss)
    p = pd.DyffusionEngine(pd.DyffusionConfig(**ENGINE_KW), fc, ip, interpolator_horizon=3,
                           criterion=port_loss.mse_loss)
    g = np.random.default_rng(0)
    x_last = g.normal(size=(B, HW, HW, C)).astype(np.float32)
    cond = g.normal(size=(B, HW, HW, C)).astype(np.float32)

    @jax.jit
    def value_and_grad(fv, t):
        def f(v):
            loss, aux = j.p_losses(v, ip_vars, jax.random.key(0), x_last, cond, t)
            return loss, aux
        return jax.value_and_grad(f, has_aux=True)(fv)

    return dict(j=j, p=p, fc=fc, fc_vars=fc_vars, x_last=x_last, cond=cond, vg=value_and_grad)


@pytest.mark.parametrize("t", [0, 2, N_STEPS - 1], ids=["t0", "tmid", "tlast"])
def test_p_losses_and_forecaster_grads_match(engines, t):
    """t=0 takes the raw condition as x_t; t=N-1 masks the l2 term out; the
    middle t runs every branch. The l2 term's gradient flows through the
    frozen interpolator's second call (its input)."""
    e = engines
    t_arr = np.full((B,), t, np.int32)
    (want_loss, want_aux), want_grads = e["vg"](e["fc_vars"], t_arr)
    fc = e["fc"]
    fc.zero_grad()
    loss, aux = e["p"].p_losses(None, None, None, nhwc_to_nchw(e["x_last"]), nhwc_to_nchw(e["cond"]),
                                torch.from_numpy(t_arr))
    loss.backward()
    for k in ("loss", "loss_forward", "loss_forward2"):
        np.testing.assert_allclose(float(aux[k].detach()), float(want_aux[k]), rtol=1e-5, atol=1e-7, err_msg=k)
    if t == N_STEPS - 1:
        assert float(aux["loss_forward2"].detach()) == 0.0
    got = {k: v.grad for k, v in fc.named_parameters()}
    assert_grads_match(got, unet_state_dict_from_jax(to_numpy_tree(want_grads)))


def test_p_losses_gradient_needs_the_second_interpolator_call(engines):
    """Negative control for the gradient check: cutting the gradient through
    the interpolator's second call (a ``no_grad`` there) must fail it."""
    e = engines
    t_arr = np.full((B,), 1, np.int32)
    _, want_grads = e["vg"](e["fc_vars"], t_arr)
    p, fc = e["p"], e["fc"]
    calls, q_sample = [], p.q_sample

    def q_sample_second_without_grad(*a, **kw):
        calls.append(None)
        if len(calls) % 2 == 0:
            with torch.no_grad():
                return q_sample(*a, **kw)
        return q_sample(*a, **kw)

    p.q_sample = q_sample_second_without_grad
    try:
        fc.zero_grad()
        loss, _ = p.p_losses(None, None, None, nhwc_to_nchw(e["x_last"]), nhwc_to_nchw(e["cond"]),
                             torch.from_numpy(t_arr))
        loss.backward()
    finally:
        del p.q_sample
    with pytest.raises(AssertionError, match="max abs err"):
        assert_grads_match({k: v.grad for k, v in fc.named_parameters()},
                           unet_state_dict_from_jax(to_numpy_tree(want_grads)))


def test_loss_draws_t_from_the_generator(engines):
    p = engines["p"]
    args = (None, None)
    x, c = nhwc_to_nchw(engines["x_last"]), nhwc_to_nchw(engines["cond"])
    with torch.no_grad():
        a = p.loss(*args, torch.Generator().manual_seed(3), x, c)[0]
        b = p.loss(*args, torch.Generator().manual_seed(3), x, c)[0]
        t = torch.randint(0, N_STEPS, (B,), generator=torch.Generator().manual_seed(3))
        want = p.p_losses(*args, None, x, c, t)[0]
    assert float(a) == float(b) == float(want)


# ---------------------------------------------------------------------------
# stage 1: loss and gradients at the drawn i, and the eval function
# ---------------------------------------------------------------------------
SMALL = [
    "datamodule.spatial=(16,16)", "datamodule.channels=2", "datamodule.horizon=3",
    "datamodule.n_traj=5", "datamodule.n_time=10", "datamodule.batch_size=2",
    "datamodule.eval_batch_size=2", "model.dim=8", "model.dim_mults=(1,2)",
    "module.num_predictions=3", "diffusion.additional_interpolation_steps=2",
    "trainer.save_checkpoints=False",
]


@pytest.fixture(scope="module")
def stage1():
    c1 = jax_config.get_config("synthetic_interpolation", SMALL)
    jdm = jax_interface.get_datamodule(c1)
    jdm.setup()
    jexp, jmodel, jvars, _, jeval, _ = jax_interface.build_experiment(c1, jdm)
    jvars = to_numpy_tree(jvars)
    pc1 = port_config.get_config("synthetic_interpolation", SMALL)
    pdm = port_interface.get_datamodule(pc1)
    pdm.setup()
    pexp, pmodel, ploss, peval, _ = port_interface.build_experiment(pc1, pdm, device="cpu")
    pmodel.load_state_dict(unet_state_dict_from_jax(jvars))
    return dict(jexp=jexp, jmodel=jmodel, jvars=jvars, jeval=jeval, pexp=pexp, pmodel=pmodel, ploss=ploss,
                peval=peval, batch=next(pdm.val_batches()))


def test_stage1_loss_and_grads_match(stage1):
    """The port's stage-1 loss function at the i it draws from its
    generator, against the JAX apply + criterion at the same i."""
    s = stage1
    dyn = s["batch"]["dynamics"]
    i = torch.randint(1, 3, (dyn.shape[0],), generator=torch.Generator().manual_seed(5)).numpy()
    jexp, apply = s["jexp"], make_apply_fn(s["jmodel"])

    def f(v):
        inputs = jexp.get_inputs(jnp.asarray(dyn))
        targets = jnp.asarray(dyn)[jnp.arange(dyn.shape[0]), 1 + i - 1]
        return jexp.criterion(apply(v, inputs, jnp.asarray(i, jnp.float32), None, None), targets)

    want_loss, want_grads = jax.jit(jax.value_and_grad(f))(s["jvars"])
    s["pmodel"].zero_grad()
    loss, metrics = s["ploss"](None, s["batch"], torch.Generator().manual_seed(5))
    loss.backward()
    np.testing.assert_allclose(float(loss), float(want_loss), rtol=1e-5)
    assert metrics["loss"] is loss
    assert_grads_match({k: v.grad for k, v in s["pmodel"].named_parameters()},
                       unet_state_dict_from_jax(to_numpy_tree(want_grads)))


def test_stage1_eval_fn_matches(stage1):
    """Folded f32 stage-1 eval, dropout rates 0: every i's ensemble and targets."""
    s = stage1
    want = jax.jit(s["jeval"]["val"])(s["jvars"], s["batch"], jax.random.key(0))
    got = s["peval"]["val"](s["batch"], torch.Generator().manual_seed(0))
    assert sorted(got) == sorted(want) == ["t1_preds", "t1_targets", "t2_preds", "t2_targets"]
    for k in want:
        assert tuple(got[k].shape) == tuple(want[k].shape), k
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), atol=1e-4, rtol=1e-4, err_msg=k)


# ---------------------------------------------------------------------------
# remat
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_remat_gives_identical_loss_and_grads_with_dropout(dtype):
    """Checkpointed blocks replay the forward's dropout masks in the
    recompute (the explicit generator's state is restored), so the two-term
    loss and every gradient are exactly those of the unchecked run, also
    with the bf16 weight copies of mixed precision."""
    drop = dict(block_dropout=0.3, attn_dropout=0.1, input_dropout=0.1)
    results = []
    for remat in (False, True):
        _, _, fc = _unet_pair(C, C, C, seed=1, remat=remat, **drop)
        _, _, ip = _unet_pair(2 * C, C, 0, seed=2, **drop)
        ip.requires_grad_(False)
        eng = pd.DyffusionEngine(pd.DyffusionConfig(**ENGINE_KW), fc, ip, interpolator_horizon=3,
                                 criterion=port_loss.l1_loss)
        g = np.random.default_rng(0)
        x_last, cond = (torch.from_numpy(g.normal(size=(B, C, HW, HW)).astype(np.float32)) for _ in range(2))
        dt = getattr(torch, dtype)
        params = None if dt == torch.float32 else {k: v.to(dt) for k, v in fc.named_parameters()}
        gen = torch.Generator().manual_seed(11)
        loss, _ = eng.loss(params, None, gen, x_last.to(dt), cond.to(dt))
        loss.backward()
        results.append((float(loss), {k: v.grad for k, v in fc.named_parameters()}, gen.get_state()))
    (l0, g0, s0), (l1, g1, s1) = results
    assert l0 == l1
    assert torch.equal(s0, s1)  # the live generator ends where the unchecked run left it
    for k in g0:
        assert torch.equal(g0[k], g1[k]), k
