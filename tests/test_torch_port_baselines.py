"""The port's baseline diffusion engines against the JAX package on the CPU:
DDPM/DDIM (``GaussianDiffusionEngine``), the LDM-style DDPM
(``LatentDDPMEngine``) and MCVD (``McvdEngine``) with its DDPM, DDIM and
F-PNDM samplers.

Both engines run over the same tiny ``Unet`` (dim 8, mults (1,), 8x8, the
JAX variables converted) with dropout off. Torch cannot draw JAX's numbers,
so the port's draws are replaced by the JAX package's: each engine draws
every random tensor through its ``draw`` method, which the tests swap for
a queue of the JAX draws in the engine's order (normal noise, or the raw
standard-Gamma draws for Gamma noise). Tolerances, relative to max|JAX|:
buffers exact (both are numpy), losses 1e-5, gradients 1e-4 of the larger
of the tensor's own and 0.1 of the model's largest gradient, samplers 1e-5
(f32 on both sides, convs summed in another order, over 10-20 steps).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dyffusion_tpu.diffusion import ddpm as jddpm
from dyffusion_tpu.diffusion import ddpm_latent as jldm
from dyffusion_tpu.diffusion import mcvd as jmcvd
from dyffusion_tpu.diffusion import schedules as jsched
from dyffusion_tpu.models import Unet as JaxUnet
from dyffusion_tpu.models import make_apply_fn
from dyffusion_tpu.models.base import BackboneSpec as JaxSpec
from dyffusion_tpu.models.base import init_backbone
from dyffusion_tpu.utils import loss as jax_loss
from dyffusion_tpu_torch.diffusion import ddpm as pddpm
from dyffusion_tpu_torch.diffusion import ddpm_latent as pldm
from dyffusion_tpu_torch.diffusion import mcvd as pmcvd
from dyffusion_tpu_torch.diffusion import schedules as psched
from dyffusion_tpu_torch.models import Unet, unet_state_dict_from_jax
from dyffusion_tpu_torch.utils import loss as port_loss
from tests._torch_port_helpers import nchw_to_nhwc, nhwc_to_nchw, to_numpy_tree
from tests._torch_port_helpers import torch_threads_share_of_cores  # noqa: F401 (autouse fixture)

B, HW, C_S, C_COND = 2, 8, 2, 1  # rows, grid, sample channels (h=2 x C=1), condition channels
T = 10
REL, LOSS_REL, GRAD_REL, GRAD_FLOOR = 1e-5, 1e-5, 1e-4, 0.1


def _close(got, want, r, what=""):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err, scale = float(np.abs(got - want).max()), float(np.abs(want).max())
    assert err <= r * scale, f"{what}: max abs err {err:.3e} > {r} x {scale:.3e}"


class Replay:
    """Stands in for an engine's ``draw``: returns the queued JAX draws in
    order (NHWC arrays as NCHW tensors), checking each one's shape."""

    def __init__(self, arrays):
        self.q = [np.asarray(a, np.float32) for a in arrays]

    def __call__(self, shape, generator, device, concentration=None):
        a = self.q.pop(0)
        t = nhwc_to_nchw(a) if a.ndim == 4 else torch.from_numpy(a)
        assert tuple(t.shape) == tuple(shape), (tuple(t.shape), tuple(shape))
        return t.to(device)


@pytest.fixture(scope="module")
def denoiser():
    """(JAX apply, JAX variables, port Unet) over the same weights."""
    kw = dict(dim=8, dim_mults=(1,), resnet_block_groups=4, with_time_emb=True,
              num_input_channels=C_S, num_output_channels=C_S, num_conditional_channels=C_COND)
    jm = JaxUnet(**kw)
    v = to_numpy_tree(init_backbone(jm, JaxSpec(C_S, C_S, C_COND, (HW, HW), True), jax.random.key(3)))
    tm = Unet(**kw)
    tm.load_state_dict(unet_state_dict_from_jax(v))
    return make_apply_fn(jm), v, tm


@pytest.fixture(scope="module")
def data():
    g = np.random.default_rng(11)
    x = g.normal(size=(B, HW, HW, C_S)).astype(np.float32)
    cond = g.normal(size=(B, HW, HW, C_COND)).astype(np.float32)
    return x, cond


def _normal(key, shape):
    return np.asarray(jax.random.normal(key, shape))


def _assert_grads_match(got: dict, want: dict):
    assert sorted(got) == sorted(want)
    top = max(float(w.abs().max()) for w in want.values())
    for k, w in want.items():
        limit = GRAD_REL * max(float(w.abs().max()), GRAD_FLOOR * top)
        err = float((got[k] - w).abs().max())
        assert err <= limit, f"{k}: max abs err {err:.3e} > {limit:.3e}"


# ---------------------------------------------------------------------------
# buffers
# ---------------------------------------------------------------------------
def test_beta_schedules_match():
    for n in (10, 1000):
        np.testing.assert_array_equal(psched.linear_beta_schedule(n), jsched.linear_beta_schedule(n))
        np.testing.assert_array_equal(psched.cosine_beta_schedule(n), jsched.cosine_beta_schedule(n))
        for name in ("linear", "cosine", "sqrt_linear", "sqrt"):
            np.testing.assert_array_equal(psched.make_beta_schedule(name, n, 0.0015, 0.0195),
                                          jsched.make_beta_schedule(name, n, 0.0015, 0.0195))
    with pytest.raises(ValueError, match="unknown"):
        psched.make_beta_schedule("quadratic", 10)


GAUSSIAN_BUFFERS = ("betas", "alphas_cumprod", "sqrt_alphas_cumprod", "sqrt_one_minus_alphas_cumprod",
                    "sqrt_recip_alphas_cumprod", "sqrt_recipm1_alphas_cumprod", "posterior_variance",
                    "posterior_log_variance_clipped", "posterior_mean_coef1", "posterior_mean_coef2")


@pytest.mark.parametrize("kw", [dict(beta_schedule="linear"), dict(beta_schedule="cosine"),
                                dict(beta_schedule="cosine", hardcode_betaN=True, p2_loss_weight_gamma=0.5)],
                         ids=["linear", "cosine", "betaN_p2"])
def test_gaussian_buffers_match(denoiser, kw):
    apply, _, tm = denoiser
    j = jddpm.GaussianDiffusionEngine(jddpm.GaussianDiffusionConfig(timesteps=T, **kw), apply, (HW, HW, C_S))
    p = pddpm.GaussianDiffusionEngine(pddpm.GaussianDiffusionConfig(timesteps=T, **kw), tm, (C_S, HW, HW))
    for name in GAUSSIAN_BUFFERS + ("p2_loss_weight",):
        np.testing.assert_array_equal(p.buffers.host[name], np.asarray(getattr(j, name)), err_msg=name)
        assert p.buffers.dev[name].dtype == torch.float32
    if kw.get("hardcode_betaN"):
        assert p.buffers.host["sqrt_alphas_cumprod"][-1] == 0.0


@pytest.mark.parametrize("kw", [dict(), dict(v_posterior=0.3, beta_schedule="cosine"),
                                dict(parameterization="pred_x0", hardcode_betaN=True)],
                         ids=["linear", "vposterior_cosine", "x0_betaN"])
def test_ldm_buffers_and_vlb_weights_match(denoiser, kw):
    apply, _, tm = denoiser
    j = jldm.LatentDDPMEngine(jldm.LatentDDPMConfig(timesteps=T, **kw), apply, (HW, HW, C_S))
    p = pldm.LatentDDPMEngine(pldm.LatentDDPMConfig(timesteps=T, **kw), tm, (C_S, HW, HW))
    for name in GAUSSIAN_BUFFERS + ("lvlb_weights",):
        np.testing.assert_array_equal(p.buffers.host[name], np.asarray(getattr(j, name)), err_msg=name)
    np.testing.assert_array_equal(p.init_logvar().numpy(), np.asarray(j.init_logvar()))


@pytest.mark.parametrize("kw", [dict(), dict(beta_schedule="cosine"), dict(gamma=True),
                                dict(gamma=True, beta_schedule="cosine")], ids=["linear", "cosine", "gamma", "gamma_cosine"])
def test_mcvd_buffers_match(denoiser, kw):
    apply, _, tm = denoiser
    j = jmcvd.McvdEngine(jmcvd.McvdConfig(timesteps=T, **kw), apply, (HW, HW, C_S))
    p = pmcvd.McvdEngine(pmcvd.McvdConfig(timesteps=T, **kw), tm, (C_S, HW, HW))
    names = ("betas", "alphas", "alphas_prev") + (("k_cum", "theta_t") if kw.get("gamma") else ())
    for name in names:
        np.testing.assert_array_equal(p.buffers.host[name], np.asarray(getattr(j, name)), err_msg=name)
    # the big-to-small convention: step 0 is the noisiest
    assert p.buffers.host["alphas"][0] < p.buffers.host["alphas"][-1]
    for s in ("geometric", "linear", "cosine"):
        np.testing.assert_array_equal(pmcvd.get_sigmas(s, 0.02, 1e-4, T), jmcvd.get_sigmas(s, 0.02, 1e-4, T))


@pytest.mark.parametrize("kw", [dict(sampling_timesteps=4), dict(sampling_timesteps=3, frac_steps=0.5),
                                dict(frac_steps=0.3), dict()], ids=["sub4", "sub3_frac", "frac", "all"])
def test_mcvd_subsampled_schedule_matches(denoiser, kw):
    apply, _, tm = denoiser
    j = jmcvd.McvdEngine(jmcvd.McvdConfig(timesteps=T, **kw), apply, (HW, HW, C_S))
    p = pmcvd.McvdEngine(pmcvd.McvdConfig(timesteps=T, **kw), tm, (C_S, HW, HW))
    for got, want in zip(p.subsampled_schedule(), j._subsampled_schedule()):
        np.testing.assert_array_equal(got, want)


# ---------------------------------------------------------------------------
# losses and gradients at fixed t, with the JAX draws replayed
# ---------------------------------------------------------------------------
T_ROWS = np.asarray([1, T - 2], np.int32)


def _jax_loss_and_grads(fn, variables):
    (loss, aux), grads = jax.value_and_grad(fn, has_aux=True)(variables)
    return loss, aux, unet_state_dict_from_jax(to_numpy_tree(grads))


def _port_grads(tm):
    grads = {k: p.grad.clone() for k, p in tm.named_parameters()}
    tm.zero_grad()
    return grads


@pytest.mark.parametrize("objective", ["pred_noise", "pred_x0"])
def test_ddpm_loss_and_grads_match(denoiser, data, objective):
    apply, v, tm = denoiser
    x, cond = data
    kw = dict(timesteps=T, objective=objective)
    j = jddpm.GaussianDiffusionEngine(jddpm.GaussianDiffusionConfig(**kw), apply, (HW, HW, C_S),
                                      criterion=jax_loss.l1_loss)
    p = pddpm.GaussianDiffusionEngine(pddpm.GaussianDiffusionConfig(**kw), tm, (C_S, HW, HW),
                                      criterion=port_loss.l1_loss)
    rng = jax.random.key(5)
    loss, _, want = _jax_loss_and_grads(lambda var: j.p_losses(var, rng, x, cond, T_ROWS), v)
    p.draw = Replay([_normal(jax.random.split(rng)[0], x.shape)])
    got, aux = p.p_losses(None, None, nhwc_to_nchw(x), nhwc_to_nchw(cond), torch.from_numpy(T_ROWS))
    got.backward()
    _close(float(got), float(loss), LOSS_REL, "loss")
    _assert_grads_match(_port_grads(tm), want)
    assert set(aux) == {"loss"} and not p.draw.q


@pytest.mark.parametrize("learn_logvar", [False, True], ids=["constant", "learned_logvar"])
def test_ldm_loss_and_grads_match(denoiser, data, learn_logvar):
    """With the learned logvar (random values, to weight the rows) its
    gradient too; the VLB term mixed in through original_elbo_weight."""
    apply, v, tm = denoiser
    x, cond = data
    kw = dict(timesteps=T, loss_function="l1", original_elbo_weight=0.3, l_simple_weight=0.7, learn_logvar=learn_logvar)
    j = jldm.LatentDDPMEngine(jldm.LatentDDPMConfig(**kw), apply, (HW, HW, C_S))
    p = pldm.LatentDDPMEngine(pldm.LatentDDPMConfig(**kw), tm, (C_S, HW, HW))
    rng = jax.random.key(6)
    lv = np.random.default_rng(2).normal(size=(T,)).astype(np.float32) * 0.5 if learn_logvar else None

    def f(var_and_lv):
        var, logvar = var_and_lv
        return j.p_losses(var, rng, x, cond, T_ROWS, logvar=logvar)

    (loss, aux), (g_var, g_lv) = jax.value_and_grad(f, has_aux=True)((v, None if lv is None else jnp.asarray(lv)))
    p.draw = Replay([_normal(jax.random.split(rng)[0], x.shape)])
    p_lv = None if lv is None else torch.from_numpy(lv).requires_grad_(True)
    got, paux = p.p_losses(None, None, nhwc_to_nchw(x), nhwc_to_nchw(cond), torch.from_numpy(T_ROWS), logvar=p_lv)
    got.backward()
    for k in ("loss", "loss_simple", "loss_vlb"):
        _close(float(paux[k]), float(aux[k]), LOSS_REL, k)
    _assert_grads_match(_port_grads(tm), unet_state_dict_from_jax(to_numpy_tree(g_var)))
    if learn_logvar:
        _close(p_lv.grad.numpy(), np.asarray(g_lv), GRAD_REL, "logvar gradient")
        assert float(np.abs(np.asarray(g_lv)).max()) > 0


@pytest.mark.parametrize("kw", [dict(noise_in_cond=True), dict(gamma=True), dict(gamma=True, noise_in_cond=True)],
                         ids=["noise_in_cond", "gamma", "gamma_noise_in_cond"])
def test_mcvd_loss_and_grads_match(denoiser, data, kw):
    """Gaussian or Gamma noise, on the sample and (noise_in_cond) on the
    condition: the raw Gamma draws replayed, the normalization the port's."""
    apply, v, tm = denoiser
    x, cond = data
    j = jmcvd.McvdEngine(jmcvd.McvdConfig(timesteps=T, **kw), apply, (HW, HW, C_S), criterion=jax_loss.l1_loss)
    p = pmcvd.McvdEngine(pmcvd.McvdConfig(timesteps=T, **kw), tm, (C_S, HW, HW), criterion=port_loss.l1_loss)
    rng = jax.random.key(7)
    loss, _, want = _jax_loss_and_grads(lambda var: j.p_losses(var, rng, x, cond, T_ROWS), v)
    k_z, k_cond, _ = jax.random.split(rng, 3)

    def raw(key, shape):
        if not kw.get("gamma"):
            return _normal(key, shape)
        k = j.k_cum[T_ROWS].reshape((-1,) + (1,) * (len(shape) - 1))
        return np.asarray(jax.random.gamma(key, jnp.broadcast_to(k, shape)))

    p.draw = Replay([raw(k_z, x.shape)] + ([raw(k_cond, cond.shape)] if kw.get("noise_in_cond") else []))
    got, _ = p.p_losses(None, None, nhwc_to_nchw(x), nhwc_to_nchw(cond), torch.from_numpy(T_ROWS))
    got.backward()
    _close(float(got), float(loss), LOSS_REL, "loss")
    _assert_grads_match(_port_grads(tm), want)
    assert not p.draw.q


def test_gamma_noise_statistics_and_port_draws():
    """The port's own draws: the normalized Gamma noise has mean 0 and
    variance 1; the same generator seed gives the same noise, another seed
    another."""
    net = torch.nn.Conv2d(1, 1, 1)
    p = pmcvd.McvdEngine(pmcvd.McvdConfig(timesteps=T, gamma=True), net, (1, 8, 8))
    t = torch.tensor([0, T // 2, T - 1])

    def noise(seed):
        return p._noise_like((3, 1, 200, 200), t, torch.Generator().manual_seed(seed), torch.device("cpu"))

    z = noise(0)
    for row in range(3):
        assert abs(float(z[row].mean())) < 0.02 and abs(float(z[row].var()) - 1.0) < 0.05, row
    assert torch.equal(z, noise(0)) and not torch.equal(z, noise(1))


# ---------------------------------------------------------------------------
# samplers, with the JAX draws replayed
# ---------------------------------------------------------------------------
SHAPE = (B, HW, HW, C_S)


@pytest.mark.parametrize("kw", [dict(), dict(sampling_timesteps=4, ddim_sampling_eta=1.0),
                                dict(sampling_timesteps=4, ddim_sampling_eta=0.0),
                                dict(objective="pred_x0", clip_denoised=True, beta_schedule="linear")],
                         ids=["ancestral", "ddim_eta1", "ddim_eta0", "x0_clip_ancestral"])
def test_ddpm_samplers_match(denoiser, data, kw):
    apply, v, tm = denoiser
    _, cond = data
    j = jddpm.GaussianDiffusionEngine(jddpm.GaussianDiffusionConfig(timesteps=T, **kw), apply, (HW, HW, C_S))
    p = pddpm.GaussianDiffusionEngine(pddpm.GaussianDiffusionConfig(timesteps=T, **kw), tm, (C_S, HW, HW))
    rng = jax.random.key(8)
    want = np.asarray(jax.jit(lambda var, c: j.sample(var, rng, c))(v, cond))
    k_init, k_loop = jax.random.split(rng)
    draws = [_normal(k_init, SHAPE)]
    if p.is_ddim_sampling:
        draws += [_normal(jax.random.fold_in(k_loop, i), SHAPE) for i, (_, tn) in enumerate(p.ddim_steps()) if tn >= 0]
    else:
        draws += [_normal(jax.random.fold_in(k_loop, t), SHAPE) for t in range(T - 1, 0, -1)]
    p.draw = Replay(draws)
    with torch.no_grad():
        got = nchw_to_nhwc(p.sample(None, None, nhwc_to_nchw(cond)))
    _close(got, want, REL, "sample")
    assert not p.draw.q


MCVD_SAMPLERS = {
    "ddpm": dict(),
    "ddpm_sub_frac_justbeta": dict(sampling_timesteps=5, frac_steps=0.8, just_beta=True),
    "ddpm_no_denoise_clip": dict(sampling_denoise=False, clip_before=True),
    "ddpm_gamma": dict(gamma=True, sampling_timesteps=5),
    "ddim": dict(version="DDIM", sampling_timesteps=5),
    "fpndm": dict(version="FPNDM", timesteps=20),
}


@pytest.mark.parametrize("name", sorted(MCVD_SAMPLERS))
def test_mcvd_samplers_match(denoiser, data, name):
    apply, v, tm = denoiser
    _, cond = data
    kw = {"timesteps": T, **MCVD_SAMPLERS[name]}
    j = jmcvd.McvdEngine(jmcvd.McvdConfig(**kw), apply, (HW, HW, C_S))
    p = pmcvd.McvdEngine(pmcvd.McvdConfig(**kw), tm, (C_S, HW, HW))
    rng = jax.random.key(9)
    want = np.asarray(jax.jit(lambda var, c: j.sample(var, rng, c))(v, cond))

    def raw(key, t_step):
        if not kw.get("gamma"):
            return _normal(key, SHAPE)
        k = np.full(SHAPE, np.asarray(j.k_cum)[t_step], np.float32)
        return np.asarray(jax.random.gamma(key, jnp.asarray(k)))

    if kw.get("version", "DDPM") == "DDPM":
        k_init, k_loop, _ = jax.random.split(rng, 3)
        steps = p.subsampled_schedule()[0]
        draws = [raw(k_init, 0)] + [raw(jax.random.fold_in(k_loop, i), int(steps[i])) for i in range(len(steps) - 1)]
    else:
        draws = [raw(jax.random.split(rng)[0], 0)]
    p.draw = Replay(draws)
    with torch.no_grad():
        got = nchw_to_nhwc(p.sample(None, None, nhwc_to_nchw(cond)))
    _close(got, want, REL, name)
    assert not p.draw.q


def test_ldm_sampler_with_intermediates_matches(denoiser, data):
    apply, v, tm = denoiser
    _, cond = data
    kw = dict(timesteps=T, v_posterior=0.2)
    j = jldm.LatentDDPMEngine(jldm.LatentDDPMConfig(**kw), apply, (HW, HW, C_S))
    p = pldm.LatentDDPMEngine(pldm.LatentDDPMConfig(**kw), tm, (C_S, HW, HW))
    rng = jax.random.key(10)
    want, want_inter = jax.jit(lambda var, c: j.sample(var, rng, c, return_intermediates=True, log_every_t=3))(v, cond)
    k_init, k_loop = jax.random.split(rng)
    p.draw = Replay([_normal(k_init, SHAPE)] + [_normal(jax.random.fold_in(k_loop, t), SHAPE) for t in range(T - 1, 0, -1)])
    with torch.no_grad():
        got, inter = p.sample(None, None, nhwc_to_nchw(cond), return_intermediates=True, log_every_t=3)
    _close(nchw_to_nhwc(got), np.asarray(want), REL, "sample")
    want_inter = np.asarray(want_inter)
    assert inter.shape[0] == want_inter.shape[0] == 1 + 4  # the noise; t = 9 (T-1), 6, 3, 0
    for i in range(inter.shape[0]):
        _close(nchw_to_nhwc(inter[i]), want_inter[i], REL, f"intermediate {i}")


def test_ldm_log_images_and_conditioned_apply(denoiser, data):
    """``log_images``' diffusion row against the JAX package's (one replayed
    noise draw), and every ``make_conditioned_apply`` routing."""
    apply, v, tm = denoiser
    x, cond = data
    j = jldm.LatentDDPMEngine(jldm.LatentDDPMConfig(timesteps=T), apply, (HW, HW, C_S))
    p = pldm.LatentDDPMEngine(pldm.LatentDDPMConfig(timesteps=T), tm, (C_S, HW, HW))
    rng = jax.random.key(12)
    want = j.log_images(v, rng, x, cond, n_row=2, sample=False)
    p.draw = Replay([_normal(jax.random.split(rng)[0], x.shape)])
    got = p.log_images(None, None, nhwc_to_nchw(x), nhwc_to_nchw(cond), n_row=2, sample=False)
    assert sorted(got) == sorted(want) == ["diffusion_row", "inputs"]
    for i in range(got["diffusion_row"].shape[0]):
        _close(nchw_to_nhwc(got["diffusion_row"][i]), np.asarray(want["diffusion_row"][i]), REL, f"row {i}")

    def net(x, t, context=None, y=None):
        return x, t, context, y

    a, c = torch.ones(1, 2, 3, 3), torch.zeros(1, 1, 3, 3)
    assert pldm.make_conditioned_apply(net, None)(a, 1)[0] is a
    assert pldm.make_conditioned_apply(net, "concat")(a, 1, c_concat=[c])[0].shape == (1, 3, 3, 3)
    ctx = [torch.ones(1, 4, 5), torch.ones(1, 4, 2)]
    assert pldm.make_conditioned_apply(net, "crossattn")(a, 1, c_crossattn=ctx)[2].shape == (1, 4, 7)
    out = pldm.make_conditioned_apply(net, "hybrid")(a, 1, c_concat=[c], c_crossattn=ctx)
    assert out[0].shape == (1, 3, 3, 3) and out[2].shape == (1, 4, 7)
    assert pldm.make_conditioned_apply(net, "adm")(a, 1, c_crossattn=[c])[3] is c
    with pytest.raises(AssertionError):
        pldm.make_conditioned_apply(net, "film")


def test_samplers_call_the_denoiser_without_a_generator(denoiser, data):
    """Dropout stays off in every sampler (the members differ only by their
    noise): the denoiser never sees a generator, while the losses pass it."""
    _, _, tm = denoiser
    _, cond = data
    seen = []

    class Spy(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.net = tm

        def forward(self, x, time=None, condition=None, generator=None):
            seen.append(generator)
            return self.net(x, time, condition, generator)

    spy = Spy()
    engines = [
        pddpm.GaussianDiffusionEngine(pddpm.GaussianDiffusionConfig(timesteps=4), spy, (C_S, HW, HW)),
        pldm.LatentDDPMEngine(pldm.LatentDDPMConfig(timesteps=4), spy, (C_S, HW, HW)),
        pmcvd.McvdEngine(pmcvd.McvdConfig(timesteps=4), spy, (C_S, HW, HW)),
        pmcvd.McvdEngine(pmcvd.McvdConfig(timesteps=4, version="FPNDM"), spy, (C_S, HW, HW)),
    ]
    g = torch.Generator().manual_seed(0)
    c = nhwc_to_nchw(cond)
    with torch.no_grad():
        for e in engines:
            e.sample(None, g, c)
    assert seen and all(s is None for s in seen)
    seen.clear()
    x = torch.zeros((B, C_S, HW, HW))
    for e in engines[:3]:
        e.loss(None, g, x, c)
    assert len(seen) == 3 and all(s is g for s in seen)
