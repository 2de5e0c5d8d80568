"""The port's FIR resampling ops and NCSN++ backbones against the JAX package.

Same numpy inputs on both sides, the JAX variables converted with
``ncsnpp_state_dict_from_jax``. NCSN++ initialises its output convs at
scale 1e-10, so every parameter leaf is first perturbed with numpy draws:
a fresh init would compare near-zeros. f32 tolerance: r x max|JAX| with
r = 2e-5 (the frameworks sum the convs in different orders). The FIR
kernel is asymmetric, so a missing flip shows.
"""
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dyffusion_tpu.models import ncsnpp as jn
from dyffusion_tpu_torch.models import (
    MODEL_REGISTRY,
    BackboneSpec,
    NCSNpp,
    SPADENCSNpp,
    build_backbone,
    ncsnpp_state_dict_from_jax,
    spade_ncsnpp_state_dict_from_jax,
)
from dyffusion_tpu_torch.models import ncsnpp as pn
from tests._torch_port_helpers import nchw_to_nhwc, nhwc_to_nchw, to_numpy_tree
from tests._torch_port_helpers import torch_threads_share_of_cores  # noqa: F401 (autouse fixture)
from tests.test_torch_parity_ncsnpp import _port_ncsnpp
from tests.test_torch_parity_spade import _port_spade_ncsnpp

jfir = importlib.import_module("dyffusion_tpu.ops.upfirdn2d")
pfir = importlib.import_module("dyffusion_tpu_torch.ops.upfirdn2d")

R = 2e-5
K1 = [1.0, 2.0, 5.0, 3.0]  # asymmetric: an unflipped kernel gives other numbers
K2 = np.outer(K1, [1.0, 4.0, 2.0, 1.0]).astype(np.float32)


def _close(got, want, r=R, what=""):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err, scale = float(np.abs(got - want).max()), float(np.abs(want).max())
    assert err <= r * scale, f"{what}: max abs err {err:.3e} > {r} x {scale:.3e}"


def _x(shape, seed=0):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


# ---------------------------------------------------------------------------
# FIR ops
# ---------------------------------------------------------------------------
UPFIRDN_CASES = [
    (1, 1, (0, 0)), (2, 1, (2, 1)), (1, 2, (1, 1)), (2, 2, (1, 2)), (3, 1, (2, 0)),
    ((2, 1), (1, 2), (1, 1)),
    (3, 1, (-1, 2)), (1, 1, (-1, -1)), ((2, 1), (1, 2), (-2, -1)),  # negative pads crop
]


@pytest.mark.parametrize("up,down,pad", UPFIRDN_CASES, ids=[str(c) for c in UPFIRDN_CASES])
def test_upfirdn2d_matches(up, down, pad):
    x = _x((2, 9, 7, 3))
    want = np.asarray(jfir.upfirdn2d(jnp.asarray(x), jnp.asarray(K2), up, down, pad))
    got = pfir.upfirdn2d(nhwc_to_nchw(x), K2, up, down, pad)
    _close(nchw_to_nhwc(got), want, what=f"upfirdn2d {up} {down} {pad}")


@pytest.mark.parametrize("factor,gain", [(2, 1.0), (2, 0.5), (3, 1.0)])
@pytest.mark.parametrize("op", ["upsample_2d", "downsample_2d", "upsample_conv_2d", "conv_downsample_2d"])
def test_fir_resamplers_match(op, factor, gain):
    x = _x((2, 9, 7, 3))
    w = _x((3, 3, 3, 5), seed=1)  # HWIO
    args_j, args_p = (), ()
    if "conv" in op:
        args_j, args_p = (jnp.asarray(w),), (torch.from_numpy(np.ascontiguousarray(w.transpose(3, 2, 0, 1))),)
    want = np.asarray(getattr(jfir, op)(jnp.asarray(x), *args_j, k=K1, factor=factor, gain=gain))
    got = getattr(pfir, op)(nhwc_to_nchw(x), *args_p, k=K1, factor=factor, gain=gain)
    _close(nchw_to_nhwc(got), want, what=op)


def test_fir_default_kernel_and_setup():
    np.testing.assert_array_equal(pfir.setup_fir_kernel(None, 2.0), jfir.setup_fir_kernel(None, 2.0))
    np.testing.assert_array_equal(pfir.setup_fir_kernel(K1, 4.0), jfir.setup_fir_kernel(K1, 4.0))
    np.testing.assert_array_equal(pfir.setup_fir_kernel(K2), jfir.setup_fir_kernel(K2))
    x = _x((1, 6, 6, 2))
    _close(nchw_to_nhwc(pfir.upsample_2d(nhwc_to_nchw(x))), np.asarray(jfir.upsample_2d(jnp.asarray(x))))


def test_fir_unflipped_kernel_is_caught():
    """The negative control of the FIR checks: the same op on the kernel
    flipped back (so the correlation runs with the taps as given) is far
    outside the tolerance."""
    x = _x((2, 9, 7, 3))
    want = np.asarray(jfir.upfirdn2d(jnp.asarray(x), jnp.asarray(K2), 2, 1, (2, 1)))
    got = nchw_to_nhwc(pfir.upfirdn2d(nhwc_to_nchw(x), K2[::-1, ::-1].copy(), 2, 1, (2, 1)))
    with pytest.raises(AssertionError):
        _close(got, want)


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("dim", [8, 9, 32])
def test_timestep_embedding(dim):
    t = np.asarray([0.0, 3.0, 17.5, 999.0], np.float32)
    _close(pn.timestep_embedding(torch.from_numpy(t), dim).numpy(), np.asarray(jn.timestep_embedding(jnp.asarray(t), dim)))


def test_groups_and_nearest_resize():
    for ch in (1, 3, 8, 12, 48, 96, 100, 192, 256):
        assert pn._groups(ch) == jn._groups(ch), ch
    x = _x((2, 16, 12, 3))
    for size in [(8, 6), (4, 3), (16, 12), (5, 7), (32, 24)]:
        want = np.asarray(jn._torch_nearest_resize(jnp.asarray(x), size))
        np.testing.assert_array_equal(nchw_to_nhwc(pn.torch_nearest_resize(nhwc_to_nchw(x), size)), want)


def test_fourier_projection_is_a_fixed_parameter():
    t = np.asarray([0.0, 5.0, 120.0], np.float32)
    jm = jn.GaussianFourierProjection(8)
    p = to_numpy_tree(jm.init(jax.random.key(0), jnp.asarray(t)))
    mod = pn.GaussianFourierProjection(8)
    mod.load_state_dict({"W": torch.from_numpy(p["params"]["W"])})
    got = mod(torch.from_numpy(t))
    _close(got.detach().numpy(), np.asarray(jm.apply(p, jnp.asarray(t))))
    assert isinstance(mod.W, torch.nn.Parameter) and not got.requires_grad


# ---------------------------------------------------------------------------
# whole backbones
# ---------------------------------------------------------------------------
HW, C_IN, C_OUT, C_COND, ROWS = 16, 3, 3, 2, 2
BASE = dict(dim=16, num_input_channels=C_IN, num_output_channels=C_OUT, n_head_channels=8,
            dim_mults=(1, 2), num_res_blocks=1, attn_resolutions=(8,), spatial_height=HW)


def perturbed(variables, seed=0, s=0.05):
    """Every parameter leaf plus numpy normal draws of scale ``s`` (the
    Fourier table by its own scale)."""
    g = np.random.default_rng(seed)
    return jax.tree_util.tree_map(lambda a: (a + s * g.normal(size=a.shape) * max(1.0, np.abs(a).max())).astype(a.dtype),
                                  to_numpy_tree(variables))


def _inputs(n_cond=C_COND, seed=3):
    g = np.random.default_rng(seed)
    x = g.normal(size=(ROWS, HW, HW, C_IN)).astype(np.float32)
    cond = g.normal(size=(ROWS, HW, HW, n_cond)).astype(np.float32) if n_cond else None
    return x, cond, np.asarray([3.0, 17.0], np.float32)


def _jax_pair(cls_j, cls_p, convert, n_cond=C_COND, seed=0, **kw):
    x, cond, t = _inputs(n_cond)
    jm = cls_j(num_conditional_channels=n_cond, **kw)
    v = jm.init(jax.random.key(1), jnp.asarray(x), time=jnp.asarray(t), condition=None if cond is None else jnp.asarray(cond))
    v = perturbed(v, seed)
    tm = cls_p(num_conditional_channels=n_cond, **kw)
    tm.load_state_dict(convert(v), strict=True)
    return jm, v, tm, (x, cond, t)


def _forward_both(jm, v, tm, inputs, with_time=True):
    x, cond, t = inputs
    want = np.asarray(jm.apply(v, jnp.asarray(x), time=jnp.asarray(t) if with_time else None,
                               condition=None if cond is None else jnp.asarray(cond)))
    with torch.no_grad():
        got = tm(nhwc_to_nchw(x), torch.from_numpy(t) if with_time else None,
                 None if cond is None else nhwc_to_nchw(cond))
    return nchw_to_nhwc(got), want


NCSNPP_CASES = {
    "biggan_positional": dict(),
    "biggan_fourier_condemb": dict(embedding_type="fourier", cond_emb=True),
    "biggan_noskip_notime": dict(skip_rescale=False, with_time_emb=False),
    "ddpm_positional_condemb": dict(resblock_type="ddpm", cond_emb=True),
    "ddpm_fourier_noskip": dict(resblock_type="ddpm", embedding_type="fourier", skip_rescale=False),
    "ddpm_notime_2blocks": dict(resblock_type="ddpm", with_time_emb=False, num_res_blocks=2),
}


@pytest.mark.parametrize("name", list(NCSNPP_CASES))
def test_ncsnpp_forward_matches(name):
    kw = {**BASE, **NCSNPP_CASES[name]}
    jm, v, tm, inputs = _jax_pair(jn.NCSNpp, NCSNpp, ncsnpp_state_dict_from_jax, **kw)
    got, want = _forward_both(jm, v, tm, inputs, kw.get("with_time_emb", True))
    _close(got, want, what=name)


def test_ncsnpp_without_condition_matches():
    jm, v, tm, inputs = _jax_pair(jn.NCSNpp, NCSNpp, ncsnpp_state_dict_from_jax, n_cond=0, **BASE)
    got, want = _forward_both(jm, v, tm, inputs)
    _close(got, want)


def test_ncsnpp_condition_follows_x():
    """The condition is concatenated after x: with the condition first
    the converted model gives other numbers."""
    jm, v, tm, (x, cond, t) = _jax_pair(jn.NCSNpp, NCSNpp, ncsnpp_state_dict_from_jax, n_cond=C_IN, **BASE)
    want = np.asarray(jm.apply(v, jnp.asarray(x), time=jnp.asarray(t), condition=jnp.asarray(cond)))
    with torch.no_grad():
        swapped = tm(nhwc_to_nchw(cond), torch.from_numpy(t), nhwc_to_nchw(x))
    assert float(np.abs(nchw_to_nhwc(swapped) - want).max()) > 100 * R * float(np.abs(want).max())


@pytest.mark.parametrize("kw", [dict(), dict(cond_emb=True, spade_dim=12, num_res_blocks=2)], ids=["base", "condemb"])
def test_spade_ncsnpp_forward_matches(kw):
    kw = {**BASE, "spade_dim": 8, **kw}
    jm, v, tm, inputs = _jax_pair(jn.SPADENCSNpp, SPADENCSNpp, spade_ncsnpp_state_dict_from_jax, **kw)
    got, want = _forward_both(jm, v, tm, inputs)
    _close(got, want)


def test_port_state_dicts_load_through_the_reference_porters():
    """A port model's state dict is one of the original reference's: the
    porters of the JAX package's parity tests read it unchanged, and the
    JAX model on the ported weights gives the port's forward."""
    x, cond, t = _inputs()
    kw = dict(dim=16, num_input_channels=C_IN, num_output_channels=C_OUT, num_conditional_channels=C_COND,
              n_head_channels=64, dim_mults=(1, 2), num_res_blocks=2, attn_resolutions=(8,), spatial_height=HW)
    for cls_p, cls_j, porter, extra in (
        (NCSNpp, jn.NCSNpp, _port_ncsnpp, {}),
        (SPADENCSNpp, jn.SPADENCSNpp, _port_spade_ncsnpp, {"spade_dim": 16}),
    ):
        torch.manual_seed(0)
        tm = cls_p(**kw, **extra)
        with torch.no_grad():  # move the near-zero output convs off zero
            for p in tm.parameters():
                p.add_(0.05 * torch.randn(p.shape))
        params = porter(tm, (1, 2), 2, (8,), HW)
        want = np.asarray(cls_j(**kw, **extra).apply({"params": params}, jnp.asarray(x), time=jnp.asarray(t),
                                                   condition=jnp.asarray(cond)))
        with torch.no_grad():
            got = nchw_to_nhwc(tm(nhwc_to_nchw(x), torch.from_numpy(t), nhwc_to_nchw(cond)))
        _close(got, want, what=cls_p.__name__)


@pytest.mark.parametrize("name", ["ncsnpp", "ncsnpp_spade"])
def test_remat_matches_no_remat(name):
    """Remat checkpoints every block; forward and gradients are those of
    the plain model, with live dropout replayed in the recompute."""
    kw = {**BASE, "dropout": 0.3}
    if name == "ncsnpp_spade":
        kw["spade_dim"] = 8
    x, cond, t = (torch.from_numpy(a) if a.ndim == 1 else nhwc_to_nchw(a) for a in _inputs())
    models = []
    for remat in (False, True):
        torch.manual_seed(0)
        models.append(MODEL_REGISTRY[name](num_conditional_channels=C_COND, remat=remat, **kw))
    models[1].load_state_dict(models[0].state_dict())
    outs, grads = [], []
    for m in models:
        with torch.no_grad():
            for p in m.parameters():
                p.add_(0.05 * torch.randn(p.shape, generator=torch.Generator().manual_seed(p.numel())))
        g = torch.Generator().manual_seed(5)
        out = m(x, t, cond, g)
        (out.square().sum()).backward()
        outs.append(out.detach())
        grads.append({n: p.grad.clone() for n, p in m.named_parameters() if p.grad is not None})
    torch.testing.assert_close(outs[1], outs[0], rtol=0, atol=0)
    assert sorted(grads[0]) == sorted(grads[1])
    for n in grads[0]:
        torch.testing.assert_close(grads[1][n], grads[0][n], rtol=1e-5, atol=1e-6, msg=n)


def test_registry_builds_ncsnpp_with_the_spec_height():
    spec = BackboneSpec(2, 2, 1, spatial_shape=(16, 16))
    m = build_backbone({"name": "ncsnpp", "dim": 8, "dim_mults": [1, 2], "attn_resolutions": [8],
                        "n_head_channels": 8, "num_res_blocks": 1, "with_time_emb": True}, spec)
    assert isinstance(m, NCSNpp) and m.all_res == [16, 8]
    m = build_backbone({"name": "ncsnpp", "dim": 8, "dim_mults": [1, 2], "spatial_height": 32}, spec)
    assert m.all_res == [32, 16]
    s = build_backbone({"name": "ncsnpp_spade", "dim": 8, "dim_mults": [1, 2], "spade_dim": 4}, spec)
    assert isinstance(s, SPADENCSNpp)
    assert "fourier_emb.W" in dict(build_backbone(
        {"name": "ncsnpp", "dim": 8, "dim_mults": [1], "embedding_type": "fourier"}, spec).named_parameters())
