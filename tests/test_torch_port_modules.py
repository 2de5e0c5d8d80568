"""The port's NN modules against their flax counterparts, with the flax params
converted into the port's state dicts, in f32 (dropout off). The tolerance
is the weight-ported one the JAX package holds against the original
reference (1e-4): the two frameworks order their sums differently."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dyffusion_tpu.models import modules as jm
from dyffusion_tpu.models import unet as ju
from dyffusion_tpu_torch.models import convert
from dyffusion_tpu_torch.models import modules as tm
from dyffusion_tpu_torch.models import unet as tu
from tests._torch_port_helpers import holder, nchw_to_nhwc, nhwc_to_nchw, to_numpy_tree
from tests._torch_port_helpers import torch_threads_share_of_cores  # noqa: F401 (autouse fixture)

TOL = dict(atol=1e-4, rtol=1e-4)


def _x(shape, seed=0):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _init(module, *args, **kw):
    return to_numpy_tree(module.init(jax.random.key(1), *args, **kw))["params"]


def test_sinusoidal_pos_emb():
    t = np.asarray([0.0, 0.25, 3.0, 17.5], np.float32)
    want = np.asarray(jm.SinusoidalPosEmb(16).apply({}, jnp.asarray(t)))
    got = tm.SinusoidalPosEmb(16)(torch.from_numpy(t)).numpy()
    np.testing.assert_allclose(got, want, **TOL)


def test_time_embedder():
    t = np.asarray([0.0, 0.5, 6.0], np.float32)
    fm = jm.TimeEmbedder(32, 16)
    p = _init(fm, jnp.asarray(t))
    mod = tm.TimeEmbedder(32, 16)
    mod.load_state_dict({
        f"{i}.{n}": torch.tensor(convert._linear(p[f"Dense_{j}"]["kernel"]) if n == "weight" else p[f"Dense_{j}"]["bias"])
        for j, i in ((0, 1), (1, 3)) for n in ("weight", "bias")
    })
    want = np.asarray(fm.apply({"params": p}, jnp.asarray(t)))
    with torch.no_grad():
        np.testing.assert_allclose(mod(torch.from_numpy(t)).numpy(), want, **TOL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_channel_layer_norm(dtype):
    x = _x((2, 5, 6, 12)) * 3 + 1
    g = _x((12,), seed=1)
    want = np.asarray(jm.ChannelLayerNorm(12).apply({"params": {"g": jnp.asarray(g, dtype)}}, jnp.asarray(x, dtype)))
    mod = tm.ChannelLayerNorm(12)
    mod.load_state_dict({"g": torch.from_numpy(g.reshape(1, -1, 1, 1))})
    mod = mod.to(getattr(torch, dtype))
    with torch.no_grad():
        got = nchw_to_nhwc(mod(nhwc_to_nchw(x).to(getattr(torch, dtype))))
    # bf16: eps 1e-3 on both sides, one bf16 rounding of ~3 significant digits
    tol = TOL if dtype == "float32" else dict(atol=3e-2, rtol=3e-2)
    np.testing.assert_allclose(got, np.asarray(want, np.float32), **tol)


def test_weight_standardize():
    k = _x((3, 3, 4, 6))
    want = np.asarray(jm.weight_standardize(jnp.asarray(k), 1e-5))
    got = tm.weight_standardize(torch.from_numpy(convert._conv(k).copy()), 1e-5).numpy()
    np.testing.assert_allclose(got, convert._conv(want), **TOL)


def test_ws_conv():
    x = _x((2, 9, 7, 4))
    fm = jm.WSConv(6)
    p = _init(fm, jnp.asarray(x))
    mod = tm.WSConv(4, 6)
    mod.load_state_dict({"weight": torch.tensor(convert._conv(p["kernel"])), "bias": torch.tensor(p["bias"])})
    want = np.asarray(fm.apply({"params": p}, jnp.asarray(x)))
    with torch.no_grad():
        np.testing.assert_allclose(nchw_to_nhwc(mod(nhwc_to_nchw(x))), want, **TOL)


def _attn_state(p, linear):
    qkv = "to_qkv.1.weight" if linear else "to_qkv.weight"
    return {
        qkv: torch.tensor(convert._dense_1x1(p["to_qkv"]["kernel"])),
        "to_out.weight": torch.tensor(convert._dense_1x1(p["to_out"]["kernel"])),
        "to_out.bias": torch.tensor(p["to_out"]["bias"]),
    }


# the JAX Pallas kernel (interpret mode here) implements the 'qkv' rescale only
@pytest.mark.parametrize("rescale,use_pallas", [("qkv", False), ("qkv", True), ("qk", False)])
def test_linear_attention(rescale, use_pallas):
    x = _x((2, 10, 9, 16), seed=3)
    fm = jm.LinearAttention(dim=16, heads=4, dim_head=32, rescale=rescale, use_pallas=use_pallas)
    p = _init(fm, jnp.asarray(x))
    want = np.asarray(fm.apply({"params": p}, jnp.asarray(x)))
    mod = tm.LinearAttention(16, 4, 32, rescale=rescale)
    mod.load_state_dict(_attn_state(p, linear=True))
    with torch.no_grad():
        np.testing.assert_allclose(nchw_to_nhwc(mod(nhwc_to_nchw(x))), want, **TOL)


def test_attention():
    x = _x((2, 5, 6, 16), seed=4)
    fm = jm.Attention(dim=16, heads=2, dim_head=8)
    p = _init(fm, jnp.asarray(x))
    want = np.asarray(fm.apply({"params": p}, jnp.asarray(x)))
    mod = tm.Attention(16, 2, 8)
    mod.load_state_dict(_attn_state(p, linear=False))
    with torch.no_grad():
        np.testing.assert_allclose(nchw_to_nhwc(mod(nhwc_to_nchw(x))), want, **TOL)


@pytest.mark.parametrize("kind", ["linear", "full"])
def test_pre_norm_residual(kind):
    x = _x((2, 8, 8, 16), seed=5)
    fcls, tcls = (jm.LinearAttention, tm.LinearAttention) if kind == "linear" else (jm.Attention, tm.Attention)
    fm = jm.PreNormResidual(16, fcls, dict(dim=16, heads=4, dim_head=32))
    p = _init(fm, jnp.asarray(x))
    # the "g" of the flax channel norm is random here, so the norm is exercised
    p["ChannelLayerNorm_0"]["g"] = _x((16,), seed=6)
    want = np.asarray(fm.apply({"params": p}, jnp.asarray(x)))
    mod = holder(tm.PreNormResidual(16, tcls(16, 4, 32)))
    sd = {}
    convert._attn(sd, p, "m", linear=kind == "linear")
    mod.load_state_dict({k: torch.tensor(v) for k, v in sd.items()})
    with torch.no_grad():
        np.testing.assert_allclose(nchw_to_nhwc(mod.m(nhwc_to_nchw(x))), want, **TOL)


@pytest.mark.parametrize("dim_in,dim_out,with_time", [(8, 8, True), (12, 8, True), (8, 16, False)])
def test_resnet_block(dim_in, dim_out, with_time):
    x = _x((2, 6, 7, dim_in), seed=7)
    t_emb = _x((2, 24), seed=8) if with_time else None
    fm = ju.ResnetBlock(dim_out, groups=4, use_time_emb=with_time)
    args = (jnp.asarray(x), None if t_emb is None else jnp.asarray(t_emb))
    p = _init(fm, *args)
    # non-trivial GroupNorm affine params
    for n in ("block1_norm", "block2_norm"):
        p[n] = {"scale": _x((dim_out,), seed=9) + 1, "bias": _x((dim_out,), seed=10)}
    want = np.asarray(fm.apply({"params": p}, *args))
    mod = holder(tu.ResnetBlock(dim_in, dim_out, 24 if with_time else None, groups=4))
    sd = {}
    convert._resblock(sd, p, "m")
    mod.load_state_dict({k: torch.tensor(v) for k, v in sd.items()})
    with torch.no_grad():
        got = mod.m(nhwc_to_nchw(x), None if t_emb is None else torch.from_numpy(t_emb))
    np.testing.assert_allclose(nchw_to_nhwc(got), want, **TOL)


def test_upsample():
    x = _x((2, 5, 6, 8), seed=11)
    fm = ju.Upsample(4)
    p = _init(fm, jnp.asarray(x))
    want = np.asarray(fm.apply({"params": p}, jnp.asarray(x)))
    mod = tu.Upsample(8, 4)
    mod.load_state_dict({
        "1.weight": torch.tensor(convert._conv(p["conv"]["kernel"])), "1.bias": torch.tensor(p["conv"]["bias"]),
    })
    with torch.no_grad():
        got = mod(nhwc_to_nchw(x))
    assert tuple(got.shape) == (2, 4, 10, 12)
    np.testing.assert_allclose(nchw_to_nhwc(got), want, **TOL)


@pytest.mark.parametrize("hw", [(8, 8), (15, 15), (7, 10)])
def test_downsample(hw):
    x = _x((2, *hw, 4), seed=12)
    fm = ju._downsample_conv(6, "down")
    p = _init(fm, jnp.asarray(x))
    want = np.asarray(fm.apply({"params": p}, jnp.asarray(x)))
    mod = torch.nn.Conv2d(4, 6, 4, stride=2, padding=1)
    mod.load_state_dict({"weight": torch.tensor(convert._conv(p["kernel"])), "bias": torch.tensor(p["bias"])})
    with torch.no_grad():
        np.testing.assert_allclose(nchw_to_nhwc(mod(nhwc_to_nchw(x))), want, **TOL)


def test_dropout_rate_scale_and_generator():
    x = torch.ones(200_000)
    assert tm.dropout(x, 0.3, None) is x  # generator=None: deterministic
    a = tm.dropout(x, 0.3, torch.Generator().manual_seed(1))
    b = tm.dropout(x, 0.3, torch.Generator().manual_seed(1))
    c = tm.dropout(x, 0.3, torch.Generator().manual_seed(2))
    assert torch.equal(a, b) and not torch.equal(a, c)
    kept = a != 0
    assert abs(kept.float().mean().item() - 0.7) < 0.01  # binomial sd ~0.001
    np.testing.assert_allclose(a[kept].numpy(), 1 / 0.7, rtol=1e-6)
