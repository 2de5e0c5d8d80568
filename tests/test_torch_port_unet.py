"""The port's ``Unet`` against the JAX ``Unet`` with converted weights.

f32: the weight-ported tolerance 1e-4 (``PARITY.md``), dropout off. bf16:
both packages run bf16 weights and activations with the time embedding and
FiLM MLP in f32; they round at different places (the JAX XLA attention path
takes its softmaxes in bf16, the port's kernel in f32), so the outputs are
compared relative to their scale.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dyffusion_tpu.models import Unet as JaxUnet
from dyffusion_tpu.models.base import BackboneSpec as JaxSpec
from dyffusion_tpu.models.base import init_backbone
from dyffusion_tpu_torch.models import Unet, unet_state_dict_from_jax
from dyffusion_tpu_torch.models.modules import TimeEmbedder
from tests._torch_port_helpers import nchw_to_nhwc, nhwc_to_nchw, to_numpy_tree
from tests._torch_port_helpers import torch_threads_share_of_cores  # noqa: F401 (autouse fixture)


def _pair(with_time, n_cond, **kw):
    kw = dict(dim=8, dim_mults=(1, 2), resnet_block_groups=4, with_time_emb=with_time,
              num_input_channels=3, num_output_channels=2, num_conditional_channels=n_cond, **kw)
    jm = JaxUnet(**kw)
    variables = to_numpy_tree(init_backbone(jm, JaxSpec(3, 2, n_cond, (16, 16), with_time), jax.random.key(3)))
    tm = Unet(**kw)
    tm.load_state_dict(unet_state_dict_from_jax(variables), strict=True)
    return jm, variables, tm


def _inputs(n_cond, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(2, 16, 16, 3)).astype(np.float32)
    cond = rng.normal(size=(2, 16, 16, n_cond)).astype(np.float32) if n_cond else None
    return x, cond, np.asarray([0.5, 3.0], np.float32)


@pytest.mark.parametrize(
    "with_time,n_cond,extra",
    [
        (True, 2, {}),
        (False, 0, {}),
        (True, 0, {"keep_spatial_dims": True}),
        (True, 1, {"init_dim": 12}),
        (True, 0, {"outer_sample_mode": "bilinear", "upsample_dims": (24, 20)}),
        (True, 0, {"outer_sample_mode": "nearest", "upsample_dims": (32, 32)}),
    ],
)
def test_unet_forward_f32(with_time, n_cond, extra):
    jm, variables, tm = _pair(with_time, n_cond, **extra)
    x, cond, t = _inputs(n_cond)
    want = np.asarray(jm.apply(variables, x, time=t if with_time else None, condition=cond))
    with torch.no_grad():
        got = tm(
            nhwc_to_nchw(x), torch.from_numpy(t) if with_time else None,
            None if cond is None else nhwc_to_nchw(cond),
        )
    np.testing.assert_allclose(nchw_to_nhwc(got), want, atol=1e-4, rtol=1e-4)


def test_unet_forward_bf16_stays_bf16():
    jm, variables, tm = _pair(True, 2)
    x, cond, t = _inputs(2, seed=1)
    v16 = jax.tree_util.tree_map(lambda p: jnp.asarray(p, jnp.bfloat16), variables)
    want = jm.apply(v16, jnp.asarray(x, jnp.bfloat16), time=jnp.asarray(t),
                    condition=jnp.asarray(cond, jnp.bfloat16))
    assert want.dtype == jnp.bfloat16
    want = np.asarray(want, np.float32)

    tm = tm.to(torch.bfloat16)
    seen = {}

    def record(name):
        def hook(mod, args, out):
            seen.setdefault(name, out.dtype)

        return hook

    hooks = [m.register_forward_hook(record(name)) for name, m in tm.named_modules() if name]
    with torch.no_grad():
        got = tm(nhwc_to_nchw(x).bfloat16(), torch.from_numpy(t), nhwc_to_nchw(cond).bfloat16())
    for h in hooks:
        h.remove()
    assert got.dtype == torch.bfloat16
    # the time embedding and the FiLM MLPs run in f32 on bf16-rounded weights,
    # as flax promotes them; every activation of the network stays bf16
    f32_ok = {n for n, m in tm.named_modules() if isinstance(m, TimeEmbedder) or n.endswith(".mlp")}
    f32_ok |= {n for n in seen for p in f32_ok if n.startswith(p + ".")}
    wrong = {n: d for n, d in seen.items() if n not in f32_ok and d != torch.bfloat16}
    assert not wrong, f"activations not in bf16: {wrong}"
    assert all(seen[n] == torch.float32 for n in f32_ok if n in seen)

    got = nchw_to_nhwc(got)
    scale = np.abs(want).max()
    # bf16 keeps ~3 significant digits; rounding at different places through
    # ~20 layers moved outputs by 1.2% of their scale at most (0.2% on
    # average) when this test was written: the bounds leave 2.5x room
    assert np.abs(got - want).max() <= 0.03 * scale, (np.abs(got - want).max(), scale)
    assert np.abs(got - want).mean() <= 0.005 * scale, (np.abs(got - want).mean(), scale)


def test_unet_dropout_uses_the_generator():
    _, _, tm = _pair(True, 0, block_dropout=0.3, attn_dropout=0.1, input_dropout=0.1)
    x, _, t = _inputs(0, seed=2)
    args = (nhwc_to_nchw(x), torch.from_numpy(t))
    with torch.no_grad():
        a = tm(*args, None, torch.Generator().manual_seed(5))
        b = tm(*args, None, torch.Generator().manual_seed(5))
        c = tm(*args, None, torch.Generator().manual_seed(6))
        d1, d2 = tm(*args), tm(*args)
    assert torch.equal(a, b) and torch.equal(d1, d2)
    assert not torch.allclose(a, c) and not torch.allclose(a, d1)


def test_converter_inverts_reference_porter_key_names():
    """Every key of the port's Unet comes from the converter and vice versa."""
    _, variables, tm = _pair(True, 2)
    assert set(unet_state_dict_from_jax(variables)) == set(tm.state_dict())
    assert "downs.0.2.fn.fn.to_qkv.1.weight" in tm.state_dict()
    assert "ups.0.3.1.weight" in tm.state_dict() and "mid_attn.fn.fn.to_qkv.weight" in tm.state_dict()
