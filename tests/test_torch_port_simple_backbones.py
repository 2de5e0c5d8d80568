"""The port's physical-systems backbones (``UNetSimple``, ``SimpleConvNet``)
and their BatchNorm state against the JAX package.

Same numpy inputs and converted variables on both sides, f32, dropout off.
Forwards are held to 1e-5 of max|JAX| (f32 on both sides, convs and
reductions in another order); running statistics too. Eval-mode cases run
on random running statistics, so that BatchNorm's normalization is not the
identity; the train-mode case also compares the updated running statistics
(flax: momentum 0.9 on the biased batch variance), and shows that torch's
own update (momentum 0.1 on the unbiased variance) would miss them.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dyffusion_tpu.models import SimpleConvNet as JaxSimpleConvNet
from dyffusion_tpu.models import UNetSimple as JaxUNetSimple
from dyffusion_tpu.models.base import BackboneSpec as JaxSpec
from dyffusion_tpu.models.base import init_backbone
from dyffusion_tpu_torch.experiments.base import cast_params
from dyffusion_tpu_torch.models import (
    SimpleConvNet,
    UNetSimple,
    build_backbone,
    simple_conv_net_state_dict_from_jax,
    unet_simple_state_dict_from_jax,
)
from dyffusion_tpu_torch.models.base import BackboneSpec, BatchNorm2d, apply_model, apply_model_train
from tests._torch_port_helpers import nhwc_to_nchw, to_numpy_tree
from tests._torch_port_helpers import torch_threads_share_of_cores  # noqa: F401 (autouse fixture)

REL = 1e-5  # forwards and running statistics, relative to max|JAX|
GRAD_REL = 1e-4

# name -> (JAX class, port class, converter, (H, W), C, Cc, kwargs): UNetSimple
# at the NS grid with the smallest working grid its six stride-2 blocks take
UNET = "unet_simple"
CNN = "cnn_simple"
CASES = {
    UNET: (JaxUNetSimple, UNetSimple, unet_simple_state_dict_from_jax, (221, 42), 3, 2,
           dict(dim=4, with_time_emb=True, upsample_dims=(64, 64))),
    CNN: (JaxSimpleConvNet, SimpleConvNet, simple_conv_net_state_dict_from_jax, (10, 10), 4, 1,
          dict(dim=32, with_time_emb=True)),
}


def _random_stats(variables, rng):
    """``variables`` with random running statistics (mean ~ N(0, 0.3), var ~ U(0.5, 1.5))."""
    def draw(path, x):
        if path[-1].key == "mean":
            return (rng.normal(size=x.shape) * 0.3).astype(np.float32)
        return rng.uniform(0.5, 1.5, size=x.shape).astype(np.float32)

    v = to_numpy_tree(variables)
    if "batch_stats" in v:
        v["batch_stats"] = jax.tree_util.tree_map_with_path(draw, v["batch_stats"])
    return v


def _pair(name, seed=1, **overrides):
    jcls, tcls, convert, (H, W), C, Cc, kw = CASES[name]
    kw = dict(kw, num_input_channels=C, num_output_channels=C, num_conditional_channels=Cc, **overrides)
    jm = jcls(**kw)
    v = _random_stats(init_backbone(jm, JaxSpec(C, C, Cc, (H, W)), jax.random.key(seed)), np.random.default_rng(seed))
    tm = tcls(**kw)
    tm.load_state_dict(convert(v))
    return jm, v, tm, convert


def _inputs(name, B=3, seed=2):
    _, _, _, (H, W), C, Cc, _ = CASES[name]
    g = np.random.default_rng(seed)
    x = g.normal(size=(B, H, W, C)).astype(np.float32)
    c = g.normal(size=(B, H, W, Cc)).astype(np.float32)
    t = np.arange(1, B + 1, dtype=np.float32) * 1.5
    return x, c, t


def _assert_close(got, want, r=REL, what=""):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err, scale = float(np.abs(got - want).max()), float(np.abs(want).max())
    assert err <= r * scale, f"{what}: max abs err {err:.3e} > {r} x {scale:.3e}"


@pytest.mark.parametrize("name", [UNET, CNN])
def test_eval_forward_matches_jax(name):
    """Running averages in BatchNorm, dropout off: the JAX ``make_apply_fn``."""
    jm, v, tm, _ = _pair(name)
    x, c, t = _inputs(name)
    want = jm.apply(v, jnp.asarray(x), time=jnp.asarray(t), condition=jnp.asarray(c), deterministic=True, train=False)
    with torch.no_grad():
        got = apply_model(tm, None, nhwc_to_nchw(x), torch.from_numpy(t), nhwc_to_nchw(c))
    _assert_close(got.permute(0, 2, 3, 1).numpy(), want, what=name)


@pytest.mark.parametrize("name", [UNET, CNN])
def test_train_forward_and_running_statistics_match_jax(name):
    """Batch statistics in BatchNorm and the updated running statistics
    (the JAX ``make_train_apply_fn``); the module's buffers stay as they
    were. Negative control: torch's own BatchNorm update of the same
    statistics lies outside the tolerance."""
    jm, v, tm, convert = _pair(name)
    x, c, t = _inputs(name)
    want, updates = jm.apply(v, jnp.asarray(x), time=jnp.asarray(t), condition=jnp.asarray(c),
                             deterministic=True, train=True, mutable=["batch_stats"])
    before = {k: b.clone() for k, b in tm.named_buffers()}
    got, got_updates = apply_model_train(tm, None, nhwc_to_nchw(x), torch.from_numpy(t), nhwc_to_nchw(c))
    _assert_close(got.detach().permute(0, 2, 3, 1).numpy(), want, what=f"{name} train forward")
    want_stats = convert({"params": v["params"], "batch_stats": to_numpy_tree(updates["batch_stats"])})
    n_bn = sum(isinstance(m, BatchNorm2d) for m in tm.modules())
    assert n_bn > 0 and len(got_updates) == 3 * n_bn
    for k, u in got_updates.items():
        if "running" in k:
            _assert_close(u.numpy(), want_stats[k].numpy(), what=k)
        else:
            assert int(u) == 1, k  # num_batches_tracked
    assert all(torch.equal(b, before[k]) for k, b in tm.named_buffers()), "the train forward wrote the buffers"

    # torch's own update of the same batch statistics (momentum 0.1 on the
    # unbiased variance): the same check rejects it
    inputs = {}
    hooks = [m.register_forward_hook(lambda m, a, out, n=n: inputs.setdefault(n, a[0].detach()))
             for n, m in tm.named_modules() if isinstance(m, BatchNorm2d)]
    apply_model(tm, None, nhwc_to_nchw(x), torch.from_numpy(t), nhwc_to_nchw(c), batch_stats={})
    for h in hooks:
        h.remove()
    misses = 0
    for n, xin in inputs.items():
        bn = tm.get_submodule(n)
        rm, rv = bn.running_mean.clone(), bn.running_var.clone()
        torch.nn.functional.batch_norm(xin, rm, rv, bn.weight, bn.bias, True, 0.1, bn.eps)
        want_var = want_stats[f"{n}.running_var"].numpy()
        misses += float(np.abs(rv.numpy() - want_var).max()) > REL * float(np.abs(want_var).max())
    assert misses > 0, "the running-statistics check accepts torch's unbiased update"


@pytest.mark.parametrize("norm", ["batch_norm", "layer_norm", "group_norm", "instance_norm", "none"])
def test_simple_conv_net_norms_match_jax(norm):
    jm, v, tm, _ = _pair(CNN, net_normalization=norm)
    x, c, t = _inputs(CNN)
    want = jm.apply(v, jnp.asarray(x), time=jnp.asarray(t), condition=jnp.asarray(c), deterministic=True, train=False)
    with torch.no_grad():
        got = apply_model(tm, None, nhwc_to_nchw(x), torch.from_numpy(t), nhwc_to_nchw(c))
    _assert_close(got.permute(0, 2, 3, 1).numpy(), want, what=norm)


def test_unet_simple_loads_through_the_reference_porter():
    """The port keeps the original reference's state-dict keys: the JAX
    package's torch -> flax porter of the reference ``UNet`` loads a port
    model unchanged, and the JAX model then computes what the port does."""
    from tests.test_torch_parity import _port_unet_simple_weights

    jm, _, tm, _ = _pair(UNET, seed=3)
    params, batch_stats = _port_unet_simple_weights(tm)
    x, c, t = _inputs(UNET, B=2, seed=4)
    want = jm.apply({"params": params, "batch_stats": batch_stats}, jnp.asarray(x), time=jnp.asarray(t),
                    condition=jnp.asarray(c), deterministic=True, train=False)
    with torch.no_grad():
        got = tm(nhwc_to_nchw(x), torch.from_numpy(t), nhwc_to_nchw(c))
    _assert_close(got.permute(0, 2, 3, 1).numpy(), want, what="reference porter")


def test_state_dict_keys_are_the_references():
    tm = UNetSimple(dim=4, num_input_channels=3, num_output_channels=3, num_conditional_channels=2, with_time_emb=True)
    keys = set(tm.state_dict())
    for i in range(6):
        bn = i < 5
        for side, conv, norm in (("input_ops", 0, 1), ("output_ops", 1, 2)):
            assert {f"{side}.{i}.ops.{conv}.weight", f"{side}.{i}.time_mlp.1.weight"} <= keys
            assert (f"{side}.{i}.ops.{norm}.running_var" in keys) == (bn or side == "output_ops")
    assert {"init_conv.weight", "readout.0.weight", "time_emb_mlp.1.weight", "time_emb_mlp.3.bias"} <= keys
    assert tuple(tm.readout[0].weight.shape) == (4, 3, 4, 4)  # ConvTranspose2d: (I, O, kh, kw)
    cnn = SimpleConvNet(dim=32, num_input_channels=4, num_output_channels=4, num_conditional_channels=1,
                        with_time_emb=True)
    assert {"convs.0.conv.weight", "convs.2.norm.running_mean", "convs.1.time_mlp.1.bias", "head.weight"} <= set(
        cnn.state_dict())
    assert tuple(cnn.head.weight.shape) == (4, 32, 1, 1)  # a 1x1 conv


@pytest.mark.parametrize("name", [UNET, CNN])
def test_mc_dropout_keeps_batchnorm_on_its_running_averages(name):
    """A live generator turns dropout on and leaves BatchNorm in eval: with
    dropout rate 0 it gives the deterministic answer, with rate > 0 another
    one per draw; no call writes the buffers."""
    _, _, tm, _ = _pair(name)
    x, c, t = _inputs(name)
    args = (nhwc_to_nchw(x), torch.from_numpy(t), nhwc_to_nchw(c))
    before = {k: b.clone() for k, b in tm.named_buffers()}
    with torch.no_grad():
        plain = apply_model(tm, None, *args)
        same = apply_model(tm, None, *args, generator=torch.Generator().manual_seed(0))
        dropped = _pair(name, dropout=0.3)[2]
        d1 = apply_model(dropped, None, *args, generator=torch.Generator().manual_seed(0))
        d2 = apply_model(dropped, None, *args, generator=torch.Generator().manual_seed(1))
        d0 = apply_model(dropped, None, *args)
    assert torch.equal(plain, same)
    assert torch.allclose(d0, plain, rtol=0, atol=0)  # same weights, same running averages
    assert not torch.allclose(d1, d2)
    assert all(torch.equal(b, before[k]) for k, b in tm.named_buffers())


def test_unet_simple_remat_matches_the_plain_backward():
    """``remat=True`` recomputes each block in the backward with the same
    dropout draws and batch statistics: the same loss, gradients and
    running-statistics updates."""
    kw = dict(dim=4, num_input_channels=3, num_output_channels=3, num_conditional_channels=2, with_time_emb=True,
              upsample_dims=(64, 64), dropout=0.2)
    torch.manual_seed(0)
    plain = UNetSimple(**kw)
    remat = UNetSimple(**kw, remat=True)
    remat.load_state_dict(plain.state_dict())
    x, c, t = _inputs(UNET, B=2)
    results = []
    for model in (plain, remat):
        out, updates = apply_model_train(model, None, nhwc_to_nchw(x), torch.from_numpy(t), nhwc_to_nchw(c),
                                         torch.Generator().manual_seed(5))
        out.square().mean().backward()
        results.append((out.detach(), updates, {k: p.grad for k, p in model.named_parameters()}))
    (o1, u1, g1), (o2, u2, g2) = results
    assert torch.equal(o1, o2)
    assert u1.keys() == u2.keys() and all(torch.equal(u1[k], u2[k]) for k in u1)
    for k in g1:
        torch.testing.assert_close(g2[k], g1[k], rtol=GRAD_REL, atol=GRAD_REL * float(g1[k].abs().max()))


def test_bf16_eval_casts_the_running_statistics():
    """The bf16 eval weights hold the running statistics in bf16 too, with
    the EMA parameters or the model's own, as the JAX package casts every
    floating variable."""
    model = build_backbone({"name": "cnn_simple", "dim": 32, "with_time_emb": True}, BackboneSpec(4, 4, 1))
    ema = {k: p.detach().clone() for k, p in model.named_parameters()}
    for params in (None, ema):
        cast = cast_params(model, torch.bfloat16, params)
        assert cast["convs.0.norm.running_var"].dtype == torch.bfloat16
        assert cast["convs.0.norm.num_batches_tracked"].dtype == torch.int64
        assert cast["head.weight"].dtype == torch.bfloat16
