"""The port's NCSN normalization zoo, RefineNet blocks and the
``DoubleConv``/``UpSampler`` blocks against the JAX package's, the flax
variables (perturbed with numpy draws) converted into the port's modules.
f32 tolerance: r x max|JAX| with r = 2e-5."""
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dyffusion_tpu.models import modules as jmod
from dyffusion_tpu.models import normalization as jnorm
from dyffusion_tpu.models import refinenet as jref
from dyffusion_tpu_torch.models import modules as pmod
from dyffusion_tpu_torch.models import normalization as pnorm
from dyffusion_tpu_torch.models import refinenet as pref
from dyffusion_tpu_torch.models.convert import _conv, _conv_transpose
from tests._torch_port_helpers import nchw_to_nhwc, nhwc_to_nchw, to_numpy_tree
from tests._torch_port_helpers import torch_threads_share_of_cores  # noqa: F401 (autouse fixture)
from tests.test_torch_port_ncsnpp import perturbed

R = 2e-5
C, NCLS = 8, 3
Y = np.asarray([2, 0], np.int64)


def _close(got, want, r=R, what=""):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err, scale = float(np.abs(got - want).max()), float(np.abs(want).max())
    assert err <= r * scale, f"{what}: max abs err {err:.3e} > {r} x {scale:.3e}"


def _x(c=C, h=6, w=5, seed=0):
    return (np.random.default_rng(seed).normal(size=(2, h, w, c)) * 2 + 0.5).astype(np.float32)


def zoo_state_dict(tree, prefix=""):
    """flax zoo/RefineNet params -> the port's (the reference's) keys."""
    out = {}
    for name, sub in tree.items():
        m = re.fullmatch(r"(conv|norm|adapt)(\d+)(?:_(\d+))?", name)
        if name == "embed":
            out[f"{prefix}embed.weight"] = np.asarray(sub["embedding"])
        elif name in ("alpha", "gamma", "beta"):
            out[prefix + name] = np.asarray(sub)
        elif name in ("msf", "crp", "output"):
            out.update(zoo_state_dict(sub, prefix + {"output": "output_convs"}.get(name, name) + "."))
        elif m and m.group(3) is not None:  # an RCU's conv{i}_{j} / norm{i}_{j}
            key = f"{prefix}{int(m.group(2)) + 1}_{int(m.group(3)) + 1}_{m.group(1)}"
            if m.group(1) == "conv":
                out[f"{key}.weight"] = _conv(sub["kernel"])
            else:
                out.update(zoo_state_dict(sub, key + "."))
        elif m:
            key = f"{prefix}{ {'conv': 'convs', 'norm': 'norms', 'adapt': 'adapt_convs'}[m.group(1)]}.{m.group(2)}"
            if m.group(1) == "conv":
                out[f"{key}.weight"] = _conv(sub["kernel"])
                if "bias" in sub:
                    out[f"{key}.bias"] = np.asarray(sub["bias"])
            else:
                out.update(zoo_state_dict(sub, key + "."))
        else:
            raise KeyError(name)
    return out


def _load(mod, sd):
    mod.load_state_dict({k: torch.tensor(np.asarray(v, np.float32)) for k, v in sd.items()}, strict=True)
    return mod


def _run(jm, pm, jargs, pargs, seed=0):
    v = perturbed(jm.init(jax.random.key(seed), *jargs), seed, s=0.1)
    want = np.asarray(jm.apply(v, *jargs))
    _load(pm, zoo_state_dict(v.get("params", {})))
    with torch.no_grad():
        got = pm(*pargs)
    return got, want


# ---------------------------------------------------------------------------
# normalization zoo
# ---------------------------------------------------------------------------
NORMS = ["InstanceNorm", "InstanceNorm++", "VarianceNorm", "NoneNorm", "GroupNorm"]


@pytest.mark.parametrize("name", NORMS)
def test_unconditional_norms_match(name):
    x = _x()
    jm, pm = jnorm.get_normalization(name)(C), pnorm.get_normalization(name)(C)
    if name == "GroupNorm":
        v = perturbed(jm.init(jax.random.key(0), jnp.asarray(x)), 0, s=0.1)
        want = np.asarray(jm.apply(v, jnp.asarray(x)))
        p = v["params"]
        _load(pm, {"weight": p["scale"], "bias": p["bias"]})
        with torch.no_grad():
            got = pm(nhwc_to_nchw(x))
    else:
        got, want = _run(jm, pm, (jnp.asarray(x),), (nhwc_to_nchw(x),))
    _close(nchw_to_nhwc(got), want, what=name)


@pytest.mark.parametrize("bias", [True, False])
@pytest.mark.parametrize("name", ["InstanceNorm++", "InstanceNorm", "VarianceNorm", "NoneNorm"])
def test_conditional_norms_match(name, bias):
    x = _x()
    kw = {} if name == "VarianceNorm" else {"bias": bias}
    jm = jnorm.get_normalization(name, conditional=True)(C, NCLS, **kw)
    pm = pnorm.get_normalization(name, conditional=True)(C, NCLS, **kw)
    got, want = _run(jm, pm, (jnp.asarray(x), jnp.asarray(Y)), (nhwc_to_nchw(x), torch.from_numpy(Y)))
    _close(nchw_to_nhwc(got), want, what=name)


def test_plus_plus_uses_the_unbiased_variance_of_the_means():
    """The "++" variants standardize the channel means with the unbiased
    variance: with the biased one the output moves well past the tolerance."""
    x = _x()
    jm = jnorm.InstanceNorm2dPlus(C)
    v = perturbed(jm.init(jax.random.key(0), jnp.asarray(x)), 0, s=0.1)
    want = np.asarray(jm.apply(v, jnp.asarray(x)))
    means = x.mean(axis=(1, 2))
    z = (means - means.mean(-1, keepdims=True)) / np.sqrt(means.var(-1, keepdims=True) + 1e-5)  # biased
    inst = (x - x.mean(axis=(1, 2), keepdims=True)) / np.sqrt(x.var(axis=(1, 2), keepdims=True) + 1e-5)
    p = v["params"]
    biased = p["gamma"] * (inst + z[:, None, None, :] * p["alpha"]) + p["beta"]
    with pytest.raises(AssertionError):
        _close(biased, want)
    _close(nchw_to_nhwc(_load(pnorm.InstanceNorm2dPlus(C), zoo_state_dict(p))(nhwc_to_nchw(x)).detach()), want)


def test_norm_dispatcher_and_inits():
    with pytest.raises(ValueError):
        pnorm.get_normalization("BatchNorm")
    with pytest.raises(NotImplementedError):
        pnorm.get_normalization("GroupNorm", conditional=True)
    emb = pnorm.ConditionalInstanceNorm2dPlus(16, 4).embed.weight.detach()
    assert abs(float(emb[:, :32].mean()) - 1.0) < 0.05 and float(emb[:, 32:].abs().max()) == 0.0
    uni = pnorm.ConditionalInstanceNorm2d(16, 4).embed.weight.detach()
    assert 0.0 <= float(uni[:, :16].min()) and float(uni[:, :16].max()) < 1.0 and float(uni[:, 16:].abs().max()) == 0


# ---------------------------------------------------------------------------
# RefineNet blocks
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("maxpool", [True, False])
def test_crp_block_matches(maxpool):
    x = _x()
    got, want = _run(jref.CRPBlock(C, 2, maxpool), pref.CRPBlock(C, 2, maxpool=maxpool),
                     (jnp.asarray(x),), (nhwc_to_nchw(x),))
    _close(nchw_to_nhwc(got), want)


def test_rcu_and_msf_blocks_match():
    x = _x()
    got, want = _run(jref.RCUBlock(C, 2, 3), pref.RCUBlock(C, 2, 3), (jnp.asarray(x),), (nhwc_to_nchw(x),))
    _close(nchw_to_nhwc(got), want, what="rcu")
    x2 = _x(c=5, h=3, w=3, seed=1)
    xs_j, xs_p = [jnp.asarray(x), jnp.asarray(x2)], [nhwc_to_nchw(x), nhwc_to_nchw(x2)]
    got, want = _run(jref.MSFBlock(C), pref.MSFBlock([C, 5], C), (xs_j, (7, 9)), (xs_p, (7, 9)))
    _close(nchw_to_nhwc(got), want, what="msf")


def test_resize_bilinear_align_corners_matches():
    x = _x(h=5, w=4)
    for shape in [(9, 7), (5, 4), (1, 3), (2, 8)]:
        want = np.asarray(jref.resize_bilinear_align_corners(jnp.asarray(x), shape))
        _close(nchw_to_nhwc(pref.resize_bilinear_align_corners(nhwc_to_nchw(x), shape)), want, what=str(shape))


@pytest.mark.parametrize("end", [False, True])
def test_refine_block_matches(end):
    x, x2 = _x(c=6, h=4, w=4), _x(c=C, h=2, w=2, seed=1)
    got, want = _run(jref.RefineBlock(C, end=end), pref.RefineBlock([6, C], C, end=end),
                     ([jnp.asarray(x), jnp.asarray(x2)], (4, 4)), ([nhwc_to_nchw(x), nhwc_to_nchw(x2)], (4, 4)))
    _close(nchw_to_nhwc(got), want)
    got, want = _run(jref.RefineBlock(C, start=True), pref.RefineBlock([C], C, start=True),
                     ([jnp.asarray(x2)], (2, 2)), ([nhwc_to_nchw(x2)], (2, 2)))
    _close(nchw_to_nhwc(got), want, what="single input")


def test_conditional_refinenet_blocks_match():
    jn, pn = jnorm.ConditionalInstanceNorm2dPlus, pnorm.ConditionalInstanceNorm2dPlus
    x, x2 = _x(c=6, h=4, w=4), _x(c=C, h=2, w=2, seed=1)
    y_j, y_p = jnp.asarray(Y), torch.from_numpy(Y)
    xj = jnp.asarray(_x())
    xp = nhwc_to_nchw(_x())
    for what, jm, pm, ja, pa in (
        ("crp", jref.CondCRPBlock(C, 2, NCLS, jn), pref.CondCRPBlock(C, 2, NCLS, pn), (xj, y_j), (xp, y_p)),
        ("rcu", jref.CondRCUBlock(C, 2, 2, NCLS, jn), pref.CondRCUBlock(C, 2, 2, NCLS, pn), (xj, y_j), (xp, y_p)),
        ("msf", jref.CondMSFBlock(C, NCLS, jn), pref.CondMSFBlock([6, C], C, NCLS, pn),
         ([jnp.asarray(x), jnp.asarray(x2)], y_j, (4, 4)), ([nhwc_to_nchw(x), nhwc_to_nchw(x2)], y_p, (4, 4))),
        ("refine", jref.CondRefineBlock(C, NCLS, jn, end=True), pref.CondRefineBlock([6, C], C, NCLS, pn, end=True),
         ([jnp.asarray(x), jnp.asarray(x2)], y_j, (4, 4)), ([nhwc_to_nchw(x), nhwc_to_nchw(x2)], y_p, (4, 4))),
    ):
        got, want = _run(jm, pm, ja, pa)
        _close(nchw_to_nhwc(got), want, what=what)


# ---------------------------------------------------------------------------
# DoubleConv / UpSampler
# ---------------------------------------------------------------------------
def _double_conv_sd(p, stats, prefix=""):
    out = {}
    for i, (ci, ni) in enumerate(((0, 1), (3, 4))):
        out[f"{prefix}double_conv.{ci}.weight"] = _conv(p[f"conv{i}"]["kernel"])
        out[f"{prefix}double_conv.{ni}.weight"] = p[f"bn{i}"]["scale"]
        out[f"{prefix}double_conv.{ni}.bias"] = p[f"bn{i}"]["bias"]
        out[f"{prefix}double_conv.{ni}.running_mean"] = stats[f"bn{i}"]["mean"]
        out[f"{prefix}double_conv.{ni}.running_var"] = np.abs(stats[f"bn{i}"]["var"]) + 0.5
        stats[f"bn{i}"]["var"] = out[f"{prefix}double_conv.{ni}.running_var"]
    return out


def _load_bn(mod, sd):
    sd = {k: torch.tensor(np.asarray(v, np.float32)) for k, v in sd.items()}
    sd.update({k: torch.tensor(0) for k in mod.state_dict() if k.endswith("num_batches_tracked")})
    mod.load_state_dict(sd, strict=True)
    return mod


@pytest.mark.parametrize("mode", ["conv", "nearest", "bilinear"])
def test_upsampler_matches_in_eval_and_train(mode):
    """Eval: BatchNorm on the (random) running averages; train: on the
    batch statistics, with the running-average updates flax computes."""
    x = _x(c=6, h=4, w=3)
    jm = jmod.UpSampler(6, 4, mode=mode)
    v = perturbed(jm.init(jax.random.key(0), jnp.asarray(x)), 0, s=0.1)
    p, stats = v["params"], {k: dict(s) for k, s in v["batch_stats"]["conv"].items()}
    sd = _double_conv_sd(p["conv"], stats, "conv.")
    if mode == "conv":
        sd["up.weight"], sd["up.bias"] = _conv_transpose(p["up"]["kernel"]), p["up"]["bias"]
    v = {"params": p, "batch_stats": {"conv": stats}}
    pm = _load_bn(pmod.UpSampler(6, 4, mode=mode), sd)
    with torch.no_grad():
        _close(nchw_to_nhwc(pm(nhwc_to_nchw(x))), np.asarray(jm.apply(v, jnp.asarray(x))), what="eval")
        want, upd = jm.apply(v, jnp.asarray(x), train=True, mutable=["batch_stats"])
        bs = {}
        got = pm(nhwc_to_nchw(x), bs)
    _close(nchw_to_nhwc(got), np.asarray(want), what="train")
    names = {m: n for n, m in pm.named_modules()}
    got_stats = {names[m]: s for m, s in bs.items()}
    for i, key in enumerate(("conv.double_conv.1", "conv.double_conv.4")):
        _close(got_stats[key][0].numpy(), upd["batch_stats"]["conv"][f"bn{i}"]["mean"], what=f"{key} mean")
        _close(got_stats[key][1].numpy(), upd["batch_stats"]["conv"][f"bn{i}"]["var"], what=f"{key} var")
