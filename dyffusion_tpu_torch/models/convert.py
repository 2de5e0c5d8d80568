"""JAX backbone variables -> the port's state dicts (``Unet``,
``UNetSimple``, ``SimpleConvNet``, ``NCSNpp``, ``SPADENCSNpp``).

The exact inverse of the torch->flax porters the JAX package's parity tests
use for the original reference: flax Conv kernels (kh, kw, I, O) become
(O, I, kh, kw); ConvTranspose kernels (kh, kw, I, O) become torch's
(I, O, kh, kw) with the taps flipped (flax correlates, torch's transposed
conv convolves); Dense kernels (I, O) become 1x1 convs (O, I, 1, 1) or
Linear weights (O, I); norm ``scale`` becomes ``weight``; the channel-norm
gain (C,) becomes (1, C, 1, 1); BatchNorm's ``batch_stats`` ``mean``/``var``
become ``running_mean``/``running_var`` (``num_batches_tracked`` 0). The
LDM-DDPM's learned logvar, a ``_diffusion_logvar`` leaf beside the
``Unet``'s params, keeps its key (the port's parameter of that name).

``NCSNpp`` and ``SPADENCSNpp`` take the original reference's flat
``all_modules.{i}`` keys in its construction order (time MLP, ``conv_in``,
the downs, the middle, the ups, the final act-norm, ``conv_out``) with its
sub-names: a BigGAN block's ``actnorm{0,1}.Dense_0`` (AdaGN) and
``Conv_0``/``Conv_1``/``Conv_2`` (the 1x1 shortcut); an attention block's
``GroupNorm_0`` and ``NIN_{0..3}.W`` (in, out) / ``.b``; the final
``Norm_0``; a SPADE act-norm's ``Norm_0.mlp_shared.0``/``mlp_gamma``/
``mlp_beta``. Where the reference's porters spell no key, these were
chosen: an unconditioned act-norm's affine GroupNorm is ``Norm_0`` (as the
final one); ``cond_emb``'s table is ``all_modules.2.weight`` (after the
two time Linears, an ``nn.Embedding``); a DDPM block is ``GroupNorm_0``,
``Conv_0``, ``Dense_0``, ``GroupNorm_1``, ``Conv_1`` and the shortcut
``NIN_0``; a standalone resampler's 3x3 weight is ``Conv2d_0`` (O, I,
kh, kw); the Gaussian-Fourier features are ``fourier_emb.W``, outside the
list (the reference's ``all_modules.0.W``), so that the optimizer's decay
mask names them as the JAX package's does and the indices after them are
the positional model's.
"""
from __future__ import annotations

from typing import Any, Dict, Mapping, Optional

import numpy as np
import torch


def _conv(w) -> np.ndarray:
    return np.transpose(np.asarray(w), (3, 2, 0, 1))


def _dense_1x1(w) -> np.ndarray:
    return np.transpose(np.asarray(w), (1, 0))[:, :, None, None]


def _linear(w) -> np.ndarray:
    return np.transpose(np.asarray(w), (1, 0))


def _resblock(out: Dict[str, np.ndarray], p: Mapping[str, Any], prefix: str) -> None:
    for i in (1, 2):
        if f"block{i}_conv" not in p:
            continue
        out[f"{prefix}.block{i}.proj.weight"] = _conv(p[f"block{i}_conv"]["kernel"])
        out[f"{prefix}.block{i}.proj.bias"] = np.asarray(p[f"block{i}_conv"]["bias"])
        out[f"{prefix}.block{i}.norm.weight"] = np.asarray(p[f"block{i}_norm"]["scale"])
        out[f"{prefix}.block{i}.norm.bias"] = np.asarray(p[f"block{i}_norm"]["bias"])
    if "residual_proj" in p:
        out[f"{prefix}.residual_conv.weight"] = _dense_1x1(p["residual_proj"]["kernel"])
        out[f"{prefix}.residual_conv.bias"] = np.asarray(p["residual_proj"]["bias"])
    if "time_mlp" in p:
        out[f"{prefix}.mlp.1.weight"] = _linear(p["time_mlp"]["kernel"])
        out[f"{prefix}.mlp.1.bias"] = np.asarray(p["time_mlp"]["bias"])


def _attn(out: Dict[str, np.ndarray], p: Mapping[str, Any], prefix: str, linear: bool) -> None:
    g = np.asarray(p["ChannelLayerNorm_0"]["g"])
    out[f"{prefix}.fn.norm.g"] = g.reshape(1, -1, 1, 1)
    qkv_key = f"{prefix}.fn.fn.to_qkv.1.weight" if linear else f"{prefix}.fn.fn.to_qkv.weight"
    out[qkv_key] = _dense_1x1(p["fn"]["to_qkv"]["kernel"])
    out[f"{prefix}.fn.fn.to_out.weight"] = _dense_1x1(p["fn"]["to_out"]["kernel"])
    out[f"{prefix}.fn.fn.to_out.bias"] = np.asarray(p["fn"]["to_out"]["bias"])


def unet_state_dict_from_jax(params: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """Convert a JAX ``Unet`` params tree (nested dict of arrays; the
    ``{'params': ...}`` variables dict is accepted too) into a state dict
    for :class:`dyffusion_tpu_torch.models.unet.Unet` (f32 tensors on the CPU)."""
    if "params" in params:
        params = params["params"]
    out: Dict[str, np.ndarray] = {
        "init_conv.weight": _conv(params["init_conv"]["kernel"]),
        "init_conv.bias": np.asarray(params["init_conv"]["bias"]),
        "final_conv.weight": _dense_1x1(params["final_conv"]["kernel"]),
        "final_conv.bias": np.asarray(params["final_conv"]["bias"]),
    }
    _time_emb(out, params)
    for name in ("final_res_block", "mid_block1", "mid_block2"):
        _resblock(out, params[name], name)
    _attn(out, params["mid_attn"], "mid_attn", linear=False)

    n_levels = sum(1 for k in params if k.startswith("down") and k.endswith("_block1"))
    for i in range(n_levels):
        for side, lst in (("down", "downs"), ("up", "ups")):
            _resblock(out, params[f"{side}{i}_block1"], f"{lst}.{i}.0")
            _resblock(out, params[f"{side}{i}_block2"], f"{lst}.{i}.1")
            _attn(out, params[f"{side}{i}_attn"], f"{lst}.{i}.2", linear=True)
        if f"down{i}_downsample" in params:
            conv, key = params[f"down{i}_downsample"], f"downs.{i}.3"
        else:
            conv, key = params[f"down{i}_conv"], f"downs.{i}.3"
        out[f"{key}.weight"], out[f"{key}.bias"] = _conv(conv["kernel"]), np.asarray(conv["bias"])
        if f"up{i}_upsample" in params:
            conv, key = params[f"up{i}_upsample"]["conv"], f"ups.{i}.3.1"
        else:
            conv, key = params[f"up{i}_conv"], f"ups.{i}.3"
        out[f"{key}.weight"], out[f"{key}.bias"] = _conv(conv["kernel"]), np.asarray(conv["bias"])
    if "_diffusion_logvar" in params:
        out["_diffusion_logvar"] = np.asarray(params["_diffusion_logvar"])
    return {k: torch.tensor(np.asarray(v, dtype=np.float32)) for k, v in out.items()}


def _conv_transpose(w) -> np.ndarray:
    return np.ascontiguousarray(np.transpose(np.asarray(w), (2, 3, 0, 1))[:, :, ::-1, ::-1])


def _time_emb(out: Dict[str, Any], params: Mapping[str, Any]) -> None:
    """``time_emb`` (a ``TimeEmbedder``): its two Dense layers, and the
    learned frequencies of a learned sinusoidal embedding at the reference's
    key ``time_emb_mlp.0.weights``."""
    if "time_emb" in params:
        for j, idx in ((0, 1), (1, 3)):
            out[f"time_emb_mlp.{idx}.weight"] = _linear(params["time_emb"][f"Dense_{j}"]["kernel"])
            out[f"time_emb_mlp.{idx}.bias"] = np.asarray(params["time_emb"][f"Dense_{j}"]["bias"])
        if "LearnedSinusoidalPosEmb_0" in params["time_emb"]:
            out["time_emb_mlp.0.weights"] = np.asarray(params["time_emb"]["LearnedSinusoidalPosEmb_0"]["weights"])


def _norm(out: Dict[str, Any], p: Mapping[str, Any], stats: Optional[Mapping[str, Any]], prefix: str) -> None:
    out[f"{prefix}.weight"] = np.asarray(p["scale"])
    out[f"{prefix}.bias"] = np.asarray(p["bias"])
    if stats is not None:
        out[f"{prefix}.running_mean"] = np.asarray(stats["mean"])
        out[f"{prefix}.running_var"] = np.asarray(stats["var"])
        out[f"{prefix}.num_batches_tracked"] = np.asarray(0, np.int64)


def _to_torch(out: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    return {
        k: torch.tensor(np.asarray(v)) if np.asarray(v).dtype == np.int64 else torch.tensor(np.asarray(v, np.float32))
        for k, v in out.items()
    }


def unet_simple_state_dict_from_jax(variables: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """Convert JAX ``UNetSimple`` variables (``{'params', 'batch_stats'}``,
    nested dicts of arrays) into a state dict for
    :class:`dyffusion_tpu_torch.models.unet_simple.UNetSimple`."""
    params, stats = variables["params"], variables.get("batch_stats", {})
    out: Dict[str, Any] = {
        "init_conv.weight": _conv(params["init_conv"]["kernel"]),
        "init_conv.bias": np.asarray(params["init_conv"]["bias"]),
        "readout.0.weight": _conv_transpose(params["readout"]["kernel"]),
        "readout.0.bias": np.asarray(params["readout"]["bias"]),
    }
    _time_emb(out, params)
    for side, lst, conv_idx in (("enc", "input_ops", 0), ("dec", "output_ops", 1)):
        for i in range(6):
            p, prefix = params[f"{side}{i}"], f"{lst}.{i}"
            out[f"{prefix}.ops.{conv_idx}.weight"] = _conv(p["conv"]["kernel"])
            out[f"{prefix}.ops.{conv_idx}.bias"] = np.asarray(p["conv"]["bias"])
            block_stats = stats.get(f"{side}{i}", {}).get("norm")
            _norm(out, p["norm"], block_stats, f"{prefix}.ops.{conv_idx + 1}")
            if "time_mlp" in p:
                out[f"{prefix}.time_mlp.1.weight"] = _linear(p["time_mlp"]["kernel"])
                out[f"{prefix}.time_mlp.1.bias"] = np.asarray(p["time_mlp"]["bias"])
    return _to_torch(out)


def simple_conv_net_state_dict_from_jax(variables: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """Convert JAX ``SimpleConvNet`` variables (``{'params',
    'batch_stats'?}``) into a state dict for
    :class:`dyffusion_tpu_torch.models.simple_conv_net.SimpleConvNet`."""
    params, stats = variables["params"], variables.get("batch_stats", {})
    out: Dict[str, Any] = {
        "head.weight": _dense_1x1(params["head"]["kernel"]),
        "head.bias": np.asarray(params["head"]["bias"]),
    }
    _time_emb(out, params)
    n_blocks = sum(1 for k in params if k.startswith("conv") and k[4:].isdigit())
    for i in range(n_blocks):
        p, prefix = params[f"conv{i}"], f"convs.{i}"
        out[f"{prefix}.conv.weight"] = _conv(p["conv"]["kernel"])
        out[f"{prefix}.conv.bias"] = np.asarray(p["conv"]["bias"])
        norm_name = next((k for k in p if k.split("_")[0] in ("BatchNorm", "LayerNorm", "GroupNorm")), None)
        if norm_name is not None:
            _norm(out, p[norm_name], stats.get(f"conv{i}", {}).get(norm_name), f"{prefix}.norm")
        if "time_mlp" in p:
            out[f"{prefix}.time_mlp.1.weight"] = _linear(p["time_mlp"]["kernel"])
            out[f"{prefix}.time_mlp.1.bias"] = np.asarray(p["time_mlp"]["bias"])
    return _to_torch(out)


def _ncsnpp_order(params: Mapping[str, Any]) -> list:
    """The JAX module names of an NCSN++ tree in the construction order of
    ``all_modules``."""
    names = [n for n in ("temb_dense1", "temb_dense2", "cond_emb") if n in params] + ["conv_in"]
    n_res = sum(1 for k in params if k.startswith("down") and k.endswith("_block0"))
    nrb = sum(1 for k in params if k.startswith("down0_block"))
    for i in range(n_res):
        for b in range(nrb):
            names += [n for n in (f"down{i}_block{b}", f"down{i}_attn{b}") if n in params]
        names += [n for n in (f"down{i}_downsample",) if n in params]
    names += ["mid_block1", "mid_attn", "mid_block2"]
    for j in range(n_res):
        names += [f"up{j}_block{b}" for b in range(nrb + 1)]
        names += [n for n in (f"up{j}_attn", f"up{j}_upsample") if n in params]
    return names + ["norm_out" if "norm_out" in params else "actnorm_out", "conv_out"]


def _weight_bias(out: Dict[str, Any], p: Mapping[str, Any], prefix: str, fn) -> None:
    out[f"{prefix}.weight"] = fn(p["kernel"])
    out[f"{prefix}.bias"] = np.asarray(p["bias"])


def _affine(out: Dict[str, Any], p: Mapping[str, Any], prefix: str) -> None:
    out[f"{prefix}.weight"], out[f"{prefix}.bias"] = np.asarray(p["scale"]), np.asarray(p["bias"])


def _nin(out: Dict[str, Any], p: Mapping[str, Any], prefix: str) -> None:
    out[f"{prefix}.W"], out[f"{prefix}.b"] = np.asarray(p["kernel"]), np.asarray(p["bias"])


def _actnorm(out: Dict[str, Any], p: Mapping[str, Any], prefix: str) -> None:
    if "dense" in p:
        _weight_bias(out, p["dense"], f"{prefix}.Dense_0", _linear)
    if "scale" in p.get("norm", {}):
        _affine(out, p["norm"], f"{prefix}.Norm_0")
    if "spade" in p:
        s = p["spade"]
        _weight_bias(out, s["mlp_shared"], f"{prefix}.Norm_0.mlp_shared.0", _conv)
        _weight_bias(out, s["mlp_gamma"], f"{prefix}.Norm_0.mlp_gamma", _conv)
        _weight_bias(out, s["mlp_beta"], f"{prefix}.Norm_0.mlp_beta", _conv)


def _ncsnpp_module(out: Dict[str, Any], name: str, p: Mapping[str, Any], prefix: str) -> None:
    if name in ("temb_dense1", "temb_dense2"):
        _weight_bias(out, p, prefix, _linear)
    elif name == "cond_emb":
        out[f"{prefix}.weight"] = np.asarray(p["embedding"])
    elif "kernel" in p:  # conv_in, conv_out, a DDPM ladder's standalone resampler
        _weight_bias(out, p, prefix if name in ("conv_in", "conv_out") else f"{prefix}.Conv2d_0", _conv)
    elif name == "norm_out":
        _affine(out, p, f"{prefix}.Norm_0")
    elif name == "actnorm_out":
        _actnorm(out, p, prefix)
    elif "nin_q" in p:
        _affine(out, p["norm"], f"{prefix}.GroupNorm_0")
        for i, n in enumerate(("nin_q", "nin_k", "nin_v", "nin_out")):
            _nin(out, p[n], f"{prefix}.NIN_{i}")
    elif "actnorm0" in p:  # BigGAN block, AdaGN or SPADE
        _actnorm(out, p["actnorm0"], f"{prefix}.actnorm0")
        _actnorm(out, p["actnorm1"], f"{prefix}.actnorm1")
        _weight_bias(out, p["conv1"], f"{prefix}.Conv_0", _conv)
        _weight_bias(out, p["conv2"], f"{prefix}.Conv_1", _conv)
        if "shortcut" in p:
            _weight_bias(out, p["shortcut"], f"{prefix}.Conv_2", _dense_1x1)
    else:  # DDPM block
        _affine(out, p["norm1"], f"{prefix}.GroupNorm_0")
        _weight_bias(out, p["conv1"], f"{prefix}.Conv_0", _conv)
        if "temb_proj" in p:
            _weight_bias(out, p["temb_proj"], f"{prefix}.Dense_0", _linear)
        _affine(out, p["norm2"], f"{prefix}.GroupNorm_1")
        _weight_bias(out, p["conv2"], f"{prefix}.Conv_1", _conv)
        if "shortcut" in p:
            _nin(out, p["shortcut"], f"{prefix}.NIN_0")


def ncsnpp_state_dict_from_jax(params: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """Convert a JAX ``NCSNpp`` params tree (the ``{'params': ...}``
    variables dict is accepted too; either block type, either embedding)
    into a state dict for :class:`dyffusion_tpu_torch.models.ncsnpp.NCSNpp`."""
    if "params" in params:
        params = params["params"]
    out: Dict[str, Any] = {}
    if "fourier_emb" in params:
        out["fourier_emb.W"] = np.asarray(params["fourier_emb"]["W"])
    for i, name in enumerate(_ncsnpp_order(params)):
        _ncsnpp_module(out, name, params[name], f"all_modules.{i}")
    return _to_torch(out)


def spade_ncsnpp_state_dict_from_jax(params: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """Convert a JAX ``SPADENCSNpp`` params tree into a state dict for
    :class:`dyffusion_tpu_torch.models.ncsnpp.SPADENCSNpp`."""
    return ncsnpp_state_dict_from_jax(params)
