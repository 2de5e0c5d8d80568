"""Backbones of the port and their registry: the ResNet-attention ``Unet``,
``UNetSimple``, ``SimpleConvNet``, and MCVD's ``NCSNpp`` and
``SPADENCSNpp``; the converters of the JAX package's variables. The NCSN
normalization zoo, the RefineNet blocks and ``DoubleConv``/``UpSampler``,
which no config reaches, live in ``normalization``, ``refinenet`` and
``modules``."""
import inspect

from dyffusion_tpu_torch.models.base import BackboneSpec, concat_condition
from dyffusion_tpu_torch.models.convert import (
    ncsnpp_state_dict_from_jax,
    simple_conv_net_state_dict_from_jax,
    spade_ncsnpp_state_dict_from_jax,
    unet_simple_state_dict_from_jax,
    unet_state_dict_from_jax,
)
from dyffusion_tpu_torch.models.ncsnpp import NCSNpp, SPADENCSNpp
from dyffusion_tpu_torch.models.simple_conv_net import SimpleConvNet
from dyffusion_tpu_torch.models.unet import Unet
from dyffusion_tpu_torch.models.unet_simple import UNetSimple

MODEL_REGISTRY = {
    "unet_resnet": Unet,
    "unet_simple": UNetSimple,
    "cnn_simple": SimpleConvNet,
    "ncsnpp": NCSNpp,
    "ncsnpp_spade": SPADENCSNpp,
}


def build_backbone(model_cfg, spec: BackboneSpec):
    """Construct a backbone from its config section and channel spec; config
    keys the backbone does not take are dropped (as the JAX package does).
    A backbone with a resolution ladder (``spatial_height``: NCSN++) gets
    the spec's height unless the config sets it."""
    cfg = dict(model_cfg)
    name = cfg.pop("name")
    cls = MODEL_REGISTRY.get(name)
    if cls is None:
        raise ValueError(f"Unknown model '{name}'. Available: {sorted(MODEL_REGISTRY)}")
    fields = set(inspect.signature(cls.__init__).parameters) - {"self"}
    kwargs = {k: tuple(v) if isinstance(v, list) else v for k, v in cfg.items() if k in fields}
    if "spatial_height" in fields and "spatial_height" not in kwargs:
        kwargs["spatial_height"] = spec.spatial_shape[0]
    return cls(
        num_input_channels=spec.num_input_channels,
        num_output_channels=spec.num_output_channels,
        num_conditional_channels=spec.num_conditional_channels,
        **kwargs,
    )


__all__ = [
    "BackboneSpec",
    "MODEL_REGISTRY",
    "NCSNpp",
    "SPADENCSNpp",
    "SimpleConvNet",
    "UNetSimple",
    "Unet",
    "build_backbone",
    "concat_condition",
    "ncsnpp_state_dict_from_jax",
    "simple_conv_net_state_dict_from_jax",
    "spade_ncsnpp_state_dict_from_jax",
    "unet_simple_state_dict_from_jax",
    "unet_state_dict_from_jax",
]
