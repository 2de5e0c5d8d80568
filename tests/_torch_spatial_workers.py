"""Rank functions of the spatial-sharding tests of the port
(``tests/test_torch_port_spatial.py``), spawned by
``tests/_torch_ddp_workers.run_ranks``: each rank joins a model group of
the whole world and computes its slab. This module imports no JAX, so that
a rank starts fast.
"""
from __future__ import annotations

import contextlib
from typing import Any, Dict, List

import numpy as np


def _slab(x: np.ndarray, axis: str, rank: int, world: int, nchw: bool = True) -> np.ndarray:
    """Rank ``rank``'s block of ``x``'s H or W axis (NCHW, or NHWC)."""
    from dyffusion_tpu_torch.parallel import spatial

    dim = (2 if axis == "h" else 3) if nchw else (1 if axis == "h" else 2)
    a, b = spatial.blocks(x.shape[dim], world)[rank]
    return np.take(x, np.arange(a, b), axis=dim)


@contextlib.contextmanager
def fault(name: str):
    """A planted fault of the sharded forward, the negative controls:
    'halos zeroed' (no row crosses ranks), 'group norm per rank' (each
    slab's own moments), 'linear attention per rank' (k's softmax and the
    context over the rank's tokens alone, v / N_local)."""
    import torch.nn.functional as F

    from dyffusion_tpu_torch.ops.linear_attention import linear_attention_qkv_plain
    from dyffusion_tpu_torch.parallel import spatial

    saved = (spatial._halo_all_reduce, spatial.group_norm, spatial.linear_attention)
    if name == "halos zeroed":
        spatial._halo_all_reduce = lambda buf: buf
    elif name == "group norm per rank":
        spatial.group_norm = lambda x, groups, w, b, eps, level: F.group_norm(x, groups, w, b, eps)
    elif name == "linear attention per rank":
        spatial.linear_attention = lambda qkv, heads, d, scale, level: linear_attention_qkv_plain(qkv, heads, d, scale)
    elif name is not None:
        raise ValueError(name)
    try:
        yield
    finally:
        spatial._halo_all_reduce, spatial.group_norm, spatial.linear_attention = saved


def unet_rank(rank: int, world: int, case: Dict[str, Any], faults: List[Any]) -> Dict[Any, np.ndarray]:
    """The sharded ``Unet`` forward of ``case`` (its kwargs, state dict,
    NCHW inputs, axis), dropout off: this rank's output slab with no
    fault and under each of ``faults``."""
    import torch

    from dyffusion_tpu_torch.models import Unet
    from dyffusion_tpu_torch.parallel import spatial

    model = Unet(**case["kwargs"])
    model.load_state_dict({k: torch.as_tensor(v) for k, v in case["state"].items()}, strict=True)
    axis, (H, W) = case["axis"], case["x"].shape[2:]
    x = torch.as_tensor(_slab(case["x"], axis, rank, world))
    cond = None if case["cond"] is None else torch.as_tensor(_slab(case["cond"], axis, rank, world))
    out = {}
    with torch.no_grad(), spatial.sharded(axis, (H, W)):
        for name in [None] + list(faults):
            with fault(name):
                out[name] = model(x, torch.as_tensor(case["t"]), cond).numpy()
    return out


def stages_rank(rank: int, world: int, stage1: List[str], stage2: List[str]) -> Dict[str, Any]:
    """Both DYffusion stages' val predictions (``Trainer.predict``, dropout
    on, gathered rows and slabs) on this world's D x K grid, the stage-1
    test metrics, and the raise of ``fit``."""
    from dyffusion_tpu_torch.config import get_config
    from dyffusion_tpu_torch.interface import build_trainer

    tr1 = build_trainer(get_config("synthetic_interpolation", stage1), device="cpu")
    tr2 = build_trainer(get_config("synthetic_dyffusion", stage2), interpolator=tr1.experiment.model, device="cpu")
    out = {"stage 1": tr1.predict("val"), "stage 2": tr2.predict("val"), "test": tr1.evaluate("test")}
    try:
        tr2.fit()
    except NotImplementedError as e:
        out["fit"] = str(e)
    return out


def spatial_rank(rank: int, world: int, unet_cases: List[Dict[str, Any]], faults: List[str], qkv: np.ndarray,
                 stage1: List[str], stage2: List[str]) -> Dict[str, Any]:
    """One spawn for the module: :func:`unet_rank` per case (the faults
    on the first), B1's plain split path on this rank's tokens of ``qkv``
    (B, N, 3*4*32), and :func:`stages_rank`."""
    import torch

    from dyffusion_tpu_torch.ops.linear_attention import linear_attention_qkv_split_plain
    from dyffusion_tpu_torch.parallel import distributed, spatial

    distributed.set_model_axis(world)
    out = {"unet": [unet_rank(rank, world, c, faults if i == 0 else []) for i, c in enumerate(unet_cases)]}
    a, b = spatial.blocks(qkv.shape[1], world)[rank]
    out["b1"] = linear_attention_qkv_split_plain(torch.as_tensor(qkv[:, a:b]), 4, 32, 32**-0.5, qkv.shape[1],
                                                 distributed.model_group()).numpy()
    out.update(stages_rank(rank, world, stage1, stage2))
    return out
