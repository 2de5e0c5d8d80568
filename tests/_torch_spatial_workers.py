"""Rank functions of the spatial-sharding tests of the port
(``tests/test_torch_port_spatial.py``, ``..._spatial_train.py``,
``..._spatial_physical.py``), spawned by
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


def thin_layouts(rank: int, world: int, shard: bool = True) -> Dict[str, np.ndarray]:
    """The layouts that a shard once refused, on this rank's rows of an
    8 x 8 grid split on H over the model group of ``world`` ranks (with
    ``shard`` False: the whole grid, no shard): the 'qk' linear attention,
    and a ``Unet`` with mults (1, 2, 4, 8), whose deepest level has one row
    (at K = 2 a level of fewer rows than ranks). Weights and input from
    fixed seeds, so that every caller computes the same: the outputs."""
    import torch

    from dyffusion_tpu_torch.models import Unet
    from dyffusion_tpu_torch.models.modules import LinearAttention
    from dyffusion_tpu_torch.parallel import spatial

    torch.manual_seed(0)
    attn = LinearAttention(8, 1, 8, rescale="qk")
    net = Unet(8, 8, 1, dim_mults=(1, 2, 4, 8), resnet_block_groups=4, attn_heads=1, attn_dim_head=8)
    x = torch.as_tensor(_slab(np.random.default_rng(0).normal(size=(2, 8, 8, 8)).astype(np.float32), "h", rank,
                              world))
    with torch.no_grad():
        if not shard:
            return {"qk": attn(x).numpy(), "unet": net(x).numpy()}
        with spatial.sharded("h", (8, 8)):
            return {"qk": attn(x, None, spatial.current().top()).numpy(), "unet": net(x).numpy()}


def assert_thin_layouts_match(slabs: List[Dict[str, np.ndarray]], rel: float = 1e-5) -> None:
    """The ranks' :func:`thin_layouts` slabs joined on H (or one rank's
    whole grid) against the whole grid without a shard, within ``rel`` of
    max."""
    for k, want in thin_layouts(0, 1, shard=False).items():
        got = np.concatenate([s[k] for s in slabs], axis=2)
        assert got.shape == want.shape, (k, got.shape, want.shape)
        err, scale = float(np.abs(got - want).max()), float(np.abs(want).max())
        assert err <= rel * scale, f"{k}: max abs err {err:.3e} > {rel} x {scale:.3e}"


def stages_rank(rank: int, world: int, stage1: List[str], stage2: List[str]) -> Dict[str, Any]:
    """Both DYffusion stages' val predictions (``Trainer.predict``, dropout
    on, gathered rows and slabs) on this world's D x K grid, the stage-1
    test metrics, the best score of stage 2's ``fit`` and
    :func:`thin_layouts` under the shard."""
    from dyffusion_tpu_torch.config import get_config
    from dyffusion_tpu_torch.interface import build_trainer

    tr1 = build_trainer(get_config("synthetic_interpolation", stage1), device="cpu")
    tr2 = build_trainer(get_config("synthetic_dyffusion", stage2), interpolator=tr1.experiment.model, device="cpu")
    out = {"stage 1": tr1.predict("val"), "stage 2": tr2.predict("val"), "test": tr1.evaluate("test")}
    out["fit"] = tr2.fit()
    out["thin"] = thin_layouts(rank, world)
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


# ---------------------------------------------------------------------------
# spatial training (tests/test_torch_port_spatial_train.py)


class _ForwardOnlySum:
    """A planted fault's sum: the all_reduce of the forward, no sum of the
    gradients in the backward (each rank keeps its own)."""

    @staticmethod
    def apply(t, group):
        import torch
        import torch.distributed as dist

        class _Sum(torch.autograd.Function):
            @staticmethod
            def forward(ctx, t):
                t = t.clone()
                dist.all_reduce(t, group=group)
                return t

            @staticmethod
            def backward(ctx, grad):
                return grad

        return _Sum.apply(t)


@contextlib.contextmanager
def grad_fault(name: str):
    """A planted fault of the sharded backward, the negative controls:
    'halo gradients kept' (the halo's backward returns no row to its
    owner), 'group norm moment gradients per rank' (the moments summed
    forward, their gradients not), 'linear attention backward per rank'
    (B1's backward over the rank's own tokens, no sum of the context's
    gradients)."""
    from dyffusion_tpu_torch.ops import linear_attention as la
    from dyffusion_tpu_torch.parallel import distributed, spatial

    saved = (spatial._Rows.backward, spatial.group_norm, la._SplitQKV.backward)
    if name == "halo gradients kept":
        def backward(ctx, grad):
            transfer = spatial._halo_all_reduce
            spatial._halo_all_reduce = lambda buf: buf
            try:
                return saved[0](ctx, grad)
            finally:
                spatial._halo_all_reduce = transfer

        spatial._Rows.backward = staticmethod(backward)
    elif name == "group norm moment gradients per rank":
        def group_norm(*args):
            group_sum = distributed.group_sum
            distributed.group_sum = lambda t, group: _ForwardOnlySum.apply(t, group)
            try:
                return saved[1](*args)
            finally:
                distributed.group_sum = group_sum

        spatial.group_norm = group_norm
    elif name == "linear attention backward per rank":
        def backward(ctx, grad):
            ctx.args = ctx.args[:-1] + (None,)
            return saved[2](ctx, grad)

        la._SplitQKV.backward = staticmethod(backward)
    elif name is not None:
        raise ValueError(name)
    try:
        yield
    finally:
        spatial._Rows.backward, spatial.group_norm, la._SplitQKV.backward = saved


def unet_grad_rank(rank: int, world: int, case: Dict[str, Any], faults: List[Any]) -> Dict[Any, Dict[str, np.ndarray]]:
    """The sharded ``Unet``'s gradients of sum(output * cot) for ``case``
    (its kwargs, state dict, NCHW inputs and cotangent, axis), dropout
    off: this rank's slab of the input's gradient and every weight's
    gradient summed over the ranks, with no fault and under each of
    ``faults``."""
    import torch

    from dyffusion_tpu_torch.models import Unet
    from dyffusion_tpu_torch.parallel import distributed, spatial

    model = Unet(**case["kwargs"])
    model.load_state_dict({k: torch.as_tensor(v) for k, v in case["state"].items()}, strict=True)
    axis, (H, W) = case["axis"], case["x"].shape[2:]
    cond = torch.as_tensor(_slab(case["cond"], axis, rank, world))
    cot = torch.as_tensor(_slab(case["cot"], axis, rank, world))
    out = {}
    for name in [None] + list(faults):
        model.zero_grad()
        x = torch.tensor(_slab(case["x"], axis, rank, world), requires_grad=True)
        with grad_fault(name):
            with spatial.sharded(axis, (H, W)):
                y = model(x, torch.as_tensor(case["t"]), cond)
            (y * cot).sum().backward()
        grads = {k: p.grad.clone() for k, p in model.named_parameters()}
        for g in grads.values():
            distributed.all_reduce_sum(g)
        out[name] = {"x": x.grad.numpy(), **{k: g.numpy() for k, g in grads.items()}}
    return out


def b1_grad_rank(rank: int, world: int, qkv: np.ndarray, cot: np.ndarray) -> np.ndarray:
    """The gradient of sum(split B1 (plain, CPU) * cot) by this rank's
    tokens of ``qkv`` (B, N, 3*4*32)."""
    import torch

    from dyffusion_tpu_torch.ops.linear_attention import linear_attention_qkv_split
    from dyffusion_tpu_torch.parallel import distributed, spatial

    a, b = spatial.blocks(qkv.shape[1], world)[rank]
    x = torch.tensor(qkv[:, a:b], requires_grad=True)
    y = linear_attention_qkv_split(x, 4, 32, 32**-0.5, qkv.shape[1], distributed.model_group())
    (y * torch.as_tensor(cot[:, a:b])).sum().backward()
    return x.grad.numpy()


def run_commands(commands: List[List[str]]) -> List[str]:
    """``run_experiment`` of each (preset, overrides) command in turn, on
    the CPU; the run ids."""
    import os

    from dyffusion_tpu_torch.config import get_config
    from dyffusion_tpu_torch.interface import run_experiment

    ids = []
    for preset, overrides in commands:
        trainer, _ = run_experiment(get_config(preset, overrides), device="cpu")
        ids.append(os.path.basename(trainer.ckpt.run_dir))
    return ids


def train_rank(rank: int, world: int, unet_cases: List[Dict[str, Any]], faults: List[str], b1: tuple,
               runs: Dict[str, list]) -> Dict[str, Any]:
    """One spawn for the module: :func:`unet_grad_rank` per case (the
    faults on the first), :func:`b1_grad_rank`, then each of ``runs``
    (name -> commands, :func:`run_commands`) on this world's grid (the
    commands set it), and :func:`thin_layouts`."""
    from dyffusion_tpu_torch.parallel import distributed

    distributed.set_model_axis(world)
    out = {"unet": [unet_grad_rank(rank, world, c, faults if i == 0 else []) for i, c in enumerate(unet_cases)],
           "b1": b1_grad_rank(rank, world, *b1)}
    out["runs"] = {name: run_commands(commands) for name, commands in runs.items()}
    out["thin"] = thin_layouts(rank, world)
    return out


def split_backward_rank(rank: int, world: int, shapes: List[tuple]) -> List[Dict[str, Any]]:
    """The split B1 on CUDA tensors over the world (gloo ranks sharing
    cuda:0), forward through its kernels and backward, at each of
    ``shapes`` ((B, per-rank tokens, dtype name, seed)): the largest error
    of this rank's output and of its tokens' gradient of sum(output * cot)
    against the same tokens of B1's plain version over all the tokens and
    of its autograd gradient (which every rank computes), their largest
    magnitudes, and the split launches the call made."""
    import torch
    import torch.distributed as dist

    from dyffusion_tpu_torch.ops import linear_attention as la

    out = []
    for B, tokens, dtype, seed in shapes:
        N, first = sum(tokens), sum(tokens[:rank])
        mine = slice(first, first + tokens[rank])
        g = torch.Generator(device="cuda").manual_seed(seed)
        qkv = torch.randn((B, N, 384), generator=g, device="cuda").to(getattr(torch, dtype))
        cot = torch.randn((B, N, 128), generator=g, device="cuda")
        x = qkv[:, mine].detach().requires_grad_(True)
        before = la.split_launches
        y = la.linear_attention_qkv_split(x, 4, 32, 32**-0.5, N, dist.group.WORLD)
        (y.float() * cot[:, mine]).sum().backward()
        split = la.split_launches - before
        whole = qkv.detach().requires_grad_(True)
        y_want = la.linear_attention_qkv_plain(whole, 4, 32, 32**-0.5)
        (y_want.float() * cot).sum().backward()
        want = whole.grad.float()
        out.append({"err": float((x.grad.float() - want[:, mine]).abs().max()), "scale": float(want.abs().max()),
                    "forward_err": float((y.detach().float() - y_want[:, mine].detach().float()).abs().max()),
                    "forward_scale": float(y_want.detach().float().abs().max()), "split": split})
    return out


# ---------------------------------------------------------------------------
# the physical-systems backbones under a shard (tests/test_torch_port_spatial_physical.py)


@contextlib.contextmanager
def physical_fault(name: str):
    """A planted fault of the physical-systems backbones under a shard, the
    negative controls: 'halos zeroed' (no row crosses ranks, forward and
    backward), 'batch norm per rank' (each rank's own batch statistics),
    'resize per slab' (the outer resample of each slab alone, its
    coordinates relative to the slab: ``F.interpolate`` on a slab),
    'group norm per rank'."""
    import dataclasses

    import torch.nn.functional as F

    from dyffusion_tpu_torch.models.base import BatchNorm2d
    from dyffusion_tpu_torch.parallel import distributed, spatial

    saved = (spatial.resize, BatchNorm2d._global_batch_norm)

    def resize_per_slab(x, level, size, mode="bilinear"):
        total, other = size if level.dim == -2 else tuple(size)[::-1]
        out = dataclasses.replace(level, total=int(total), other=int(other))
        n = out.stop - out.start
        local = (n, out.other) if level.dim == -2 else (out.other, n)
        return F.interpolate(x, size=local, mode=mode, **({"align_corners": False} if mode == "bilinear" else {})), out

    def batch_norm_per_rank(self, x, batch_stats):
        active = distributed.active
        distributed.active = lambda: False
        try:
            return BatchNorm2d.forward(self, x, batch_stats)
        finally:
            distributed.active = active

    if name == "resize per slab":
        spatial.resize = resize_per_slab
    elif name == "batch norm per rank":
        BatchNorm2d._global_batch_norm = batch_norm_per_rank
    try:
        with fault(name if name in ("halos zeroed", "group norm per rank") else None):
            yield
    finally:
        spatial.resize, BatchNorm2d._global_batch_norm = saved


def backbone_rank(rank: int, world: int, case: Dict[str, Any]) -> Dict[Any, Dict[str, Any]]:
    """A backbone (``case['cls']``: its kwargs, state dict, NCHW inputs,
    cotangent, axis) on this rank's slab, dropout off, with no fault and
    under each of ``case['faults']``: the eval forward (running averages)
    and, with ``case['train']``, the train-mode forward, its BatchNorm
    updates and the gradients of sum(output * cot) (the input's slab, each
    weight's summed over the ranks)."""
    import torch

    from dyffusion_tpu_torch import models
    from dyffusion_tpu_torch.models.base import apply_model, apply_model_train
    from dyffusion_tpu_torch.parallel import distributed, spatial

    model = getattr(models, case["cls"])(**case["kwargs"])
    model.load_state_dict({k: torch.as_tensor(v) for k, v in case["state"].items()}, strict=True)
    axis, (H, W) = case["axis"], case["x"].shape[2:]
    cond = torch.as_tensor(_slab(case["cond"], axis, rank, world))
    t = torch.as_tensor(case["t"])
    out = {}
    for name in [None] + list(case["faults"]):
        got = {}
        x = torch.tensor(_slab(case["x"], axis, rank, world), requires_grad=True)
        with physical_fault(name):
            with torch.no_grad(), spatial.sharded(axis, (H, W)):
                got["eval"] = apply_model(model, None, x, t, cond).numpy()
            if case["train"]:
                model.zero_grad()
                with spatial.sharded(axis, (H, W)):
                    y, updates = apply_model_train(model, None, x, t, cond)
                (y * torch.as_tensor(_slab(case["cot"], axis, rank, world))).sum().backward()
                grads = {k: p.grad.clone() for k, p in model.named_parameters()}
                for g in grads.values():
                    distributed.all_reduce_sum(g)
                got.update(train=y.detach().numpy(), updates={k: v.numpy() for k, v in updates.items()},
                           grads={"x": x.grad.numpy(), **{k: g.numpy() for k, g in grads.items()}})
        out[name] = got
    return out


def boundary_rank(rank: int, world: int, case: Dict[str, Any]) -> Dict[str, np.ndarray]:
    """The NS boundary conditions on this rank's slab of H and of W of
    ``case`` (predictions (N, B, H, W, C), the batch's metadata, times)."""
    import torch

    from dyffusion_tpu_torch.data.physical_systems import PhysicalSystemsDataModule
    from dyffusion_tpu_torch.parallel import spatial

    dm = PhysicalSystemsDataModule(case["data_dir"], physical_system="navier-stokes")
    out = {}
    for axis in ("h", "w"):
        dim = 2 if axis == "h" else 3  # of (N, B, H, W, C)
        a, b = spatial.blocks(case["preds"].shape[dim], world)[rank]
        preds = torch.as_tensor(np.take(case["preds"], np.arange(a, b), axis=dim))
        meta = {k: torch.as_tensor(_slab(v, axis, rank, world, nchw=False) if v.ndim == 4 else v)
                for k, v in case["meta"].items()}
        with spatial.sharded(axis, case["preds"].shape[2:4]):
            out[axis] = dm.boundary_conditions(preds, meta, torch.as_tensor(case["time"])).numpy()
    return out


def raises_rank(commands: Dict[str, List[Any]]) -> Dict[str, str]:
    """The error each (preset, overrides) command raises on this world,
    through ``build_trainer`` then ``fit`` and, where that trains, the
    val split's evaluation."""
    from dyffusion_tpu_torch.config import get_config
    from dyffusion_tpu_torch.interface import build_trainer

    out = {}
    for name, (preset, overrides) in commands.items():
        errors = []
        try:
            trainer = build_trainer(get_config(preset, overrides), device="cpu")
        except (ValueError, NotImplementedError) as e:
            out[name] = [str(e)]
            continue
        for call in (trainer.fit, lambda: trainer.evaluate("val")):
            try:
                call()
                errors.append("no error")
            except NotImplementedError as e:
                errors.append(str(e))
        out[name] = errors
    return out


def physical_rank(rank: int, world: int, backbones: List[Dict[str, Any]], boundary: Dict[str, Any],
                  runs: Dict[str, list], tests: Dict[str, tuple], raises: Dict[str, list],
                  waits: Dict[str, str]) -> Dict[str, Any]:
    """One spawn for the module: :func:`backbone_rank` per case,
    :func:`boundary_rank`, each of ``runs`` (name -> commands,
    :func:`run_commands`), each of ``tests`` (name -> (registry, run id):
    ``mode=test`` of the stored run on this world, its metrics) and
    :func:`raises_rank`; a run or test named in ``waits`` starts once the
    file it names exists."""
    import os
    import time

    from dyffusion_tpu_torch.interface import reload_and_test
    from dyffusion_tpu_torch.parallel import distributed

    def wait(name):
        while name in waits and not os.path.exists(waits[name]):
            time.sleep(0.1)

    distributed.set_model_axis(world)
    out = {"backbones": [backbone_rank(rank, world, c) for c in backbones],
           "boundary": boundary_rank(rank, world, boundary), "runs": {}, "tests": {}}
    out["raises"] = raises_rank(raises)
    for name, commands in runs.items():
        wait(name)
        out["runs"][name] = run_commands(commands)
    for name, (reg, run_id) in tests.items():
        wait(name)
        out["tests"][name] = reload_and_test(reg, run_id, device="cpu")
    return out


# ---------------------------------------------------------------------------
# the diffusion baselines under a shard (tests/test_torch_port_spatial_baselines.py)


@contextlib.contextmanager
def baseline_fault(name: str):
    """A planted fault of the NCSN++ backbones and the diffusion engines
    under a shard, the negative controls: 'halos zeroed' (no row crosses
    ranks, the FIR resampling's halos too), 'group norm per rank',
    'attention per rank' (the keys and values of the rank's own tokens),
    'resize per slab' (the SPADE map resized from each slab alone,
    ``F.interpolate`` on a slab), 'draws per slab' (every draw over the
    grid taken at the slab's shape instead of sliced from the global
    draw)."""
    from dyffusion_tpu_torch.parallel import spatial
    from dyffusion_tpu_torch.utils import rng

    saved = (spatial.gather, rng.grid_slab)
    if name == "attention per rank":
        spatial.gather = lambda x, level: x
    elif name == "draws per slab":
        rng.grid_slab = lambda: None
    try:
        with physical_fault(name if name in ("halos zeroed", "group norm per rank", "resize per slab") else None):
            yield
    finally:
        spatial.gather, rng.grid_slab = saved


def ncsnpp_rank(rank: int, world: int, case: Dict[str, Any]) -> Dict[Any, Dict[str, Any]]:
    """An NCSN++ backbone (``case['cls']``: its kwargs, state dict, NCHW
    inputs, cotangent, axis) on this rank's slab, dropout off, with no
    fault and under each of ``case['faults']``: the eval forward and, with
    ``case['grads']`` and no fault, the gradients of sum(output * cot)
    (the input's slab, each weight's summed over the ranks)."""
    import torch

    from dyffusion_tpu_torch import models
    from dyffusion_tpu_torch.parallel import distributed, spatial

    model = getattr(models, case["cls"])(**case["kwargs"])
    model.load_state_dict({k: torch.as_tensor(v) for k, v in case["state"].items()}, strict=True)
    axis, (H, W) = case["axis"], case["x"].shape[2:]
    cond = torch.as_tensor(_slab(case["cond"], axis, rank, world))
    t = torch.as_tensor(case["t"])
    out = {}
    for name in [None] + list(case["faults"]):
        got = {}
        x = torch.tensor(_slab(case["x"], axis, rank, world), requires_grad=True)
        with baseline_fault(name):
            with torch.no_grad(), spatial.sharded(axis, (H, W)):
                got["eval"] = model(x, t, cond).numpy()
            if case["grads"] and name is None:
                model.zero_grad()
                with spatial.sharded(axis, (H, W)):
                    y = model(x, t, cond)
                (y * torch.as_tensor(_slab(case["cot"], axis, rank, world))).sum().backward()
                grads = {k: p.grad.clone() for k, p in model.named_parameters() if p.grad is not None}
                for g in grads.values():
                    distributed.all_reduce_sum(g)
                got["grads"] = {"x": x.grad.numpy(), **{k: g.numpy() for k, g in grads.items()}}
        out[name] = got
    return out


LANGEVIN = ("plain", "sparse", "consistent", "sparse_consistent", "inpainting", "interpolation")


def langevin_run(case: Dict[str, Any], rank: int = 0, world: int = 1) -> Dict[str, np.ndarray]:
    """The six annealed-Langevin functions over ``case``'s score network
    (an ``NCSNpp``: kwargs, state dict) on this rank's slab of the case's
    NCHW tensors (the whole of them for ``world`` 1, unsharded), each from
    a generator seeded alike, with the functions' own draw (over the
    grid: under a shard the slab of the global draw)."""
    import torch

    from dyffusion_tpu_torch import models
    from dyffusion_tpu_torch.diffusion import mcvd
    from dyffusion_tpu_torch.parallel import spatial

    net = models.NCSNpp(**case["kwargs"])
    net.load_state_dict({k: torch.as_tensor(v) for k, v in case["state"].items()}, strict=True)
    axis, (H, W) = case["axis"], case["x"].shape[2:]
    a = {k: torch.as_tensor(_slab(case[k], axis, rank, world)) for k in ("x", "cond", "sparsity", "refer", "mask")}
    sig, n = case["sigmas"], case["n_steps"]
    n_i = 3
    calls = {
        "plain": lambda g: mcvd.anneal_langevin_dynamics(net, None, g, a["x"], a["cond"], sig, n, step_lr=2e-5),
        "sparse": lambda g: mcvd.sparse_anneal_langevin_dynamics(net, None, g, a["x"], a["sparsity"], a["cond"], sig,
                                                                 n, step_lr=2e-5, frac_steps=0.5),
        "consistent": lambda g: mcvd.anneal_langevin_dynamics_consistent(net, None, g, a["x"], a["cond"], sig, n,
                                                                         step_lr=1e-4),
        "sparse_consistent": lambda g: mcvd.sparse_anneal_langevin_dynamics_consistent(
            net, None, g, a["x"], a["sparsity"], a["cond"], sig, n, step_lr=1e-4),
        "inpainting": lambda g: mcvd.anneal_langevin_dynamics_inpainting(
            net, None, g, a["x"], a["refer"], a["mask"], a["cond"], sig, n, step_lr=2e-5),
        "interpolation": lambda g: mcvd.anneal_langevin_dynamics_interpolation(
            net, None, g, a["x"], n_i, torch.repeat_interleave(a["cond"], n_i, dim=0), sig, n, step_lr=2e-5),
    }
    out = {}
    shard = spatial.sharded(axis, (H, W)) if world > 1 else contextlib.nullcontext()
    with torch.no_grad(), shard:
        for name in LANGEVIN:
            out[name] = calls[name](torch.Generator().manual_seed(case["seed"])).numpy()
    return out


def baselines_rank(rank: int, world: int, fir: tuple, cases: List[Dict[str, Any]], langevin: Dict[str, Any],
                   runs: Dict[str, list], faulty: Dict[str, list], tests: Dict[str, tuple],
                   faulty_tests: Dict[str, tuple]) -> Dict[str, Any]:
    """One spawn for the module: :func:`fir_rank` on ``fir``,
    :func:`ncsnpp_rank` per case, :func:`langevin_run`, each of ``runs``
    (name -> commands, :func:`run_commands`), each of ``faulty`` (the same
    under the fault 'draws per slab'), each of ``tests`` (name ->
    (registry, run id, overrides): ``mode=test`` of a stored run on this
    world, its metrics), and each of ``faulty_tests`` (the same under
    'draws per slab')."""
    from dyffusion_tpu_torch.interface import reload_and_test
    from dyffusion_tpu_torch.parallel import distributed

    distributed.set_model_axis(world)
    out = {"fir": fir_rank(rank, world, *fir), "ncsnpp": [ncsnpp_rank(rank, world, c) for c in cases],
           "langevin": langevin_run(langevin, rank, world)}
    out["runs"] = {name: run_commands(commands) for name, commands in runs.items()}
    with baseline_fault("draws per slab"):
        out["faulty"] = {name: run_commands(commands) for name, commands in faulty.items()}
    def test(specs):
        return {name: reload_and_test(reg, run_id, list(ov), device="cpu") for name, (reg, run_id, ov) in specs.items()}

    out["tests"] = test(tests)
    with baseline_fault("draws per slab"):
        out["faulty_tests"] = test(faulty_tests)
    return out


def fir_rank(rank: int, world: int, x: np.ndarray, w: np.ndarray, taps: List[float],
             cases: List[tuple]) -> Dict[str, np.ndarray]:
    """The slab-aware FIR resampling of ``parallel.spatial`` on this rank's
    slab of ``x`` (NCHW), on H and on W: ``upfirdn2d`` with the 2-D
    ``taps`` outer product at each (up, down, pad) of ``cases``, and the
    four x2 resamplers with the 1-D ``taps`` (the fused ones with the conv
    weight ``w``, OIHW)."""
    import torch

    from dyffusion_tpu_torch.parallel import spatial

    k2 = np.outer(taps, taps[::-1]).astype(np.float32)  # asymmetric on both axes
    wt = torch.as_tensor(w)
    out = {}
    for axis in ("h", "w"):
        xs = torch.as_tensor(_slab(x, axis, rank, world))
        with torch.no_grad(), spatial.sharded(axis, x.shape[2:]) as shard:
            level = shard.top()
            for up, down, pad in cases:
                out[f"{axis} upfirdn2d {up} {down} {pad}"] = spatial.upfirdn2d(xs, k2, level, up, down, pad)[0].numpy()
            for name in ("fir_upsample", "fir_downsample"):
                out[f"{axis} {name}"] = getattr(spatial, name)(xs, taps, level)[0].numpy()
            for name in ("upsample_conv_fir", "conv_downsample_fir"):
                out[f"{axis} {name}"] = getattr(spatial, name)(xs, wt, taps, level)[0].numpy()
    return out


# ---------------------------------------------------------------------------
# levels of fewer rows than ranks, the 'qk' attention and the resample
# methods under a shard (tests/test_torch_port_spatial_thin.py)


@contextlib.contextmanager
def thin_fault(name: str):
    """A planted fault of a layout with an empty block: :func:`fault`'s
    'halos zeroed', or 'empty rank skips its contribution' (a rank whose
    block of a transfer's output is empty puts zeros for its rows into the
    halo's all_reduce: it still calls it, so no rank waits)."""
    import torch

    from dyffusion_tpu_torch.parallel import spatial

    if name != "empty rank skips its contribution":
        with fault(name):
            yield
        return
    saved = spatial._take_rows

    def take_rows(x, level, need):
        lo, hi = need[level.rank]
        return saved(torch.zeros_like(x) if hi <= lo else x, level, need)

    spatial._take_rows = take_rows
    try:
        yield
    finally:
        spatial._take_rows = saved


def _group_grads(module) -> Dict[str, np.ndarray]:
    """Each weight's gradient summed over the model group (zeros where this
    rank's backward did not reach it: a rank of no rows at the deepest
    levels)."""
    import torch

    from dyffusion_tpu_torch.parallel import distributed

    return {k: distributed.model_sum(torch.zeros_like(p) if p.grad is None else p.grad.clone()).numpy()
            for k, p in module.named_parameters()}


def thin_backbone(case: Dict[str, Any]) -> Dict[Any, Any]:
    """A backbone (``case['cls']``: kwargs, state dict, NCHW inputs,
    cotangent, axis, ``dtype``) on this rank's slab of its model group,
    dropout off, eval mode: the forward with no fault and under each of
    ``case['faults']`` and, with ``case['grads']``, the gradients of
    sum(output * cot): the input's slab and each weight's summed over the
    group."""
    import torch

    from dyffusion_tpu_torch import models
    from dyffusion_tpu_torch.parallel import distributed, spatial

    dtype = getattr(torch, case.get("dtype", "float32"))
    model = getattr(models, case["cls"])(**case["kwargs"])
    model.load_state_dict({k: torch.as_tensor(v) for k, v in case["state"].items()}, strict=True)
    model.to(dtype)
    rank, world = distributed.model_rank(), distributed.model_size()
    axis, (H, W) = case["axis"], case["x"].shape[2:]
    slab = lambda a: torch.as_tensor(_slab(a, axis, rank, world)).to(dtype)  # noqa: E731
    x, cond, t = slab(case["x"]), slab(case["cond"]), torch.as_tensor(case["t"])
    out = {}
    for name in [None] + list(case.get("faults", ())):
        with thin_fault(name), torch.no_grad(), spatial.sharded(axis, (H, W)):
            out[name] = model(x, t, cond).numpy()
    if case.get("grads"):
        x.requires_grad_(True)
        with spatial.sharded(axis, (H, W)):
            y = model(x, t, cond)
        (y * slab(case["cot"])).sum().backward()
        out["grads"] = {"x": x.grad.numpy(), **_group_grads(model)}
    return out


def thin_b1(case: Dict[str, Any]) -> Dict[str, np.ndarray]:
    """The split B1 (plain, CPU) on this rank's tokens of ``case['qkv']``
    (B, N, 3*2*8) over its model group, and its tokens' gradient of
    sum(output * case['cot'])."""
    import torch

    from dyffusion_tpu_torch.ops.linear_attention import linear_attention_qkv_split
    from dyffusion_tpu_torch.parallel import distributed, spatial

    qkv, cot = case["qkv"], case["cot"]
    a, b = spatial.blocks(qkv.shape[1], distributed.model_size())[distributed.model_rank()]
    x = torch.tensor(qkv[:, a:b], requires_grad=True)
    y = linear_attention_qkv_split(x, 2, 8, 8**-0.5, qkv.shape[1], distributed.model_group())
    (y * torch.as_tensor(cot[:, a:b])).sum().backward()
    return {"out": y.detach().numpy(), "grad": x.grad.numpy()}


def thin_qk(case: Dict[str, Any]) -> Dict[str, Any]:
    """The 'qk' ``LinearAttention`` (``case``: kwargs, state dict, NCHW
    input and cotangent split on H) on this rank's rows, as the ``Unet``'s
    blocks call it under a shard: its output slab, its input's gradient
    slab and the weights' gradients summed over the model group."""
    import torch

    from dyffusion_tpu_torch.models.modules import LinearAttention
    from dyffusion_tpu_torch.parallel import distributed, spatial

    attn = LinearAttention(**case["kwargs"])
    attn.load_state_dict({k: torch.as_tensor(v) for k, v in case["state"].items()}, strict=True)
    rank, world = distributed.model_rank(), distributed.model_size()
    x = torch.tensor(_slab(case["x"], "h", rank, world), requires_grad=True)
    with spatial.sharded("h", case["x"].shape[2:]):
        y = attn(x, None, spatial.current().top())
    (y * torch.as_tensor(_slab(case["cot"], "h", rank, world))).sum().backward()
    return {"out": y.detach().numpy(), "grads": {"x": x.grad.numpy(), **_group_grads(attn)}}


def thin_resizes(case: Dict[str, Any]) -> Dict[tuple, np.ndarray]:
    """``spatial.resize`` of this rank's slab of each input (by its (H, W)
    in ``case['x']``) to the size paired with it in ``case['sizes']``, on H
    and on W, by each of ``case['modes']``: (mode, source (H, W), size,
    axis) -> the slab."""
    import torch

    from dyffusion_tpu_torch.parallel import distributed, spatial

    rank, world = distributed.model_rank(), distributed.model_size()
    out = {}
    for src, size in case["sizes"]:
        for axis in ("h", "w"):
            total, other = src if axis == "h" else src[::-1]
            level = spatial.Level(spatial.AXES[axis], total, other, rank, world)
            slab = torch.as_tensor(_slab(case["x"][src], axis, rank, world))
            for mode in case["modes"]:
                out[(mode, src, size, axis)] = spatial.resize(slab, level, size, mode)[0].numpy()
    return out


def thin_rank(rank: int, world: int, cases: Dict[str, Any]) -> Dict[int, Dict[str, Any]]:
    """One spawn for the module: on model groups of the whole world (K =
    ``world``) and then of 2, each K of ``cases['k']`` maps to what the
    rank computes there: each case of ``cases[str(K)]`` by its kind
    (``'backbone'``: :func:`thin_backbone`, ``'b1'``, ``'qk'``,
    ``'resize'``)."""
    from dyffusion_tpu_torch.parallel import distributed

    run = {"backbone": thin_backbone, "b1": thin_b1, "qk": thin_qk, "resize": thin_resizes}
    out = {}
    for k in cases["k"]:
        distributed.set_model_axis(k)
        out[k] = {name: run[c["kind"]](c) for name, c in cases[str(k)].items()}
    return out
