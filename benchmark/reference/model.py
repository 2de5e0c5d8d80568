"""A configuration's reference: its two networks, the served ensemble and
the first training steps, from the ``reference`` section of the
configuration's file (the plain restatement of what the system runs)."""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import torch

from benchmark.reference import dyffusion, unet, unet_simple
from benchmark.reference import nn as rn

BACKBONES = {"unet": unet, "unet_simple": unet_simple}


def channels(ref: dict) -> Dict[str, tuple]:
    """(inputs, outputs, conditions) of the forecaster and the interpolator."""
    C, w, s = ref["channels"], ref.get("window", 1), ref.get("static_channels", 0)
    fc_cond = (C * w if ref["conditioning"] == "data" else 0) + s
    return {"forecaster": (C, C, fc_cond), "interpolator": (C * w + C, C, s)}


def param_specs(ref: dict) -> Dict[str, dict]:
    mod = BACKBONES[ref["backbone"]]
    ch = channels(ref)
    return {net: mod.param_spec(ref["model"][net], *ch[net]) for net in ("forecaster", "interpolator")}


def network(ref: dict, net: str, P: rn.Params, num: rn.Numerics):
    mod, cfg = BACKBONES[ref["backbone"]], ref["model"][net]

    def call(x, time, condition, g, bn_stats=None):
        return mod.forward(num, P, cfg, x, time, condition, g, bn_stats)

    return call


def _nchw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2)


@torch.no_grad()
def serve(ref: dict, weights: Dict[str, rn.Params], batch: Dict[str, torch.Tensor], seed: int,
          members: int, fp8: bool = False, forced: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One folded ensemble request: (members, rows, horizon, H, W, C), the
    boundary conditions applied where the configuration has them. With
    ``forced`` (an answer of that shape), each output after the first is
    one sampler step from ``forced``'s previous frame
    (:func:`dyffusion.sample`)."""
    low = ref["low_eps"]["serve"]
    fc = network(ref, "forecaster", weights["forecaster"], rn.Numerics(low_eps=low[0], fp8=fp8))
    ip = network(ref, "interpolator", weights["interpolator"], rn.Numerics(low_eps=low[1], fp8=fp8))
    dyn = batch["dynamics"].float()
    B = dyn.shape[0]
    w = ref.get("window", 1)
    ic = dyn[:, :w].permute(0, 1, 4, 2, 3).flatten(1, 2).repeat(members, 1, 1, 1)  # (N*B, w*C, H, W), member-major
    static = batch.get("condition")
    static = None if static is None else _nchw(static.float()).repeat(members, 1, 1, 1)
    g = torch.Generator(device=dyn.device)
    g.manual_seed(int(seed))
    if forced is not None:  # (N, B, h, H, W, C) -> (N*B, h, C, H, W)
        forced = forced.permute(0, 1, 2, 5, 3, 4).flatten(0, 1)
    out = dyffusion.sample(fc, ip, ic, static, horizon=ref["horizon"], k=ref["k"],
                           conditioning=ref["conditioning"], refine=ref["refine"], channels=ref["channels"], g=g,
                           forced=forced)
    out = out.reshape((members, B) + tuple(out.shape[1:])).permute(0, 1, 2, 4, 5, 3)  # (N, B, h, H, W, C)
    if ref.get("boundary") == "navier_stokes":
        out = torch.stack([dyffusion.ns_boundary(out[:, :, i], batch, i + 1) for i in range(out.shape[2])], dim=2)
    return out


def _adamw(params: Dict[str, torch.Tensor], grads: Dict[str, torch.Tensor], state: dict, opt: dict) -> None:
    """One AdamW step (decoupled decay, bias-corrected moments) after the
    global-norm clip, in place."""
    clip = opt.get("clip")
    if clip:
        norm = torch.sqrt(sum(g.double().square().sum() for g in grads.values())).float()
        if norm >= clip:
            grads = {k: g / norm * clip for k, g in grads.items()}
    b1, b2 = opt["betas"]
    state["t"] = state.get("t", 0) + 1
    t = state["t"]
    for k, p in params.items():
        m = state.setdefault(("m", k), torch.zeros_like(p))
        v = state.setdefault(("v", k), torch.zeros_like(p))
        m.mul_(b1).add_(grads[k], alpha=1 - b1)
        v.mul_(b2).addcmul_(grads[k], grads[k], value=1 - b2)
        p.mul_(1 - opt["lr"] * opt["weight_decay"])
        denom = (v.sqrt() / (1 - b2**t) ** 0.5).add_(opt["eps"])
        p.addcdiv_(m, denom, value=-opt["lr"] / (1 - b1**t))
    if t == 1:
        state["first_grads"] = {k: g.clone() for k, g in grads.items()}


def train(ref: dict, weights: Dict[str, rn.Params], batches: Sequence[Dict[str, torch.Tensor]], seed: int,
          steps: int, accumulate: int, fp8: bool = False) -> dict:
    """``steps`` optimizer steps of stage 2 from ``weights``, the i-th
    micro-batch ``batches[i]``, every draw from one generator seeded with
    ``seed`` (t per row, then the dropout masks, in the order of the
    calls); ``accumulate`` micro-batches a step, their gradients averaged.
    A BatchNorm forecaster's first pass of each micro-batch normalizes with
    the batch's statistics, and its running averages take them after that
    micro-batch. Returns the losses (one per micro-batch), the first step's
    clipped gradient and the change of each weight over the steps."""
    low = ref["low_eps"]["train"]
    opt = ref["optimizer"]
    trainable = [k for k, (_, kind) in param_specs(ref)["forecaster"].items() if kind != "count"
                 and not k.endswith(("running_mean", "running_var"))]
    P = {k: v.clone() for k, v in weights["forecaster"].items()}
    start = {k: P[k].clone() for k in trainable}
    ip = network(ref, "interpolator", weights["interpolator"], rn.Numerics(low_eps=low[1], fp8=fp8))
    dev = batches[0]["dynamics"].device
    g = torch.Generator(device=dev)
    g.manual_seed(int(seed))
    N = ref["horizon"] + ref["k"]
    state: dict = {}
    losses: List[float] = []
    for step in range(steps):
        acc = {k: torch.zeros_like(P[k]) for k in trainable}
        for micro in range(accumulate):
            batch = batches[step * accumulate + micro]
            dyn = batch["dynamics"].float()
            x_last = _nchw(dyn[:, -1])
            cond = _nchw(dyn[:, 0])
            static = batch.get("condition")
            static = None if static is None else _nchw(static.float())
            t = torch.randint(0, N, (dyn.shape[0],), generator=g, device=dev)
            live = {k: (P[k].detach().requires_grad_(True) if k in acc else P[k]) for k in P}
            fc = network(ref, "forecaster", live, rn.Numerics(low_eps=low[0], fp8=fp8))
            stats: dict = {}
            loss = dyffusion.stage2_loss(fc, ip, x_last, cond, static, t, horizon=ref["horizon"], k=ref["k"],
                                         conditioning=ref["conditioning"], lam1=ref["loss"]["lam1"],
                                         lam2=ref["loss"]["lam2"], g=g, bn_stats=stats)
            grads = torch.autograd.grad(loss, [live[k] for k in trainable], allow_unused=True)
            for k, gr in zip(trainable, grads):
                acc[k].add_((torch.zeros_like(acc[k]) if gr is None else gr) - acc[k], alpha=1.0 / (micro + 1))
            losses.append(float(loss.detach()))
            for pre, (mean, var) in stats.items():  # BatchNorm's running averages move after each micro-batch
                P[pre + ".running_mean"], P[pre + ".running_var"] = mean, var
        with torch.no_grad():
            _adamw({k: P[k] for k in trainable}, acc, state, opt)
    return {"losses": losses, "grads": state["first_grads"],
            "change": {k: P[k] - start[k] for k in trainable}}


def flops_and_bytes(ref: dict, mode: str, rows: int, members: int, hw, accumulate: int = 1) -> dict:
    """The work of one request ('serve', ``rows`` x ``members`` rows) or
    one optimizer step ('train', ``accumulate`` micro-batches of ``rows``),
    counted on the meta device: model FLOPs (``torch.utils.flop_counter``,
    the backward included), the byte bound of the linear attentions (B1:
    B N 512 elements a call) and the bytes of the bilinear resamples (input
    + output), each at the dtype its network runs in (16-bit where the
    configuration's ``low_eps`` says so, else 32-bit)."""
    from torch.utils.flop_counter import FlopCounterMode

    low = ref["low_eps"][mode]
    specs = param_specs(ref)
    meta = torch.device("meta")
    W = {net: {k: torch.empty(shape, device=meta, dtype=torch.int64 if kind == "count" else torch.float32)
               for k, (shape, kind) in spec.items()} for net, spec in specs.items()}
    H_, W_ = hw
    C, w = ref["channels"], ref.get("window", 1)
    s = ref.get("static_channels", 0)
    unet.LINEAR_ATTENTION_CALLS = b1 = []
    unet_simple.RESAMPLES = resamples = []
    counter = FlopCounterMode(display=False)
    ip = network(ref, "interpolator", W["interpolator"], rn.Numerics(low_eps=low[1]))
    try:
        with counter:
            if mode == "serve":
                R = rows * members
                fc = network(ref, "forecaster", W["forecaster"], rn.Numerics(low_eps=low[0]))
                ic = torch.empty((R, w * C, H_, W_), device=meta)
                st = torch.empty((R, s, H_, W_), device=meta) if s else None
                with torch.no_grad():
                    dyffusion.sample(fc, ip, ic, st, horizon=ref["horizon"], k=ref["k"],
                                     conditioning=ref["conditioning"], refine=ref["refine"], channels=C, g=None)
            else:
                for _ in range(accumulate):
                    live = {k: v.requires_grad_(True) if v.is_floating_point() and "running" not in k else v
                            for k, v in W["forecaster"].items()}
                    fc = network(ref, "forecaster", live, rn.Numerics(low_eps=low[0]))
                    x = torch.empty((rows, C, H_, W_), device=meta)
                    st = torch.empty((rows, s, H_, W_), device=meta) if s else None
                    t = torch.zeros((rows,), device=meta)
                    loss = dyffusion.stage2_loss(fc, ip, x, x, st, t, horizon=ref["horizon"], k=ref["k"],
                                                 conditioning=ref["conditioning"], lam1=0.5, lam2=0.5, g=None)
                    loss.backward()
    finally:
        unet.LINEAR_ATTENTION_CALLS = None
        unet_simple.RESAMPLES = None
    return {
        "flops": float(counter.get_total_flops()),
        "b1_bytes": float(sum(B * N * 512 * nbytes for B, N, nbytes in b1)),
        "resize_bytes": float(sum(n * nbytes for n, nbytes in resamples)),
    }
