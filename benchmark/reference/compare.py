"""The numbers that decide ``correct``, each of a served answer or a
training run against the reference's, and the verdict against limits."""
from __future__ import annotations

from typing import Dict, Mapping

import torch


def serve_numbers(got: torch.Tensor, want: torch.Tensor) -> Dict[str, float]:
    """``got``, ``want``: (members, rows, frames, H, W, C). ``rel_rms``: the
    RMS of the difference over the RMS of the reference, all of the
    answer; ``worst_frame``: the same per frame (one member, row and lead
    time), the largest. Non-finite answers read inf."""
    got, want = got.double(), want.double()
    if not bool(torch.isfinite(got).all()):
        return {"rel_rms": float("inf"), "worst_frame": float("inf")}
    diff = (got - want).flatten(3).square().sum(-1)
    ref = want.flatten(3).square().sum(-1)
    return {
        "rel_rms": float((diff.sum() / ref.sum()).sqrt()),
        "worst_frame": float((diff / ref.clamp_min(1e-30)).sqrt().max()),
    }


def stepwise_numbers(got: torch.Tensor, want: torch.Tensor) -> Dict[str, float]:
    """``want`` followed ``got`` step by step (each frame after the first
    one step from ``got``'s previous frame). ``start_gap``: ``rel_rms`` of
    the first frame, which follows the auxiliary steps from the input;
    ``step_gap``: the largest ``rel_rms`` of one later frame over all
    members and rows; ``worst_step``: the largest per-frame gap (one
    member, row and frame) of the later frames."""
    first = serve_numbers(got[:, :, :1], want[:, :, :1])
    later = [serve_numbers(got[:, :, i:i + 1], want[:, :, i:i + 1]) for i in range(1, got.shape[2])]
    return {
        "start_gap": first["rel_rms"],
        "step_gap": max(n["rel_rms"] for n in later),
        "worst_step": max(n["worst_frame"] for n in later),
    }


def _leaf_gaps(got, want, keep):
    """Per leaf of ``keep``: | |got| - |want| | over the larger of its
    reference norm and the median leaf's."""
    gn = {k: float(got[k].double().norm()) for k in keep}
    wn = {k: float(want[k].double().norm()) for k in keep}
    med = float(torch.tensor(list(wn.values()), dtype=torch.float64).median())
    return [abs(gn[k] - wn[k]) / max(wn[k], med, 1e-30) if gn[k] == gn[k] else float("inf") for k in keep]


def worst_leaves(got, want, keep, n: int = 3):
    """The ``n`` leaves of ``keep`` with the largest gaps (a look at what
    sets a worst-leaf number), as [name, gap, reference norm / median]."""
    keep = list(keep)
    gaps = _leaf_gaps(got, want, keep)
    norms = [float(want[k].double().norm()) for k in keep]
    med = float(torch.tensor(norms, dtype=torch.float64).median())
    order = sorted(range(len(keep)), key=lambda i: -gaps[i])[:n]
    return [[keep[i], gaps[i], norms[i] / med] for i in order]


def train_numbers(losses, ref_losses, grads, ref_grads, change, ref_change) -> Dict[str, float]:
    """``loss_gap``: the largest relative gap of a micro-step's loss
    (``loss1_gap``: the first one's); ``grad_gap``: the first step's
    gradient, as the optimizer took it, by the worst leaf
    (``grad_gap_median``: the median leaf's gap); ``update_gap``: the change
    of the weights over the steps by the worst leaf (``update_gap_median``:
    the median leaf's), over the leaves whose reference gradient is at least
    a thousandth of the median leaf's (the others move by round-off alone
    under Adam). A gap is | |program| - |reference| | over the larger of the
    leaf's reference norm and the median leaf's."""
    rel = [abs(float(a) - float(b)) / max(abs(float(b)), 1e-30) if float(a) == float(a) else float("inf")
           for a, b in zip(losses, ref_losses)]
    names = list(ref_grads)
    norms = torch.tensor([float(ref_grads[k].double().norm()) for k in names], dtype=torch.float64)
    med = float(norms.median())
    moved = [k for k, n in zip(names, norms.tolist()) if n >= 1e-3 * med]
    g, u = _leaf_gaps(grads, ref_grads, names), _leaf_gaps(change, ref_change, moved)
    return {
        "loss_gap": max(rel), "loss1_gap": rel[0],
        "grad_gap": max(g), "grad_gap_median": float(torch.tensor(g).median()),
        "update_gap": max(u), "update_gap_median": float(torch.tensor(u).median()),
    }


def verdict(numbers: Mapping[str, float], limits: Mapping[str, float]) -> bool:
    """Every number limited is at most its limit (and was read)."""
    return all(k in numbers and numbers[k] <= v for k, v in limits.items())
