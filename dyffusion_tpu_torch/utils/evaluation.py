"""Ensemble evaluation metrics: CRPS, ensemble-mean MSE, spread-skill
ratio, Gaussian NLL, correlation, and the metrics over growing ensembles.

Counterpart of ``dyffusion_tpu/utils/evaluation.py`` on tensors. The member
axis is axis 0. CRPS is the empirical-CDF estimator
(``properscoring.crps_ensemble``), in its pairwise form

    CRPS = mean_i |x_i - y| - 1/2 mean_ij |x_i - x_j|

(:func:`crps_ensemble`, O(m^2) memory in the member count) and in the
sorted form (:func:`crps_ensemble_sorted`, O(m log m), used by the eval
path):

    CRPS = mean_i |x_i - y| - sum_i x_(i) (2i - m - 1) / m^2
"""
from __future__ import annotations

import math
from typing import Dict, Optional

import numpy as np
import torch


def _t(x) -> torch.Tensor:
    return torch.as_tensor(x)


def _mean_per_sample(x: torch.Tensor, mean_over_samples: bool) -> torch.Tensor:
    return x.mean() if mean_over_samples else x.reshape(x.shape[0], -1).mean(dim=-1)


def crps_ensemble(predictions, targets, mean_over_samples: bool = True) -> torch.Tensor:
    """CRPS of an m-member ensemble by the pairwise form, predictions
    (m, n, ...), targets (n, ...); a scalar, or (n,) when
    ``mean_over_samples`` is False. Materializes (m, m, n, ...)."""
    predictions = _t(predictions)
    skill = torch.mean(torch.abs(predictions - _t(targets).to(predictions.device)[None]), dim=0)
    spread = torch.mean(torch.abs(predictions[:, None] - predictions[None, :]), dim=(0, 1))
    return _mean_per_sample(skill - 0.5 * spread, mean_over_samples)


def crps_ensemble_sorted(predictions, targets, mean_over_samples: bool = True) -> torch.Tensor:
    """CRPS of an m-member ensemble, predictions (m, n, ...), targets (n, ...);
    a scalar, or (n,) when ``mean_over_samples`` is False."""
    predictions = _t(predictions)
    m = predictions.shape[0]
    x = torch.sort(predictions, dim=0).values
    y = _t(targets).to(x.device)[None]
    skill = torch.mean(torch.abs(x - y), dim=0)
    i = torch.arange(1, m + 1, device=x.device, dtype=x.dtype).reshape((m,) + (1,) * (predictions.ndim - 1))
    spread = torch.sum(x * (2 * i - m - 1), dim=0) / (m * m)
    return _mean_per_sample(skill - spread, mean_over_samples)


def mse_ensemble(predictions, targets, mean_over_samples: bool = True) -> torch.Tensor:
    """MSE of the ensemble-mean prediction."""
    predictions = _t(predictions)
    err = (predictions.mean(dim=0) - _t(targets).to(predictions.device)) ** 2
    return _mean_per_sample(err, mean_over_samples)


def spread_skill_ratio(
    predictions, targets, skill: Optional[torch.Tensor] = None, mean_over_samples: bool = True
) -> torch.Tensor:
    """Ensemble stddev / RMSE: mean of the per-point (biased) ensemble
    variance first, sqrt second."""
    predictions = _t(predictions)
    var = predictions.var(dim=0, unbiased=False)
    if mean_over_samples:
        spread = var.mean().sqrt()
    else:
        spread = var.reshape(var.shape[0], -1).mean(dim=-1).sqrt()
    if skill is None:
        skill = mse_ensemble(predictions, targets, mean_over_samples).sqrt()
    return spread / skill


def nll_ensemble(mean_predictions, var_predictions, targets, mean_over_samples: bool = True) -> torch.Tensor:
    """Gaussian negative log-likelihood of (mean, variance) predictions:
    0.5 log(2 pi var) + (y - mu)^2 / (2 var)."""
    mu, var = _t(mean_predictions), _t(var_predictions)
    y = _t(targets).to(mu.device)
    nll = 0.5 * torch.log(2 * math.pi * var) + (y - mu) ** 2 / (2 * var)
    return _mean_per_sample(nll, mean_over_samples)


def corr_ensemble(predictions, targets) -> torch.Tensor:
    """Pearson correlation of the ensemble-mean prediction with the targets,
    over all their elements."""
    predictions = _t(predictions)
    mp = predictions.mean(dim=0).reshape(-1)
    t = _t(targets).to(predictions.device).reshape(-1)
    mp, t = mp - mp.mean(), t - t.mean()
    return (mp * t).sum() / torch.sqrt((mp**2).sum() * (t**2).sum())


def evaluate_ensemble_prediction(
    predictions, targets, mean_over_samples: bool = True, also_per_member_metrics: bool = False
) -> Dict[str, np.ndarray]:
    """{mse, crps, ssr} of an ensemble (m, n, ...) against targets (n, ...),
    as numpy values; with ``also_per_member_metrics`` also each member's MSE
    (``mse_per_mem``, (m,)) and their mean (``mse_per_mem_mean``)."""
    predictions = _t(predictions)
    targets = _t(targets).to(predictions.device)
    assert predictions.shape[1:] == targets.shape, (
        f"predictions.shape[1:]={tuple(predictions.shape[1:])} != targets.shape={tuple(targets.shape)}"
    )
    mse = mse_ensemble(predictions, targets, mean_over_samples)
    crps = crps_ensemble_sorted(predictions, targets, mean_over_samples)
    ssr = spread_skill_ratio(predictions, targets, skill=mse.sqrt(), mean_over_samples=mean_over_samples)
    out = {"mse": mse, "crps": crps, "ssr": ssr}
    if also_per_member_metrics:
        per_mem = ((predictions - targets[None]) ** 2).mean(dim=tuple(range(1, predictions.ndim)))
        out.update(mse_per_mem=per_mem, mse_per_mem_mean=per_mem.mean())
    return {k: v.detach().cpu().numpy() for k, v in out.items()}


def evaluate_ensemble_prediction_for_varying_members(predictions, targets) -> Dict[str, np.ndarray]:
    """The metrics of :func:`evaluate_ensemble_prediction` for the first n
    members, n = 1..m, each stacked along a leading axis of length m."""
    predictions = _t(predictions)
    out: Dict[str, list] = {}
    for n in range(1, predictions.shape[0] + 1):
        for k, v in evaluate_ensemble_prediction(predictions[:n], targets).items():
            out.setdefault(k, []).append(v)
    return {k: np.asarray(v) for k, v in out.items()}
