"""The unfolded member layout (``module.fold_members_into_batch=false``) of
the port against the JAX package on the CPU, and against the port's folded
layout.

Both packages build each experiment from the same preset and overrides; the
port's networks hold the JAX variables (``models/convert.py``). Tiny shapes:
8x8, C=1, horizon 3, a dim-8 ``Unet`` with one level, 3 members, eval
batches of 2. DYffusion's stage 2 runs over the stage-1 interpolator of the
same fixture, with one autoregressive window after the first (prediction
horizon 2h). With dropout off and ``prediction_inputs_noise=0`` every member
is deterministic, so the JAX vmap over member keys and the port's loop over
member generators must agree: f32 on both sides, within 1e-5 of max|JAX|
(sums in another order). The port's unfolded and folded layouts agree
within 1e-5 of max|folded| (convolutions at B and N*B rows). With dropout
on, the members must differ, a seed must repeat bit for bit, and member i
must not depend on the ensemble size. Then the CLI runs the four
experiments unfolded, stage 1 to ``mode=test``.
"""
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dyffusion_tpu import config as jax_config
from dyffusion_tpu import interface as jax_interface
from dyffusion_tpu.models import make_apply_fn
from dyffusion_tpu_torch import config as port_config
from dyffusion_tpu_torch import interface as port_interface
from dyffusion_tpu_torch import train as port_train
from dyffusion_tpu_torch.models import unet_state_dict_from_jax
from dyffusion_tpu_torch.utils import rng
from tests._torch_port_helpers import to_numpy_tree
from tests._torch_port_helpers import torch_threads_share_of_cores  # noqa: F401 (autouse fixture)

REL = 1e-5
H = 3
TINY = [
    "datamodule.spatial=(8,8)", "datamodule.channels=1", f"datamodule.horizon={H}",
    f"datamodule.prediction_horizon={2 * H}", "datamodule.n_traj=5", "datamodule.n_time=12",
    "datamodule.batch_size=2", "datamodule.eval_batch_size=2", "model.dim=8", "model.dim_mults=(1,)",
    "module.num_predictions=3", "module.num_predictions_test=3", "trainer.save_checkpoints=False",
]
UNFOLD = ["module.fold_members_into_batch=false"]
DROPOUT = ["model.block_dropout=0.2"]
KINDS = {
    "interpolation": "synthetic_interpolation",
    "dyffusion": "synthetic_dyffusion",
    "time_conditioned": "synthetic_time_conditioned",
    "simultaneous": "synthetic_simultaneous",
}


def _close(got, want, r, what=""):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err, scale = float(np.abs(got - want).max()), float(np.abs(want).max())
    assert scale > 0, what
    assert err <= r * scale, f"{what}: max abs err {err:.3e} > {r} x {scale:.3e}"


def _build(extra, weights_from=None):
    """{kind: (JAX experiment parts, port experiment parts)} over the same
    weights; stage 2 over stage 1's interpolator in both packages. With
    ``weights_from`` (an earlier build) the port side alone, holding that
    build's weights."""
    out, j_ip, p_ip = {}, None, None
    for kind, preset in KINDS.items():
        ov = TINY + list(extra)
        pc = port_config.get_config(preset, ov)
        pdm = port_interface.get_datamodule(pc)
        pdm.setup()
        stage2 = kind == "dyffusion"
        pexp, pmodel, _, peval, _ = port_interface.build_experiment(
            pc, pdm, interpolator=p_ip if stage2 else None, device="cpu")
        j = None
        if weights_from is None:
            jc = jax_config.get_config(preset, ov)
            jdm = jax_interface.get_datamodule(jc)
            jdm.setup()
            jexp, jmodel, jvars, _, jeval, _ = jax_interface.build_experiment(
                jc, jdm, interpolator=j_ip if stage2 else None)
            jvars = to_numpy_tree(jvars)
            pmodel.load_state_dict(unet_state_dict_from_jax(jvars))
            j = dict(vars=jvars, eval=jeval)
            if kind == "interpolation":
                j_ip = (make_apply_fn(jmodel), jvars)
        else:
            pmodel.load_state_dict(weights_from[kind][1]["exp"].model.state_dict())
        if kind == "interpolation":
            p_ip = pmodel
        out[kind] = (j, dict(exp=pexp, eval=peval, dm=pdm))
    return out


@pytest.fixture(scope="module")
def unfolded():
    return _build(UNFOLD)


@pytest.fixture(scope="module")
def folded(unfolded):
    return _build([], weights_from=unfolded)


@pytest.fixture(scope="module")
def dropout(unfolded):
    return _build(UNFOLD + DROPOUT, weights_from=unfolded)


def _split(kind):
    """The split whose eval chains the autoregressive window (forecasters)."""
    return "val" if kind == "interpolation" else "test"


def _batch(p, kind):
    return next(iter(getattr(p["dm"], f"{_split(kind)}_batches")()))


def _preds(out):
    return {k: v for k, v in out.items() if k.endswith("_preds")}


@pytest.mark.parametrize("kind", sorted(KINDS))
def test_unfolded_eval_matches_jax(unfolded, kind):
    j, p = unfolded[kind]
    batch = _batch(p, kind)
    split = _split(kind)
    want = jax.jit(j["eval"][split])(j["vars"], {k: jnp.asarray(v) for k, v in batch.items()}, jax.random.key(0))
    got = p["eval"][split](batch, None, None)
    assert sorted(got) == sorted(want)
    n_t = H - 1 if kind == "interpolation" else 2 * H  # the forecasters chain a second window
    assert len(_preds(got)) == n_t
    for k in sorted(want):
        _close(got[k].numpy(), want[k], REL, f"{kind} {k}")
        if k.endswith("_preds"):
            assert got[k].shape[0] == 3, got[k].shape


@pytest.mark.parametrize("kind", sorted(KINDS))
def test_unfolded_equals_folded(unfolded, folded, kind):
    _, p_un = unfolded[kind]
    _, p_fo = folded[kind]
    assert not p_un["exp"].cfg.fold_members_into_batch and p_fo["exp"].cfg.fold_members_into_batch
    batch, split = _batch(p_un, kind), _split(kind)
    want = p_fo["eval"][split](batch, torch.Generator().manual_seed(0), None)
    got = p_un["eval"][split](batch, torch.Generator().manual_seed(0), None)
    assert sorted(got) == sorted(want)
    for k in sorted(want):
        _close(got[k].numpy(), want[k].numpy(), REL, f"{kind} {k}")


def _run(p, kind, seed, n_members=None):
    exp, split = p["exp"], _split(kind)
    cfg = exp.cfg
    if n_members is not None:
        exp.cfg = dataclasses.replace(cfg, num_predictions=n_members, num_predictions_test=n_members)
    try:
        eval_fn = exp.make_eval_fn(split=split, autoregressive=kind != "interpolation") if kind != "interpolation" \
            else exp.make_eval_fn(split=split)
        return eval_fn(_batch(p, kind), torch.Generator().manual_seed(seed), None)
    finally:
        exp.cfg = cfg


@pytest.mark.parametrize("kind", sorted(KINDS))
def test_dropout_members_differ_and_seeds_repeat(dropout, kind):
    _, p = dropout[kind]
    a, b, c = _run(p, kind, 0), _run(p, kind, 0), _run(p, kind, 1)
    for k in _preds(a):
        assert torch.equal(a[k], b[k]), f"{kind} {k}: the same seed did not repeat"
        spread = float(a[k].std(dim=0).mean())
        assert spread > 1e-4, f"{kind} {k}: members do not differ ({spread:.2e})"
        assert float((a[k] - c[k]).abs().max()) > 1e-4, f"{kind} {k}: two seeds agree"


@pytest.mark.parametrize("kind", sorted(KINDS))
def test_dropout_member_does_not_depend_on_ensemble_size(dropout, kind):
    _, p = dropout[kind]
    two, five = _run(p, kind, 3, n_members=2), _run(p, kind, 3, n_members=5)
    for k in _preds(two):
        assert two[k].shape[0] == 2 and five[k].shape[0] == 5
        assert torch.equal(two[k], five[k][:2]), f"{kind} {k}: member answers depend on N"


def test_member_generators():
    """One draw from the request's generator, whatever N; member i's stream
    depends on i and that draw only; the device default and None pass
    through to every member."""
    g1, g2 = torch.Generator().manual_seed(5), torch.Generator().manual_seed(5)
    a, b = rng.split(g1, 2), rng.split(g2, 4)
    assert torch.equal(g1.get_state(), g2.get_state())
    for x, y in zip(a, b):
        assert torch.equal(torch.rand(4, generator=x), torch.rand(4, generator=y))
    assert not torch.equal(torch.rand(4, generator=b[2]), torch.rand(4, generator=b[3]))
    assert rng.split(rng.DEVICE_DEFAULT, 3) == [rng.DEVICE_DEFAULT] * 3
    assert rng.split(None, 2) == [None, None]


@torch.no_grad()
def test_sample_ensemble(unfolded, dropout):
    """(N, B, h, C, H, W); a list of member generators gives what splitting
    the request's generator gives; per-member conditions; inputs noise
    drawn per member makes dropout-free members differ."""
    _, p = dropout["dyffusion"]
    exp = p["exp"]
    batch = _batch(p, "dyffusion")
    cond = torch.as_tensor(batch["dynamics"][:, 0]).permute(0, 3, 1, 2)
    eng = exp.engine
    out = eng.sample_ensemble(None, None, torch.Generator().manual_seed(2), cond, num_predictions=3)
    assert out.shape == (3, cond.shape[0], H, 1, 8, 8)
    same = eng.sample_ensemble(None, None, rng.split(torch.Generator().manual_seed(2), 3), cond)
    assert torch.equal(out, same)
    per = eng.sample_ensemble(None, None, rng.split(torch.Generator().manual_seed(2), 3),
                              cond.unsqueeze(0).expand(3, *cond.shape))
    assert torch.equal(out, per)
    _, q = unfolded["dyffusion"]
    quiet = q["exp"].engine.sample_ensemble(None, None, torch.Generator().manual_seed(2), cond, num_predictions=2)
    assert torch.equal(quiet[0], quiet[1])  # dropout off: members agree
    noisy = q["exp"].engine.sample_ensemble(None, None, torch.Generator().manual_seed(2), cond, num_predictions=2,
                                            inputs_noise=0.1)
    assert float((noisy[0] - noisy[1]).abs().max()) > 1e-4


def test_cli_runs_unfolded(tmp_path, capsys):
    """Stage 1, stage 2 by run id and ``mode=test``, then the two
    baselines, through the port's CLI with the unfolded layout; finite
    metrics."""
    common = TINY + UNFOLD + DROPOUT + ["trainer.max_steps=2", "trainer.save_checkpoints=True",
                                         f"registry_dir={tmp_path}", "--device=cpu"]
    port_train.main(["experiment=synthetic_interpolation"] + common)
    run1 = json.loads(capsys.readouterr().out.strip().splitlines()[-1])["run_dir"].rsplit("/", 1)[-1]
    best2 = port_train.main(["experiment=synthetic_dyffusion", f"diffusion.interpolator_run_id={run1}"] + common)
    run2 = json.loads(capsys.readouterr().out.strip().splitlines()[-1])["run_dir"].rsplit("/", 1)[-1]
    assert np.isfinite(best2)
    crps = port_train.main(["mode=test", f"run_id={run2}", f"registry_dir={tmp_path}", "--device=cpu"])
    assert np.isfinite(crps)
    for preset in ("synthetic_time_conditioned", "synthetic_simultaneous"):
        assert np.isfinite(port_train.main([f"experiment={preset}"] + common))
