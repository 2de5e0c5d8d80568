"""Spatial sharding of the port on the CPU (eval path): two gloo ranks,
spawned once for the module, split the grid's H or W axis, against the JAX
package's single-device computation and against one process.

- The sharded ``Unet`` forward (halo-exchanged convs, GroupNorm moments
  over the model group, B1 split across the ranks, the mid-block attention
  on gathered keys and values), dropout off, f32, on H and on W, against
  the JAX ``Unet``'s forward on the same ported weights within 1e-5 of
  max|JAX|: a 12x12 grid with mults (1, 2, 4), whose lowest level (3 rows)
  splits 2/1, and a 16x20 grid sharded on W. Negative controls, each of
  which must fail the check: every halo zeroed, the GroupNorm moments kept
  per rank, k's softmax over the rank's own tokens.
- B1's plain split path (``linear_attention_qkv_split_plain``) on each
  rank's tokens against the JAX package's XLA B1 over all of them.
- Both DYffusion stages' val predictions (``Trainer.predict``: rows and
  slabs gathered) with the dropout of the preset on, against one process
  at the same seed within 1e-5; stage 2's ``fit`` runs under the shard
  (its training is held against one process in
  ``tests/test_torch_port_spatial_train.py``).
- The CLI: ``mode=test`` with ``trainer.devices=2 trainer.spatial_shards=2``
  (it spawns its ranks) against one process, with dropout; and a 2 x 2
  grid (``trainer.devices=4``) against two data-parallel ranks, whose
  data indices draw as the grid's do.
- The grid's divisibility error in the JAX package's words, and the
  layouts a shard once refused (the 'qk' linear attention, a ``Unet``
  level of fewer rows than ranks) against one process.

Every spawned rank has a deadline of 120 s (``tests/_torch_ddp_workers.py``).
"""
import json
import os
import signal
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from dyffusion_tpu.interface import _check_spatial_divisibility as jax_check_spatial_divisibility
from dyffusion_tpu.models import Unet as JaxUnet
from dyffusion_tpu.models.base import BackboneSpec as JaxSpec
from dyffusion_tpu.models.base import init_backbone
from dyffusion_tpu.ops.pallas_attention import _xla_qkv
from dyffusion_tpu_torch.config import get_config
from dyffusion_tpu_torch.interface import (
    _check_spatial_divisibility,
    build_trainer,
    reload_and_test,
    run_experiment,
)
from dyffusion_tpu_torch.models import unet_state_dict_from_jax
from tests import _torch_ddp_workers as workers
from tests import _torch_spatial_workers as spatial_workers
from tests._torch_port_helpers import to_numpy_tree
from tests._torch_port_helpers import torch_threads_share_of_cores  # noqa: F401 (autouse fixture)

WORLD = 2
REL = 1e-5
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FAULTS = ("halos zeroed", "group norm per rank", "linear attention per rank")
# (H, W, axis): the first splits the lowest level 2/1 (12 -> 6 -> 3 rows)
UNET_GRIDS = ((12, 12, "h"), (16, 20, "w"))
TINY = [
    "datamodule.spatial=(8,8)", "datamodule.channels=1", "datamodule.horizon=3", "datamodule.n_traj=5",
    "datamodule.n_time=8", "datamodule.batch_size=4", "datamodule.eval_batch_size=3", "model.dim=8",
    "model.dim_mults=(1,2)", "model.block_dropout=0.2", "model.attn_dropout=0.1", "module.num_predictions=2",
    "module.num_predictions_test=3", "trainer.max_steps=2",
]
SHARDED = ["trainer.devices=2", "trainer.spatial_shards=2"]


def _close(got, want, r, what=""):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err, scale = float(np.abs(got - want).max()), float(np.abs(want).max())
    assert err <= r * max(scale, 1e-30), f"{what}: max abs err {err:.3e} > {r} x {scale:.3e}"


def _unet_case(H, W, axis, seed):
    """A JAX ``Unet`` (dim 8, mults (1, 2, 4), two heads of 32, time and a
    condition), its weights perturbed and ported, and inputs: the case the
    ranks take (NCHW), and a function giving the JAX forward (NCHW)."""
    kw = dict(dim=8, dim_mults=(1, 2, 4), resnet_block_groups=4, with_time_emb=True, num_input_channels=2,
              num_output_channels=2, num_conditional_channels=1, attn_heads=2, attn_dim_head=32)
    jm = JaxUnet(**kw)
    variables = to_numpy_tree(init_backbone(jm, JaxSpec(2, 2, 1, (H, W), True), jax.random.key(seed)))
    g = np.random.default_rng(seed)
    variables = {k: v if k != "params" else jax.tree_util.tree_map(
        lambda p: (p + 0.05 * g.normal(size=p.shape)).astype(np.float32), v) for k, v in variables.items()}
    x = g.normal(size=(3, H, W, 2)).astype(np.float32)
    cond = g.normal(size=(3, H, W, 1)).astype(np.float32)
    t = np.asarray([0.5, 2.0, 3.5], np.float32)
    state = {k: v.numpy() for k, v in unet_state_dict_from_jax(variables).items()}
    case = {"kwargs": kw, "state": state, "x": np.ascontiguousarray(x.transpose(0, 3, 1, 2)),
            "cond": np.ascontiguousarray(cond.transpose(0, 3, 1, 2)), "t": t, "axis": axis}
    return case, lambda: np.asarray(jm.apply(variables, x, time=t, condition=cond)).transpose(0, 3, 1, 2)


@pytest.fixture(scope="module")
def ranks():
    """The one spawn of the module (:func:`spatial_workers.spatial_rank`)
    with its inputs, and the single-device answers, computed while the
    ranks run."""
    cases = [_unet_case(H, W, axis, seed) for seed, (H, W, axis) in enumerate(UNET_GRIDS)]
    qkv = np.random.default_rng(5).normal(size=(3, 50, 384)).astype(np.float32)
    with ThreadPoolExecutor(1) as pool:
        spawn = pool.submit(workers.run_ranks, spatial_workers.spatial_rank, WORLD, [c for c, _ in cases],
                            list(FAULTS), qkv, TINY + SHARDED, TINY + SHARDED)
        cases = [(case, jax_forward()) for case, jax_forward in cases]
        out = spawn.result()
    return dict(cases=cases, qkv=qkv, out=out)


def _joined(ranks, get, axis):
    return np.concatenate([get(r) for r in ranks["out"]], axis=2 if axis == "h" else 3)


@pytest.mark.parametrize("grid", range(len(UNET_GRIDS)))
def test_sharded_unet_matches_the_jax_unet(ranks, grid):
    case, want = ranks["cases"][grid]
    got = _joined(ranks, lambda r: r["unet"][grid][None], case["axis"])
    _close(got, want, REL, f"{UNET_GRIDS[grid]}")


@pytest.mark.parametrize("fault", FAULTS)
def test_planted_faults_fail_the_unet_check(ranks, fault):
    case, want = ranks["cases"][0]
    got = _joined(ranks, lambda r: r["unet"][0][fault], case["axis"])
    with pytest.raises(AssertionError):
        _close(got, want, REL, fault)


def test_split_linear_attention_matches_the_jax_b1(ranks):
    got = np.concatenate([r["b1"] for r in ranks["out"]], axis=1)
    want = np.asarray(_xla_qkv(jnp.asarray(ranks["qkv"]), 4, 32, 32**-0.5))
    _close(got, want, REL, "B1 split")


@pytest.fixture(scope="module")
def one_process():
    """Both stages' val predictions and the stage-1 test metrics on one
    process, at the sharded run's seed."""
    tr1 = build_trainer(get_config("synthetic_interpolation", TINY), device="cpu")
    tr2 = build_trainer(get_config("synthetic_dyffusion", TINY), interpolator=tr1.experiment.model, device="cpu")
    return {"stage 1": tr1.predict("val"), "stage 2": tr2.predict("val"), "test": tr1.evaluate("test")}


@pytest.mark.parametrize("stage", ["stage 1", "stage 2"])
def test_sharded_eval_with_dropout_matches_one_process(ranks, one_process, stage):
    want = one_process[stage]
    for r in ranks["out"]:
        assert sorted(r[stage]) == sorted(want)
        for k, w in want.items():
            _close(r[stage][k], w, REL, f"{stage} {k}")
    # the members differ: dropout is on
    assert np.abs(np.diff(want["t1_preds"], axis=0)).max() > 1e-3


def test_sharded_test_metrics_match_one_process(ranks, one_process):
    want = one_process["test"]
    for r in ranks["out"]:
        for k, w in want.items():
            if "frames_per_sec" not in k:
                np.testing.assert_allclose(r["test"][k], w, rtol=REL, atol=1e-7, err_msg=k)


def test_training_under_a_shard_raises(ranks):
    """Training under a shard runs: stage 2's ``fit`` on the two ranks
    gives one finite best score. The layouts a shard once refused run too
    (the 'qk' linear attention, and on the ranks a ``Unet`` level of one
    row): the two ranks' slabs and a one-rank shard in this process equal
    the whole grid without a shard."""
    scores = [r["fit"] for r in ranks["out"]]
    assert np.isfinite(scores[0]) and scores == [scores[0]] * WORLD
    spatial_workers.assert_thin_layouts_match([r["thin"] for r in ranks["out"]], REL)
    spatial_workers.assert_thin_layouts_match([spatial_workers.thin_layouts(0, 1)], REL)


def test_grid_divisibility_error_has_the_jax_wording():
    config = get_config("synthetic_interpolation", TINY + ["datamodule.spatial=(9,10)"])
    tr = build_trainer(config, device="cpu")
    mesh = type("Mesh", (), {"shape": {"model": 4}})()
    for axis in ("h", "w"):
        with pytest.raises(AssertionError) as jax_err:
            jax_check_spatial_divisibility(mesh, tr.datamodule, axis)
        with pytest.raises(ValueError) as err:
            _check_spatial_divisibility(tr.datamodule, 4, axis)
        assert str(err.value) == str(jax_err.value)
    with pytest.raises(ValueError, match="not divisible by trainer.spatial_shards=2"):
        build_trainer(get_config("synthetic_interpolation", TINY + ["trainer.spatial_shards=2"]), device="cpu")


# ---------------------------------------------------------------------------
# the CLI


@pytest.fixture(scope="module")
def cli(tmp_path_factory):
    """A trained stage-2 run, then ``mode=test`` through the CLI, with
    dropout on, on two ranks of one model group, on a 2 x 2 grid and on
    two data-parallel ranks (the grid's witness: its data index seeds its
    draws as the grid's does, ``distributed.rank_seed``), all started
    together, and in this process; each command's metrics."""
    reg = str(tmp_path_factory.mktemp("spatial_cli"))
    tr1, _ = run_experiment(get_config("synthetic_interpolation", TINY + [f"registry_dir={reg}"]), device="cpu")
    run1 = os.path.basename(tr1.ckpt.run_dir)
    tr2, _ = run_experiment(get_config("synthetic_dyffusion", TINY + [f"registry_dir={reg}",
                                                                      f"diffusion.interpolator_run_id={run1}"]),
                            device="cpu")
    run2 = os.path.basename(tr2.ckpt.run_dir)
    commands = {"2": SHARDED, "2x2": ["trainer.devices=4", "trainer.spatial_shards=2"], "2x1": ["trainer.devices=2"]}
    env = {**os.environ, "OMP_NUM_THREADS": "1"}
    procs = {
        name: subprocess.Popen(
            [sys.executable, "-m", "dyffusion_tpu_torch.train", "mode=test", f"run_id={run2}",
             f"registry_dir={reg}", *ov, "--device=cpu"],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env, start_new_session=True, cwd=ROOT)
        for name, ov in commands.items()}
    out = {}
    try:
        for name, proc in procs.items():
            stdout, stderr = proc.communicate(timeout=workers.JOIN_TIMEOUT_S)
            assert proc.returncode == 0, stderr[-3000:]
            lines = [json.loads(line) for line in stdout.splitlines() if line.startswith("{")]
            assert len(lines) == 1  # rank 0 alone prints
            out[name] = lines[0]
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                os.killpg(proc.pid, signal.SIGKILL)
                proc.communicate()
    out["1"] = reload_and_test(reg, run2, device="cpu")
    return out


@pytest.mark.parametrize("layout,want", [("2", "1"), ("2x2", "2x1")])
def test_cli_sharded_test_mode_matches_one_process(cli, layout, want):
    """The sharded layout's metrics equal those of its unsharded witness
    (one process; the 2 x 2 grid: two data-parallel ranks)."""
    got, want = cli[layout], cli[want]
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        if "frames_per_sec" not in k:
            np.testing.assert_allclose(got[k], w, rtol=REL, atol=1e-7, err_msg=k)
    assert got["test/avg/ssr"] > 1e-2  # the dropout is live: the members spread
