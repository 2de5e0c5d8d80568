"""Spatial training of the port on the CPU: gloo ranks split the grid's H or
W axis, forward and backward, against the JAX package's gradients and
against one process.

- (a) The sharded ``Unet``'s gradients (two ranks; halo-exchanged convs,
  GroupNorm moments and B1 over the model group, each with its backward)
  of sum(output * cot), dropout off, f32, against ``jax.grad`` of the same
  scalar of the JAX ``Unet`` on the same ported weights: the input and
  every weight within 1e-5 of the larger of the tensor's max|JAX| and 0.1
  of the largest of all (a conv bias in front of a GroupNorm has a
  gradient of float noise), on H (12x12, the lowest level split 2/1) and
  on W (16x20). Three planted faults must each fail the check: the halo's
  backward keeping each row's gradient on the rank that read it, the
  GroupNorm moments' gradients left per rank, B1's backward over the
  rank's own tokens.
- (b) The split B1's backward against ``jax.vjp`` of the JAX package's XLA
  B1 (``_xla_qkv``) over all the tokens, within 1e-5 of max.
- (c) Both DYffusion stages trained through ``run_experiment`` on K = 2
  ranks, dropout on (0.2 / 0.1), against one process at the same seed:
  stage 1, then stage 2 by run id from the registry, 3 AdamW + EMA steps
  each, on H through the spawn and on W through the CLI; stage 2 again
  with remat and folded accumulation (2 x 4 rows, 3 steps); stage 1 on a
  2 x 2 grid against two data-parallel ranks. Every logged loss within
  1e-5 relative, the final weights and EMA within 1e-2 of their change
  over the run as a relative L2 over the model (the measure of
  ``tests/test_torch_port_ddp.py``: not elementwise, Adam moves a
  noise-gradient bias a full step of either sign).
- (d) The CLI (``python -m dyffusion_tpu_torch.train``, which spawns its
  ranks) with ``trainer.devices=2 trainer.spatial_shards=2
  trainer.spatial_axis=w`` for stage 1, then stage 2 by run id; the run
  ids equal the JAX package's.
- The layouts a shard once refused (the 'qk' attention, a level of fewer
  rows than ranks) run on the two ranks and equal one process.

One spawn of two ranks for (a)-(c) beside the JAX gradients and the
one-process runs, then the CLI and the 2 x 2 grid with its witness, each
rank with a deadline of 120 s (``tests/_torch_ddp_workers.py``).
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
import torch

from dyffusion_tpu import config as jax_config
from dyffusion_tpu.models import Unet as JaxUnet
from dyffusion_tpu.ops.pallas_attention import _xla_qkv
from dyffusion_tpu.utils.naming import get_run_id as jax_run_id
from dyffusion_tpu_torch.config import get_config
from dyffusion_tpu_torch.interface import build_trainer
from dyffusion_tpu_torch.models import unet_state_dict_from_jax
from dyffusion_tpu_torch.utils.naming import get_run_id
from tests import _torch_ddp_workers as workers
from tests import _torch_spatial_workers as spatial_workers
from tests._torch_port_helpers import to_numpy_tree
from tests._torch_port_helpers import torch_threads_share_of_cores  # noqa: F401 (autouse fixture)

WORLD = 2
REL = 1e-5
CHANGE_REL = 1e-2
GRAD_FLOOR = 0.1
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FAULTS = ("halo gradients kept", "group norm moment gradients per rank", "linear attention backward per rank")
# (H, W, axis): the first splits the lowest level 2/1 (12 -> 6 -> 3 rows)
UNET_GRIDS = ((12, 12, "h"), (16, 20, "w"))
TINY = [
    "datamodule.spatial=(8,8)", "datamodule.channels=1", "datamodule.horizon=3", "datamodule.n_traj=5",
    "datamodule.n_time=8", "datamodule.batch_size=4", "datamodule.eval_batch_size=3", "model.dim=8",
    "model.dim_mults=(1,2)", "model.block_dropout=0.2", "model.attn_dropout=0.1", "module.num_predictions=2",
    "module.use_ema=true", "trainer.max_steps=3", "trainer.log_every_n_steps=1", "trainer.val_every_n_epochs=100",
]
SHARDED = ["trainer.devices=2", "trainer.spatial_shards=2"]
# stage 2 with remat and two micro-batches folded into one step: 3 steps of 2 x 4 rows
REMAT_FOLD = ["model.remat=true", "trainer.accumulate_grad_batches=2", "trainer.fold_accumulation_into_batch=true",
              "trainer.max_steps=6", "run_id=remat_fold"]


def _commands(registry, layout, stage2_extra=()):
    """(preset, overrides) of stage 1 and of stage 2 by run id."""
    common = TINY + layout + [f"registry_dir={registry}"]
    run1 = get_run_id(get_config("synthetic_interpolation", common))
    return [("synthetic_interpolation", common),
            ("synthetic_dyffusion", common + [f"diffusion.interpolator_run_id={run1}", *stage2_extra])]


# ---------------------------------------------------------------------------
# the JAX side


def _random_params(jm, H, W, g):
    """Random weights of the JAX ``Unet`` ``jm`` on an H x W grid, in the
    shapes of its init (``jax.eval_shape``, no compile): kernels N(0,
    1/fan_in), biases N(0, 0.1^2), norm scales 1 + N(0, 0.1^2)."""
    x = jnp.zeros((1, H, W, jm.num_input_channels), jnp.float32)
    cond = jnp.zeros((1, H, W, jm.num_conditional_channels), jnp.float32)
    shapes = jax.eval_shape(lambda: jm.init({"params": jax.random.key(0)}, x, time=jnp.zeros((1,)), condition=cond,
                                            deterministic=True))["params"]

    def draw(path, leaf):
        name = str(path[-1].key)
        if name in ("scale", "g"):
            return (1.0 + 0.1 * g.normal(size=leaf.shape)).astype(np.float32)
        if name == "kernel" and len(leaf.shape) > 1:
            return (g.normal(size=leaf.shape) / np.sqrt(np.prod(leaf.shape[:-1]))).astype(np.float32)
        return (0.1 * g.normal(size=leaf.shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, shapes)


def _unet_case(H, W, axis, seed):
    """A JAX ``Unet`` (dim 8, mults (1, 2, 4), two heads of 32, time and a
    condition) with random weights, ported, inputs and a cotangent: the
    case the ranks take (NCHW), and a function giving ``jax.grad`` of
    sum(output * cot) by the input and the weights (NCHW, the port's
    state-dict names)."""
    kw = dict(dim=8, dim_mults=(1, 2, 4), resnet_block_groups=4, with_time_emb=True, num_input_channels=2,
              num_output_channels=2, num_conditional_channels=1, attn_heads=2, attn_dim_head=32)
    jm = JaxUnet(**kw)
    g = np.random.default_rng(seed)
    params = _random_params(jm, H, W, g)
    x = g.normal(size=(3, H, W, 2)).astype(np.float32)
    cond = g.normal(size=(3, H, W, 1)).astype(np.float32)
    cot = g.normal(size=(3, H, W, 2)).astype(np.float32)
    t = np.asarray([0.5, 2.0, 3.5], np.float32)
    nchw = lambda a: np.ascontiguousarray(np.asarray(a).transpose(0, 3, 1, 2))  # noqa: E731
    case = {"kwargs": kw, "state": {k: v.numpy() for k, v in unet_state_dict_from_jax(params).items()},
            "x": nchw(x), "cond": nchw(cond), "cot": nchw(cot), "t": t, "axis": axis}

    def jax_grads():
        def f(p, x):
            return jnp.sum(jm.apply({"params": p}, x, time=t, condition=cond) * cot)

        dp, dx = jax.jit(jax.grad(f, argnums=(0, 1)))(params, jnp.asarray(x))
        want = {k: v.numpy() for k, v in unet_state_dict_from_jax(to_numpy_tree(dp)).items()}
        return {"x": nchw(dx), **want}

    return case, jax_grads


def _b1_case():
    g = np.random.default_rng(5)
    qkv = g.normal(size=(3, 50, 384)).astype(np.float32)
    cot = g.normal(size=(3, 50, 128)).astype(np.float32)
    return qkv, cot


def _jax_b1_grad(qkv, cot):
    _, vjp = jax.vjp(lambda x: _xla_qkv(x, 4, 32, 32**-0.5), jnp.asarray(qkv))
    return np.asarray(vjp(jnp.asarray(cot))[0])


@pytest.fixture(scope="module")
def registries(tmp_path_factory):
    root = tmp_path_factory.mktemp("spatial_train")
    return {name: str(root / name) for name in ("one", "h", "w", "2x2", "2x1")}


@pytest.fixture(scope="module")
def ranks(registries):
    """The module's spawn of two ranks (:func:`spatial_workers.train_rank`)
    with its inputs, and beside it the JAX gradients and the one-process
    runs (the witness of every layout: the sharded layouts hash to its
    run ids)."""
    cases = [_unet_case(H, W, axis, seed) for seed, (H, W, axis) in enumerate(UNET_GRIDS)]
    b1 = _b1_case()
    runs = {"h": _commands(registries["h"], SHARDED + ["trainer.spatial_axis=h"]),
            "remat_fold": _commands(registries["h"], SHARDED, REMAT_FOLD)[1:]}
    with ThreadPoolExecutor(1) as pool:
        spawn = pool.submit(workers.run_ranks, spatial_workers.train_rank, WORLD, [c for c, _ in cases],
                            list(FAULTS), b1, runs)
        cases = [(case, jax_grads()) for case, jax_grads in cases]
        want_b1 = _jax_b1_grad(*b1)
        one = spatial_workers.run_commands(_commands(registries["one"], []))
        one += spatial_workers.run_commands(_commands(registries["one"], [], REMAT_FOLD)[1:])
        out = spawn.result()
    return dict(cases=cases, b1=b1, want_b1=want_b1, one=one, out=out)


def _joined(ranks, get, axis):
    return np.concatenate([get(r) for r in ranks["out"]], axis=2 if axis == "h" else 3)


def _assert_grads_match(got, want, r=REL):
    """Each tensor within ``r`` of the larger of its own max|JAX| and
    GRAD_FLOOR of the largest of all."""
    assert sorted(got) == sorted(want)
    top = max(float(np.abs(w).max()) for w in want.values())
    for k, w in want.items():
        err = float(np.abs(np.asarray(got[k], np.float64) - w).max())
        limit = r * max(float(np.abs(w).max()), GRAD_FLOOR * top)
        assert err <= limit, f"{k}: max abs err {err:.3e} > {limit:.3e}"


def _rank_grads(ranks, grid, fault=None):
    case, _ = ranks["cases"][grid]
    got = dict(ranks["out"][0]["unet"][grid][fault])
    got["x"] = _joined(ranks, lambda r: r["unet"][grid][fault]["x"], case["axis"])
    return got


@pytest.mark.parametrize("grid", range(len(UNET_GRIDS)))
def test_sharded_unet_gradients_match_jax(ranks, grid):
    _, want = ranks["cases"][grid]
    _assert_grads_match(_rank_grads(ranks, grid), want)
    # every rank holds the same summed weight gradients
    for k, v in ranks["out"][1]["unet"][grid][None].items():
        if k != "x":
            np.testing.assert_array_equal(v, ranks["out"][0]["unet"][grid][None][k])


@pytest.mark.parametrize("fault", FAULTS)
def test_planted_backward_faults_fail_the_gradient_check(ranks, fault):
    _, want = ranks["cases"][0]
    with pytest.raises(AssertionError):
        _assert_grads_match(_rank_grads(ranks, 0, fault), want)


def test_split_linear_attention_backward_matches_jax(ranks):
    got = np.concatenate([r["b1"] for r in ranks["out"]], axis=1)
    want = ranks["want_b1"]
    err, scale = float(np.abs(got - want).max()), float(np.abs(want).max())
    assert err <= REL * scale, f"B1 split backward: max abs err {err:.3e} > {REL} x {scale:.3e}"


def test_a2_backbone_still_raises_under_a_shard(ranks):
    """The layouts a shard once refused now run: the ranks' slabs equal
    one process."""
    spatial_workers.assert_thin_layouts_match([r["thin"] for r in ranks["out"]], REL)


# ---------------------------------------------------------------------------
# training against one process


def _metrics(registry, run_id):
    with open(os.path.join(registry, run_id, "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


def _state(registry, run_id):
    return torch.load(os.path.join(registry, run_id, "last", "state.pt"), weights_only=True)


def _initial_weights(registry, run_id):
    """The run's weights before its first step: its config built anew."""
    with open(os.path.join(registry, run_id, "config.json")) as f:
        config = json.load(f)
    config["trainer"].update(devices=1, spatial_shards=1)
    return {k: v.clone() for k, v in build_trainer(config, device="cpu").state.model.state_dict().items()}


def assert_trains_as(registry, want_registry, run_id, init_registry=None, steps=3, ignore=()):
    """The run ``run_id`` of ``registry`` against that of ``want_registry``:
    every logged loss within REL relative, the weights and the EMA within
    CHANGE_REL of their change (relative L2), but for the names in
    ``ignore``."""
    got, want = _metrics(registry, run_id), _metrics(want_registry, run_id)
    losses = [(a["train/loss"], b["train/loss"]) for a, b in zip(got, want) if "train/loss" in b]
    assert len(losses) == steps and len(got) == len(want)
    for g, w in losses:
        np.testing.assert_allclose(g, w, rtol=REL)
    s, s1 = _state(registry, run_id), _state(want_registry, run_id)
    assert s["step"] == s1["step"]
    init = _initial_weights(init_registry or want_registry, run_id)
    for part in ("model", "ema"):
        keys = [k for k, w in s1[part].items() if w.is_floating_point() and k in init and k not in ignore]
        num = sum(float(((s[part][k] - s1[part][k]) ** 2).sum()) for k in keys)
        den = sum(float(((s1[part][k] - init[k]) ** 2).sum()) for k in keys)
        assert (num / den) ** 0.5 <= CHANGE_REL, (part, (num / den) ** 0.5)


@pytest.mark.parametrize("stage", [0, 1], ids=["stage 1", "stage 2"])
def test_two_ranks_on_h_train_as_one_process(ranks, registries, stage):
    run_id = ranks["one"][stage]
    assert [r["runs"]["h"][stage] for r in ranks["out"]] == [run_id] * WORLD  # the run id of one process
    assert_trains_as(registries["h"], registries["one"], run_id)


def test_two_ranks_with_remat_and_folded_accumulation_train_as_one_process(ranks, registries):
    assert ranks["out"][0]["runs"]["remat_fold"] == ["remat_fold"] == ranks["one"][2:]
    assert_trains_as(registries["h"], registries["one"], "remat_fold", steps=3)


# ---------------------------------------------------------------------------
# the CLI on W, and the 2 x 2 grid against two data-parallel ranks


def _cli(argv):
    env = {**os.environ, "OMP_NUM_THREADS": "1"}
    return subprocess.Popen([sys.executable, "-m", "dyffusion_tpu_torch.train", *argv, "--device=cpu"],
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env,
                            start_new_session=True, cwd=ROOT)


def _finish(proc):
    try:
        stdout, stderr = proc.communicate(timeout=2 * workers.JOIN_TIMEOUT_S)
    finally:
        if proc.poll() is None:
            os.killpg(proc.pid, signal.SIGKILL)
            proc.communicate()
    assert proc.returncode == 0, stderr[-3000:]
    lines = [json.loads(line) for line in stdout.splitlines() if line.startswith("{")]
    assert len(lines) == 1  # rank 0 alone prints
    return lines[0]


@pytest.fixture(scope="module")
def grids(ranks, registries):
    """After the module's spawn: stage 1 then stage 2 through the CLI on
    two ranks sharding W, and beside it stage 1 on a 2 x 2 grid and on two
    data-parallel ranks (each data index with 4 rows)."""
    cmds = _commands(registries["w"], SHARDED + ["trainer.spatial_axis=w"])
    grid = {name: _commands(registries[name], layout + ["datamodule.batch_size=2"])[0]
            for name, layout in (("2x2", ["trainer.devices=4", "trainer.spatial_shards=2"]),
                                 ("2x1", ["trainer.devices=2"]))}
    procs = {name: _cli([f"experiment={preset}", *ov]) for name, (preset, ov) in grid.items()}
    out = {"w": [_finish(_cli([f"experiment={preset}", *ov])) for preset, ov in cmds]}
    out.update({name: _finish(proc) for name, proc in procs.items()})
    out["commands"] = {"w": cmds, **grid}
    return out


@pytest.mark.parametrize("stage", [0, 1], ids=["stage 1", "stage 2"])
def test_cli_two_ranks_on_w_train_as_one_process(ranks, registries, grids, stage):
    run_id = os.path.basename(grids["w"][stage]["run_dir"])
    assert run_id == ranks["one"][stage]
    assert_trains_as(registries["w"], registries["one"], run_id)
    preset, overrides = grids["commands"]["w"][stage]
    assert run_id == jax_run_id(jax_config.get_config(preset, overrides))


def test_a_2x2_grid_trains_as_two_data_parallel_ranks(registries, grids):
    run_id = os.path.basename(grids["2x2"]["run_dir"])
    assert run_id == os.path.basename(grids["2x1"]["run_dir"])
    preset, overrides = grids["commands"]["2x2"]
    assert run_id == jax_run_id(jax_config.get_config(preset, overrides))
    assert_trains_as(registries["2x2"], registries["2x1"], run_id)
