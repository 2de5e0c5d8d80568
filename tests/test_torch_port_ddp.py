"""Data parallelism of the port on the CPU: two gloo ranks, spawned, against
the JAX package's global-batch computation and against one process.

- The cross-rank BatchNorm (``models/base.py::BatchNorm2d`` in a process
  group) on two halves of a global batch against flax's ``nn.BatchNorm``
  (momentum 0.9, eps 1e-5) on the whole: the output, the gradients by the
  input, scale and bias, and the running statistics, within 1e-5 of their
  scale (f32, sums in another order). Its negative control: each half
  normalized by its own statistics must fail the same check.
- The padded eval sums: an odd batch (5 rows) padded to 6 by repeating the
  last row, 3 rows a rank, the padded row masked out, the sums all-reduced,
  against the JAX trainer's ``_make_metric_sums`` with its ``valid`` mask,
  within 1e-5 relative.
- ``all_reduce_gradients`` with a weight that one rank does not reach.
- Two ranks against one process at the same global batch (4 rows: 2 a
  rank), dropout off: stage 1 and stage 2 (by run id from the registry)
  through ``run_experiment`` for 3 AdamW + EMA steps and a validation whose
  last batch is odd (padded): every logged loss within 1e-5 relative, the
  final weights and EMA within 1e-2 of their change over the 3 steps, as
  a relative L2 over the whole model (measured: 0.9e-3 to 1.8e-3; not
  elementwise: a conv bias in front of a norm has a gradient of float
  noise, ~1e-9, and Adam moves it by a step of either sign), the val
  metrics and ``Trainer.predict`` within 1e-5; rank 1 writes nothing under the registry; one spring-mesh
  ``SimpleConvNet`` train step (BatchNorm) gives the one-process loss,
  gradients and running statistics (1e-5, with the same floor), and rank
  0's rows alone (per-rank statistics) must not.
- MCVD with ``diffusion.gamma=true`` (and noise in the condition) on two
  ranks against one process, 3 steps: the losses within 1e-5 relative,
  the weights within 1e-2 of their change; each rank drawing the Gamma
  noise of its own rows from its own generator (the planted fault) must
  fail the same check.
- ``mode=test`` of the two-rank run through the CLI (which starts its two
  ranks itself) against the one-process run's.
- The native loader's per-rank rows against the global batch's slices; the
  run id of a two-rank config against the JAX package's; a world that does
  not match ``trainer.devices`` raises, so does ``trainer.spatial_shards=2``
  on one process (K must divide the world), and an A2 layout under a
  shard.

Every spawned rank has a deadline of 120 s (``tests/_torch_ddp_workers.py``).
"""
import json
import os
import signal
import subprocess
import sys

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dyffusion_tpu import config as jax_config
from dyffusion_tpu.training.trainer import _make_metric_sums
from dyffusion_tpu.utils.naming import get_run_id as jax_run_id
from dyffusion_tpu_torch.config import get_config
from dyffusion_tpu_torch.data import write_fake_benchmark_dir
from dyffusion_tpu_torch.interface import build_trainer, reload_and_test, run_experiment
from dyffusion_tpu_torch.models.base import BatchNorm2d
from dyffusion_tpu_torch.parallel import process_local_rows, shard_batch
from dyffusion_tpu_torch.utils.naming import get_run_id
from tests import _torch_ddp_workers as workers
from tests._torch_spatial_workers import assert_thin_layouts_match, thin_layouts
from tests._torch_port_helpers import torch_threads_share_of_cores  # noqa: F401 (autouse fixture)

WORLD = 2
REL = 1e-5
CHANGE_REL = 1e-2
TINY = [
    "datamodule.spatial=(8,8)", "datamodule.channels=1", "datamodule.horizon=3", "datamodule.n_traj=5",
    "datamodule.n_time=8", "datamodule.eval_batch_size=3", "model.dim=8", "model.dim_mults=(1,)",
    "module.num_predictions=2", "module.num_predictions_test=2", "module.use_ema=true",
    "trainer.max_steps=3", "trainer.log_every_n_steps=1",
]
SPRING = ["datamodule.horizon=4", "datamodule.prediction_horizon=8", "model.dim=32", "model.dropout=0.0",
          "module.num_predictions=2", "trainer.save_checkpoints=False"]
# MCVD with Gamma noise (in the loss, the condition and the sampler), 3 steps and no validation
MCVD = [o for o in TINY if not o.startswith("module.use_ema")] + [
    "diffusion.gamma=true", "diffusion.noise_in_cond=true", "diffusion.timesteps=10", "trainer.val_every_n_epochs=100"]


def _close(got, want, r, what=""):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err, scale = float(np.abs(got - want).max()), float(np.abs(want).max())
    assert err <= r * max(scale, 1e-30), f"{what}: max abs err {err:.3e} > {r} x {scale:.3e}"


def _close_with_floor(got: dict, want: dict, r: float, what: str):
    """Elementwise: each tensor within ``r`` of the larger of its own
    largest |value| and 0.1 of the largest |value| of all of them (some
    gradients are float noise, e.g. a conv bias in front of a norm; Adam
    moves their weights by a full step of either sign)."""
    want = {k: np.asarray(v, np.float64) for k, v in want.items()}
    top = max(float(np.abs(v).max()) for v in want.values())
    for k, w in want.items():
        err = float(np.abs(np.asarray(got[k], np.float64) - w).max())
        limit = r * max(float(np.abs(w).max()), 0.1 * top)
        assert err <= limit, f"{what} {k}: max abs err {err:.3e} > {limit:.3e}"


# ---------------------------------------------------------------------------
# collectives against the JAX package


@pytest.fixture(scope="module")
def collectives():
    g = np.random.default_rng(0)
    x = g.normal(1.0, 2.0, (4, 3, 5, 5)).astype(np.float32)
    cot = g.normal(size=x.shape).astype(np.float32)
    params = {"weight": g.normal(1.0, 0.2, 3), "bias": g.normal(size=3), "running_mean": g.normal(size=3),
              "running_var": g.uniform(0.5, 1.5, 3)}
    params = {k: v.astype(np.float32) for k, v in params.items()}
    preds = g.normal(size=(4, 5, 6, 6, 1)).astype(np.float32)  # (members, rows, H, W, C)
    targets = g.normal(size=(5, 6, 6, 1)).astype(np.float32)
    ranks = workers.run_ranks(workers.collectives_rank, WORLD, (x, cot, params), (preds, targets))
    return dict(x=x, cot=cot, params=params, preds=preds, targets=targets, ranks=ranks)


def _flax_batch_norm(x, cot, params):
    """flax on the whole batch (NHWC): output, gradients, running stats."""
    bn = nn.BatchNorm(use_running_average=False, momentum=0.9, epsilon=1e-5)
    stats = {"mean": params["running_mean"], "var": params["running_var"]}
    xh, cot_h = np.transpose(x, (0, 2, 3, 1)), np.transpose(cot, (0, 2, 3, 1))

    def f(xh, scale, bias):
        y, upd = bn.apply({"params": {"scale": scale, "bias": bias}, "batch_stats": stats}, xh, mutable=["batch_stats"])
        return jnp.sum(y * cot_h), (y, upd)

    (_, (y, upd)), (dx, dw, db) = jax.value_and_grad(f, argnums=(0, 1, 2), has_aux=True)(
        jnp.asarray(xh), jnp.asarray(params["weight"]), jnp.asarray(params["bias"]))
    nchw = lambda a: np.transpose(np.asarray(a), (0, 3, 1, 2))  # noqa: E731
    return {"y": nchw(y), "dx": nchw(dx), "dweight": np.asarray(dw), "dbias": np.asarray(db),
            "mean": np.asarray(upd["batch_stats"]["mean"]), "var": np.asarray(upd["batch_stats"]["var"])}


def _ranks_batch_norm(ranks):
    return {"y": np.concatenate([r["bn"]["y"] for r in ranks]), "dx": np.concatenate([r["bn"]["dx"] for r in ranks]),
            **{k: ranks[0]["bn"][k] for k in ("dweight", "dbias", "mean", "var")}}


@pytest.mark.parametrize("what", ["y", "dx", "dweight", "dbias", "mean", "var"])
def test_cross_rank_batch_norm_matches_flax(collectives, what):
    c = collectives
    want = _flax_batch_norm(c["x"], c["cot"], c["params"])
    got = _ranks_batch_norm(c["ranks"])
    _close(got[what], want[what], REL, what)
    if what in ("dweight", "dbias", "mean", "var"):  # the same on every rank
        np.testing.assert_array_equal(c["ranks"][1]["bn"][what], c["ranks"][0]["bn"][what])
    assert all(r["bn"]["count"] == 1 for r in c["ranks"])


def test_per_rank_batch_norm_statistics_fail_the_check(collectives):
    """The negative control: each half normalized by its own statistics
    (one process, no group) is not flax's global-batch answer."""
    c = collectives
    want = _flax_batch_norm(c["x"], c["cot"], c["params"])
    parts = []
    for rows in (slice(0, 2), slice(2, 4)):
        bn = BatchNorm2d(3)
        with torch.no_grad():
            for k, v in c["params"].items():
                getattr(bn, k).copy_(torch.as_tensor(v))
        stats: dict = {}
        parts.append((bn(torch.as_tensor(c["x"][rows]), stats).detach().numpy(), stats[bn][0].numpy()))
    with pytest.raises(AssertionError):
        _close(np.concatenate([p[0] for p in parts]), want["y"], REL, "y")
    with pytest.raises(AssertionError):
        _close(parts[0][1], want["mean"], REL, "mean")


def test_padded_metric_sums_match_jax(collectives):
    c = collectives
    n = c["targets"].shape[0]
    pad = np.concatenate([np.arange(n), [n - 1]])
    valid = np.arange(n + 1) < n
    want = jax.jit(_make_metric_sums())(jnp.asarray(c["preds"][:, pad]), jnp.asarray(c["targets"][pad]),
                                        jnp.asarray(valid))
    for r in c["ranks"]:
        for k in ("n", "sq", "var", "crps"):
            np.testing.assert_allclose(r["sums"][k], float(want[k]), rtol=REL, err_msg=k)
    assert c["ranks"][0]["sums"]["n"] == n * 36


def test_gradient_all_reduce_takes_unreached_weights_as_zeros(collectives):
    # a: rank 0 never reaches it (grad None -> zeros), rank 1's gradient is 2; b: ranks give 1 and 2
    for r in collectives["ranks"]:
        assert r["grads"] == [[1.0] * 4, [1.5] * 5]


# ---------------------------------------------------------------------------
# two ranks against one process


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The two-rank run (spawned) and the one-process run at the same
    global batch, each in a registry of its own."""
    root = tmp_path_factory.mktemp("ddp")
    spring_data = str(root / "spring")
    write_fake_benchmark_dir(spring_data, "spring-mesh", n_traj={"train": 2, "val": 1, "test": 1}, n_time=12)
    spring = SPRING + [f"datamodule.data_dir={spring_data}"]
    out = {}
    for world in (WORLD, 1):
        reg = str(root / f"registry{world}")
        common = TINY + [f"datamodule.batch_size={4 // world}", f"trainer.devices={world}", f"registry_dir={reg}"]
        spring_w = spring + [f"datamodule.batch_size={4 // world}", f"trainer.devices={world}"]
        mcvd = MCVD + [f"datamodule.batch_size={4 // world}", f"trainer.devices={world}", f"registry_dir={reg}"]
        if world == 1:
            # one thread, as each spawned rank runs: CPU sums split by thread,
            # and the val metrics and predictions are held at 1e-5
            threads = torch.get_num_threads()
            torch.set_num_threads(1)
            try:
                ranks = [workers.train_rank(0, 1, common, common, spring_w, reg, mcvd)]
            finally:
                torch.set_num_threads(threads)
        else:
            fault = mcvd[:-1] + [f"registry_dir={root / 'own_gamma'}"]
            ranks = workers.run_ranks(workers.train_rank, world, common, common, spring_w, reg, mcvd, fault)
        out[world] = dict(ranks=ranks, registry=reg)
    out["own_gamma"] = str(root / "own_gamma")
    out["spring_rank0_alone"] = workers.spring_step(
        get_config("spring_mesh_interpolation", spring + ["datamodule.batch_size=2"]))
    return out


def _metrics(registry, run_id):
    with open(os.path.join(registry, run_id, "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


def _initial_weights(registry, run_id):
    """The run's weights before its first step: its config built anew."""
    with open(os.path.join(registry, run_id, "config.json")) as f:
        config = json.load(f)
    config["trainer"]["devices"] = 1
    return {k: v.clone() for k, v in build_trainer(config, device="cpu").state.model.state_dict().items()}


def _state(registry, run_id):
    return torch.load(os.path.join(registry, run_id, "last", "state.pt"), weights_only=True)


@pytest.mark.parametrize("stage", ["run1", "run2"])
def test_two_ranks_train_as_one_process(runs, stage):
    two, one = runs[WORLD], runs[1]
    run_id = two["ranks"][0][stage]
    assert run_id == one["ranks"][0][stage] and run_id == two["ranks"][1][stage]  # the effective batch is hashed
    got, want = _metrics(two["registry"], run_id), _metrics(one["registry"], run_id)
    assert [r["step"] for r in got] == [r["step"] for r in want]
    losses = [(a["train/loss"], b["train/loss"]) for a, b in zip(got, want) if "train/loss" in b]
    assert len(losses) == 3
    for g, w in losses:
        np.testing.assert_allclose(g, w, rtol=REL)
    val = [(a, b) for a, b in zip(got, want) if "val/crps" in b]
    assert len(val) == 1
    for k, w in val[0][1].items():
        if k.startswith("val/") and "frames_per_sec" not in k:
            np.testing.assert_allclose(val[0][0][k], w, rtol=REL, atol=1e-6 if k.endswith("ssr") else 0, err_msg=k)
    s2, s1 = _state(two["registry"], run_id), _state(one["registry"], run_id)
    assert s2["step"] == s1["step"] == 3 and len(s2["rank_generators"]) == WORLD and "rank_generators" not in s1
    init = _initial_weights(one["registry"], run_id)
    for part in ("model", "ema"):
        keys = [k for k, w in s1[part].items() if w.is_floating_point() and k in init]
        num = sum(float(((s2[part][k] - s1[part][k]) ** 2).sum()) for k in keys)
        den = sum(float(((s1[part][k] - init[k]) ** 2).sum()) for k in keys)
        assert (num / den) ** 0.5 <= CHANGE_REL, (part, (num / den) ** 0.5)


def _mcvd_trains_as(registry, want_registry, run_id):
    """The MCVD run ``run_id`` of ``registry`` against that of
    ``want_registry``: every logged loss within REL relative, the final
    weights within CHANGE_REL of their change (relative L2)."""
    got, want = _metrics(registry, run_id), _metrics(want_registry, run_id)
    losses = [(a["train/loss"], b["train/loss"]) for a, b in zip(got, want) if "train/loss" in b]
    assert len(losses) == 3
    for g, w in losses:
        np.testing.assert_allclose(g, w, rtol=REL)
    s2, s1 = _state(registry, run_id), _state(want_registry, run_id)
    init = _initial_weights(want_registry, run_id)
    keys = [k for k, w in s1["model"].items() if w.is_floating_point() and k in init]
    num = sum(float(((s2["model"][k] - s1["model"][k]) ** 2).sum()) for k in keys)
    den = sum(float(((s1["model"][k] - init[k]) ** 2).sum()) for k in keys)
    assert (num / den) ** 0.5 <= CHANGE_REL, (num / den) ** 0.5


def test_two_ranks_train_mcvd_with_gamma_noise_as_one_process(runs):
    """MCVD's Gamma draws (the loss's noise and the condition's) are the
    global batch's, each rank keeping its rows, as the normal draws are."""
    run_id = runs[WORLD]["ranks"][0]["mcvd"]
    assert [r["mcvd"] for r in runs[WORLD]["ranks"]] == [run_id] * WORLD == [runs[1]["ranks"][0]["mcvd"]] * WORLD
    _mcvd_trains_as(runs[WORLD]["registry"], runs[1]["registry"], run_id)


def test_per_rank_gamma_draws_fail_the_check(runs):
    """The planted fault: each rank draws the Gamma noise of its rows from
    its own generator."""
    run_id = runs[WORLD]["ranks"][0]["mcvd_fault"]
    assert run_id == runs[1]["ranks"][0]["mcvd"]
    with pytest.raises(AssertionError):
        _mcvd_trains_as(runs["own_gamma"], runs[1]["registry"], run_id)


def test_two_ranks_predict_every_row(runs):
    got, want = runs[WORLD]["ranks"], runs[1]["ranks"][0]["predict"]
    for r in got:
        assert sorted(r["predict"]) == sorted(want)
        for k, w in want.items():
            _close(r["predict"][k], w, REL, k)


def test_rank_one_writes_nothing_to_the_registry(runs):
    two = runs[WORLD]["ranks"]
    assert two[1]["writes"] == []
    assert any(kind == "save" for kind, _ in two[0]["writes"])
    run1 = two[0]["run1"]
    assert os.path.exists(os.path.join(runs[WORLD]["registry"], run1, ".shared_fs_probe"))
    assert len(_metrics(runs[WORLD]["registry"], run1)) == len(_metrics(runs[1]["registry"], run1))


@pytest.mark.parametrize("what", ["loss", "grads", "stats"])
def test_spring_step_on_two_ranks_equals_one_process(runs, what):
    got = runs[WORLD]["ranks"]
    want = runs[1]["ranks"][0]["spring"]
    alone = runs["spring_rank0_alone"]
    assert want["n_batch_norms"] > 0
    if what == "loss":
        for r in got:
            np.testing.assert_allclose(r["spring"]["loss"], want["loss"], rtol=REL)
        assert abs(alone["loss"] - want["loss"]) > 1e-4 * abs(want["loss"])
        return
    for r in got:
        _close_with_floor(r["spring"][what], want[what], REL, what)
    # the negative control: rank 0's rows with their own statistics
    with pytest.raises(AssertionError):
        _close_with_floor(alone[what], want[what], REL, what)


def test_cli_two_rank_test_mode_matches_one_process(runs):
    """``mode=test`` of the two-rank stage-2 run through the CLI: it reads
    ``trainer.devices=2`` from the stored config and starts two ranks."""
    run2 = runs[WORLD]["ranks"][0]["run2"]
    cmd = [sys.executable, "-m", "dyffusion_tpu_torch.train", "mode=test", f"run_id={run2}",
           f"registry_dir={runs[WORLD]['registry']}", "--device=cpu"]
    env = {**os.environ, "OMP_NUM_THREADS": "1"}
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env,
                            start_new_session=True, cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    try:
        stdout, stderr = proc.communicate(timeout=workers.JOIN_TIMEOUT_S)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        proc.communicate()
        raise AssertionError("mode=test on two ranks did not finish within 120 s")
    assert proc.returncode == 0, stderr[-3000:]
    lines = [json.loads(line) for line in stdout.splitlines() if line.startswith("{")]
    assert len(lines) == 1  # rank 0 alone prints
    got = lines[0]
    want = reload_and_test(runs[1]["registry"], run2, device="cpu")
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        if "frames_per_sec" not in k:
            np.testing.assert_allclose(got[k], w, rtol=REL, atol=1e-6 if k.endswith("ssr") else 0, err_msg=k)


# ---------------------------------------------------------------------------
# one process


def test_native_loader_rows_are_the_global_batch_slices():
    config = get_config("synthetic_interpolation", TINY + ["datamodule.batch_size=4"])
    tr = build_trainer(config, device="cpu")
    dm = tr.datamodule
    want = list(dm.train_batches(rng=np.random.default_rng(3)))
    assert len(want) > 1
    for rank in range(WORLD):
        rows = process_local_rows(dm.batch_size, rank, WORLD)
        got = list(dm.train_loader(rng=np.random.default_rng(3), rows=rows))
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert sorted(g) == sorted(w)
            for k in w:
                np.testing.assert_array_equal(g[k], w[k][rows])
        sharded = shard_batch(want[0], "cpu", rank, WORLD)
        for k in want[0]:
            np.testing.assert_array_equal(sharded[k].numpy(), want[0][k][rows])
    with pytest.raises(ValueError):
        process_local_rows(5, 0, WORLD)


def test_run_id_hashes_the_world_as_the_jax_package():
    for devices in (1, 2, "auto"):
        ov = TINY + ["datamodule.batch_size=2", f"trainer.devices={devices}"]
        assert get_run_id(get_config("synthetic_interpolation", ov)) == \
            jax_run_id(jax_config.get_config("synthetic_interpolation", ov))
    two = get_run_id(get_config("synthetic_interpolation", TINY + ["datamodule.batch_size=2", "trainer.devices=2"]))
    one = get_run_id(get_config("synthetic_interpolation", TINY + ["datamodule.batch_size=4", "trainer.devices=1"]))
    assert two == one


def test_world_must_match_trainer_devices():
    with pytest.raises(ValueError, match="trainer.devices=2"):
        build_trainer(get_config("synthetic_interpolation", TINY + ["trainer.devices=2"]), device="cpu")
    # training under a shard runs: on one process only the world is refused (K must divide it),
    # and the layouts a shard once refused run under a one-rank shard as without one
    with pytest.raises(ValueError, match="not divisible by trainer.spatial_shards=2"):
        run_experiment(get_config("synthetic_interpolation", TINY + ["trainer.spatial_shards=2"]), device="cpu")
    assert_thin_layouts_match([thin_layouts(0, 1)], REL)
