"""The port's run registry on the CPU: run ids and configs against the JAX
package's, the registry queries over ``runs_flagship``, the CLI's two-stage
handoff through the registry and ``mode=test``, exact resume, resume across
accumulation layouts, sweeps, serving a run by id with its EMA weights, the
config keys and settings the JAX package accepts, the frozen interpolator's
copy, and the CUDA default of the new entry points."""
import glob
import json
import os

import numpy as np
import pytest
import torch

from dyffusion_tpu import config as jax_config
from dyffusion_tpu.utils import naming as jax_naming
from dyffusion_tpu.utils import registry_api as jax_registry
from dyffusion_tpu_torch import train
from dyffusion_tpu_torch.config import get_config
from dyffusion_tpu_torch.interface import build_trainer, load_interpolator_from_registry, reload_trainer, run_experiment
from dyffusion_tpu_torch.serving import build_predict_fn
from dyffusion_tpu_torch.training import TrainState
from dyffusion_tpu_torch.utils import registry_api
from dyffusion_tpu_torch.utils.naming import get_run_id
from tests._torch_port_helpers import torch_threads_share_of_cores  # noqa: F401 (autouse fixture)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FLAGSHIP = os.path.join(ROOT, "runs_flagship")
PRESETS = ("synthetic_interpolation", "synthetic_dyffusion") + tuple(
    f"{dataset}_{method}"
    for dataset in ("synthetic", "navier_stokes", "spring_mesh")
    for method in ("time_conditioned", "simultaneous", "ddpm", "ddpm_v2", "mcvd")
) + tuple(
    f"oisst_pacific_{method}"
    for method in ("interpolation", "dyffusion", "time_conditioned", "simultaneous", "ddpm", "ddpm_v2", "mcvd")
)
TINY = [
    "datamodule.spatial=(8,8)", "datamodule.channels=1", "datamodule.horizon=3",
    "datamodule.n_traj=5", "datamodule.n_time=8", "datamodule.batch_size=4",
    "datamodule.eval_batch_size=2", "model.dim=8", "model.dim_mults=(1,)",
    "module.num_predictions=2", "module.num_predictions_test=3", "diffusion.additional_interpolation_steps=1",
]
RUN_FILES = {"best", "last", "config.json", "meta.json", "metrics.jsonl", "hparams.json"}
META_KEYS = {"best_score", "best_monitor", "best_step", "last_step", "epochs_done"}

# ---------------------------------------------------------------------------
# run ids and configs, against the JAX package
# ---------------------------------------------------------------------------
OVERRIDES = {
    "preset": [],
    "volatile": ["trainer.max_epochs=3", "trainer.max_steps=5", "registry_dir=/elsewhere", "trainer.log_every_n_steps=2"],
    "seed": ["seed=3"],
    "width": ["model.dim=16"],
    "ema_acc2": ["module.use_ema=true", "trainer.accumulate_grad_batches=2"],
    "ema_acc2_folded": ["module.use_ema=true", "trainer.accumulate_grad_batches=2",
                        "trainer.fold_accumulation_into_batch=true"],
    "batch8_acc2": ["datamodule.batch_size=8", "trainer.accumulate_grad_batches=2"],
    "jax_top_level_keys": ["debug=false", "jax_debug_nans=false", "matmul_precision=high",
                           "torch_matmul_precision=high", "use_wandb=false", "perf=parity"],
    "debug": ["debug=true"],
    "perf_measured": ["perf=measured"],
}


@pytest.mark.parametrize("preset", PRESETS)
@pytest.mark.parametrize("case", sorted(OVERRIDES))
def test_config_and_run_id_match_jax(preset, case):
    """The port accepts every override the JAX package takes here, resolves
    it to the same dict and names the run the same."""
    want = jax_config.get_config(preset, OVERRIDES[case])
    got = get_config(preset, OVERRIDES[case])
    assert got == want
    assert get_run_id(got) == jax_naming.get_run_id(want)


def test_run_id_keeps_science_and_drops_volatile_keys():
    ids = {case: get_run_id(get_config("synthetic_dyffusion", ov)) for case, ov in OVERRIDES.items()}
    assert ids["volatile"] == ids["preset"]
    assert len({ids[c] for c in ("preset", "seed", "width", "ema_acc2")}) == 4
    # the same effective batch (8 x 2 = 16) is the same science without an EMA; a
    # folded layout is the same science with one (it replays the micro-batch cadence)
    assert ids["batch8_acc2"] == ids["preset"] and ids["ema_acc2_folded"] == ids["ema_acc2"]


def test_perf_modes():
    """perf=measured: the JAX package's recipes, applied before the dotted
    overrides (a user's key wins), keeping the run id of the parity layout;
    with the EMA on, the re-batching stage-2 recipe is refused as the JAX
    package refuses it; an unknown mode is an error."""
    for preset, overrides in (("oisst_pacific_interpolation", []), ("oisst_pacific_dyffusion", []),
                              ("oisst_pacific_dyffusion", ["datamodule.batch_size=96"]),
                              ("synthetic_dyffusion", ["perf=parity", "perf=measured"])):
        want = jax_config.get_config(preset, overrides + ["perf=measured"])
        got = get_config(preset, overrides + ["perf=measured"])
        assert got == want
        assert get_run_id(got) == jax_naming.get_run_id(want)
    measured = get_config("oisst_pacific_dyffusion", ["perf=measured"])
    assert (measured["datamodule"]["batch_size"], measured["trainer"]["accumulate_grad_batches"],
            measured["model"]["remat"]) == (128, 2, True)
    assert get_run_id(measured) == get_run_id(get_config("oisst_pacific_dyffusion"))
    assert get_config("oisst_pacific_interpolation", ["perf=measured"])["trainer"]["fold_accumulation_into_batch"]
    assert get_config("oisst_pacific_dyffusion", ["perf=measured", "datamodule.batch_size=96"])[
        "datamodule"]["batch_size"] == 96
    for mod in (jax_config, None):
        with pytest.raises(ValueError, match="EMA update cadence"):
            (mod.get_config if mod else get_config)("oisst_pacific_dyffusion", ["perf=measured", "module.use_ema=true"])
    with pytest.raises(ValueError, match="unknown perf mode"):
        get_config("synthetic_dyffusion", ["perf=fast"])


@pytest.mark.parametrize("path", sorted(glob.glob(os.path.join(FLAGSHIP, "*", "config.json"))))
def test_flagship_run_ids(path):
    with open(path) as f:
        config = json.load(f)
    assert get_run_id(config) == os.path.basename(os.path.dirname(path))


@pytest.mark.parametrize("query", [
    lambda api: api.list_runs(FLAGSHIP),
    lambda api: [api.get_run_config(FLAGSHIP, r) for r in api.list_runs(FLAGSHIP)],
    lambda api: [api.get_run_meta(FLAGSHIP, r) for r in api.list_runs(FLAGSHIP)],
    lambda api: [api.get_run_metrics(FLAGSHIP, r) for r in api.list_runs(FLAGSHIP)],
    lambda api: [api.filter_runs(FLAGSHIP, **kw) for kw in
                 ({"group_contains": "dyffusion"}, {"seed": 7}, {"seed": 8}, {"experiment": "interpolation"})],
    lambda api: api.get_runs_summary(FLAGSHIP),
    lambda api: api.metrics_of_runs_to_arrays(FLAGSHIP, api.list_runs(FLAGSHIP), "val/crps"),
], ids=["list_runs", "get_run_config", "get_run_meta", "get_run_metrics", "filter_runs", "get_runs_summary",
        "metrics_of_runs_to_arrays"])
def test_registry_api_matches_jax(query):
    want = query(jax_registry)
    assert want  # the flagship registry is not empty
    assert query(registry_api) == want


# ---------------------------------------------------------------------------
# the CLI: stage 1, stage 2 through the registry, mode=test
# ---------------------------------------------------------------------------
def _cli(args, capsys):
    """train.main on the CPU; returns its printed JSON line."""
    train.main(args + ["--device=cpu"])
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


@pytest.fixture(scope="module")
def cli_registry(tmp_path_factory):
    """Stage 1 then stage 2 (``diffusion.interpolator_run_id``) through the
    CLI into one registry, EMA on; returns (registry, stage-1 args, stage-1
    id, stage-2 args, stage-2 id)."""
    reg = str(tmp_path_factory.mktemp("registry"))
    common = TINY + ["trainer.max_epochs=2", "module.use_ema=true", "module.optimizer.lr=3e-3",
                     f"registry_dir={reg}"]
    a1 = ["experiment=synthetic_interpolation"] + common
    train.main(a1 + ["--device=cpu"])
    id1 = get_run_id(get_config("synthetic_interpolation", common))
    a2 = ["experiment=synthetic_dyffusion", f"diffusion.interpolator_run_id={id1}"] + common
    train.main(a2 + ["--device=cpu"])
    id2 = get_run_id(get_config("synthetic_dyffusion", a2[1:]))
    return reg, a1, id1, a2, id2


@pytest.mark.parametrize("stage", [1, 2])
def test_cli_run_directory_matches_jax_layout(cli_registry, stage):
    reg, a1, id1, a2, id2 = cli_registry
    args, run_id = (a1, id1) if stage == 1 else (a2, id2)
    run_dir = os.path.join(reg, run_id)
    assert RUN_FILES <= set(os.listdir(run_dir))
    with open(os.path.join(run_dir, "meta.json")) as f:
        meta = json.load(f)
    assert set(meta) == META_KEYS and meta["last_step"] == 2 * 3 and meta["epochs_done"] == 2
    with open(os.path.join(run_dir, "config.json")) as f:
        stored = json.load(f)
    assert stored == json.loads(json.dumps(jax_config.get_config(args[0].split("=", 1)[1], args[1:])))
    assert registry_api.get_runs_summary(reg, [run_id])[0]["best_score"] == meta["best_score"]
    assert any("val/crps" in r for r in registry_api.get_run_metrics(reg, run_id))


def test_cli_stage2_from_registry_equals_in_memory_interpolator(cli_registry):
    """Stage 2 through ``diffusion.interpolator_run_id`` takes the same first
    step as stage 2 with the reloaded stage-1 model passed in memory; a
    stage 2 over an untrained interpolator does not (negative control)."""
    reg, a1, id1, a2, id2 = cli_registry
    config = get_config("synthetic_dyffusion", a2[1:])
    stage1 = reload_trainer(reg, id1, device="cpu").experiment.model
    fresh = build_trainer(get_config("synthetic_interpolation", a1[1:]), device="cpu").experiment.model
    losses = []
    for interpolator in (None, stage1, fresh):
        trainer = build_trainer(config, interpolator=interpolator, device="cpu")
        batch = next(trainer.datamodule.train_batches(rng=np.random.default_rng(0)))
        losses.append(float(trainer.train_step(trainer.state, trainer._put(batch))["loss"]))
    assert losses[0] == losses[1]
    assert losses[2] != losses[0]


def test_cli_mode_test(cli_registry, capsys):
    reg, _, _, _, id2 = cli_registry
    metrics = _cli(["mode=test", f"run_id={id2}", f"registry_dir={reg}"], capsys)
    assert np.isfinite(metrics["test/crps"]) and {"test/t1/crps", "test/t3/ssr", "test/mse"} <= set(metrics)
    curves = set(os.listdir(os.path.join(reg, id2, "curves")))
    assert {"test_crps.npz", "test_crps.json", "test_mse.json", "test_ssr.npz"} <= curves
    with open(os.path.join(reg, id2, "curves", "test_crps.json")) as f:
        table = json.load(f)
    assert table["horizon"] == [1, 2, 3] and np.allclose(np.mean(table["crps"]), metrics["test/crps"])


def test_serving_by_run_id_serves_the_ema(cli_registry):
    """C1: the registry-served forecast is the EMA weights' eval, not the
    live weights' (negative control)."""
    reg, _, _, _, id2 = cli_registry
    predict, specs, info = build_predict_fn(reg, id2, device="cpu")
    assert info["run_id"] == id2 and info["slot"] == "best" and specs["dynamics"].shape[1] == 1
    trainer = reload_trainer(reg, id2, device="cpu")
    assert trainer.state.use_ema and trainer.state.ema_num_updates == trainer.state.step > 0
    batch = next(trainer.datamodule.predict_batches())
    served = predict(batch, 5)
    torch.testing.assert_close(predict(batch, 5), served, rtol=0, atol=0)

    def members(params):
        out = trainer.eval_fns["predict"](batch, torch.Generator().manual_seed(5), params)
        return torch.stack([out[f"t{i}_preds"] for i in (1, 2, 3)], dim=2)

    torch.testing.assert_close(served, members(trainer.state.eval_params()), rtol=0, atol=0)
    assert float((served - members(None)).abs().max()) > 1e-3 * float(served.abs().max())


def test_predict_concatenates_the_split(cli_registry):
    """Trainer.predict: every batch's members and targets of the split, in
    order (5 test rows in batches of 2, 2 and 1; 3 test members)."""
    reg, _, _, _, id2 = cli_registry
    trainer = reload_trainer(reg, id2, device="cpu")
    out = trainer.predict("test")
    assert sorted(out) == sorted(f"t{i}_{kind}" for i in (1, 2, 3) for kind in ("preds", "targets"))
    assert out["t1_preds"].shape == (3, 5, 8, 8, 1) and np.isfinite(out["t3_preds"]).all()
    np.testing.assert_array_equal(out["t2_targets"], trainer.datamodule.split("test").tensors["dynamics"][:, 2])


def test_registry_interpolator_ema_and_missing_run(cli_registry):
    reg, _, id1, _, _ = cli_registry
    live, s1 = load_interpolator_from_registry(reg, id1, device="cpu")
    ema, _ = load_interpolator_from_registry(reg, id1, use_ema=True, device="cpu")
    state = torch.load(os.path.join(reg, id1, "best", "state.pt"), weights_only=True)
    for name, p in ema.named_parameters():
        assert not p.requires_grad and torch.equal(p, state["ema"][name])
        assert torch.equal(dict(live.named_parameters())[name], state["model"][name])
    assert s1["datamodule"]["horizon"] == 3
    with pytest.raises(FileNotFoundError, match="not found"):
        load_interpolator_from_registry(reg, "no_such_run", device="cpu")


def test_orbax_slot_is_refused(tmp_path):
    """A slot the port did not write (the JAX package's orbax directory) is
    an error, not a silent fresh start."""
    config = get_config("synthetic_interpolation", TINY + [f"registry_dir={tmp_path}", "trainer.max_epochs=1"])
    slot = os.path.join(tmp_path, get_run_id(config), "last")
    os.makedirs(slot)
    open(os.path.join(slot, "_METADATA"), "w").close()
    with pytest.raises(ValueError, match="not written by dyffusion_tpu_torch"):
        run_experiment(config, device="cpu")


# ---------------------------------------------------------------------------
# resume
# ---------------------------------------------------------------------------
# one train row (2 trajectories of window + horizon frames: one train, one
# val/test), so each epoch is one batch whatever the shuffle: the trainer's
# shuffle generator is not checkpointed (nor is it in the JAX package)
ONE_ROW = TINY + [
    "datamodule.n_traj=2", "datamodule.n_time=4", "datamodule.batch_size=1", "model.block_dropout=0.3",
    "module.use_ema=true", "module.optimizer.lr=1e-2",
    "module.scheduler={'name': 'warmup_cosine', 'warm_up_steps': 1, 'lr_min': 0.1, 'lr_max': 1.0, "
    "'lr_start': 0.5, 'max_decay_steps': 4}",
]


def _state_and_next_loss(trainer):
    weights = {k: v.clone() for k, v in trainer.experiment.model.state_dict().items()}
    ema = {k: v.clone() for k, v in trainer.state.ema.items()}
    batch = next(trainer.datamodule.train_batches())
    return trainer.state.step, weights, ema, float(trainer.train_step(trainer.state, trainer._put(batch))["loss"])


def _assert_same(a, b):
    assert a[0] == b[0] and a[3] == b[3]
    for x, y in ((a[1], b[1]), (a[2], b[2])):
        assert all(torch.equal(x[k], y[k]) for k in x)


@pytest.mark.parametrize("restore_generator", [True, False])
def test_resume_is_exact(tmp_path, monkeypatch, restore_generator):
    """Two epochs in one run == one epoch, a restart, one more epoch:
    weights, EMA, step and the next step's loss, bit for bit. The negative
    control restarts without the step generator's state: dropout draws
    repeat, and the runs part."""
    def run(registry, epochs):
        config = get_config("synthetic_interpolation", ONE_ROW + [f"registry_dir={registry}", f"trainer.max_epochs={epochs}"])
        return run_experiment(config, device="cpu")[0]

    whole = _state_and_next_loss(run(tmp_path / "whole", 2))
    run(tmp_path / "split", 1)
    if not restore_generator:
        load = TrainState.load_state_dict

        def load_without_generator(self, state):
            kept = self.generator.get_state()
            load(self, state)
            self.generator.set_state(kept)

        monkeypatch.setattr(TrainState, "load_state_dict", load_without_generator)
    resumed = run(tmp_path / "split", 2)
    assert [h["epoch"] for h in resumed.history] == [1]
    split = _state_and_next_loss(resumed)
    if restore_generator:
        _assert_same(split, whole)
    else:
        assert split[0] == whole[0] and split[3] != whole[3]


@pytest.mark.parametrize("saved,restored", [("accumulated", "folded"), ("folded", "accumulated")])
def test_resume_across_accumulation_layouts(tmp_path, saved, restored):
    """A run saved under accumulate_grad_batches=2 restores into the folded
    layout and the other way round: the same run id, the optimizer's and
    the schedule's state loaded, a fresh accumulation cycle."""
    layouts = {"accumulated": ["trainer.accumulate_grad_batches=2"],
               "folded": ["trainer.accumulate_grad_batches=2", "trainer.fold_accumulation_into_batch=true"]}
    # 12 train rows: 6 micro-batches of 2 (3 updates) or 3 folded batches of 4 per epoch
    base = TINY + ["datamodule.n_time=7", "datamodule.batch_size=2", f"registry_dir={tmp_path}"]
    first = get_config("synthetic_interpolation", base + layouts[saved] + ["trainer.max_epochs=1"])
    second = get_config("synthetic_interpolation", base + layouts[restored] + ["trainer.max_epochs=2"])
    assert get_run_id(first) == get_run_id(second)
    tr1, _ = run_experiment(first, device="cpu")
    saved_opt = tr1.state.optimizer.state_dict()
    tr2 = build_trainer(second, device="cpu", run_dir=tr1.ckpt.run_dir)
    assert tr2.maybe_resume()
    opt = tr2.state.optimizer
    assert opt.mini_step == 0 and opt._acc is None and tr2.state.step == tr1.state.step
    for k, s in saved_opt["optimizer"]["state"].items():
        assert all(torch.equal(s[n], opt.optimizer.state_dict()["state"][k][n]) for n in s)
    tr2.fit()
    assert [h["epoch"] for h in tr2.history] == [1] and tr2.state.step == 2 * tr1.state.step


# ---------------------------------------------------------------------------
# sweeps
# ---------------------------------------------------------------------------
def test_split_sweep_values_respects_brackets():
    assert train._split_sweep_values("1e-4,3e-4") == ["1e-4", "3e-4"]
    assert train._split_sweep_values("(1,2)") == ["(1,2)"]
    assert train._split_sweep_values("(1,2),(1,2,4)") == ["(1,2)", "(1,2,4)"]
    assert train._split_sweep_values("[60,60]") == ["[60,60]"]
    assert train._split_sweep_values("single") == ["single"]


def test_expand_multirun_cartesian_order():
    combos = train.expand_multirun(["experiment=x", "a=1,2", "b=u,v", "c=(1,2)"])
    assert len(combos) == 4
    assert combos[0] == ["experiment=x", "a=1", "b=u", "c=(1,2)"]
    assert combos[-1] == ["experiment=x", "a=2", "b=v", "c=(1,2)"]
    assert train.expand_multirun(["a=1", "b=(1,2)"]) == [["a=1", "b=(1,2)"]]


def test_multirun_end_to_end(tmp_path, capsys):
    summary = _cli(["-m", "experiment=synthetic_interpolation", *TINY, "module.optimizer.lr=1e-4,3e-4",
                    "trainer.max_epochs=1", "trainer.max_steps=2", f"registry_dir={tmp_path}"], capsys)
    assert summary["multirun"] == 2 and len(summary["results"]) == 2 and np.isfinite(summary["best"])
    assert len(registry_api.list_runs(str(tmp_path))) == 2


# ---------------------------------------------------------------------------
# C3 settings, C4, the device default
# ---------------------------------------------------------------------------
@pytest.fixture
def torch_numerics():
    """Restore torch's matmul precision and cuDNN TF32 flag after a test."""
    before = torch.get_float32_matmul_precision(), torch.backends.cudnn.allow_tf32
    yield
    torch.set_float32_matmul_precision(before[0])
    torch.backends.cudnn.allow_tf32 = before[1]


@pytest.mark.parametrize("precision", ["highest", "high"])
def test_matmul_precision_and_debug_nans_apply(tmp_path, torch_numerics, precision):
    torch.backends.cudnn.allow_tf32 = precision == "highest"  # the opposite of what the config sets
    anomaly = []
    config = get_config("synthetic_interpolation", TINY + [
        f"matmul_precision={precision}", "jax_debug_nans=true", "trainer.max_steps=1", "trainer.max_epochs=1",
        f"registry_dir={tmp_path}"])
    run_experiment(config, device="cpu", log_fn=lambda m, s: anomaly.append(torch.is_anomaly_enabled()))
    assert torch.get_float32_matmul_precision() == precision
    assert torch.backends.cudnn.allow_tf32 == (precision != "highest")
    assert anomaly and all(anomaly) and not torch.is_anomaly_enabled()


def test_debug_mode_runs_two_steps_without_checkpoints(tmp_path):
    config = get_config("synthetic_interpolation", TINY + ["debug=true", f"registry_dir={tmp_path}"])
    trainer, best = run_experiment(config, device="cpu")
    assert trainer.state.step == 2 and trainer.ckpt is None and np.isfinite(best)
    assert set(os.listdir(os.path.join(tmp_path, get_run_id(config)))) == {"hparams.json", "metrics.jsonl"}


def test_stage2_build_leaves_stage1_trainable():
    """C4: the stage-2 engine freezes a copy of the in-memory interpolator;
    stage 1's own model keeps its gradients and trains on."""
    tr1 = build_trainer(get_config("synthetic_interpolation", TINY + ["trainer.max_steps=1"]), device="cpu")
    tr2 = build_trainer(get_config("synthetic_dyffusion", TINY), interpolator=tr1.experiment.model, device="cpu")
    copy = tr2.experiment.engine.interpolator
    assert copy is not tr1.experiment.model and not any(p.requires_grad for p in copy.parameters())
    assert all(p.requires_grad for p in tr1.experiment.model.parameters())
    before = {k: v.clone() for k, v in tr1.experiment.model.state_dict().items()}
    tr1.fit()
    assert tr1.state.step == 1
    assert any(not torch.equal(v, before[k]) for k, v in tr1.experiment.model.state_dict().items())
    assert all(torch.equal(v, before[k]) for k, v in copy.state_dict().items())


def test_new_entry_points_default_to_cuda(cli_registry):
    """Without --device / device=, the registry entry points run on the GPU
    or raise; they do not fall back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA: the default runs there")
    reg, a1, _, _, id2 = cli_registry
    for call in (
        lambda: reload_trainer(reg, id2),
        lambda: build_predict_fn(reg, id2),
        lambda: train.main(["mode=test", f"run_id={id2}", f"registry_dir={reg}"]),
        lambda: train.main(a1),
    ):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
