"""The port's exported sampler (``serving.export_run`` / ``load_exported``)
on the CPU, at a tiny width.

The artifact of a stage-2 run (two autoregressive windows, the EMA on)
answers as the eager ``build_predict_fn`` does, bit for bit, for any batch
from one symbolic export; a pinned export rejects another batch; the
``mean_std`` artifact is the host reduction of the members; the graph holds
one B1 node per ``LinearAttention`` call of a request, those of the
sampler's steps once in its loop op's body; the
artifact directory, moved away, serves in a process that imports nothing of
the package but ``ops`` and ``serving``; the spring mesh's boundary
conditions live inside its artifact; the CLI rejects malformed arguments;
the kernels' ``torch.library`` ops pass ``opcheck``; and a dropout-free
export matches the JAX package's eval on the same converted weights.
The exports are shared by module fixtures: each costs seconds.
"""
import json
import os
import shutil
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from chip_smoke import _boundary_error
from dyffusion_tpu import config as jax_config
from dyffusion_tpu import interface as jax_interface
from dyffusion_tpu.models import make_apply_fn
from dyffusion_tpu_torch import config as port_config
from dyffusion_tpu_torch import interface as port_interface
from dyffusion_tpu_torch import serving
from dyffusion_tpu_torch.data import write_fake_benchmark_dir
from dyffusion_tpu_torch.interface import reload_trainer, run_experiment
from dyffusion_tpu_torch.models import unet_state_dict_from_jax
from dyffusion_tpu_torch.models.modules import LinearAttention
from tests._torch_port_helpers import to_numpy_tree
from tests._torch_port_helpers import torch_threads_share_of_cores  # noqa: F401 (autouse fixture)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = dict(atol=1e-4, rtol=1e-4)  # test_torch_port_sampler.py's, f32 sums in another order
# horizon 2 without auxiliary steps: 3 network forwards per sampler window
TINY = [
    "datamodule.spatial=(8,8)", "datamodule.channels=1", "datamodule.horizon=2",
    "datamodule.n_traj=5", "datamodule.n_time=8", "datamodule.batch_size=4",
    "datamodule.eval_batch_size=2", "model.dim=8", "model.dim_mults=(1,)", "model.block_dropout=0.2",
    "module.num_predictions=2", "module.num_predictions_test=3", "diffusion.additional_interpolation_steps=0",
    "trainer.max_epochs=1",
]


def _batch(specs, batch_size, seed=0):
    rng = np.random.default_rng(seed)
    return {k: rng.standard_normal((batch_size,) + s.shape[1:]).astype(s.dtype) for k, s in specs.items()}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """A stage-1 run and a stage-2 run from it, prediction horizon twice the
    horizon (two chained windows), the EMA on."""
    registry = str(tmp_path_factory.mktemp("registry"))
    common = TINY + [f"registry_dir={registry}"]
    t1, best1 = run_experiment(port_config.get_config("synthetic_interpolation", common), device="cpu")
    stage2 = common + ["datamodule.prediction_horizon=4", "module.use_ema=true",
                       f"diffusion.interpolator_run_id={os.path.basename(t1.ckpt.run_dir)}"]
    t2, best2 = run_experiment(port_config.get_config("synthetic_dyffusion", stage2), device="cpu")
    assert np.isfinite(best1) and np.isfinite(best2)
    return registry, os.path.basename(t1.ckpt.run_dir), os.path.basename(t2.ckpt.run_dir)


@pytest.fixture(scope="module")
def stage2(runs, tmp_path_factory):
    """The stage-2 artifact (symbolic batch), served, and the eager predict."""
    registry, _, run2 = runs
    out = str(tmp_path_factory.mktemp("stage2"))
    serving.export_run(registry, run2, out, device="cpu")
    served, manifest = serving.load_exported(out)
    predict, specs, info = serving.build_predict_fn(registry, run2, device="cpu")
    return out, served, manifest, predict, specs, info


@pytest.fixture(scope="module")
def stage1(runs, tmp_path_factory):
    """Stage-1 artifacts through the CLI, batch pinned to 2: the members and
    the mean_std reduction."""
    registry, run1, _ = runs
    outs = {}
    for reduce in ("none", "mean_std"):
        outs[reduce] = str(tmp_path_factory.mktemp(f"stage1_{reduce}"))
        args = [f"run_id={run1}", f"out={outs[reduce]}", f"registry_dir={registry}", "polymorphic_batch=false",
                "batch_size=2", "device=cpu"] + ([f"reduce={reduce}"] if reduce != "none" else [])
        assert serving._main(args) == os.path.join(outs[reduce], "sampler.pt2")
    return outs


def test_stage2_artifact_is_the_eager_predict_bit_for_bit(stage2):
    _, served, manifest, predict, specs, info = stage2
    batch = _batch(specs, 2)
    want = predict(batch, 3)
    got = served(batch, 3)
    assert tuple(got.shape) == (2, 2, 4, 8, 8, 1) and got.dtype == torch.float32
    assert torch.equal(got, want)
    assert torch.equal(served(batch, 3), got)  # the same seed repeats
    assert float((served(batch, 4) - got).abs().max()) > 1e-3  # another seed does not
    assert manifest["run_id"] == info["run_id"] and manifest["experiment"] == "DyffusionForecastingExperiment"
    assert manifest["inputs"] == {"dynamics": {"shape": ["b", 1, 8, 8, 1], "dtype": "float32"}}
    assert manifest["output"]["shape"] == [2, "b", 4, 8, 8, 1] and manifest["polymorphic_batch"] is True
    assert manifest["platforms"] == ["cpu"] and manifest["attention_kernel"] == "plain"
    assert manifest["devices"] == 1 and manifest["dynamics_frames_read"] == [0]


def test_stage2_artifact_serves_any_batch(stage2):
    """One symbolic export, batches 1-3, each the eager answer."""
    _, served, _, predict, specs, _ = stage2
    for B in (1, 2, 3):
        batch = _batch(specs, B, seed=B)
        got = served(batch, 5)
        assert tuple(got.shape)[:2] == (2, B)
        assert torch.equal(got, predict(batch, 5)), B


@pytest.fixture(scope="module")
def trainer2(runs):
    registry, _, run2 = runs
    return reload_trainer(registry, run2, device="cpu")


def test_stage2_artifact_serves_the_eval_weights(stage2, trainer2):
    """The artifact's weights are the EMA's (the run's eval weights), not the live ones."""
    _, served, _, _, specs, _ = stage2
    trainer = trainer2
    batch = _batch(specs, 2)
    live = serving.build_experiment_predict_fn(trainer.experiment, trainer.eval_fns, trainer.datamodule, None)[0]
    assert float((served(batch, 0) - live(batch, 0)).abs().max()) > 0


def test_graph_holds_b1_per_linear_attention_call(stage2, trainer2):
    """One B1 node per LinearAttention call of a request: per window,
    n_attn per forward, 2 * len(s) + 1 forwards, of which the loop op's
    body holds the 2 * len(s) of its len(s) trips once and the graph the
    peeled last step; two windows, so two loop ops."""
    _, served, manifest, _, _, _ = stage2
    exp = trainer2.experiment
    n_attn = sum(isinstance(m, LinearAttention) for m in exp.model.modules())
    trips = len(exp.engine._steps.s)
    want = 2 * n_attn * (2 * trips + 1)
    gm = served.exported.graph_module

    def b1(graph):
        return sum(str(n.target).startswith("dyffusion_tpu_torch.linear_attention_qkv") for n in graph.nodes)

    loops = [n for n in gm.graph.nodes if n.target is torch.ops.higher_order.while_loop]
    bodies = [getattr(gm, n.args[1].target) for n in loops]
    got = b1(gm.graph) + sum(trips * b1(body.graph) for body in bodies)
    assert n_attn > 0 and len(loops) == 2 and all(b1(body.graph) == 2 * n_attn for body in bodies)
    assert got == want and manifest["graph"]["b1_nodes"] == b1(gm.graph) + sum(b1(body.graph) for body in bodies)
    assert manifest["graph"]["loops"] == 2


# the CPU's reductions split by thread: the served process takes this one's
# thread count, so that the two answers can be compared bit for bit
SERVE_ALONE = """
import sys
import numpy as np
import torch
from dyffusion_tpu_torch.serving import load_exported
torch.set_num_threads(int(sys.argv[4]))
predict, manifest = load_exported(sys.argv[1])
batch = dict(np.load(sys.argv[2]))
np.save(sys.argv[3], predict(batch, 3).numpy())
print(sorted(m for m in sys.modules if m.startswith("dyffusion")))
"""


def test_artifact_moved_away_serves_in_a_process_without_the_model_code(stage1, runs, tmp_path):
    registry, run1, _ = runs
    predict, specs, _ = serving.build_predict_fn(registry, run1, batch_size=2, device="cpu")
    moved = str(tmp_path / "shipped")
    shutil.copytree(stage1["none"], moved)
    batch = _batch(specs, 2)
    np.savez(tmp_path / "batch.npz", **batch)
    proc = subprocess.run(
        [sys.executable, "-c", SERVE_ALONE, moved, str(tmp_path / "batch.npz"), str(tmp_path / "out.npy"),
         str(torch.get_num_threads())],
        capture_output=True, text=True, cwd=ROOT, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr
    modules = json.loads(proc.stdout.strip().splitlines()[-1].replace("'", '"'))
    allowed = {"dyffusion_tpu_torch", "dyffusion_tpu_torch.serving"}
    assert all(m in allowed or m.startswith("dyffusion_tpu_torch.ops") for m in modules), modules
    np.testing.assert_array_equal(np.load(tmp_path / "out.npy"), predict(batch, 3).numpy())


def test_pinned_artifact_is_the_eager_predict_and_rejects_another_batch(stage1, runs):
    registry, run1, _ = runs
    served, manifest = serving.load_exported(stage1["none"])
    predict, specs, _ = serving.build_predict_fn(registry, run1, batch_size=2, device="cpu")
    assert manifest["polymorphic_batch"] is False and manifest["batch_size"] == 2
    assert manifest["inputs"]["dynamics"]["shape"] == [2, 3, 8, 8, 1]
    assert manifest["dynamics_frames_read"] == [0, 2] and manifest["attention_kernel"] == "plain"
    batch = _batch(specs, 2)
    assert torch.equal(served(batch, 1), predict(batch, 1))
    with pytest.raises(ValueError, match="artifact takes"):
        served(_batch(specs, 3), 1)


def test_mean_std_artifact_is_the_host_reduction(stage1, runs):
    registry, run1, _ = runs
    members, _ = serving.load_exported(stage1["none"])
    stats, manifest = serving.load_exported(stage1["mean_std"])
    _, specs, _ = serving.build_predict_fn(registry, run1, batch_size=2, device="cpu")
    batch = _batch(specs, 2)
    m = members(batch, 7).double().numpy()
    s = stats(batch, 7)
    assert manifest["reduce"] == "mean_std" and manifest["output"]["axes"][0] == "stat(mean,std)"
    assert tuple(s.shape) == (2,) + m.shape[1:]
    np.testing.assert_allclose(s[0].numpy(), m.mean(0), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(s[1].numpy(), m.std(0), rtol=1e-5, atol=1e-6)


def test_bad_reduce_raises_before_the_reload(tmp_path):
    with pytest.raises(ValueError, match="unknown reduce"):
        serving.export_run(str(tmp_path), "no-such-run", str(tmp_path / "out"), reduce="median", device="cpu")


@pytest.mark.parametrize("argv,error", [
    (["run_id"], "key=value"),
    (["=x", "out=y"], "key=value"),
    (["out=y"], "required"),
    (["run_id=x"], "required"),
    (["run_id=x", "out=y", "polymorphic_batch=maybe"], "true or false"),
    (["run_id=x", "out=y", "batch_size=two"], "integer"),
])
def test_cli_rejects_malformed_arguments(argv, error):
    with pytest.raises(SystemExit, match=error):
        serving._main(argv)


@pytest.mark.parametrize("argv,error,match", [
    (["devices=2"], ValueError, "polymorphic_batch"),
    (["platforms=cpu,tpu"], ValueError, "unknown platform"),
    (["platforms=cuda"], ValueError, "does not name the export device"),
    (["reduce=median"], ValueError, "unknown reduce"),
    (["devices=2", "polymorphic_batch=false", "batch_size=3"], ValueError, "divisible"),
    (["devices=0"], ValueError, "devices must be"),
])
def test_cli_refuses_what_is_not_ported_before_the_reload(tmp_path, argv, error, match):
    """Each refusal comes from the arguments alone: there is no run to reload."""
    with pytest.raises(error, match=match):
        serving._main(["run_id=none", f"out={tmp_path}", f"registry_dir={tmp_path}", "device=cpu", *argv])


@pytest.fixture(scope="module")
def spring(tmp_path_factory):
    """A spring-mesh stage 2 (two chained windows): its datamodule re-imposes
    the pinned nodes on every prediction."""
    root = str(tmp_path_factory.mktemp("bench"))
    write_fake_benchmark_dir(root, "spring-mesh", n_traj={"train": 2, "val": 1, "test": 1}, n_time=8)
    registry = str(tmp_path_factory.mktemp("registry_spring"))
    common = [f"datamodule.data_dir={root}", "datamodule.horizon=2", "datamodule.prediction_horizon=4",
              "datamodule.batch_size=4", "datamodule.eval_batch_size=2", "model.dim=8",
              "module.num_predictions=2", "module.num_predictions_test=2", "trainer.max_epochs=1",
              f"registry_dir={registry}"]
    t1, _ = run_experiment(port_config.get_config("spring_mesh_interpolation", common), device="cpu")
    cfg2 = port_config.get_config("spring_mesh_dyffusion",
                                  common + [f"diffusion.interpolator_run_id={os.path.basename(t1.ckpt.run_dir)}"])
    t2, _ = run_experiment(cfg2, device="cpu")
    return registry, os.path.basename(t2.ckpt.run_dir), t2


def test_spring_artifact_applies_boundary_conditions(spring, tmp_path):
    """The boundary hook lives inside the artifact: the pinned nodes hold in
    every member, frame and row of both windows (the JAX package's
    ``test_spring_export_applies_boundary_conditions``)."""
    registry, run_id, trainer = spring
    out = str(tmp_path / "artifact")
    serving.export_run(registry, run_id, out, split="test", device="cpu")
    served, manifest = serving.load_exported(out)
    assert manifest["output"]["shape"][2] == 4 and manifest["attention_kernel"] is None
    example = next(iter(trainer._eval_batches("test")))
    batch = {k: np.asarray(v)[:2, :1] if k == "dynamics" else np.asarray(v)[:2] for k, v in example.items()}
    got = served(batch, 3)
    want, _, _ = serving.build_predict_fn(registry, run_id, split="test", device="cpu")
    assert torch.equal(got, want(batch, 3))
    for i in range(1, 5):
        time = batch["metadata_t0"] + batch["metadata_dt"] * i
        assert _boundary_error("spring_mesh", got[:, :, i - 1].numpy(), batch, time) <= 1e-6, i


@pytest.mark.parametrize("layout", ["nchw_view", "contiguous"])
@pytest.mark.parametrize("op", ["linear_attention_qkv", "linear_attention_core", "fused_leaky_relu"])
def test_ops_pass_opcheck(op, layout):
    """Schema, autograd registration, fake vs real (shapes and strides) and
    AOT dispatch with dynamic shapes, on CPU tensors in both layouts."""
    g = torch.Generator().manual_seed(0)
    nchw = layout == "nchw_view"
    if op == "linear_attention_qkv":
        x = torch.randn(2, 384, 12, generator=g)  # (B, 3hd, N): the 1x1 conv's NCHW output, flattened
        args = ((x.transpose(1, 2) if nchw else x.transpose(1, 2).contiguous()).requires_grad_(), 4, 32, 32**-0.5)
    elif op == "linear_attention_core":
        qkv = [torch.randn(8, 12, 32, generator=g) for _ in range(3)]  # (BH, N, d)
        args = (*[(t.transpose(1, 2) if nchw else t.transpose(1, 2).contiguous()).requires_grad_() for t in qkv], 0.2)
    else:
        x = torch.randn(2, 6, 5, 4, generator=g)
        x = x.to(memory_format=torch.channels_last) if nchw else x
        args = (x.requires_grad_(), torch.randn(6, generator=g).requires_grad_(), 0.2, 2**0.5)
    torch.library.opcheck(getattr(torch.ops.dyffusion_tpu_torch, op).default, args)


# ---------------------------------------------------------------------------
# the JAX package's eval on the same converted weights
# ---------------------------------------------------------------------------
PARITY = TINY + ["model.block_dropout=0.0", "trainer.save_checkpoints=False"]


def test_dropout_free_export_matches_the_jax_eval():
    c1 = jax_config.get_config("synthetic_interpolation", PARITY)
    jdm = jax_interface.get_datamodule(c1)
    jdm.setup()
    _, ip_model, ip_vars, _, _, _ = jax_interface.build_experiment(c1, jdm)
    c2 = jax_config.get_config("synthetic_dyffusion", PARITY)
    _, _, fc_vars, _, jax_eval_fns, _ = jax_interface.build_experiment(
        c2, jdm, interpolator=(make_apply_fn(ip_model), ip_vars))
    batch = next(jdm.predict_batches())
    want = jax.jit(jax_eval_fns["predict"])(fc_vars, batch, jax.random.key(0))
    want = np.stack([np.asarray(want[f"t{i}_preds"]) for i in range(1, 3)], axis=2)

    p1 = port_config.get_config("synthetic_interpolation", PARITY)
    pdm = port_interface.get_datamodule(p1)
    pdm.setup()
    _, ip, _, _, _ = port_interface.build_experiment(p1, pdm, device="cpu")
    ip.load_state_dict(unet_state_dict_from_jax(to_numpy_tree(ip_vars)))
    exp, fc, _, eval_fns, _ = port_interface.build_experiment(
        port_config.get_config("synthetic_dyffusion", PARITY), pdm, interpolator=ip, device="cpu")
    fc.load_state_dict(unet_state_dict_from_jax(to_numpy_tree(fc_vars)))
    program, manifest = serving.export_experiment(exp, eval_fns, pdm, None)
    got = serving.serve_exported(program, manifest)({"dynamics": batch["dynamics"][:, :1]}, 0)
    assert tuple(got.shape) == want.shape == (2, 2, 2, 8, 8, 1)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
