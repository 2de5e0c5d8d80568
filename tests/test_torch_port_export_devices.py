"""The data-parallel artifact (``devices=N``) and the multi-platform
artifact (``platforms``) of the port's serving export, on the CPU at a tiny
width (a DYffusion stage 2 at horizon 2, dropout on, f32).

``devices=2`` served on ``["cpu", "cpu"]`` answers within 1e-5 of max of
the one-device pinned artifact at the same seed (differences come only
from batch-dependent kernels), and the planted fault, each replica drawing
at its own batch's shape, exceeds that; the JAX package's three errors
("polymorphic_batch", "divisible", and "re-export" on a host with fewer
cards, the device count patched); a ``platforms=("cpu", "cuda")``
artifact traced on the CPU lists both and serves the eager answer on the
CPU, bit for bit, while a one-platform artifact is refused elsewhere and a
CUDA request without a card raises, with no fallback.
"""
import contextlib
import json
import os
import shutil

import pytest
import torch

from dyffusion_tpu_torch import serving
from dyffusion_tpu_torch.utils import rng
from tests._torch_port_helpers import torch_threads_share_of_cores  # noqa: F401 (autouse fixture)
from tests.test_torch_port_export_loop import _batch, build

REL = 1e-5
DP = ("synthetic_dyffusion", ["datamodule.horizon=2", "model.block_dropout=0.2"])


@pytest.fixture(scope="module")
def experiment():
    return build(*DP)


# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def data_parallel(experiment, tmp_path_factory):
    """The one-device pinned artifact at batch 4, the two-replica one
    (saved), and the two-replica one exported with the planted fault."""
    exp, eval_fns, dm = experiment
    one = serving.export_experiment(exp, eval_fns, dm, None, batch_size=4, polymorphic_batch=False)
    two = serving.export_experiment(exp, eval_fns, dm, None, batch_size=4, polymorphic_batch=False, devices=2)
    out = str(tmp_path_factory.mktemp("dp"))
    serving.save_exported(*two, out)
    # the fault: each replica draws at its own batch's shape
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(rng, "replica_rows", lambda total, rows: contextlib.nullcontext())
        own = serving.export_experiment(exp, eval_fns, dm, None, batch_size=4, polymorphic_batch=False, devices=2)
    _, specs, _ = serving.build_experiment_predict_fn(exp, eval_fns, dm, None, batch_size=4)
    return one, two, own, out, specs


def _dp_error(got, want):
    return float((got - want).abs().max()) / float(want.abs().max())


def test_two_replicas_answer_as_one_device(data_parallel):
    one, _, _, out, specs = data_parallel
    served, manifest = serving.load_exported(out, device=["cpu", "cpu"])
    ref = serving.serve_exported(*one)
    assert manifest["devices"] == 2 and manifest["replica_batch_size"] == 2
    assert manifest["inputs"]["dynamics"]["shape"][0] == 4 and manifest["output"]["shape"][1] == 4
    batch = _batch(specs, 4)
    for seed in (0, 3):
        got, want = served(batch, seed), ref(batch, seed)
        assert got.shape == want.shape and _dp_error(got, want) <= REL, seed
    assert float((served(batch, 4) - got).abs().max()) > 1e-3  # dropout is on: the seed moves the answer


def test_replicas_drawing_at_their_own_shape_fail_the_check(data_parallel):
    one, _, own, _, specs = data_parallel
    batch = _batch(specs, 4)
    got = serving.serve_exported(*own, ["cpu", "cpu"])(batch, 0)
    assert _dp_error(got, serving.serve_exported(*one)(batch, 0)) > REL


def test_data_parallel_export_errors():
    """The JAX package's two export errors, raised before the run is reloaded."""
    with pytest.raises(ValueError, match="polymorphic_batch"):
        serving.export_run("no-registry", "no-run", "no-out", devices=2, device="cpu")
    with pytest.raises(ValueError, match="divisible"):
        serving.export_run("no-registry", "no-run", "no-out", devices=2, polymorphic_batch=False, batch_size=3,
                           device="cpu")


def test_too_few_cards_say_to_re_export(data_parallel, tmp_path, monkeypatch):
    """A two-replica CUDA artifact on a host with one card: the manifest of
    the CPU artifact claims ``cuda:0`` (no card here exports one)."""
    _, _, _, out, _ = data_parallel
    moved = str(tmp_path / "cuda_dp")
    shutil.copytree(out, moved)
    path = os.path.join(moved, "manifest.json")
    with open(path) as f:
        manifest = json.load(f)
    manifest.update(device="cuda:0", platforms=["cuda"])
    with open(path, "w") as f:
        json.dump(manifest, f)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(RuntimeError, match="re-export"):
        serving.load_exported(moved)


# ---------------------------------------------------------------------------
# the multi-platform artifact
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def multi_platform(experiment, tmp_path_factory):
    """The eager predict and its specs, and the symbolic-batch artifact
    traced on the CPU for the platforms ("cpu", "cuda"), saved."""
    exp, eval_fns, dm = experiment
    predict, specs, _ = serving.build_experiment_predict_fn(exp, eval_fns, dm, None)
    out = str(tmp_path_factory.mktemp("multi"))
    serving.save_exported(*serving.export_experiment(exp, eval_fns, dm, None, platforms=("cpu", "cuda")), out)
    return predict, specs, out


def test_multi_platform_artifact_serves_on_the_cpu(multi_platform):
    predict, specs, out = multi_platform
    served, manifest = serving.load_exported(out, device="cpu")
    assert manifest["platforms"] == ["cpu", "cuda"] and manifest["device"] == "cpu"
    for batch_size in (1, 3):
        batch = _batch(specs, batch_size)
        assert torch.equal(served(batch, 1), predict(batch, 1))
    if not torch.cuda.is_available():  # no fallback: a CUDA request needs a card
        with pytest.raises(RuntimeError, match="no CPU fallback"):
            serving.load_exported(out, device="cuda")


def test_one_platform_artifact_is_refused_elsewhere(data_parallel):
    (program, manifest), _, _, _, _ = data_parallel
    assert manifest["platforms"] == ["cpu"]
    with pytest.raises(ValueError, match="runs there"):
        serving.serve_exported(program, manifest, "cuda")
    with pytest.raises(ValueError, match="unknown platform"):
        serving.export_run("no-registry", "no-run", "no-out", platforms=("cpu", "tpu"), device="cpu")


def test_a_run_saved_on_another_device_type_reloads(tmp_path):
    """A checkpoint whose step generator is a CUDA one (a 16-byte state)
    reloads on the CPU, as the eager CPU predict of a two-platform
    artifact's run needs: the CPU generator keeps its own stream; the
    weights are the checkpoint's."""
    from dyffusion_tpu_torch.config import get_config
    from dyffusion_tpu_torch.interface import build_trainer

    cfg = get_config("synthetic_interpolation", ["datamodule.spatial=(8,8)", "datamodule.channels=1",
                                                 "datamodule.horizon=2", "model.dim=8", "model.dim_mults=(1,)",
                                                 "trainer.save_checkpoints=False", f"registry_dir={tmp_path}"])
    trainer = build_trainer(cfg, device="cpu")
    tree = trainer._state_tree()
    fresh = trainer.state.generator.get_state()
    tree["generator"] = torch.zeros(16, dtype=torch.uint8)  # a CUDA generator's (seed, offset)
    tree["model"] = {k: v + 1 if v.is_floating_point() else v for k, v in tree["model"].items()}
    trainer._load_state_tree(tree)
    assert torch.equal(trainer.state.generator.get_state(), fresh)
    assert all(torch.equal(v, tree["model"][k]) for k, v in trainer.state.model.state_dict().items())
