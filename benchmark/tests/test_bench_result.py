"""A run's result line, the run without a card, and the faults that must
turn ``correct`` false: the harness's look for a chip is skipped (device
'cpu', tiny float32 cells) and the rest of a run is driven with the timed
path broken underneath."""
import json
import subprocess
import sys

import pytest
import torch

from benchmark import harness
from benchmark.tests.tiny import REPO, tiny_root


@pytest.fixture
def root(tmp_path):
    return tiny_root(tmp_path)


def test_result_keys(root):
    r = harness.execute("tiny-serve", 2**31 + 12345, 0.5, 0, device="cpu", root=root)
    r.pop("_readings")
    json.dumps(r)
    assert list(r)[:5] == ["correct", "attempted", "failed", "metrics", "device"] and list(r)[-1] == "checks"
    assert r["correct"] is True and r["failed"] == 0 and r["attempted"] >= 1
    assert set(r["metrics"]) == {"frames_per_s", "setup_s"}
    assert all(set(v) == {"value", "unit"} for v in r["metrics"].values())
    assert all(set(v) == {"value", "limit"} for v in r["checks"].values())


def test_no_card_no_result():
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    p = subprocess.run([sys.executable, "benchmark/run.py", "--workload", "sst-serve", "--seed", "1", "--seconds", "1",
                        "--trace", "0"], cwd=REPO, capture_output=True, text=True, timeout=300)
    assert p.returncode != 0 and p.stdout.strip() == ""


def test_only_the_benchmark_files_is_no_run(tmp_path):
    """A directory with BENCHMARK.json and the benchmark folder alone (no
    system under test) gives no result."""
    import shutil

    shutil.copytree(REPO / "benchmark", tmp_path / "benchmark", ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(REPO / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    p = subprocess.run([sys.executable, "benchmark/run.py", "--workload", "sst-serve", "--seed", "1", "--seconds", "1",
                        "--trace", "0"], cwd=tmp_path, capture_output=True, text=True, timeout=300)
    assert p.returncode != 0 and p.stdout.strip() == ""


def _sample_fault(monkeypatch, fault):
    from dyffusion_tpu_torch.diffusion import dyffusion

    orig = dyffusion.DyffusionEngine.sample

    def broken(self, *a, **kw):
        return fault(orig, self, *a, **kw)

    monkeypatch.setattr(dyffusion.DyffusionEngine, "sample", broken)


def test_fault_state_unchanged_serve(root, monkeypatch):
    from dyffusion_tpu_torch.diffusion import dyffusion

    monkeypatch.setattr(dyffusion, "loop", lambda step, carry, xs, consts, nets: carry)
    assert harness.execute("tiny-serve", 7, 0.5, 0, device="cpu", root=root)["correct"] is False


def test_fault_answer_altered(root, monkeypatch):
    def fault(orig, self, *a, **kw):
        out = orig(self, *a, **kw).clone()
        out[0, 2] = out[0, 2] * 1.01  # one row's frame, 1% off
        return out

    _sample_fault(monkeypatch, fault)
    assert harness.execute("tiny-serve", 7, 0.5, 0, device="cpu", root=root)["correct"] is False


def test_fault_half_the_rows_serve(root, monkeypatch):
    def fault(orig, self, fc, ip, g, ic, sc=None):
        half = ic.shape[0] // 2
        out = orig(self, fc, ip, g, ic[:half], None if sc is None else sc[:half])
        return torch.cat([out, out[: ic.shape[0] - half]])

    _sample_fault(monkeypatch, fault)
    assert harness.execute("tiny-serve", 7, 0.5, 0, device="cpu", root=root)["correct"] is False


def test_fault_step_unchanged_train(root, monkeypatch):
    from dyffusion_tpu_torch.training import state

    monkeypatch.setattr(state.TrainState, "apply_gradients", lambda self, updates=None: self.optimizer.zero_grad())
    assert harness.execute("tiny-train", 7, 0.5, 0, device="cpu", root=root)["correct"] is False


def test_fault_half_the_batch_train(root, monkeypatch):
    from dyffusion_tpu_torch.diffusion import dyffusion

    orig = dyffusion.DyffusionEngine.p_losses

    def half(self, fc, ip, g, x_last, cond, t, static=None):
        n = x_last.shape[0] // 2
        return orig(self, fc, ip, g, x_last[:n], cond[:n], t[:n], None if static is None else static[:n])

    monkeypatch.setattr(dyffusion.DyffusionEngine, "p_losses", half)
    assert harness.execute("tiny-train", 7, 0.5, 0, device="cpu", root=root)["correct"] is False


@pytest.mark.cuda
def test_sst_serve_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    p = subprocess.run([sys.executable, "benchmark/run.py", "--workload", "sst-serve", "--seed", "3", "--seconds", "5",
                        "--trace", "0"], cwd=REPO, capture_output=True, text=True, timeout=600)
    assert p.returncode == 0, p.stderr[-2000:]
    assert json.loads(p.stdout.strip().splitlines()[-1])["correct"] is True
