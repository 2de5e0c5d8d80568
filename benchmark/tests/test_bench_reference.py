"""The plain reference against the system under test at tiny sizes, in
float32 on the CPU: the served ensemble (dropout on, the draws replayed
from the request's seed, and off), Navier-Stokes with its boundary
conditions, and the first training steps. The test imports both; the
reference imports nothing of the system."""
import copy
import tempfile

import pytest
import torch

from benchmark import inputs
from benchmark.reference import compare
from benchmark.reference import model as ref_model
from benchmark.tests.tiny import TINY_SST, tiny_config


def _port_sst(conf, overrides, device="cpu"):
    from dyffusion_tpu_torch.config import get_config
    from dyffusion_tpu_torch.interface import build_experiment, get_datamodule

    c1, c2 = get_config(conf["stage1_preset"], overrides), get_config(conf["preset"], overrides)
    dm = get_datamodule(c1)
    dm.setup()
    return c1, c2, dm, build_experiment


@pytest.mark.parametrize("dropout", [True, False])
def test_served_sst_equals_the_reference(dropout):
    from dyffusion_tpu_torch.serving import build_experiment_predict_fn

    conf = tiny_config()
    ref = copy.deepcopy(conf["reference"])
    extra = [] if dropout else ["model.block_dropout=0.0", "model.attn_dropout=0.0"]
    if not dropout:
        for net in ref["model"].values():
            net.update(block_dropout=0.0, attn_dropout=0.0)
    c1, c2, dm, build = _port_sst(conf, TINY_SST[:-6] + ["module.eval_dtype=float32", "datamodule.n_traj=2",
                                                        "datamodule.n_time=12", "datamodule.eval_batch_size=2"] + extra)
    W = {n: inputs.make_weights(s, 11, "cpu", n) for n, s in ref_model.param_specs(ref).items()}
    _, ip, _, _, _ = build(c1, dm, device="cpu")
    ip.load_state_dict(W["interpolator"])
    exp, _, _, fns, _ = build(c2, dm, interpolator=ip, device="cpu")
    exp.model.load_state_dict(W["forecaster"])
    predict, _, info = build_experiment_predict_fn(exp, fns, dm, None)
    batch = inputs.make_batches("synthetic", inputs.generator(11, "cpu", "b"), 1, 2, 1, (16, 16), 1, "cpu")[0]
    out = predict(batch, 12345)
    want = ref_model.serve(ref, W, batch, 12345, info["ensemble_members"])
    assert compare.serve_numbers(out, want)["rel_rms"] < 1e-4
    if dropout:  # another seed draws other masks: the check sees the members
        other = ref_model.serve(ref, W, batch, 12346, info["ensemble_members"])
        assert compare.serve_numbers(out, other)["rel_rms"] > 0.1
    step = compare.stepwise_numbers(out, ref_model.serve(ref, W, batch, 12345, info["ensemble_members"], forced=out))
    assert max(step.values()) < 1e-4


def test_served_navier_stokes_equals_the_reference():
    from dyffusion_tpu_torch.config import get_config
    from dyffusion_tpu_torch.interface import build_experiment, get_datamodule
    from dyffusion_tpu_torch.serving import build_experiment_predict_fn

    ref = {"backbone": "unet_simple", "channels": 3, "window": 1, "static_channels": 2, "horizon": 3, "k": 0,
           "conditioning": "none", "refine": True, "boundary": "navier_stokes",
           "model": {n: {"dim": 4, "upsample_dims": [64, 64], "dropout": 0.15} for n in ("forecaster", "interpolator")},
           "low_eps": {"serve": [False, False], "train": [False, False]}}
    with tempfile.TemporaryDirectory() as tmp:
        root = inputs.write_ns_archive(tmp, 5, n_time=8)
        ov = [f"datamodule.data_dir={root}", "datamodule.horizon=3", "datamodule.prediction_horizon=3", "model.dim=4",
              "model.upsample_dims=(64,64)", "module.num_predictions=2", "datamodule.eval_batch_size=2"]
        c1, c2 = get_config("navier_stokes_interpolation", ov), get_config("navier_stokes_dyffusion", ov)
        dm = get_datamodule(c1)
        dm.setup()
        W = {n: inputs.make_weights(s, 13, "cpu", n) for n, s in ref_model.param_specs(ref).items()}
        _, ip, _, _, _ = build_experiment(c1, dm, device="cpu")
        ip.load_state_dict(W["interpolator"])
        exp, _, _, fns, _ = build_experiment(c2, dm, interpolator=ip, device="cpu")
        exp.model.load_state_dict(W["forecaster"])
        predict, _, info = build_experiment_predict_fn(exp, fns, dm, None, split="val")
        batch = inputs.make_batches("navier_stokes", inputs.generator(13, "cpu", "b"), 1, 2, 1, (221, 42), 3,
                                    "cpu")[0]
        out = predict(batch, 777)
    want = ref_model.serve(ref, W, batch, 777, info["ensemble_members"])
    assert compare.serve_numbers(out, want)["rel_rms"] < 1e-4
    fixed = batch["metadata_fixed_mask"]
    assert float(out[:, :, :, 1:][fixed[None, :, None, 1:].expand_as(out[:, :, :, 1:])].abs().max()) == 0.0


def test_first_training_steps_equal_the_reference(tmp_path):
    from benchmark import harness
    from benchmark.tests.tiny import tiny_root

    root = tiny_root(tmp_path)
    result = harness.execute("tiny-train", 5, 0.5, 0, device="cpu", root=root)
    checks = {k: v["value"] for k, v in result["checks"].items()}
    assert result["correct"] and max(checks.values()) < 1e-3, checks


def test_the_fp8_control_fails_the_limits():
    from benchmark.modes import serve

    conf = tiny_config()
    ref = conf["reference"]
    W = {n: inputs.make_weights(s, 17, "cpu", n) for n, s in ref_model.param_specs(ref).items()}
    batch = inputs.make_batches("synthetic", inputs.generator(17, "cpu", "b"), 1, 2, 1, (16, 16), 1, "cpu")[0]
    numbers = serve.judge(ref, W, batch, 99, 3, None, fp8=True)
    assert not compare.verdict(numbers, conf["limits"]["serve"]), numbers
    batches = inputs.make_batches("synthetic", inputs.generator(17, "cpu", "b"), 3, 4, 5, (16, 16), 1, "cpu")
    want = ref_model.train(ref, W, batches, 5, 3, 1)
    got = ref_model.train(ref, W, batches, 5, 3, 1, fp8=True)
    numbers = compare.train_numbers(got["losses"], want["losses"], got["grads"], want["grads"], got["change"],
                                    want["change"])
    assert not compare.verdict(numbers, conf["limits"]["train"]), numbers
    assert torch.isfinite(torch.tensor(list(numbers.values()))).all()


def test_navier_stokes_training_steps_equal_the_reference():
    """Accumulation over two micro-batches, BatchNorm on the batch's
    statistics in the first forecaster pass and its running averages moved
    after each micro-batch."""
    from dyffusion_tpu_torch.config import get_config
    from dyffusion_tpu_torch.interface import build_experiment, build_trainer, get_datamodule

    ref = {"backbone": "unet_simple", "channels": 3, "window": 1, "static_channels": 2, "horizon": 3, "k": 0,
           "conditioning": "none", "refine": True, "boundary": "navier_stokes", "accumulate": 2,
           "model": {n: {"dim": 4, "upsample_dims": [64, 64], "dropout": 0.15} for n in ("forecaster", "interpolator")},
           "low_eps": {"serve": [False, False], "train": [False, False]}, "loss": {"lam1": 0.5, "lam2": 0.5},
           "optimizer": {"lr": 3e-4, "weight_decay": 1e-4, "betas": [0.9, 0.999], "eps": 1e-8, "clip": 1.0}}
    with tempfile.TemporaryDirectory() as tmp:
        root = inputs.write_ns_archive(tmp, 5, n_time=8)
        ov = [f"datamodule.data_dir={root}", "datamodule.horizon=3", "datamodule.prediction_horizon=3", "model.dim=4",
              "model.upsample_dims=(64,64)", "module.num_predictions=2", "datamodule.batch_size=4",
              "trainer.save_checkpoints=False"]
        c1, c2 = get_config("navier_stokes_interpolation", ov), get_config("navier_stokes_dyffusion", ov)
        dm = get_datamodule(c1)
        dm.setup()
        W = {n: inputs.make_weights(s, 13, "cpu", n) for n, s in ref_model.param_specs(ref).items()}
        _, ip, _, _, _ = build_experiment(c1, dm, device="cpu")
        ip.load_state_dict(W["interpolator"])
        trainer = build_trainer(c2, dm, interpolator=ip, device="cpu")
    st = trainer.state
    assert st.optimizer.accumulate_grad_batches == 2
    st.model.load_state_dict(W["forecaster"])
    st.generator.manual_seed(99)
    batches = inputs.make_batches("navier_stokes", inputs.generator(1, "cpu", "b"), 6, 4, 4, (221, 42), 3, "cpu")
    start = {k: p.detach().clone() for k, p in st.params.items()}
    losses, grads = [], None
    for i, b in enumerate(batches):
        losses.append(float(trainer.train_step(st, b)["loss"]))
        if i == 1:
            grads = {k: st.optimizer.optimizer.state[p]["exp_avg"] / 0.1 for k, p in st.params.items()}
    change = {k: p.detach() - start[k] for k, p in st.params.items()}
    want = ref_model.train(ref, W, batches, 99, 3, 2)
    numbers = compare.train_numbers(losses, want["losses"], grads, want["grads"], change, want["change"])
    assert max(numbers.values()) < 1e-4, numbers
