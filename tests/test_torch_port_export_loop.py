"""Each sampler's loop exported as one loop op, on the CPU at a tiny width.

Every sampler a preset reaches: DYffusion (cold, with its s = 0 step and
the refinement), the DDPM's ancestral and DDIM samplers, the LDM's, and
MCVD's DDPM, DDIM and F-PNDM with Gamma noise. Each is exported with a
symbolic batch and answers as the eager predict does, bit for bit (the two
run the same step function: no tolerance), at two seeds and batches 1 and
3; the graph holds one ``while_loop`` op per sampler loop, and its node
count does not change with the number of steps. The eager answers are
those of the code before the loops, saved from it at seed 0
(``data/torch_port_sampler_answers.npz``, made by ``_write_answers``): held
to 1e-5 of their largest value, where a draw taken out of order moves an
answer by its own size (the CPU's kernels may round otherwise on another
machine). The artifacts are traced for the platforms ``("cpu", "cuda")``;
the data-parallel and multi-platform checks are in
``test_torch_port_export_devices.py``. Builds and exports are shared by
module fixtures: an export takes seconds.
"""
import contextlib
import os

import numpy as np
import pytest
import torch

from dyffusion_tpu_torch import config as port_config
from dyffusion_tpu_torch import interface as port_interface
from dyffusion_tpu_torch import serving
from tests._torch_port_helpers import torch_threads_share_of_cores  # noqa: F401 (autouse fixture)

ANSWERS = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data", "torch_port_sampler_answers.npz")
REL = 1e-5
BASE = ["datamodule.spatial=(8,8)", "datamodule.channels=1", "datamodule.n_traj=5", "datamodule.n_time=10",
        "datamodule.batch_size=4", "datamodule.eval_batch_size=2", "model.dim=8", "model.dim_mults=(1,)",
        "module.num_predictions=2", "trainer.save_checkpoints=False"]
DIFF = ["datamodule.horizon=2", "diffusion.timesteps=10"]
GAMMA = DIFF + ["diffusion.gamma=true"]
CASES = {
    # horizon 3 and two auxiliary steps: a schedule of 5, its s = 0 step masked
    "dyffusion": ("synthetic_dyffusion", ["datamodule.horizon=3", "model.block_dropout=0.2",
                  "diffusion.additional_interpolation_steps=2", "diffusion.refine_intermediate_predictions=true"]),
    "ddpm": ("synthetic_ddpm", DIFF),
    "ddim": ("synthetic_ddpm", DIFF + ["diffusion.sampling_timesteps=4"]),
    "ldm": ("synthetic_ddpm_v2", DIFF),
    "mcvd_ddpm": ("synthetic_mcvd", GAMMA),
    "mcvd_ddim": ("synthetic_mcvd", GAMMA + ["diffusion.version=DDIM", "diffusion.sampling_timesteps=5"]),
    # 5 steps: 3 Runge-Kutta steps peeled, 2 Adams-Bashforth steps in the loop
    "mcvd_fpndm": ("synthetic_mcvd", GAMMA + ["diffusion.version=FPNDM", "diffusion.sampling_timesteps=5"]),
}
# the same samplers at another step count, for the node count
MORE_STEPS = {
    "dyffusion": ["diffusion.additional_interpolation_steps=4"],
    "ddpm": ["diffusion.timesteps=20"],
}


@contextlib.contextmanager
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(threads)


def build(preset, extra):
    """(experiment, eval_fns, datamodule) of ``preset`` at the tiny
    overrides on the CPU, the trained network's weights (and a DYffusion's
    interpolator's) spread by N(0, 0.05^2) from a seed: a fresh network's
    zero-initialized output would answer ~0."""
    overrides = BASE + list(extra)
    cfg = port_config.get_config(preset, overrides)
    dm = port_interface.get_datamodule(cfg)
    dm.setup()
    g = torch.Generator().manual_seed(1)

    def spread(net):
        with torch.no_grad():
            for p in net.parameters():
                p.add_(0.05 * torch.randn(p.shape, generator=g))

    interpolator = None
    if preset.endswith("dyffusion"):
        stage1 = [o for o in overrides if not o.startswith("diffusion.")]
        _, interpolator, _, _, _ = port_interface.build_experiment(
            port_config.get_config("synthetic_interpolation", stage1), dm, device="cpu")
        spread(interpolator)
    exp, model, _, eval_fns, _ = port_interface.build_experiment(cfg, dm, interpolator=interpolator, device="cpu")
    spread(model)
    return exp, eval_fns, dm


def _batch(specs, batch_size, seed=0):
    r = np.random.default_rng(seed)
    return {k: r.standard_normal((batch_size,) + s.shape[1:]).astype(s.dtype) for k, s in specs.items()}


def _write_answers(path=ANSWERS):
    """Save every case's eager answer at seed 0, batch 2, one thread (run
    once, on the code whose answers the tests hold)."""
    out = {}
    with _one_thread():
        for name, (preset, extra) in CASES.items():
            exp, eval_fns, dm = build(preset, extra)
            predict, specs, _ = serving.build_experiment_predict_fn(exp, eval_fns, dm, None)
            out[name] = predict(_batch(specs, 2), 0).numpy()
    os.makedirs(os.path.dirname(path), exist_ok=True)
    np.savez(path, **out)


@pytest.fixture(scope="module")
def exported():
    """Per case: the eager predict, its input specs, the program and
    manifest, traced on the CPU for the platforms ``("cpu", "cuda")``."""
    cache = {}

    def get(name):
        if name not in cache:
            exp, eval_fns, dm = build(*CASES[name])
            predict, specs, _ = serving.build_experiment_predict_fn(exp, eval_fns, dm, None)
            program, manifest = serving.export_experiment(exp, eval_fns, dm, None, platforms=("cpu", "cuda"))
            cache[name] = predict, specs, program, manifest
        return cache[name]

    return get


@pytest.mark.parametrize("name", list(CASES))
def test_eager_answers_are_the_unrolled_samplers(name):
    want = np.load(ANSWERS)[name]
    with _one_thread():
        exp, eval_fns, dm = build(*CASES[name])
        predict, specs, _ = serving.build_experiment_predict_fn(exp, eval_fns, dm, None)
        got = predict(_batch(specs, 2), 0).numpy()
    assert got.shape == want.shape
    err = float(np.abs(got - want).max())
    assert err <= REL * float(np.abs(want).max()), (name, err)


@pytest.mark.parametrize("name", list(CASES))
def test_artifact_is_the_eager_predict_bit_for_bit(exported, name):
    predict, specs, program, manifest = exported(name)
    served = serving.serve_exported(program, manifest)
    for batch_size in (1, 3):
        batch = _batch(specs, batch_size, seed=batch_size)
        for seed in (0, 7):
            got, want = served(batch, seed), predict(batch, seed)
            assert tuple(got.shape[:2]) == (2, batch_size)
            assert torch.equal(got, want), (name, batch_size, seed, float((got - want).abs().max()))
    assert float((served(batch, 8) - served(batch, 7)).abs().max()) > 0  # the seed is read


@pytest.mark.parametrize("name", list(CASES))
def test_each_sampler_loop_is_one_loop_op(exported, name):
    _, _, program, manifest = exported(name)
    gm = program.graph_module
    loops = [n for n in gm.graph.nodes if n.target is torch.ops.higher_order.while_loop]
    # DYffusion: the sampler's loop and the refinement's; F-PNDM: its Runge-Kutta and Adams-Bashforth steps
    assert len(loops) == manifest["graph"]["loops"] == (2 if name in ("dyffusion", "mcvd_fpndm") else 1)
    for n in loops:
        body = getattr(gm, n.args[1].target)
        assert any(str(m.target).startswith("dyffusion_tpu_torch.linear_attention_qkv") for m in body.graph.nodes)


@pytest.mark.parametrize("name", list(MORE_STEPS))
def test_node_count_does_not_grow_with_the_steps(exported, name):
    _, _, _, manifest = exported(name)
    preset, extra = CASES[name]
    exp, eval_fns, dm = build(preset, list(extra) + MORE_STEPS[name])
    _, more = serving.export_experiment(exp, eval_fns, dm, None)
    steps = exp.engine._steps.s.size if name == "dyffusion" else exp.diffusion_engine.num_timesteps
    assert steps == (6 if name == "dyffusion" else 20)
    assert more["graph"]["nodes"] == manifest["graph"]["nodes"] and more["graph"]["loops"] >= 1


@pytest.fixture(scope="module")
def saved(exported, tmp_path_factory):
    """The MCVD DDPM artifact written to a directory."""
    _, _, program, manifest = exported("mcvd_ddpm")
    out = str(tmp_path_factory.mktemp("mcvd_ddpm"))
    serving.save_exported(program, manifest, out)
    return out


def test_saved_artifact_serves_the_loop(exported, saved):
    """Saved and loaded, the loop op still answers as eager does."""
    predict, specs, _, manifest = exported("mcvd_ddpm")
    served, loaded = serving.load_exported(saved)
    batch = _batch(specs, 3)
    assert loaded["graph"] == manifest["graph"]
    assert torch.equal(served(batch, 2), predict(batch, 2))
