"""Spatial sharding of the physical-systems backbones on the CPU: two gloo
ranks split the grid's H or W axis of ``UNetSimple``, ``SimpleConvNet`` and
the ``Unet``'s outer resample, against the JAX package and against one
process.

- (a) The sharded backbones against the one-device JAX model on the same
  ported weights and random running statistics, f32, dropout off:
  ``UNetSimple`` (dim 8, with time and a condition) on H (a 24 x 16 grid
  resampled to a 128 x 64 working grid and back) and on W (16 x 24 ->
  64 x 128: the six stride-2 blocks leave one row a rank); ``SimpleConvNet``
  on spring's 10 x 10 on H with BatchNorm and with GroupNorm. The eval
  forward (running averages) and the train-mode forward with its
  BatchNorm updates within 1e-5 of max|JAX|; the gradients of
  sum(output * cot) in train mode, the input's and every weight's, within
  1e-4 of the larger of the tensor's max|JAX| and 0.1 of the largest of
  all (a conv bias in front of a norm has a gradient of float noise). The
  planted faults must each fail the checks they can reach, on H and on
  W: every halo zeroed, BatchNorm on each rank's own batch statistics
  (train mode), the outer resample of each slab alone (``F.interpolate``
  on a slab, coordinates relative to the slab), GroupNorm per rank.
- (b) The ``Unet``'s outer resample (bilinear and nearest) on H against
  the JAX ``Unet`` (11 x 10 -> 16 x 16 and back, the 11 rows split 6 / 5),
  eval forward within 1e-5 of max; the per-slab resample must fail.
- (c) The NS boundary conditions on an H slab and on a W slab of the
  221 x 42 grid against one process, exactly: under W each rank takes its
  columns of the inflow; under H only rank 0 writes the inflow row, and
  rank 1's first row (global row 111) keeps the prediction.
- (d) Two ranks against one process at the same seed, dropout on: NS
  stage 1 and stage 2 by run id on W through the CLI (``python -m
  dyffusion_tpu_torch.train``, which spawns its ranks), spring stage 1
  and 2 on H through the module's spawn, and ``mode=test`` of both on its
  ranks, through the autoregressive chain; each stage 2 on the
  one-process stage 1; the time-conditioned and simultaneous forecasters
  of spring on H and the time-conditioned of NS on W. Every logged loss within 1e-5
  relative, the final weights and EMA within 1e-2 of their change (a
  relative L2 over the model, without the conv biases that a BatchNorm
  subtracts again: Adam moves them by rounding noise); the test metrics
  of the two-rank run within 1e-5 of the largest of those of the same run
  tested on one process.
- (e) NS on H at K = 2 raises the JAX package's wording (221 rows);
  ``navier_stokes_ddpm`` on W with a 64-column working grid (the
  ``UNetSimple``'s deepest level of one column over two ranks: one rank's
  block is empty) trains on two ranks as on one process, and
  ``mode=test`` of that run samples on two ranks as on one.

One spawn of two ranks computes (a)-(e) beside the JAX side and the
one-process runs, and beside it the CLI's own spawns for NS; each rank
has a deadline of 120 s (``tests/_torch_ddp_workers.py``).
"""
import os
import shutil
import threading
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dyffusion_tpu.interface import _check_spatial_divisibility as jax_check_spatial_divisibility
from dyffusion_tpu.models import SimpleConvNet as JaxSimpleConvNet
from dyffusion_tpu.models import Unet as JaxUnet
from dyffusion_tpu.models import UNetSimple as JaxUNetSimple
from dyffusion_tpu_torch.config import get_config
from dyffusion_tpu_torch.data import write_fake_benchmark_dir
from dyffusion_tpu_torch.data.physical_systems import PhysicalSystemsDataModule
from dyffusion_tpu_torch.interface import reload_and_test
from dyffusion_tpu_torch.parallel import spatial
from dyffusion_tpu_torch.models import (
    simple_conv_net_state_dict_from_jax,
    unet_simple_state_dict_from_jax,
    unet_state_dict_from_jax,
)
from dyffusion_tpu_torch.utils.naming import get_run_id
from tests import _torch_ddp_workers as workers
from tests import _torch_spatial_workers as spatial_workers
from tests._torch_port_helpers import to_numpy_tree
from tests._torch_port_helpers import torch_threads_share_of_cores  # noqa: F401 (autouse fixture)
from tests.test_torch_port_spatial_train import _cli, _finish, _state
from tests.test_torch_port_spatial_train import assert_trains_as as _assert_trains_as

WORLD = 2
REL = 1e-5
GRAD_REL = 1e-4
GRAD_FLOOR = 0.1
TRAIN_FAULTS = ("halos zeroed", "batch norm per rank", "resize per slab")
# name -> (port class, data grid (H, W), sharded axis, kwargs, planted faults)
BACKBONE_CASES = {
    "unet_simple h": ("UNetSimple", (24, 16), "h", dict(dim=8, upsample_dims=(128, 64)), TRAIN_FAULTS),
    "unet_simple w": ("UNetSimple", (16, 24), "w", dict(dim=8, upsample_dims=(64, 128)), TRAIN_FAULTS),
    "cnn batch_norm": ("SimpleConvNet", (10, 10), "h", dict(dim=32, net_normalization="batch_norm"),
                       ("halos zeroed", "batch norm per rank")),
    "cnn group_norm": ("SimpleConvNet", (10, 10), "h", dict(dim=32, net_normalization="group_norm"),
                       ("halos zeroed", "group norm per rank")),
    "cnn batch_norm w": ("SimpleConvNet", (10, 10), "w", dict(dim=32, net_normalization="batch_norm"),
                         ("halos zeroed",)),
    "cnn instance_norm": ("SimpleConvNet", (10, 10), "h", dict(dim=32, net_normalization="instance_norm"), ()),
    "cnn layer_norm": ("SimpleConvNet", (10, 10), "h", dict(dim=32, net_normalization="layer_norm"), ()),
    "cnn none": ("SimpleConvNet", (10, 10), "h", dict(dim=32, net_normalization="none"), ()),
    # the case above under remat (its JAX answers: remat computes the same)
    "unet_simple h remat": ("UNetSimple", (24, 16), "h", dict(dim=8, upsample_dims=(128, 64), remat=True), ()),
    # 11 rows split 6 / 5: a slab's own nearest resample differs from the global one only where the
    # blocks of the two grids do not line up
    "unet bilinear": ("Unet", (11, 10), "h", dict(outer_sample_mode="bilinear"), ("resize per slab",)),
    "unet nearest": ("Unet", (11, 10), "h", dict(outer_sample_mode="nearest"), ("resize per slab",)),
}
EVAL_CASES = list(BACKBONE_CASES)


def _base(name):
    """The case whose weights, inputs and JAX answers ``name`` shares."""
    return name.replace(" remat", "")


JAX = {"UNetSimple": (JaxUNetSimple, unet_simple_state_dict_from_jax),
       "SimpleConvNet": (JaxSimpleConvNet, simple_conv_net_state_dict_from_jax),
       "Unet": (JaxUnet, None)}
UNET_KW = dict(dim=8, dim_mults=(1, 2), resnet_block_groups=4, attn_heads=1, attn_dim_head=8, upsample_dims=(16, 16))

NS = ["datamodule.horizon=4", "datamodule.prediction_horizon=8", "datamodule.batch_size=2",
      "datamodule.eval_batch_size=2", "model.dim=16", "model.upsample_dims=(64,128)", "module.num_predictions=2",
      "module.num_predictions_test=2", "module.use_ema=true", "trainer.max_steps=3", "trainer.log_every_n_steps=1",
      "trainer.val_every_n_epochs=100"]
SPRING = ["datamodule.horizon=4", "datamodule.prediction_horizon=8", "datamodule.batch_size=4",
          "datamodule.eval_batch_size=4", "model.dim=16", "model.dropout=0.2", "module.num_predictions=2",
          "module.num_predictions_test=2", "module.use_ema=true", "trainer.max_steps=3",
          "trainer.log_every_n_steps=1", "trainer.val_every_n_epochs=100"]
SHARDED = ["trainer.devices=2", "trainer.spatial_shards=2"]
# the NS DDPM on a 64 x 64 working grid: its deepest level has one column
NS_DDPM = ["diffusion.timesteps=4", "model.upsample_dims=(64,64)"]
# the single-stage forecasters on the physical systems: (system, method, sharded axis)
BASELINES = (("spring_mesh", "time_conditioned", "h"), ("spring_mesh", "simultaneous", "h"),
             ("navier_stokes", "time_conditioned", "w"))


def _overrides(system, data, registry, layout):
    return (NS if system == "navier_stokes" else SPRING) + [f"datamodule.data_dir={data}",
                                                            f"registry_dir={registry}"] + layout


def _commands(system, data, registry, layout):
    """(preset, overrides) of stage 1 and of stage 2 by run id."""
    common = _overrides(system, data, registry, layout)
    run1 = get_run_id(get_config(f"{system}_interpolation", common))
    return [(f"{system}_interpolation", common),
            (f"{system}_dyffusion", common + [f"diffusion.interpolator_run_id={run1}"])]


def _cancelled_biases(state):
    """The conv biases that the BatchNorm right after each conv subtracts
    again: their gradient is 0 but for rounding, and Adam moves each a full
    step of the rounding's sign, another sign in another layout (or at
    another thread count), whatever the loss does."""
    out = set()
    for k in state:
        if k.endswith(".running_mean"):
            head, _, idx = k[: -len(".running_mean")].rpartition(".")
            conv = f"{head}.{int(idx) - 1}.bias" if idx.isdigit() else f"{head}.conv.bias"
            out |= {conv} & set(state)
    return out


def assert_trains_as(registry, want_registry, run_id, steps):
    """``tests/test_torch_port_spatial_train.py``'s check (losses within
    1e-5 relative, weights and EMA within 1e-2 of their change), the
    :func:`_cancelled_biases` left out of the weights."""
    _assert_trains_as(registry, want_registry, run_id, steps=steps,
                      ignore=_cancelled_biases(_state(want_registry, run_id)["model"]))


# ---------------------------------------------------------------------------
# the JAX side


def _random_variables(jm, shape, C, Cc, g):
    """Random variables of the JAX backbone ``jm`` on an H x W grid, in the
    shapes of its init (``jax.eval_shape``, no compile): kernels N(0,
    1/fan_in), biases N(0, 0.1^2), norm scales 1 + N(0, 0.1^2), running
    means N(0, 0.3^2), running variances U(0.5, 1.5)."""
    x = jnp.zeros((1, *shape, C), jnp.float32)
    cond = jnp.zeros((1, *shape, Cc), jnp.float32)
    shapes = jax.eval_shape(lambda: jm.init({"params": jax.random.key(0)}, x, time=jnp.zeros((1,)), condition=cond))

    def draw(path, leaf):
        name = str(path[-1].key)
        if name == "mean":
            return (0.3 * g.normal(size=leaf.shape)).astype(np.float32)
        if name == "var":
            return g.uniform(0.5, 1.5, size=leaf.shape).astype(np.float32)
        if name in ("scale", "g"):
            return (1.0 + 0.1 * g.normal(size=leaf.shape)).astype(np.float32)
        if name == "kernel" and len(leaf.shape) > 1:
            return (g.normal(size=leaf.shape) / np.sqrt(np.prod(leaf.shape[:-1]))).astype(np.float32)
        return (0.1 * g.normal(size=leaf.shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, dict(shapes))


def _backbone_case(name, seed):
    """A JAX backbone with random variables, ported, with inputs and a
    cotangent: the case the ranks take (NCHW) and a function giving the
    JAX answers (NCHW, the port's state-dict names): the eval forward and,
    but for the ``Unet``, the train-mode forward, its updated running
    statistics and ``jax.grad`` of sum(output * cot)."""
    cls, grid, axis, kw, faults = BACKBONE_CASES[name]
    jcls, convert = JAX[cls]
    C, Cc = (3, 2) if cls != "SimpleConvNet" else (4, 1)
    kw = dict(kw, num_input_channels=C, num_output_channels=C, num_conditional_channels=Cc, with_time_emb=True)
    if cls == "Unet":
        kw.update(UNET_KW)
    jm = jcls(**{k: v for k, v in kw.items() if k != "remat"})
    g = np.random.default_rng(seed)
    v = _random_variables(jm, grid, C, Cc, g)
    train = cls != "Unet"  # the Unet case checks the outer resample's eval forward
    x, cond, cot = (g.normal(size=(3, *grid, c)).astype(np.float32) for c in (C, Cc, C))
    t = np.asarray([0.5, 2.0, 3.5], np.float32)
    nchw = lambda a: np.ascontiguousarray(np.asarray(a).transpose(0, 3, 1, 2))  # noqa: E731
    state = convert(v) if convert else unet_state_dict_from_jax(v["params"])
    case = {"cls": cls, "kwargs": kw, "state": {k: s.numpy() for k, s in state.items()}, "x": nchw(x),
            "cond": nchw(cond), "cot": nchw(cot), "t": t, "axis": axis, "faults": list(faults), "train": train}

    def jax_answers():
        apply = lambda variables, x, train: jm.apply(  # noqa: E731
            variables, x, time=t, condition=cond, deterministic=True, train=train, mutable=["batch_stats"] if train
            else False) if cls != "Unet" else jm.apply(variables, x, time=t, condition=cond, deterministic=True)
        out = {"eval": nchw(jax.jit(lambda v, x: apply(v, x, False))(v, jnp.asarray(x)))}
        if not train:
            return out

        def f(params, x):
            y, updates = apply({"params": params, "batch_stats": v.get("batch_stats", {})}, x, True)
            return jnp.sum(y * cot), (y, updates.get("batch_stats", {}))

        (_, (y, stats)), (dp, dx) = jax.jit(jax.value_and_grad(f, argnums=(0, 1), has_aux=True))(v["params"], x)
        stats = convert({"params": v["params"], "batch_stats": to_numpy_tree(stats)})
        updates = {k: s.numpy() for k, s in stats.items() if "running" in k}
        grads = convert({"params": to_numpy_tree(dp), "batch_stats": v.get("batch_stats", {})})
        names = set(state) - {k for k in state if "running" in k or "num_batches" in k}
        out.update(train=nchw(y), updates=updates,
                   grads={"x": nchw(dx), **{k: s.numpy() for k, s in grads.items() if k in names}})
        return out

    return case, jax_answers


def _boundary_case(data_dir, seed=11):
    """NS predictions (N, B, 221, 42, C) and a batch's metadata, random."""
    g = np.random.default_rng(seed)
    B = 3
    meta = {"metadata_fixed_mask": g.uniform(size=(B, 221, 42, 3)) < 0.2,
            "metadata_in_velocity": g.uniform(0.5, 1.5, size=(B,)).astype(np.float32),
            "metadata_vertex_y": g.uniform(0.0, 0.41, size=(B, 42)).astype(np.float32)}
    return {"data_dir": data_dir, "preds": g.normal(size=(2, B, 221, 42, 3)).astype(np.float32), "meta": meta,
            "time": g.uniform(0.0, 2.0, size=(B,)).astype(np.float32)}


class _Datamodule:
    dims = {"spatial": (221, 42)}


def _jax_divisibility_error():
    mesh = type("Mesh", (), {"shape": {"model": WORLD}})()
    with pytest.raises(AssertionError) as err:
        jax_check_spatial_divisibility(mesh, _Datamodule(), "h")
    return str(err.value)


# ---------------------------------------------------------------------------
# the module's spawn, beside the JAX side, the CLI on W and the one-process runs


def _cli_chain(ns, regs, ready, done):
    """NS stage 1 through the CLI on two ranks sharding W; once ``ready``
    is set, stage 2 by run id on the one-process stage 1 (its copy in
    ``regs['ns_w2']``), then the file ``done``: each command's printed
    line."""
    layout = SHARDED + ["trainer.spatial_axis=w"]
    stage1 = _commands("navier_stokes", ns, regs["ns_w"], layout)[0]
    stage2 = _commands("navier_stokes", ns, regs["ns_w2"], layout)[1]
    try:
        out = [_finish(_cli([f"experiment={stage1[0]}", *stage1[1]]))]
        ready.wait()
        out.append(_finish(_cli([f"experiment={stage2[0]}", *stage2[1]])))
    finally:  # the waiting ranks go on (and fail) if a command did
        open(done, "w").close()
    return out


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """The module's spawn of two ranks (:func:`spatial_workers
    .physical_rank`) and the CLI's NS runs on W, beside them the JAX
    answers and the one-process runs. Each stage 2 trains on the
    one-process stage 1 in both layouts (copied into the two-rank runs'
    second registry): a BatchNorm net's stage 1 differs between layouts
    where Adam moves a conv bias in front of a BatchNorm (a gradient of
    float noise) a step of either sign, and the frozen interpolator reads
    those biases in eval, so a stage 2 on each layout's own stage 1 would
    compare two interpolators."""
    root = tmp_path_factory.mktemp("spatial_physical")
    data = {system: write_fake_benchmark_dir(str(root / system), name, n_traj={"train": 1, "val": 1, "test": 1},
                                             n_time=10)
            for system, name in (("navier_stokes", "navier-stokes"), ("spring_mesh", "spring-mesh"))}
    regs = {name: str(root / name) for name in ("ns_one", "ns_w", "ns_w2", "spring_one", "spring_h", "spring_h2",
                                                 "baselines", "baselines_one", "raises", "ns_ddpm", "ns_ddpm_one")}
    cases = [_backbone_case(name, EVAL_CASES.index(_base(name))) for name in EVAL_CASES]
    boundary = _boundary_case(data["navier_stokes"])
    h = SHARDED + ["trainer.spatial_axis=h"]
    baselines = {f"{system}_{method}": (system, f"trainer.spatial_axis={axis}") for system, method, axis in BASELINES}
    baseline_cmds = {preset: (preset, _overrides(system, data[system], regs["baselines"], SHARDED + [axis]))
                     for preset, (system, axis) in baselines.items()}
    baseline_ids = {preset: get_run_id(get_config(*cmd)) for preset, cmd in baseline_cmds.items()}
    runs = {"stage 1": _commands("spring_mesh", data["spring_mesh"], regs["spring_h"], h)[:1],
            **{preset: [cmd] for preset, cmd in baseline_cmds.items()},
            "after stage 1: stage 2": _commands("spring_mesh", data["spring_mesh"], regs["spring_h2"], h)[1:]}
    one_cmds = {system: _commands(system, data[system], regs[reg], [])
                for system, reg in (("navier_stokes", "ns_one"), ("spring_mesh", "spring_one"))}
    ids = {system: [get_run_id(get_config(p, o)) for p, o in cmds] for system, cmds in one_cmds.items()}
    ns_tiny = NS + [f"datamodule.data_dir={data['navier_stokes']}", f"registry_dir={regs['raises']}"] + SHARDED
    raises = {"ns on h": ("navier_stokes_interpolation", ns_tiny + ["trainer.spatial_axis=h"])}
    ns_ddpm = {reg: ("navier_stokes_ddpm", _overrides("navier_stokes", data["navier_stokes"], regs[reg], layout)
                     + NS_DDPM) for reg, layout in (("ns_ddpm", SHARDED + ["trainer.spatial_axis=w"]),
                                                    ("ns_ddpm_one", []))}
    ns_ddpm_id = get_run_id(get_config(*ns_ddpm["ns_ddpm"]))
    runs["ns ddpm"] = [ns_ddpm["ns_ddpm"]]
    ready, ready_file, ns_done = threading.Event(), str(root / "stage 1 ready"), str(root / "ns stage 2 done")
    def one_process():
        """The one-process runs: each stage 1, copied beside the two-rank
        runs for their stage 2 (then ``ready``), each stage 2, the
        single-stage forecasters."""
        try:
            for system, reg in (("navier_stokes", "ns_w2"), ("spring_mesh", "spring_h2")):
                spatial_workers.run_commands(one_cmds[system][:1])
                run1 = ids[system][0]
                shutil.copytree(os.path.join(regs[reg.replace("_w2", "_one").replace("_h2", "_one")], run1),
                                os.path.join(regs[reg], run1))
        finally:  # the waiting ranks and commands go on (and fail) if stage 1 did
            ready.set()
            open(ready_file, "w").close()
        for system in one_cmds:
            spatial_workers.run_commands(one_cmds[system][1:])
        spatial_workers.run_commands([(preset, _overrides(system, data[system], regs["baselines_one"], []))
                                      for preset, (system, _) in baselines.items()] + [ns_ddpm["ns_ddpm_one"]])

    with ThreadPoolExecutor(3) as pool:
        tests = {"spring_mesh": (regs["spring_h2"], ids["spring_mesh"][1]),
                 **{preset: (regs["baselines"], run_id) for preset, run_id in baseline_ids.items()},
                 "navier_stokes": (regs["ns_w2"], ids["navier_stokes"][1]),
                 "ns ddpm": (regs["ns_ddpm"], ns_ddpm_id)}
        waits = {"after stage 1: stage 2": ready_file, "navier_stokes": ns_done}
        spawn = pool.submit(workers.run_ranks, spatial_workers.physical_rank, WORLD, [c for c, _ in cases], boundary,
                            runs, tests, raises, waits)
        cli = pool.submit(_cli_chain, data["navier_stokes"], regs, ready, ns_done)
        runs_one = pool.submit(one_process)
        answers = {name: jax_answers() for name, (_, jax_answers) in zip(EVAL_CASES, cases) if name == _base(name)}
        answers = [answers[_base(name)] for name in EVAL_CASES]
        dm = PhysicalSystemsDataModule(data["navier_stokes"], physical_system="navier-stokes")
        want_boundary = dm.boundary_conditions(torch.as_tensor(boundary["preds"]),
                                               {k: torch.as_tensor(v) for k, v in boundary["meta"].items()},
                                               torch.as_tensor(boundary["time"])).numpy()
        out, cli_lines, _ = spawn.result(), cli.result(), runs_one.result()
    # mode=test of the two-rank runs on one process: the same weights
    one_process = ["trainer.devices=1", "trainer.spatial_shards=1"]
    one = {system: {"ids": ids[system], "test": reload_and_test(regs[reg], ids[system][1], one_process, device="cpu")}
           for system, reg in (("navier_stokes", "ns_w2"), ("spring_mesh", "spring_h2"))}
    one.update({preset: {"ids": [run_id], "test": reload_and_test(regs["baselines"], run_id, one_process, device="cpu")}
                for preset, run_id in baseline_ids.items()})
    one["ns ddpm"] = {"ids": [ns_ddpm_id], "test": reload_and_test(regs["ns_ddpm"], ns_ddpm_id, one_process,
                                                                   device="cpu")}
    return dict(cases=[c for c, _ in cases], answers=answers, out=out, cli=cli_lines, one=one, regs=regs,
                boundary=boundary, want_boundary=want_boundary, jax_error=_jax_divisibility_error())


# ---------------------------------------------------------------------------
# (a), (b): the backbones against JAX


def _joined(ranks, i, get):
    axis = ranks["cases"][i]["axis"]
    return np.concatenate([get(r["backbones"][i]) for r in ranks["out"]], axis=2 if axis == "h" else 3)


def _assert_close(got, want, r=REL, what=""):
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err, scale = float(np.abs(got - want).max()), float(np.abs(want).max())
    assert err <= r * scale, f"{what}: max abs err {err:.3e} > {r} x {scale:.3e}"


def _assert_grads_close(got, want):
    """Each tensor within GRAD_REL of the larger of its own max|JAX| and
    GRAD_FLOOR of the largest of all."""
    assert sorted(got) == sorted(want)
    top = max(float(np.abs(w).max()) for w in want.values())
    for k, w in want.items():
        err = float(np.abs(np.asarray(got[k], np.float64) - w).max())
        limit = GRAD_REL * max(float(np.abs(w).max()), GRAD_FLOOR * top)
        assert err <= limit, f"{k}: max abs err {err:.3e} > {limit:.3e}"


def _check(ranks, i, what, fault=None):
    """The sharded backbone ``i``'s ``what`` ('eval', 'train', 'updates',
    'grads') under ``fault`` against the JAX answer."""
    want = ranks["answers"][i][what]
    if what == "updates":  # the same on every rank
        got = ranks["out"][0]["backbones"][i][fault]["updates"]
        assert {k for k in got if "running" in k} == set(want)
        for k, w in want.items():
            _assert_close(got[k], w, what=k)
        assert all(int(v) == 1 for k, v in got.items() if "num_batches" in k)
    elif what == "grads":
        got = dict(ranks["out"][0]["backbones"][i][fault]["grads"])
        got["x"] = _joined(ranks, i, lambda r: r[fault]["grads"]["x"])
        _assert_grads_close(got, want)
    else:
        _assert_close(_joined(ranks, i, lambda r: r[fault][what]), want, what=what)


TRAIN_CASES = [n for n in BACKBONE_CASES if BACKBONE_CASES[n][0] != "Unet"]


def _has_batch_norm(name):
    return BACKBONE_CASES[name][3].get("net_normalization", "batch_norm") == "batch_norm"


@pytest.mark.parametrize("name", EVAL_CASES)
def test_sharded_eval_forward_matches_jax(ranks, name):
    _check(ranks, EVAL_CASES.index(name), "eval")


@pytest.mark.parametrize("name,what", [(n, w) for n in TRAIN_CASES for w in ("train", "updates", "grads")
                                       if w != "updates" or _has_batch_norm(n)])
def test_sharded_train_forward_updates_and_gradients_match_jax(ranks, name, what):
    i = EVAL_CASES.index(name)
    _check(ranks, i, what)
    if what == "grads":  # every rank holds the same summed weight gradients
        for k, v in ranks["out"][1]["backbones"][i][None]["grads"].items():
            if k != "x":
                np.testing.assert_array_equal(v, ranks["out"][0]["backbones"][i][None]["grads"][k])


def _fault_cases():
    """(backbone, fault, check) for every planted fault and every check it
    can reach: BatchNorm per rank only in train mode, the updates only
    where a BatchNorm is."""
    out = []
    for name, (cls, _, _, _, faults) in BACKBONE_CASES.items():
        for fault in faults:
            whats = ["eval"] if cls == "Unet" else ["eval", "train"] + ["updates"] * _has_batch_norm(name) + ["grads"]
            if fault == "batch norm per rank":
                whats = ["train", "updates", "grads"]
            out += [(name, fault, what) for what in whats]
    return out


@pytest.mark.parametrize("name,fault,what", _fault_cases())
def test_planted_faults_fail_the_check(ranks, name, fault, what):
    with pytest.raises(AssertionError):
        _check(ranks, EVAL_CASES.index(name), what, fault)


def test_resample_taps_read_global_rows():
    """The taps of a slab's resample come from the global coordinates: NS
    on W at K = 2, the 42 columns resampled to 256, rank 0's last output
    column (127) and rank 1's first (128) both read source columns 20 and
    21 (21 is rank 1's, 20 rank 0's); the source index clamps at the grid's
    edges; the way out, 512 -> 221, takes two taps, no antialias."""
    i0, i1, w = spatial._taps(127, 129, 42, 256, "bilinear")
    assert i0.tolist() == [20, 20] and i1.tolist() == [21, 21] and np.all((w > 0) & (w < 1))
    i0, i1, w = spatial._taps(0, 256, 42, 256, "bilinear")
    assert i0[0] == 0 and w[0] == 0 and i0[-1] == i1[-1] == 41
    i0, i1, w = spatial._taps(0, 221, 512, 221, "bilinear")
    assert np.all(i1 - i0 == 1) and i0[0] == 0 and i1[-1] <= 511
    x = torch.randn(1, 1, 512, 3, generator=torch.Generator().manual_seed(0))
    want = torch.nn.functional.interpolate(x, size=(221, 3), mode="bilinear", align_corners=False)[0, 0, :, 0]
    got = torch.lerp(x[0, 0, i0, 0], x[0, 0, i1, 0], torch.as_tensor(w))
    assert float((got - want).abs().max()) <= REL * float(want.abs().max())


@pytest.mark.parametrize("k,s,p", [(4, 2, 1), (2, 2, 0), (3, 1, 1)])
def test_transposed_conv_rows_are_the_rows_its_outputs_read(k, s, p):
    """``spatial.transposed_rows`` against a count of which input rows
    reach which outputs, for every block of every split of 1..12 rows over
    1..4 ranks: each output block reads exactly its range (beyond the grid
    at the edges: zeros)."""
    for n in range(1, 13):
        total = (n - 1) * s - 2 * p + k
        for ranks in range(1, min(n, 4) + 1):
            for a, b in spatial.blocks(total, ranks):
                read = {i for o in range(a, b) for i in range(-k, n + k) for j in range(k) if o == i * s - p + j}
                lo, hi = spatial.transposed_rows(a, b, k, s, p)
                assert set(range(lo, hi)) == read, (n, a, b, lo, hi)


# ---------------------------------------------------------------------------
# (c) the boundary conditions


@pytest.mark.parametrize("axis", ["h", "w"])
def test_ns_boundary_conditions_on_a_slab_match_one_process(ranks, axis):
    slabs = [r["boundary"][axis] for r in ranks["out"]]
    np.testing.assert_array_equal(np.concatenate(slabs, axis=2 if axis == "h" else 3), ranks["want_boundary"])
    if axis == "h":  # rank 1's first row is global row 111: the prediction, masked, not the inflow
        preds, fixed = ranks["boundary"]["preds"], ranks["boundary"]["meta"]["metadata_fixed_mask"]
        kept = np.where(fixed[:, 111], 0.0, preds[:, :, 111])
        np.testing.assert_array_equal(slabs[1][:, :, 0], kept)
        assert not np.allclose(slabs[1][:, :, 0, :, 0], ranks["want_boundary"][:, :, 0, :, 0])


# ---------------------------------------------------------------------------
# (d) two ranks against one process


@pytest.mark.parametrize("stage", [0, 1], ids=["stage 1", "stage 2"])
def test_cli_ns_on_w_trains_as_one_process(ranks, stage):
    run_id = os.path.basename(ranks["cli"][stage]["run_dir"])
    assert run_id == ranks["one"]["navier_stokes"]["ids"][stage]  # the run id of one process
    assert_trains_as(ranks["regs"]["ns_w2" if stage else "ns_w"], ranks["regs"]["ns_one"], run_id, steps=3)


@pytest.mark.parametrize("stage", [0, 1], ids=["stage 1", "stage 2"])
def test_spring_on_h_trains_as_one_process(ranks, stage):
    run_id = ranks["one"]["spring_mesh"]["ids"][stage]
    name = "after stage 1: stage 2" if stage else "stage 1"
    assert [r["runs"][name] for r in ranks["out"]] == [[run_id]] * WORLD
    assert_trains_as(ranks["regs"]["spring_h2" if stage else "spring_h"], ranks["regs"]["spring_one"], run_id, 3)


def _assert_metrics_close(got, want):
    """Each test metric within 1e-5 of the largest (the SSR of a few steps'
    training is ~1e-3: its members' spread is ~1e-3 of their values, so
    their rounding moves it by ~1e-3 of itself)."""
    keys = [k for k in want if "frames_per_sec" not in k]
    assert len([k for k in keys if k.startswith("test/t")]) == 3 * 8  # the 8 steps of two windows
    scale = max(abs(want[k]) for k in keys)
    for metrics in got:
        for k in keys:
            assert abs(metrics[k] - want[k]) <= REL * scale, (k, metrics[k], want[k])


@pytest.mark.parametrize("system", ["navier_stokes", "spring_mesh"])
def test_sharded_test_mode_matches_one_process(ranks, system):
    """``mode=test`` of the two-rank run on two ranks against the same run
    on one process."""
    _assert_metrics_close([r["tests"][system] for r in ranks["out"]], ranks["one"][system]["test"])


@pytest.mark.parametrize("preset", [f"{system}_{method}" for system, method, _ in BASELINES])
def test_sharded_baselines_train_and_test_as_one_process(ranks, preset):
    """The time-conditioned and simultaneous forecasters trained on two
    ranks (spring on H, NS on W) against one process, then ``mode=test``
    of the two-rank run on two ranks against it on one."""
    run_id = ranks["one"][preset]["ids"][0]
    assert [r["runs"][preset] for r in ranks["out"]] == [[run_id]] * WORLD
    assert_trains_as(ranks["regs"]["baselines"], ranks["regs"]["baselines_one"], run_id, steps=3)
    _assert_metrics_close([r["tests"][preset] for r in ranks["out"]], ranks["one"][preset]["test"])


# ---------------------------------------------------------------------------
# (e) NS on H, and the NS DDPM on a level of fewer columns than ranks


def test_ns_on_h_raises_the_jax_wording(ranks):
    for r in ranks["out"]:
        assert r["raises"]["ns on h"] == [ranks["jax_error"]]
    assert "height H=221" in ranks["jax_error"]


def test_ns_ddpm_under_a_shard_still_raises_a2(ranks):
    """The DDPM engine on W with a 64-column working grid, whose deepest
    level of one column leaves one of the two ranks an empty block: trained
    on two ranks as on one process at the same seed (losses, weights), and
    ``mode=test`` of that run (the sampler's samples through the metrics)
    on two ranks as on one."""
    run_id = ranks["one"]["ns ddpm"]["ids"][0]
    assert [r["runs"]["ns ddpm"] for r in ranks["out"]] == [[run_id]] * WORLD
    assert_trains_as(ranks["regs"]["ns_ddpm"], ranks["regs"]["ns_ddpm_one"], run_id, steps=3)
    _assert_metrics_close([r["tests"]["ns ddpm"] for r in ranks["out"]], ranks["one"]["ns ddpm"]["test"])
