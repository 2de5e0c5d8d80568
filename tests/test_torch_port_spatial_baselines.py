"""The diffusion baselines under a shard on the CPU: two gloo ranks split the
grid's H or W axis of the NCSN++ backbones and of the DDPM, LDM and MCVD
engines' draws, against the JAX package and against one process.

- (a) The slab-aware FIR resampling (``parallel.spatial``): ``upfirdn2d``
  with an asymmetric kernel at several up / down / pad factors (negative
  pads crop), and the four x2 resamplers of NCSN++ (the fused transposed
  conv + FIR and FIR + stride-2 conv among them), on H and on W of a 9 x 7
  grid (5 / 4 and 4 / 3 rows a rank), against the one-process ops within
  1e-5 of max; torch's floor ``nearest`` taps against ``F.interpolate``.
- (b) ``NCSNpp`` (nf 8, mults (1, 2), one residual block, attention at 8,
  a 16 x 16 grid; BigGAN and DDPM residual blocks, positional and Fourier
  time embeddings) and ``SPADENCSNpp`` (on H, on W under remat, and on a
  10 x 8 grid whose 5-row level splits 3 / 2 against the 5 / 5 rows of
  its condition) against the one-device JAX models on the same random
  weights, dropout off: the eval forward within 1e-5 of max|JAX|; the
  gradients of sum(output * cot), the input's and every weight's, within
  1e-4 of the larger of the tensor's max|JAX| and 0.1 of the largest of
  all. Planted faults, each of which must fail the forward's check: every
  halo zeroed (the FIR resampling's too), the attention over each rank's
  own tokens, GroupNorm per rank, the SPADE map resized from each slab
  alone.
- (c) The six annealed-Langevin functions over a sharded ``NCSNpp`` (3
  levels, one step each) with their own draws from one seed against one
  process, within 1e-5 of max.
- (d) Two ranks against one process at the same seed, dropout on where
  the preset has it: ``synthetic_ddpm``, ``synthetic_ddpm_v2``
  (``diffusion.learn_logvar=true``) and ``synthetic_mcvd``
  (``diffusion.gamma=true``, ``noise_in_cond=true``) on H,
  ``navier_stokes_ddpm`` on W, ``spring_mesh_mcvd`` on H and
  ``synthetic_mcvd model.name=ncsnpp`` on W, 2 AdamW + EMA steps each:
  every logged loss within 1e-5 relative, the weights and the EMA within
  1e-2 of their change (``assert_trains_as``, the conv biases in front of
  a BatchNorm left out as there); then ``mode=test`` of each two-rank run
  on its ranks against the same run on one process (DDPM, DDIM, the LDM's
  ancestral sampler, MCVD's DDPM, DDIM and F-PNDM with Gamma noise, the
  NS autoregressive chain) within 1e-5 of the largest metric. The planted
  fault, every draw over the grid taken at the slab's shape, must fail a
  training run (MCVD with Gamma noise) and two samplers (DDPM, MCVD).

One spawn of two ranks computes (a)-(d) beside the JAX side and the
one-process runs; each rank has a deadline of 360 s
(``tests/_torch_ddp_workers.py``).
"""
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dyffusion_tpu.models import ncsnpp as jn
from dyffusion_tpu_torch.config import get_config
from dyffusion_tpu_torch.data import write_fake_benchmark_dir
from dyffusion_tpu_torch.diffusion import get_sigmas
from dyffusion_tpu_torch.interface import reload_and_test
from dyffusion_tpu_torch.models import ncsnpp_state_dict_from_jax, spade_ncsnpp_state_dict_from_jax
from dyffusion_tpu_torch.ops import upfirdn2d as fir
from dyffusion_tpu_torch.parallel import spatial
from dyffusion_tpu_torch.utils.naming import get_run_id
from tests import _torch_ddp_workers as workers
from tests import _torch_spatial_workers as spatial_workers
from tests._torch_port_helpers import to_numpy_tree
from tests._torch_port_helpers import torch_threads_share_of_cores  # noqa: F401 (autouse fixture)
from tests.test_torch_port_spatial_physical import NS, SPRING, assert_trains_as

WORLD = 2
# the ranks' deadline: their work takes ~80 s alone and more than 120 s beside five other test workers
SPAWN_TIMEOUT_S = 360
REL = 1e-5
GRAD_REL = 1e-4
GRAD_FLOOR = 0.1

# ---------------------------------------------------------------------------
# (a) the FIR resampling
FIR_TAPS = [1.0, 2.0, 5.0, 3.0]  # asymmetric: an unflipped kernel gives other numbers
FIR_CASES = [(2, 1, (2, 1)), (1, 2, (1, 1)), (2, 2, (1, 2)), (3, 1, (2, 0)), (1, 1, (-1, -1)), (1, 2, (2, 2))]

# ---------------------------------------------------------------------------
# (b) the NCSN++ backbones: name -> (class, grid (H, W), axis, kwargs, gradients, planted faults)
NCSNPP_KW = dict(dim=8, num_input_channels=2, num_output_channels=2, num_conditional_channels=1, n_head_channels=8,
                 dim_mults=(1, 2), num_res_blocks=1, attn_resolutions=(8,), spatial_height=16)
CASES = {
    "biggan positional h": ("NCSNpp", (16, 16), "h", {}, True,
                            ("halos zeroed", "group norm per rank", "attention per rank")),
    "biggan fourier condemb w": ("NCSNpp", (16, 16), "w", dict(embedding_type="fourier", cond_emb=True), False,
                                 ("halos zeroed",)),
    "ddpm positional w": ("NCSNpp", (16, 16), "w", dict(resblock_type="ddpm"), True, ("halos zeroed",)),
    "ddpm fourier h": ("NCSNpp", (16, 16), "h", dict(resblock_type="ddpm", embedding_type="fourier"), False, ()),
    "spade h": ("SPADENCSNpp", (16, 16), "h", dict(spade_dim=8), False, ("halos zeroed", "attention per rank")),
    "spade w remat": ("SPADENCSNpp", (16, 16), "w", dict(spade_dim=8, remat=True), True, ("group norm per rank",)),
    # 10 rows: the 5-row level splits 3 / 2, its condition's 10 rows 5 / 5, so a slab's own resize reads
    # other rows than the global one
    "spade h 10x8": ("SPADENCSNpp", (10, 8), "h", dict(spade_dim=8, spatial_height=10, attn_resolutions=(5,)), False,
                     ("resize per slab",)),
}
JAX = {"NCSNpp": (jn.NCSNpp, ncsnpp_state_dict_from_jax),
       "SPADENCSNpp": (jn.SPADENCSNpp, spade_ncsnpp_state_dict_from_jax)}
FAULTS = [(name, fault) for name, case in CASES.items() for fault in case[5]]

# ---------------------------------------------------------------------------
# (d) the engines
SYNTHETIC = [
    "datamodule.spatial=(8,8)", "datamodule.channels=1", "datamodule.horizon=2", "datamodule.n_traj=5",
    "datamodule.n_time=8", "datamodule.batch_size=4", "datamodule.eval_batch_size=3", "model.dim=8",
    "model.dim_mults=(1,2)", "module.num_predictions=2", "module.num_predictions_test=2", "module.use_ema=true",
    "trainer.log_every_n_steps=1", "trainer.val_every_n_epochs=100", "diffusion.timesteps=4",
]
STEPS = 2  # AdamW + EMA steps of each engine run
UNET = ["model.block_dropout=0.2", "model.attn_heads=1", "model.attn_dim_head=8"]
NCSNPP = ["model.name=ncsnpp", "model.num_res_blocks=1", "model.attn_resolutions=(4,)", "model.n_head_channels=8",
          "model.dropout=0.1"]
SHARDED = ["trainer.devices=2", "trainer.spatial_shards=2"]
# name -> (preset, dataset, overrides, axis)
ENGINES = {
    "synthetic_ddpm h": ("synthetic_ddpm", "synthetic", UNET, "h"),
    "synthetic_ddpm_v2 learned logvar h": ("synthetic_ddpm_v2", "synthetic", UNET + ["diffusion.learn_logvar=true"],
                                           "h"),
    "synthetic_mcvd gamma h": ("synthetic_mcvd", "synthetic", UNET + ["diffusion.gamma=true",
                                                                      "diffusion.noise_in_cond=true"], "h"),
    "navier_stokes_ddpm w": ("navier_stokes_ddpm", "navier_stokes", ["diffusion.timesteps=4"], "w"),
    "spring_mesh_mcvd h": ("spring_mesh_mcvd", "spring_mesh", ["diffusion.timesteps=4"], "h"),
    "synthetic_mcvd ncsnpp w": ("synthetic_mcvd", "synthetic", NCSNPP, "w"),
}
# the samplers of mode=test: name -> (engine run, overrides)
SAMPLERS = {
    "ddpm": ("synthetic_ddpm h", []),
    "ddim": ("synthetic_ddpm h", ["diffusion.sampling_timesteps=2"]),
    "ldm ancestral, learned logvar": ("synthetic_ddpm_v2 learned logvar h", []),
    "mcvd ddpm, gamma": ("synthetic_mcvd gamma h", []),
    "mcvd ddim, gamma": ("synthetic_mcvd gamma h", ["diffusion.version=DDIM"]),
    "mcvd fpndm, gamma": ("synthetic_mcvd gamma h", ["diffusion.version=FPNDM"]),
    "navier_stokes ddpm, autoregressive": ("navier_stokes_ddpm w", []),
    "spring_mesh mcvd": ("spring_mesh_mcvd h", []),
    "mcvd over ncsnpp": ("synthetic_mcvd ncsnpp w", []),
}
FAULTY_RUN = "synthetic_mcvd gamma h"
FAULTY_SAMPLERS = ("ddpm", "mcvd ddpm, gamma")
ONE_PROCESS = ["trainer.devices=1", "trainer.spatial_shards=1"]


def _engine_command(name, data, registry, layout):
    """(preset, overrides) of the engine run ``name`` into ``registry``, on
    two ranks sharding its axis with ``layout``, else on one process."""
    preset, dataset, extra, axis = ENGINES[name]
    base = {"synthetic": SYNTHETIC, "navier_stokes": NS, "spring_mesh": SPRING}[dataset]
    data_dir = [] if dataset == "synthetic" else [f"datamodule.data_dir={data[dataset]}"]
    sharded = SHARDED + [f"trainer.spatial_axis={axis}"] if layout else []
    return preset, base + data_dir + extra + [f"trainer.max_steps={STEPS}", f"registry_dir={registry}"] + sharded


# ---------------------------------------------------------------------------
# the JAX side


def _random_variables(jm, grid, C, Cc, g):
    """Random variables of the JAX NCSN++ ``jm`` on an H x W grid, in the
    shapes of its init (``jax.eval_shape``, no compile): kernels N(0,
    1/fan_in), GroupNorm scales 1 + N(0, 0.1^2), everything else (biases,
    embeddings, the Fourier features) N(0, 0.1^2)."""
    x = jnp.zeros((1, *grid, C), jnp.float32)
    cond = jnp.zeros((1, *grid, Cc), jnp.float32)
    shapes = jax.eval_shape(lambda: jm.init(jax.random.key(0), x, time=jnp.zeros((1,)), condition=cond))

    def draw(path, leaf):
        name = str(path[-1].key)
        if name == "scale":
            return (1.0 + 0.1 * g.normal(size=leaf.shape)).astype(np.float32)
        if name in ("kernel", "W") and len(leaf.shape) > 1:
            return (g.normal(size=leaf.shape) / np.sqrt(np.prod(leaf.shape[:-1]))).astype(np.float32)
        return (0.1 * g.normal(size=leaf.shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, dict(shapes))


def _ncsnpp_case(name, seed):
    """A JAX NCSN++ with random variables, ported, with inputs and a
    cotangent: the case the ranks take (NCHW) and a function giving the
    JAX answers (NCHW, the port's state-dict names): the eval forward and
    the gradients of sum(output * cot)."""
    cls, grid, axis, extra, grads, faults = CASES[name]
    jcls, convert = JAX[cls]
    kw = {**NCSNPP_KW, **extra}
    jm = jcls(**{k: v for k, v in kw.items() if k != "remat"})
    g = np.random.default_rng(seed)
    v = _random_variables(jm, grid, kw["num_input_channels"], kw["num_conditional_channels"], g)
    x, cond, cot = (g.normal(size=(2, *grid, c)).astype(np.float32) for c in (2, 1, 2))
    t = np.asarray([3.0, 17.0], np.float32)
    nchw = lambda a: np.ascontiguousarray(np.asarray(a).transpose(0, 3, 1, 2))  # noqa: E731
    state = {k: s.numpy() for k, s in convert(v).items()}
    case = {"cls": cls, "kwargs": kw, "state": state, "x": nchw(x), "cond": nchw(cond), "cot": nchw(cot), "t": t,
            "axis": axis, "faults": list(faults), "grads": grads}

    def f(params, x):
        return jm.apply({**v, "params": params}, x, time=t, condition=cond)

    def forward_backward(params, x):
        y, vjp = jax.vjp(f, params, x)
        return y, vjp(jnp.asarray(cot))

    def jax_answers():
        if not grads:
            return {"eval": nchw(jax.jit(f)(v["params"], jnp.asarray(x)))}
        y, (dp, dx) = jax.jit(forward_backward)(v["params"], jnp.asarray(x))
        want = convert({**v, "params": to_numpy_tree(dp)})
        # the Fourier features never train: the port cuts their gradient
        return {"eval": nchw(y), "grads": {"x": nchw(dx), **{k: s.numpy() for k, s in want.items()
                                                               if k != "fourier_emb.W"}}}

    return case, jax_answers


def _langevin_case(ncsnpp_case, seed=21):
    """The Langevin functions' inputs on the first NCSN++ case's network and
    grid (H split)."""
    g = np.random.default_rng(seed)
    shape = ncsnpp_case["x"].shape
    mask = np.zeros(shape, np.float32)
    mask[..., : shape[-1] // 2] = 1.0
    return {"kwargs": ncsnpp_case["kwargs"], "state": ncsnpp_case["state"], "axis": "h",
            "x": g.normal(size=shape).astype(np.float32), "cond": ncsnpp_case["cond"],
            "sparsity": g.uniform(0.5, 1.5, size=shape).astype(np.float32),
            "refer": g.normal(size=shape).astype(np.float32), "mask": mask,
            "sigmas": get_sigmas("geometric", 1.0, 0.01, 3), "n_steps": 1, "seed": seed}


def _fir_case():
    g = np.random.default_rng(31)
    return g.normal(size=(2, 3, 9, 7)).astype(np.float32), (0.2 * g.normal(size=(5, 3, 3, 3))).astype(np.float32)


# ---------------------------------------------------------------------------
# the module's spawn, beside the JAX side and the one-process runs


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    root = tmp_path_factory.mktemp("spatial_baselines")
    data = {system: write_fake_benchmark_dir(str(root / system), name, n_traj={"train": 1, "val": 1, "test": 1},
                                             n_time=10)
            for system, name in (("navier_stokes", "navier-stokes"), ("spring_mesh", "spring-mesh"))}
    regs = {k: str(root / k) for k in ("two", "one", "faulty")}
    x, w = _fir_case()
    cases = [_ncsnpp_case(name, seed) for seed, name in enumerate(CASES)]
    langevin = _langevin_case(cases[0][0])
    runs = {name: [_engine_command(name, data, regs["two"], True)] for name in ENGINES}
    faulty = {FAULTY_RUN: [_engine_command(FAULTY_RUN, data, regs["faulty"], True)]}
    ids = {name: get_run_id(get_config(*cmds[0])) for name, cmds in runs.items()}
    tests = {name: (regs["two"], ids[run], ov) for name, (run, ov) in SAMPLERS.items()}
    faulty_tests = {name: tests[name] for name in FAULTY_SAMPLERS}

    def one_process():
        """The one-process runs of every engine and the Langevin functions;
        ``mode=test`` of the two-rank runs on one process follows the
        spawn."""
        spatial_workers.run_commands([_engine_command(name, data, regs["one"], False) for name in ENGINES])
        return {"langevin": spatial_workers.langevin_run(langevin)}

    with ThreadPoolExecutor(2) as pool:
        spawn = pool.submit(workers.run_ranks, spatial_workers.baselines_rank, WORLD,
                            (x, w, FIR_TAPS, FIR_CASES), [c for c, _ in cases], langevin, runs, faulty, tests,
                            faulty_tests, timeout=SPAWN_TIMEOUT_S)
        one = pool.submit(one_process)
        answers = [jax_answers() for _, jax_answers in cases]
        out, one = spawn.result(), one.result()
    one["tests"] = {name: reload_and_test(reg, run_id, list(ov) + ONE_PROCESS, device="cpu")
                    for name, (reg, run_id, ov) in tests.items()}
    return dict(fir=(x, w), cases=[c for c, _ in cases], answers=answers, out=out, one=one, ids=ids, regs=regs)


def _joined(ranks, get, axis):
    """The ranks' NCHW slabs joined on ``axis``."""
    return np.concatenate([get(r) for r in ranks["out"]], axis=2 if axis == "h" else 3)


def _assert_close(got, want, r=REL, what=""):
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err, scale = float(np.abs(got - want).max()), float(np.abs(want).max())
    assert err <= r * scale, f"{what}: max abs err {err:.3e} > {r} x {scale:.3e}"


# ---------------------------------------------------------------------------
# (a) the FIR resampling


# the ranks' key of each FIR output -> the one-process op (x, w) -> output
FIR_PLAIN = {
    **{f"upfirdn2d {u} {d} {p}": (lambda x, w, u=u, d=d, p=p: fir.upfirdn2d(
        x, np.outer(FIR_TAPS, FIR_TAPS[::-1]), u, d, p)) for u, d, p in FIR_CASES},
    "fir_upsample": lambda x, w: fir.upsample_2d(x, FIR_TAPS),
    "fir_downsample": lambda x, w: fir.downsample_2d(x, FIR_TAPS),
    "upsample_conv_fir": lambda x, w: fir.upsample_conv_2d(x, w, FIR_TAPS),
    "conv_downsample_fir": lambda x, w: fir.conv_downsample_2d(x, w, FIR_TAPS),
}


@pytest.mark.parametrize("axis", ["h", "w"])
@pytest.mark.parametrize("op", list(FIR_PLAIN))
def test_sharded_fir_resampling_matches_one_process(ranks, op, axis):
    x, w = ranks["fir"]
    want = FIR_PLAIN[op](torch.as_tensor(x), torch.as_tensor(w)).numpy()
    _assert_close(_joined(ranks, lambda r: r["fir"][f"{axis} {op}"], axis), want, what=op)


def test_floor_nearest_taps_match_torch():
    """torch's 'nearest' (floor(i in / out), no half-pixel centres) from
    the global coordinates: the SPADE map's resize."""
    x = torch.arange(10.0).reshape(1, 1, 10, 1)
    for n_out in (5, 3, 7, 20):
        want = torch.nn.functional.interpolate(x, size=(n_out, 1), mode="nearest")[0, 0, :, 0]
        i0, i1, _ = spatial._taps(0, n_out, 10, n_out, "nearest")
        assert i0.tolist() == i1.tolist() == want.long().tolist()


# ---------------------------------------------------------------------------
# (b) the NCSN++ backbones against JAX


def _check(ranks, name, what, fault=None):
    i = list(CASES).index(name)
    axis = ranks["cases"][i]["axis"]
    want = ranks["answers"][i][what]
    if what == "eval":
        _assert_close(_joined(ranks, lambda r: r["ncsnpp"][i][fault]["eval"], axis), want, what=name)
        return
    got = dict(ranks["out"][0]["ncsnpp"][i][fault]["grads"])
    got["x"] = _joined(ranks, lambda r: r["ncsnpp"][i][fault]["grads"]["x"], axis)
    assert sorted(got) == sorted(want)
    top = max(float(np.abs(v).max()) for v in want.values())
    for k, v in want.items():
        err = float(np.abs(np.asarray(got[k], np.float64) - v).max())
        limit = GRAD_REL * max(float(np.abs(v).max()), GRAD_FLOOR * top)
        assert err <= limit, f"{name} {k}: max abs err {err:.3e} > {limit:.3e}"


@pytest.mark.parametrize("name", list(CASES))
def test_sharded_ncsnpp_forward_matches_jax(ranks, name):
    _check(ranks, name, "eval")


@pytest.mark.parametrize("name", [n for n, c in CASES.items() if c[4]])
def test_sharded_ncsnpp_gradients_match_jax(ranks, name):
    _check(ranks, name, "grads")
    i = list(CASES).index(name)  # every rank holds the same summed weight gradients
    for k, v in ranks["out"][1]["ncsnpp"][i][None]["grads"].items():
        if k != "x":
            np.testing.assert_array_equal(v, ranks["out"][0]["ncsnpp"][i][None]["grads"][k])


@pytest.mark.parametrize("name,fault", FAULTS, ids=[f"{n}: {f}" for n, f in FAULTS])
def test_planted_ncsnpp_faults_fail_the_check(ranks, name, fault):
    with pytest.raises(AssertionError):
        _check(ranks, name, "eval", fault)


# ---------------------------------------------------------------------------
# (c) the Langevin functions


@pytest.mark.parametrize("name", spatial_workers.LANGEVIN)
def test_sharded_langevin_matches_one_process(ranks, name):
    got = _joined(ranks, lambda r: r["langevin"][name], "h")
    _assert_close(got, ranks["one"]["langevin"][name], what=name)


# ---------------------------------------------------------------------------
# (d) the engines against one process


@pytest.mark.parametrize("name", list(ENGINES))
def test_two_ranks_train_the_engine_as_one_process(ranks, name):
    run_id = ranks["ids"][name]
    assert [r["runs"][name] for r in ranks["out"]] == [[run_id]] * WORLD  # the run id of one process
    assert_trains_as(ranks["regs"]["two"], ranks["regs"]["one"], run_id, steps=STEPS)


def _assert_metrics_close(got, want):
    keys = [k for k in want if "frames_per_sec" not in k]
    assert keys and sorted(got) == sorted(want)
    scale = max(abs(want[k]) for k in keys)
    for k in keys:
        assert abs(got[k] - want[k]) <= REL * scale, f"{k}: {got[k]} vs {want[k]} (scale {scale})"


@pytest.mark.parametrize("name", list(SAMPLERS))
def test_two_ranks_sample_as_one_process(ranks, name):
    want = ranks["one"]["tests"][name]
    assert all(np.isfinite(v) for v in want.values())
    for r in ranks["out"]:
        _assert_metrics_close(r["tests"][name], want)


def test_draws_at_the_slab_shape_fail_training(ranks):
    run_id = ranks["ids"][FAULTY_RUN]
    assert ranks["out"][0]["faulty"][FAULTY_RUN] == [run_id]
    with pytest.raises(AssertionError):
        assert_trains_as(ranks["regs"]["faulty"], ranks["regs"]["one"], run_id, steps=STEPS)


@pytest.mark.parametrize("name", FAULTY_SAMPLERS)
def test_draws_at_the_slab_shape_fail_the_sampler(ranks, name):
    with pytest.raises(AssertionError):
        _assert_metrics_close(ranks["out"][0]["faulty_tests"][name], ranks["one"]["tests"][name])
