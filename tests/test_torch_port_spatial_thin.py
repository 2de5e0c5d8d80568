"""The last layouts under a shard, on the CPU: levels of fewer rows than
ranks, the 'qk' linear attention, and every ``jax.image.resize`` method of
``UNetSimple``'s outer resample. One spawn of four gloo ranks, on a model
group of four and then on groups of two, beside the JAX answers and the
one-process witness.

- Thin levels, K = 4, f32, dropout off, each against one process within
  1e-5 of max (gradients: of the larger of the tensor's max and 0.1 of
  the largest of all): a ``Unet`` on a 12 x 12 grid on H and on W (levels
  12 / 6 / 3: the 3 rows split 1/1/1/0), forward and the gradients of
  sum(output * cot); ``NCSNpp`` on 16 x 16 (levels down to 2 rows,
  1/1/0/0), forward and gradients; a ``UNetSimple`` whose deepest level
  has 2 rows (20 x 12 resampled to 128 x 64), the gradients in f64 on both
  sides (f32 rounds some ReLU inputs to the other sign); the split B1's
  plain version over 3 tokens (1/1/1/0) against the unsplit plain version,
  forward and backward. Planted faults on the ``Unet`` on H, each of which
  must fail: every halo zeroed, and a rank of an empty block that puts
  zeros for its rows into the halo's all_reduce.
- The 'qk' ``LinearAttention`` at K = 4 and K = 2 on a 3 x 5 and a 12 x 5
  level: against one process (forward and gradients) and against the JAX
  package's ``LinearAttention(rescale="qk")`` on the same weights.
- Resampling: each method name of ``jax.image.resize`` up and down
  against ``jax.image.resize`` (f32, 1e-5 of max), an unknown one with
  JAX's error; each mode of ``spatial.resize`` at K = 4 and K = 2, on H
  and on W, up, down and on grids of fewer rows than ranks, against one
  device; ``UNetSimple`` with 'nearest', 'bicubic' and 'lanczos3' on one
  device and at K = 2 and 4 against the JAX ``UNetSimple``.

Each spawned rank has a deadline of 120 s (``tests/_torch_ddp_workers.py``).
"""
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dyffusion_tpu.models import UNetSimple as JaxUNetSimple
from dyffusion_tpu.models.modules import LinearAttention as JaxLinearAttention
from dyffusion_tpu_torch import models
from dyffusion_tpu_torch.models import unet_simple_state_dict_from_jax
from dyffusion_tpu_torch.models.modules import LinearAttention
from dyffusion_tpu_torch.ops.linear_attention import linear_attention_qkv_plain
from dyffusion_tpu_torch.parallel import spatial
from dyffusion_tpu_torch.utils import resize as resize_ops
from tests import _torch_ddp_workers as workers
from tests import _torch_spatial_workers as spatial_workers
from tests._torch_port_helpers import torch_threads_share_of_cores  # noqa: F401 (autouse fixture)
from tests.test_torch_port_spatial_physical import _random_variables

WORLD = 4
KS = (4, 2)
REL = 1e-5
GRAD_FLOOR = 0.1
FAULTS = ("halos zeroed", "empty rank skips its contribution")
# every method name of jax.image.resize, and the mode of spatial.resize each maps to
METHODS = ("nearest", "linear", "bilinear", "trilinear", "triangle", "cubic", "bicubic", "tricubic", "lanczos3",
           "lanczos5")
MODES = ("nearest-exact", "bilinear", "cubic", "lanczos3", "lanczos5")
# (source (H, W), size): up, down, and grids of fewer rows than four ranks on both axes
RESIZES = (((10, 12), (23, 29)), ((23, 29), (10, 12)), ((6, 6), (3, 2)), ((3, 2), (6, 3)))
UNET_SIMPLE_METHODS = ("nearest", "bicubic", "lanczos3")
QK_GRIDS = ((3, 5), (12, 5))

UNET_KW = dict(dim=8, dim_mults=(1, 2, 4), resnet_block_groups=4, with_time_emb=True, num_input_channels=2,
               num_output_channels=2, num_conditional_channels=1, attn_heads=2, attn_dim_head=8)
NCSNPP_KW = dict(dim=8, num_input_channels=2, num_output_channels=2, num_conditional_channels=1, n_head_channels=8,
                 dim_mults=(1, 2, 2, 2), num_res_blocks=1, attn_resolutions=(4,), spatial_height=16)
UNET_SIMPLE_KW = dict(dim=4, num_input_channels=3, num_output_channels=3, num_conditional_channels=2,
                      with_time_emb=True, upsample_dims=(128, 64))
UNET_SIMPLE_GRID = (20, 12)  # the working grid's levels on H: 128 / 64 / ... / 4 / 2 rows
QK_KW = dict(dim=8, heads=2, dim_head=8, rescale="qk")


def _close(got, want, r=REL, what=""):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err, scale = float(np.abs(got - want).max()), float(np.abs(want).max())
    assert err <= r * max(scale, 1e-30), f"{what}: max abs err {err:.3e} > {r} x {scale:.3e}"


def _grads_close(got, want, r=REL):
    """Each tensor within ``r`` of the larger of its own max and GRAD_FLOOR
    of the largest of all."""
    assert sorted(got) == sorted(want)
    top = max(float(np.abs(w).max()) for w in want.values())
    for k, w in want.items():
        err = float(np.abs(np.asarray(got[k], np.float64) - w).max())
        limit = r * max(float(np.abs(w).max()), GRAD_FLOOR * top)
        assert err <= limit, f"{k}: max abs err {err:.3e} > {limit:.3e}"


def _inputs(g, channels, grid, batch=2):
    """x, cond, cot (NCHW) and times."""
    x, cond, cot = (g.normal(size=(batch, c, *grid)).astype(np.float32) for c in channels)
    return x, cond, cot, np.asarray([0.5, 2.0, 3.0, 17.0][:batch], np.float32)


def _port_case(cls, kw, grid, axis, seed, **extra):
    """A port backbone from a seed, every weight perturbed (NCSN++'s output
    conv starts at scale 1e-10), with inputs: the case the ranks take."""
    torch.manual_seed(seed)
    g = np.random.default_rng(seed)
    state = {k: (v.numpy() + 0.05 * g.normal(size=v.shape)).astype(np.float32) if v.is_floating_point()
             else v.numpy() for k, v in getattr(models, cls)(**kw).state_dict().items()}
    C, Cc = kw["num_input_channels"], kw["num_conditional_channels"]
    x, cond, cot, t = _inputs(g, (C, Cc, kw["num_output_channels"]), grid)
    return {"kind": "backbone", "cls": cls, "kwargs": kw, "state": state, "x": x, "cond": cond, "cot": cot, "t": t,
            "axis": axis, **extra}


def _unet_simple_case(seed=7):
    """The JAX ``UNetSimple`` with random variables (its weights do not
    depend on the method), ported, and inputs; a function of the method
    giving the JAX eval forward (NCHW)."""
    C, Cc = UNET_SIMPLE_KW["num_input_channels"], UNET_SIMPLE_KW["num_conditional_channels"]
    g = np.random.default_rng(seed)
    v = _random_variables(JaxUNetSimple(**UNET_SIMPLE_KW), UNET_SIMPLE_GRID, C, Cc, g)
    state = {k: s.numpy() for k, s in unet_simple_state_dict_from_jax(v).items()}
    x, cond, cot, t = _inputs(g, (C, Cc, C), UNET_SIMPLE_GRID)
    case = {"kind": "backbone", "cls": "UNetSimple", "kwargs": UNET_SIMPLE_KW, "state": state, "x": x, "cond": cond,
            "cot": cot, "t": t, "axis": "h"}

    def jax_forward(method):
        jm = JaxUNetSimple(**UNET_SIMPLE_KW, outer_sample_mode=method)
        nhwc = lambda a: jnp.asarray(a.transpose(0, 2, 3, 1))  # noqa: E731
        y = jax.jit(lambda v, x, t, c: jm.apply(v, x, time=t, condition=c, deterministic=True, train=False))(
            v, nhwc(x), jnp.asarray(t), nhwc(cond))
        return np.asarray(y).transpose(0, 3, 1, 2)

    return case, jax_forward


def _qk_case(grid, seed):
    """The JAX 'qk' ``LinearAttention`` with random weights, ported, and an
    NCHW input and cotangent; a function giving the JAX forward (NCHW)."""
    g = np.random.default_rng(seed)
    jm = JaxLinearAttention(**QK_KW)
    hidden = QK_KW["heads"] * QK_KW["dim_head"]
    params = {"to_qkv": {"kernel": g.normal(size=(8, 3 * hidden)).astype(np.float32) / np.sqrt(8)},
              "to_out": {"kernel": g.normal(size=(hidden, 8)).astype(np.float32) / np.sqrt(hidden),
                         "bias": (0.1 * g.normal(size=(8,))).astype(np.float32)}}
    state = {"to_qkv.1.weight": params["to_qkv"]["kernel"].T[:, :, None, None],
             "to_out.weight": params["to_out"]["kernel"].T[:, :, None, None], "to_out.bias": params["to_out"]["bias"]}
    x, _, cot, _ = _inputs(g, (8, 1, 8), grid)
    case = {"kind": "qk", "kwargs": QK_KW, "state": state, "x": x, "cot": cot}

    def jax_forward():
        return np.asarray(jm.apply({"params": params}, jnp.asarray(x.transpose(0, 2, 3, 1)))).transpose(0, 3, 1, 2)

    return case, jax_forward


def _cases():
    """The spawn's cases by K, and what the main process checks them with."""
    g = np.random.default_rng(3)
    b1 = {"kind": "b1", "qkv": g.normal(size=(2, 3, 48)).astype(np.float32),
          "cot": g.normal(size=(2, 3, 16)).astype(np.float32)}
    resize_x = {src: g.normal(size=(2, 3, *src)).astype(np.float32) for src, _ in RESIZES}
    resize = {"kind": "resize", "x": resize_x, "sizes": list(RESIZES), "modes": list(MODES)}
    unet_simple, unet_simple_jax = _unet_simple_case()
    qk = {grid: _qk_case(grid, 20 + i) for i, grid in enumerate(QK_GRIDS)}
    four = {
        "unet h": _port_case("Unet", UNET_KW, (12, 12), "h", 0, faults=list(FAULTS), grads=True),
        "unet w": _port_case("Unet", UNET_KW, (12, 12), "w", 1, grads=True),
        "ncsnpp": _port_case("NCSNpp", NCSNPP_KW, (16, 16), "h", 2, grads=True),
        "unet_simple f64": {**unet_simple, "kwargs": {**UNET_SIMPLE_KW, "outer_sample_mode": "lanczos3"},
                            "dtype": "float64", "grads": True},
        "b1": b1, "resize": resize,
    }
    two = {"resize": resize}
    for k_cases in (four, two):
        k_cases.update({f"unet_simple {m}": {**unet_simple, "kwargs": {**UNET_SIMPLE_KW, "outer_sample_mode": m}}
                        for m in UNET_SIMPLE_METHODS})
        k_cases.update({f"qk {grid}": case for grid, (case, _) in qk.items()})
    return {"k": list(KS), "4": four, "2": two}, unet_simple_jax, {grid: f for grid, (_, f) in qk.items()}


def _one_process(case, faults=False):
    """A backbone case on one process: the forward and, with ``grads``,
    the gradients of sum(output * cot)."""
    dtype = getattr(torch, case.get("dtype", "float32"))
    model = getattr(models, case["cls"])(**case["kwargs"])
    model.load_state_dict({k: torch.as_tensor(v) for k, v in case["state"].items()}, strict=True)
    model.to(dtype)
    x = torch.tensor(case["x"], dtype=dtype, requires_grad=True)
    y = model(x, torch.as_tensor(case["t"]), torch.as_tensor(case["cond"]).to(dtype))
    out = {"eval": y.detach().numpy()}
    if case.get("grads"):
        (y * torch.as_tensor(case["cot"]).to(dtype)).sum().backward()
        out["grads"] = {"x": x.grad.numpy(), **{k: p.grad.numpy() for k, p in model.named_parameters()
                                                 if p.grad is not None}}
    return out


def _one_process_qk(case):
    attn = LinearAttention(**case["kwargs"])
    attn.load_state_dict({k: torch.as_tensor(v) for k, v in case["state"].items()}, strict=True)
    x = torch.tensor(case["x"], requires_grad=True)
    y = attn(x)
    (y * torch.as_tensor(case["cot"])).sum().backward()
    return {"out": y.detach().numpy(), "grads": {"x": x.grad.numpy(), **{k: p.grad.numpy()
                                                                          for k, p in attn.named_parameters()}}}


@pytest.fixture(scope="module")
def ranks():
    """The module's spawn of four ranks (:func:`spatial_workers.thin_rank`)
    beside the JAX answers and the one-process witness."""
    cases, unet_simple_jax, qk_jax = _cases()
    with ThreadPoolExecutor(1) as pool:
        spawn = pool.submit(workers.run_ranks, spatial_workers.thin_rank, WORLD, cases)
        four = cases["4"]
        one = {name: _one_process(four[name]) for name in ("unet h", "unet w", "ncsnpp", "unet_simple f64")}
        one.update({f"qk {grid}": _one_process_qk(four[f"qk {grid}"]) for grid in QK_GRIDS})
        jax_out = {f"unet_simple {m}": unet_simple_jax(m) for m in UNET_SIMPLE_METHODS}
        jax_out.update({f"qk {grid}": f() for grid, f in qk_jax.items()})
        out = spawn.result()
    return dict(cases=cases, out=out, one=one, jax=jax_out)


def _joined(ranks, k, get, dim=2):
    """The slabs of model ranks 0 .. k - 1 (the first group) joined."""
    return np.concatenate([get(ranks["out"][r][k]) for r in range(k)], axis=dim)


def _axis_dim(axis):
    return 2 if axis == "h" else 3


# ---------------------------------------------------------------------------
# thin levels


@pytest.mark.parametrize("name", ["unet h", "unet w", "ncsnpp"])
def test_thin_levels_forward_matches_one_process(ranks, name):
    case = ranks["cases"]["4"][name]
    _close(_joined(ranks, 4, lambda r: r[name][None], _axis_dim(case["axis"])), ranks["one"][name]["eval"],
           what=name)


@pytest.mark.parametrize("name", ["unet h", "unet w", "ncsnpp", "unet_simple f64"])
def test_thin_levels_gradients_match_one_process(ranks, name):
    case = ranks["cases"]["4"][name]
    got = dict(ranks["out"][0][4][name]["grads"])
    got["x"] = _joined(ranks, 4, lambda r: r[name]["grads"]["x"], _axis_dim(case["axis"]))
    want = ranks["one"][name]["grads"]
    # a weight the one-process backward does not reach has no gradient there, and zeros on the ranks
    for k in set(got) - set(want):
        assert not np.any(got.pop(k)), k
    _grads_close(got, want)
    # every rank of the group holds the same summed weight gradients
    for r in range(1, 4):
        for k, v in ranks["out"][r][4][name]["grads"].items():
            if k != "x":
                np.testing.assert_array_equal(v, ranks["out"][0][4][name]["grads"][k], err_msg=k)


def test_thin_levels_leave_a_rank_without_rows():
    """The cases' deepest levels: fewer rows than ranks."""
    assert spatial.blocks(3, 4)[-1] == (3, 3)  # the Unet's 12 -> 6 -> 3 rows
    assert spatial.blocks(2, 4)[2:] == [(2, 2), (2, 2)]  # NCSN++'s 16 -> 2, UNetSimple's 128 -> 2
    assert UNET_SIMPLE_KW["upsample_dims"][0] // 2**6 == 2


@pytest.mark.parametrize("fault", FAULTS)
def test_planted_faults_fail_the_thin_unet_check(ranks, fault):
    with pytest.raises(AssertionError):
        _close(_joined(ranks, 4, lambda r: r["unet h"][fault], 2), ranks["one"]["unet h"]["eval"], what=fault)


@pytest.mark.parametrize("k", KS)
def test_split_b1_with_an_empty_rank_matches_unsplit(ranks, k):
    """The split B1's plain version (3 tokens: 1/1/1/0 at K = 4, 2/1 at
    K = 2) against the unsplit plain version, forward and backward."""
    case = ranks["cases"]["4"]["b1"]
    if k == 4:
        assert ranks["out"][3][4]["b1"]["out"].shape == (2, 0, 16)
    qkv = torch.tensor(case["qkv"], requires_grad=True)
    y = linear_attention_qkv_plain(qkv, 2, 8, 8**-0.5)
    (y * torch.as_tensor(case["cot"])).sum().backward()
    got = {w: _joined(ranks, 4, lambda r: r["b1"][w], 1) for w in ("out", "grad")}
    _close(got["out"], y.detach().numpy(), what="forward")
    _close(got["grad"], qkv.grad.numpy(), what="backward")


# ---------------------------------------------------------------------------
# the 'qk' linear attention


@pytest.mark.parametrize("k", KS)
@pytest.mark.parametrize("grid", QK_GRIDS, ids=lambda g: f"{g[0]}x{g[1]}")
def test_qk_attention_matches_one_process_and_jax(ranks, k, grid):
    name = f"qk {grid}"
    got = _joined(ranks, k, lambda r: r[name]["out"])
    _close(got, ranks["one"][name]["out"], what="one process")
    _close(got, ranks["jax"][name], what="JAX")
    grads = dict(ranks["out"][0][k][name]["grads"])
    grads["x"] = _joined(ranks, k, lambda r: r[name]["grads"]["x"])
    _grads_close(grads, ranks["one"][name]["grads"])


# ---------------------------------------------------------------------------
# resampling


@pytest.mark.parametrize("method", METHODS)
@pytest.mark.parametrize("src,size", [((10, 12), (23, 29)), ((23, 29), (10, 12))], ids=["up", "down"])
def test_resize_matches_jax_image_resize(method, src, size):
    x = np.random.default_rng(9).normal(size=(2, 3, *src)).astype(np.float32)
    want = jax.image.resize(jnp.asarray(x.transpose(0, 2, 3, 1)), (2, *size, 3), method, antialias=False)
    _close(resize_ops.resize(torch.as_tensor(x), size, method).numpy(), np.asarray(want).transpose(0, 3, 1, 2),
           what=method)


def test_unknown_resize_method_raises_the_jax_error():
    with pytest.raises(ValueError) as jax_err:
        jax.image.resize(jnp.zeros((1, 4, 4, 1)), (1, 8, 8, 1), "area")
    with pytest.raises(ValueError) as err:
        resize_ops.resize(torch.zeros(1, 1, 4, 4), (8, 8), "area")
    assert str(err.value) == str(jax_err.value)


@pytest.mark.parametrize("k", KS)
@pytest.mark.parametrize("mode", MODES)
def test_sharded_resize_matches_one_device(ranks, k, mode):
    x = ranks["cases"]["4"]["resize"]["x"]
    method = {"nearest-exact": "nearest"}.get(mode, mode)
    for src, size in RESIZES:
        want = resize_ops.resize(torch.as_tensor(x[src]), size, method).numpy()
        for axis in ("h", "w"):
            got = _joined(ranks, k, lambda r: r["resize"][(mode, src, size, axis)], _axis_dim(axis))
            _close(got, want, what=f"{src} -> {size} on {axis}")


@pytest.mark.parametrize("layout", [1, *KS])
@pytest.mark.parametrize("method", UNET_SIMPLE_METHODS)
def test_unet_simple_outer_resample_matches_jax(ranks, method, layout):
    """``UNetSimple`` with ``outer_sample_mode`` ``method`` on one device
    and on K ranks against the JAX ``UNetSimple``."""
    name = f"unet_simple {method}"
    if layout == 1:
        case = ranks["cases"]["4"][name]
        with torch.no_grad():
            got = _one_process(case)["eval"]
    else:
        got = _joined(ranks, layout, lambda r: r[name][None])
    _close(got, ranks["jax"][name], what=f"{method} on {layout}")
