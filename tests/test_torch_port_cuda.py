"""The port's CUDA kernels (B1, B2, B3) on the GPU, against their plain
PyTorch versions.

These tests need an NVIDIA GPU and nvcc; elsewhere they skip. The module
imports neither JAX nor the JAX package, so it also runs where JAX is not
installed (the repo's conftest imports JAX; skip it there):

    python -m pytest -m cuda --noconftest -p no:cacheprovider tests/test_torch_port_cuda.py

The serving slice as a whole, GPU against CPU, is checked by phase 4 of
``chip_smoke.py``.
"""
import numpy as np
import pytest
import torch

from dyffusion_tpu_torch.ops import fused_act as fa
from dyffusion_tpu_torch.ops import linear_attention as la

HEADS, DIM_HEAD = 4, 32
SCALE = DIM_HEAD**-0.5
# r of _assert_close_to_scale: f32 on both sides, sums over up to 3600 tokens
# in another order (mean-zero v cancels, so the result is ~50x smaller than
# its terms); bf16 outputs may also round one ulp (<= 2**-7 of the largest
# output) apart
REL_TOL = {torch.float32: 2e-5, torch.bfloat16: 1e-2}


def _assert_close_to_scale(got, want, r):
    """No element further off than ``r`` times the largest ``|want|``: the
    outputs are small (v is divided by N: about 4e-6 at N=3600), so an
    absolute tolerance would pass a wrong kernel."""
    err = float((got.float() - want.float()).abs().max())
    limit = r * float(want.float().abs().max())
    assert err <= limit, f"max abs err {err:.3e} > {limit:.3e} ({r} of max |want|)"


def _require_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels run only on the card")


def _qkv(B, N, seed):
    return torch.from_numpy(np.random.default_rng(seed).normal(size=(B, N, 3 * HEADS * DIM_HEAD)).astype(np.float32))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("strided", [False, True])
def test_kernel_matches_plain(dtype, strided):
    _require_cuda()
    dt = getattr(torch, dtype)
    for B, N in ((2, 7), (3, 64), (3, 225), (2, 900), (1, 3600)):
        x = _qkv(B, N, seed=B * N).cuda()
        if strided:  # the (B, N, 3hd) view of an NCHW tensor
            x = x.transpose(1, 2).contiguous().transpose(1, 2)
        x = x.to(dt)
        before = la.launches
        got = la.linear_attention_qkv(x, HEADS, DIM_HEAD, SCALE)
        torch.cuda.synchronize()
        assert la.launches == before + 1
        assert got.dtype == dt and tuple(got.shape) == (B, N, HEADS * DIM_HEAD)
        want = la.linear_attention_qkv_plain(x, HEADS, DIM_HEAD, SCALE)
        _assert_close_to_scale(got, want, REL_TOL[dt])
        if N >= 900:  # negative controls: the check rejects a result 5% off or zero
            for wrong in (want * 1.05, torch.zeros_like(want)):
                with pytest.raises(AssertionError, match="max abs err"):
                    _assert_close_to_scale(wrong, want, REL_TOL[dt])


@pytest.mark.cuda
@pytest.mark.parametrize("B", [300, 600])
@pytest.mark.parametrize("N", [3600, 900, 225])
def test_kernel_matches_plain_at_the_test_ensemble_batch(N, B):
    """B1 at the 50-member test ensemble's folded batches (eval batch 6:
    300 forecaster rows, 600 interpolator rows), bf16, NCHW view."""
    _require_cuda()
    x = _qkv_wide_k(B, N, True, torch.bfloat16, seed=B + N)
    got = la.linear_attention_qkv(x, HEADS, DIM_HEAD, SCALE)
    _assert_close_with_controls(got, la.linear_attention_qkv_plain(x, HEADS, DIM_HEAD, SCALE), REL_TOL[torch.bfloat16])


def _assert_close_with_controls(got, want, r):
    _assert_close_to_scale(got, want, r)
    for wrong in (want * 1.05, torch.zeros_like(want)):  # negative controls: the check rejects these
        with pytest.raises(AssertionError, match="max abs err"):
            _assert_close_to_scale(wrong, want, r)


def _qkv_wide_k(B, N, strided, dtype, seed, offset=0):
    """(B, N, 3hd) on the GPU: q, v standard normal, k uniform in [-50, 50]
    (chunk maxima far apart, so the merge's rescale matters); contiguous or
    the NCHW view; ``offset`` elements into a larger buffer."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    F, hd = 3 * HEADS * DIM_HEAD, HEADS * DIM_HEAD
    x = torch.randn((B, N, F), generator=g, device="cuda")
    x[:, :, hd:2 * hd] = torch.rand((B, N, hd), generator=g, device="cuda") * 100 - 50
    buf = torch.empty(B * N * F + offset, dtype=dtype, device="cuda")[offset:]
    out = buf.view(B, F, N).transpose(1, 2) if strided else buf.view(B, N, F)
    return out.copy_(x)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("strided", [False, True])
@pytest.mark.parametrize("B", [1, 240])
@pytest.mark.parametrize("N", [1, 7, 225, 900, 3600, 3601])
def test_kernel_matches_plain_across_splits(N, B, strided, dtype):
    """B1's two launches at the splits S, S' that ``split_counts`` picks
    (one chunk up to N = 64, several above), every load width of both
    layouts, and k of magnitude up to 50."""
    _require_cuda()
    dt = getattr(torch, dtype)
    x = _qkv_wide_k(B, N, strided, dt, seed=B * 10007 + N)
    before = la.launches
    got = la.linear_attention_qkv(x, HEADS, DIM_HEAD, SCALE)
    torch.cuda.synchronize()
    assert la.launches == before + 1
    assert got.dtype == dt and tuple(got.shape) == (B, N, HEADS * DIM_HEAD)
    _assert_close_with_controls(got, la.linear_attention_qkv_plain(x, HEADS, DIM_HEAD, SCALE), REL_TOL[dt])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("strided", [False, True])
def test_kernel_matches_plain_from_a_misaligned_base(strided, dtype):
    """A qkv one element into a larger buffer: its base pointer allows only
    one element per load."""
    _require_cuda()
    dt = getattr(torch, dtype)
    for N in (900, 3600):
        x = _qkv_wide_k(3, N, strided, dt, seed=N, offset=1)
        assert la.load_width(x) == (1, strided)
        got = la.linear_attention_qkv(x, HEADS, DIM_HEAD, SCALE)
        torch.cuda.synchronize()
        _assert_close_with_controls(got, la.linear_attention_qkv_plain(x, HEADS, DIM_HEAD, SCALE), REL_TOL[dt])


@pytest.mark.cuda
def test_kernel_gradient():
    _require_cuda()
    x = _qkv(2, 100, seed=9).cuda().requires_grad_(True)
    g = torch.randn(2, 100, HEADS * DIM_HEAD, device="cuda")
    (la.linear_attention_qkv(x, HEADS, DIM_HEAD, SCALE) * g).sum().backward()
    y = x.detach().clone().requires_grad_(True)
    (la.linear_attention_qkv_plain(y, HEADS, DIM_HEAD, SCALE) * g).sum().backward()
    _assert_close_to_scale(x.grad, y.grad, REL_TOL[torch.float32])


@pytest.mark.cuda
def test_kernel_rejects_what_it_does_not_take():
    _require_cuda()
    with pytest.raises(ValueError, match="dim_head"):
        la.linear_attention_qkv(torch.zeros(1, 8, 3 * 2 * 16, device="cuda"), 2, 16, 0.25)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        la.linear_attention_qkv(torch.zeros(1, 8, 384, device="cuda", dtype=torch.float16), HEADS, DIM_HEAD, SCALE)


def _core_inputs(BH, N, seed, strided):
    g = np.random.default_rng(seed)
    xs = [torch.from_numpy(g.normal(size=(BH, DIM_HEAD, N)).astype(np.float32)).cuda() for _ in range(3)]
    if strided:  # (BH, d, N) views of (BH, N, d) tensors: channels on the stride-1 axis
        xs = [x.transpose(1, 2).contiguous().transpose(1, 2) for x in xs]
    return xs


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("strided", [False, True])
def test_core_kernel_matches_plain(dtype, strided):
    """B3, the (BH, d, N) stride case of the B1 kernel."""
    _require_cuda()
    dt = getattr(torch, dtype)
    for BH, N in ((2, 7), (6, 64), (8, 225), (4, 900), (3, 3600)):
        q, k, v = (x.to(dt) for x in _core_inputs(BH, N, BH * N, strided))
        before = la.core_launches
        got = la.linear_attention_core(q, k, v, SCALE)
        torch.cuda.synchronize()
        assert la.core_launches == before + 1
        assert got.dtype == dt and tuple(got.shape) == (BH, DIM_HEAD, N) and got.is_contiguous()
        want = la.linear_attention_core_plain(q, k, v, SCALE)
        _assert_close_to_scale(got, want, REL_TOL[dt])
        if N >= 900:
            for wrong in (want * 1.05, torch.zeros_like(want)):
                with pytest.raises(AssertionError, match="max abs err"):
                    _assert_close_to_scale(wrong, want, REL_TOL[dt])


def _core_wide_k(BH, N, strided, dtype, seed, off=(0, 0, 0)):
    """q, k, v (BH, d, N) on the GPU: q, v standard normal, k uniform in
    [-50, 50]; contiguous or views of (BH, N, d) tensors; each ``off``
    elements into its own buffer."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    out = []
    for i, o in enumerate(off):
        x = torch.randn((BH, DIM_HEAD, N), generator=g, device="cuda")
        if i == 1:
            x = torch.rand((BH, DIM_HEAD, N), generator=g, device="cuda") * 100 - 50
        buf = torch.empty(BH * DIM_HEAD * N + o, dtype=dtype, device="cuda")[o:]
        t = buf.view(BH, N, DIM_HEAD).transpose(1, 2) if strided else buf.view(BH, DIM_HEAD, N)
        out.append(t.copy_(x))
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("strided", [False, True])
@pytest.mark.parametrize("BH", [1, 960])
@pytest.mark.parametrize("N", [1, 7, 225, 900, 3600, 3601])
def test_core_kernel_matches_plain_across_splits(N, BH, strided, dtype):
    """B3 through B1's two kernels as heads = 1: the splits S, S' that
    ``split_counts(BH, N)`` picks, every load width of both layouts (the
    output contiguous either way), and k of magnitude up to 50."""
    _require_cuda()
    dt = getattr(torch, dtype)
    q, k, v = _core_wide_k(BH, N, strided, dt, seed=BH * 10007 + N)
    before = la.core_launches
    got = la.linear_attention_core(q, k, v, SCALE)
    torch.cuda.synchronize()
    assert la.core_launches == before + 1
    assert got.dtype == dt and tuple(got.shape) == (BH, DIM_HEAD, N) and got.is_contiguous()
    _assert_close_with_controls(got, la.linear_attention_core_plain(q, k, v, SCALE), REL_TOL[dt])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("strided", [False, True])
def test_core_kernel_matches_plain_from_a_misaligned_base(strided, dtype):
    """One of q, k, v one element into a larger buffer: one element per
    load for all three."""
    _require_cuda()
    dt = getattr(torch, dtype)
    for off in ((1, 0, 0), (0, 0, 1)):
        q, k, v = _core_wide_k(64, 3600, strided, dt, seed=sum(off), off=off)
        assert la.load_width(q.transpose(1, 2), k, v) == (1, not strided)
        got = la.linear_attention_core(q, k, v, SCALE)
        torch.cuda.synchronize()
        _assert_close_with_controls(got, la.linear_attention_core_plain(q, k, v, SCALE), REL_TOL[dt])


@pytest.mark.cuda
def test_core_kernel_rejects_mixed_layouts():
    _require_cuda()
    q, k, _ = _core_inputs(2, 64, 5, False)
    _, _, v = _core_inputs(2, 64, 5, True)
    with pytest.raises(ValueError, match="one layout"):
        la.linear_attention_core(q, k, v, SCALE)


@pytest.mark.cuda
def test_core_kernel_gradient():
    _require_cuda()
    xs = [x.requires_grad_(True) for x in _core_inputs(4, 100, 11, False)]
    g = torch.randn(4, DIM_HEAD, 100, device="cuda")
    (la.linear_attention_core(*xs, SCALE) * g).sum().backward()
    ys = [x.detach().clone().requires_grad_(True) for x in xs]
    (la.linear_attention_core_plain(*ys, SCALE) * g).sum().backward()
    for x, y in zip(xs, ys):
        _assert_close_to_scale(x.grad, y.grad, REL_TOL[torch.float32])


def _act_input(shape, dtype, channels_last, seed):
    x = torch.from_numpy(np.random.default_rng(seed).normal(size=shape).astype(np.float32)).cuda()
    if channels_last:
        x = x.contiguous(memory_format=torch.channels_last)
    return x.to(dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("channels_last", [False, True])
def test_fused_leaky_relu_kernel_matches_plain(dtype, channels_last):
    """B2 with and without a bias, at shapes that take every load width."""
    _require_cuda()
    dt = getattr(torch, dtype)
    for shape in ((2, 64, 60, 60), (3, 128, 30, 30), (2, 256, 15, 15), (3, 5, 7, 3)):
        x = _act_input(shape, dt, channels_last, sum(shape))
        bias = torch.randn(shape[1], device="cuda")
        for b in (bias, None):
            before = fa.launches
            got = fa.fused_leaky_relu(x, b)
            torch.cuda.synchronize()
            assert fa.launches == before + 1
            assert got.dtype == dt and got.shape == x.shape and got.stride() == x.stride()
            want = fa.fused_leaky_relu_plain(x, b)
            _assert_close_to_scale(got, want, 1e-6 if dt == torch.float32 else 1e-2)
            for wrong in (want * 1.05, torch.zeros_like(want)):
                with pytest.raises(AssertionError, match="max abs err"):
                    _assert_close_to_scale(wrong, want, 1e-6 if dt == torch.float32 else 1e-2)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("channels_last", [False, True])
@pytest.mark.parametrize("offset", [0, 1])
@pytest.mark.parametrize("shape", [(3, 5, 7, 3), (120, 256, 15, 15), (2, 3, 1, 1)], ids=str)
def test_fused_leaky_relu_kernel_any_width(shape, offset, channels_last, dtype):
    """B2 with vectors that span channels (channel stride 225, 21, 1),
    numel not a multiple of the width (315, 6: the scalar tail), channels-
    last with C % width != 0, and from a base one element off (one element
    per load)."""
    _require_cuda()
    dt = getattr(torch, dtype)
    x = _act_input(shape, dt, channels_last, sum(shape) + offset)
    if offset:
        buf = torch.empty(x.numel() + offset, dtype=dt, device="cuda")[offset:]
        x = buf.as_strided(x.shape, x.stride()).copy_(x)
    wide = 16 // x.element_size()
    assert fa.load_width(x, torch.empty_like(x)) == (1 if offset else wide)
    bias = torch.randn(shape[1], device="cuda")
    for b in (bias, None):
        before = fa.launches
        got = fa.fused_leaky_relu(x, b)
        torch.cuda.synchronize()
        assert fa.launches == before + 1
        assert got.dtype == dt and got.shape == x.shape and got.stride() == x.stride()
        _assert_close_with_controls(got, fa.fused_leaky_relu_plain(x, b), 1e-6 if dt == torch.float32 else 1e-2)


@pytest.mark.cuda
def test_fused_leaky_relu_kernel_gradient():
    _require_cuda()
    x = _act_input((2, 16, 9, 9), torch.float32, False, 3).requires_grad_(True)
    b = torch.randn(16, device="cuda", requires_grad=True)
    g = torch.randn(2, 16, 9, 9, device="cuda")
    (fa.fused_leaky_relu(x, b) * g).sum().backward()
    y, c = x.detach().clone().requires_grad_(True), b.detach().clone().requires_grad_(True)
    (fa.fused_leaky_relu_plain(y, c) * g).sum().backward()
    _assert_close_to_scale(x.grad, y.grad, 1e-6)
    _assert_close_to_scale(b.grad, c.grad, 1e-5)


@pytest.mark.cuda
def test_fused_leaky_relu_kernel_rejects_what_it_does_not_take():
    _require_cuda()
    x = torch.zeros(2, 4, 6, 6, device="cuda")
    with pytest.raises(ValueError, match="dense"):
        fa.fused_leaky_relu(x[:, :, ::2], torch.zeros(4, device="cuda"))
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        fa.fused_leaky_relu(x.half())


# one train row, dropout on, EMA and an LR schedule: each epoch is one step
ONE_ROW = [
    "datamodule.spatial=(8,8)", "datamodule.channels=1", "datamodule.horizon=3", "datamodule.n_traj=2",
    "datamodule.n_time=4", "datamodule.batch_size=1", "datamodule.eval_batch_size=1", "model.dim=8",
    "model.dim_mults=(1,)", "model.block_dropout=0.3", "module.num_predictions=2", "module.use_ema=true",
    "module.optimizer.lr=1e-2",
    "module.scheduler={'name': 'warmup_cosine', 'warm_up_steps': 1, 'lr_min': 0.1, 'lr_max': 1.0, "
    "'lr_start': 0.5, 'max_decay_steps': 4}",
]


@pytest.fixture
def deterministic_cudnn():
    before = torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    yield
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = before


@pytest.mark.cuda
def test_resume_on_the_gpu(tmp_path, deterministic_cudnn):
    """Save and resume on the card: the CUDA step generator's state comes
    back, the optimizer's moments land on the card, and one epoch + a
    restart + one epoch ends where two epochs in one run end, and takes the
    same next step."""
    _require_cuda()
    from dyffusion_tpu_torch.config import get_config
    from dyffusion_tpu_torch.interface import run_experiment

    def run(registry, epochs):
        return run_experiment(get_config("synthetic_interpolation", ONE_ROW + [
            f"registry_dir={registry}", f"trainer.max_epochs={epochs}"]), device="cuda")[0]

    whole = run(tmp_path / "whole", 2)
    run(tmp_path / "split", 1)
    resumed = run(tmp_path / "split", 2)
    assert [h["epoch"] for h in resumed.history] == [1] and resumed.state.step == whole.state.step == 2
    assert resumed.state.generator.device.type == "cuda"
    assert torch.equal(resumed.state.generator.get_state(), whole.state.generator.get_state())
    moments = [s["exp_avg"] for s in resumed.state.optimizer.optimizer.state.values()]
    assert moments and all(m.device.type == "cuda" for m in moments)
    for a, b in ((resumed.experiment.model.state_dict(), whole.experiment.model.state_dict()),
                 (resumed.state.ema, whole.state.ema)):
        for k in b:
            torch.testing.assert_close(a[k], b[k], rtol=1e-5, atol=1e-6)
    batch = next(whole.datamodule.train_batches())
    losses = [float(t.train_step(t.state, t._put(batch))["loss"]) for t in (whole, resumed)]
    assert abs(losses[0] - losses[1]) <= 1e-5 * abs(losses[0]), losses


def _physical_backbone(name, seed):
    """A small UNetSimple (NS grid, 64x64 working grid) or SimpleConvNet
    (spring grid) with random running statistics, and NCHW inputs."""
    from dyffusion_tpu_torch.models import build_backbone
    from dyffusion_tpu_torch.models.base import BackboneSpec

    torch.manual_seed(seed)
    if name == "unet_simple":
        cfg, (C, Cc, H, W) = {"name": name, "dim": 8, "upsample_dims": (128, 128), "with_time_emb": True}, (3, 2, 221, 42)
    else:
        cfg, (C, Cc, H, W) = {"name": name, "dim": 64, "with_time_emb": True}, (4, 1, 10, 10)
    model = build_backbone(cfg, BackboneSpec(C, C, Cc))
    with torch.no_grad():
        for k, buf in model.named_buffers():
            if "running_mean" in k:
                buf.copy_(0.3 * torch.randn(buf.shape))
            elif "running_var" in k:
                buf.copy_(0.5 + torch.rand(buf.shape))
    g = np.random.default_rng(seed)
    x, c = (torch.from_numpy(g.normal(size=(8, n, H, W)).astype(np.float32)) for n in (C, Cc))
    return model, x, c, torch.arange(1.0, 9.0)


@pytest.fixture
def full_f32():
    """f32 convs and matmuls without TF32 (cuDNN's convs default to it)."""
    before = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    yield
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = before


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["unet_simple", "cnn_simple"])
def test_physical_backbones_on_the_gpu_match_the_cpu(name, deterministic_cudnn, full_f32):
    """The NS and spring backbones: the eval forward, the train-mode forward
    and its running-statistics updates in f32, GPU against CPU (1e-4 of the
    largest value); the gradients of the train-mode forward against the
    CPU's f64 ones. UNetSimple's f32 gradients are ill-conditioned (its
    tiny DCGAN-initialized features meet BatchNorm): here the CPU's own lie
    up to ~2e-3 of their scale from f64. So the GPU's are held to 1e-3 of
    each gradient's scale, or 3 times the CPU's f32 error, whichever is
    larger (the scale: the larger of its own largest |value| and 0.1 of the
    model's largest; conv biases feeding a BatchNorm get only float noise)."""
    _require_cuda()
    import copy

    from dyffusion_tpu_torch.models.base import apply_model, apply_model_train

    model, x, c, t = _physical_backbone(name, seed=0)
    out = {}
    for device, dtype in (("cpu", torch.float64), ("cpu", torch.float32), ("cuda", torch.float32)):
        m = copy.deepcopy(model).to(device, dtype)
        args = (x.to(device, dtype), t.to(device), c.to(device, dtype))
        with torch.no_grad():
            eval_out = apply_model(m, None, *args)
        m.zero_grad()
        train_out, updates = apply_model_train(m, None, *args)
        train_out.square().mean().backward()
        out[device, dtype] = (eval_out.cpu(), train_out.detach().cpu(), {k: v.cpu() for k, v in updates.items()},
                              {k: p.grad.cpu().double() for k, p in m.named_parameters()})
    f64, cpu, gpu = out["cpu", torch.float64], out["cpu", torch.float32], out["cuda", torch.float32]
    _assert_close_to_scale(gpu[0], cpu[0], 1e-4)
    _assert_close_to_scale(gpu[1], cpu[1], 1e-4)
    assert sorted(gpu[2]) == sorted(cpu[2])
    for k, v in cpu[2].items():
        _assert_close_to_scale(gpu[2][k], v, 1e-4)
    top = max(float(v.abs().max()) for v in f64[3].values())

    def worst(grads):
        return max(float((grads[k] - v).abs().max()) / max(float(v.abs().max()), 0.1 * top) for k, v in f64[3].items())

    assert worst(gpu[3]) <= max(1e-3, 3 * worst(cpu[3])), (worst(gpu[3]), worst(cpu[3]))
