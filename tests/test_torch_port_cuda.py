"""The port's CUDA kernels (B1, B2, B3) on the GPU, against their plain
PyTorch versions.

These tests need an NVIDIA GPU and nvcc; elsewhere they skip. The module
imports neither JAX nor the JAX package, so it also runs where JAX is not
installed (the repo's conftest imports JAX; skip it there):

    python -m pytest -m cuda --noconftest -p no:cacheprovider tests/test_torch_port_cuda.py

The serving slice as a whole, GPU against CPU, is checked by phase 4 of
``chip_smoke.py``.
"""
import os
import sys

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


def _split_emulated(parts):
    """The split B1 kernel over ``parts``, each one rank's tokens, the ranks
    emulated in one process: each rank's partial pass and chunk maxima, the
    maximum over the ranks (their all_reduce), each rank's merge at it, the
    sum (their second all_reduce), each rank's output pass."""
    steps = [la.split_partial(q, HEADS, DIM_HEAD) for q in parts]
    top = torch.stack([m for _, _, m in steps]).amax(dim=0)
    merged = sum(la.split_merge(q, ws, S, top) for q, (ws, S, _) in zip(parts, steps))
    n = sum(q.shape[1] for q in parts)
    return [la.split_output(q, merged, HEADS, DIM_HEAD, SCALE, n) for q in parts]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("tokens", [(1800, 1800), (450, 450), (120, 105), (3, 1, 7)])
def test_split_kernel_matches_plain_at_the_per_rank_shapes(tokens, dtype):
    """B1 split across ranks (two ranks at the SST grid's per-rank tokens
    at K = 2, and three uneven ones) against B1's plain version over all
    the tokens; the NCHW view the ``Unet`` passes. Rank 0's tokens alone
    (k's softmax over its own N) must fail the same check."""
    _require_cuda()
    dt = getattr(torch, dtype)
    x = _qkv(120, sum(tokens), seed=sum(tokens)).cuda().transpose(1, 2).contiguous().transpose(1, 2).to(dt)
    bounds = np.cumsum((0,) + tokens)
    parts = [x[:, a:b] for a, b in zip(bounds[:-1], bounds[1:])]
    got = torch.cat(_split_emulated(parts), dim=1)
    torch.cuda.synchronize()
    want = la.linear_attention_qkv_plain(x, HEADS, DIM_HEAD, SCALE)
    _assert_close_to_scale(got, want, REL_TOL[dt])
    alone = _split_emulated(parts[:1])[0]
    with pytest.raises(AssertionError):
        _assert_close_to_scale(alone, want[:, : tokens[0]], REL_TOL[dt])


@pytest.mark.cuda
def test_split_kernel_through_a_gloo_group_of_one():
    """``linear_attention_qkv_split`` on a CUDA tensor over a gloo group of
    one rank: its two all_reduces on the card's tensors, the kernel counted
    as a B1 launch and a split one; it equals B1."""
    _require_cuda()
    import socket

    import torch.distributed as dist

    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}", rank=0, world_size=1)
    try:
        x = _qkv(6, 900, seed=3).cuda()
        before, split_before = la.launches, la.split_launches
        got = la.linear_attention_qkv_split(x, HEADS, DIM_HEAD, SCALE, 900, dist.group.WORLD)
        torch.cuda.synchronize()
        assert (la.launches - before, la.split_launches - split_before) == (1, 1)
    finally:
        dist.destroy_process_group()
    _assert_close_to_scale(got, la.linear_attention_qkv_plain(x, HEADS, DIM_HEAD, SCALE), REL_TOL[torch.float32])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("tokens", [(1, 1, 1, 0), (60, 60, 60, 0), (450, 0)])
def test_split_kernel_with_an_empty_rank_matches_plain(tokens, dtype):
    """B1 split across ranks of which one holds no token (a level of fewer
    rows than ranks: 3 rows at K = 4, times 1 or 60 columns) against B1's
    plain version over all the tokens, the ranks emulated as above. The
    empty rank launches neither the partial pass nor the output pass (its
    merge writes maxima of -inf and a partial of zeros) and returns a (B,
    0, heads*dim_head) output; its plain version does the same."""
    _require_cuda()
    dt = getattr(torch, dtype)
    x = _qkv(8, sum(tokens), seed=sum(tokens) + 1).cuda().transpose(1, 2).contiguous().transpose(1, 2).to(dt)
    bounds = np.cumsum((0,) + tokens)
    parts = [x[:, a:b] for a, b in zip(bounds[:-1], bounds[1:])]
    la.reset_launches()
    outs = _split_emulated(parts)
    torch.cuda.synchronize()
    ranks_with_tokens = sum(1 for n in tokens if n)
    assert (la.split_partial_launches, la.split_output_launches) == (ranks_with_tokens, ranks_with_tokens)
    assert outs[-1].shape == (8, 0, HEADS * DIM_HEAD)
    want = la.linear_attention_qkv_plain(x, HEADS, DIM_HEAD, SCALE)
    _assert_close_to_scale(torch.cat(outs, dim=1), want, REL_TOL[dt])
    empty = parts[-1].cpu().float()
    plain, maximum = la._split_plain(empty, HEADS, DIM_HEAD, SCALE, sum(tokens), None)
    assert plain.shape == (8, 0, HEADS * DIM_HEAD) and bool(torch.isinf(maximum).all())


@pytest.mark.cuda
def test_split_kernel_of_no_tokens_through_a_gloo_group_of_one():
    """``linear_attention_qkv_split`` on a CUDA tensor of no tokens over a
    gloo group of one rank (of 900 tokens over the group): one split call,
    no partial or output pass, an empty output, and a backward of zeros."""
    _require_cuda()
    import socket

    import torch.distributed as dist

    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}", rank=0, world_size=1)
    try:
        x = _qkv(6, 900, seed=4).cuda()[:, :0].clone().requires_grad_(True)
        la.reset_launches()
        got = la.linear_attention_qkv_split(x, HEADS, DIM_HEAD, SCALE, 900, dist.group.WORLD)
        got.sum().backward()
        torch.cuda.synchronize()
        assert (la.launches, la.split_launches, la.split_partial_launches, la.split_output_launches) == (1, 1, 0, 0)
    finally:
        dist.destroy_process_group()
    assert got.shape == (6, 0, HEADS * DIM_HEAD) and x.grad.shape == x.shape


# the per-rank tokens of the split B1 in a 64-row SST train step on two ranks
# sharding H (60 -> 30 -> 15 rows, split 30/30, 15/15, 8/7, times 60, 30, 15)
SPLIT_TRAIN_TOKENS = ((1800, 1800), (450, 450), (120, 105))


@pytest.mark.cuda
def test_split_backward_on_two_ranks_matches_plain():
    """The split B1's backward on CUDA tensors, two gloo ranks sharing
    cuda:0 at the per-rank shapes of a 64-row SST train step, f32 and bf16:
    the forward through the kernels (one split launch a call on each rank),
    the backward replaying the plain split with the sums' gradients summed
    over the ranks. Each rank's gradient against its tokens of the autograd
    gradient of B1's plain version over all the tokens."""
    _require_cuda()
    # the worker modules by the name a spawned rank imports: this directory's (another package
    # named ``tests`` may be installed where this file runs)
    here = os.path.dirname(os.path.abspath(__file__))
    if here not in sys.path:
        sys.path.insert(0, here)
    import _torch_ddp_workers as workers
    import _torch_spatial_workers as spatial_workers

    shapes = [(64, tokens, dtype, seed) for seed, (tokens, dtype) in enumerate(
        (t, d) for d in ("float32", "bfloat16") for t in SPLIT_TRAIN_TOKENS)]
    ranks = workers.run_ranks(spatial_workers.split_backward_rank, 2, shapes)
    for i, (_, tokens, dtype, _) in enumerate(shapes):
        for rank, r in enumerate(ranks):
            r_tol = REL_TOL[getattr(torch, dtype)]
            assert r[i]["split"] == 1 and r[i]["forward_err"] <= r_tol * r[i]["forward_scale"], (tokens, dtype, rank, r[i])
            assert r[i]["err"] <= r_tol * r[i]["scale"], (tokens, dtype, rank, r[i])


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


# ---------------------------------------------------------------------------
# the baselines' paths (SST width, f32): B1 at their rows, and one sampler
# step of each diffusion engine, GPU against CPU
# ---------------------------------------------------------------------------
@pytest.mark.cuda
@pytest.mark.parametrize("B", [4, 20, 40, 100])
@pytest.mark.parametrize("N", [3600, 900, 225])
def test_kernel_matches_plain_at_the_baseline_shapes(N, B):
    """B1 in f32 (the baselines' presets evaluate in f32), NCHW view, at the
    rows of their paths: a train batch of 4; 20 members x eval batch 1 and
    2; the 50-member test ensemble x 2."""
    _require_cuda()
    x = _qkv_wide_k(B, N, True, torch.float32, seed=7 * B + N)
    before = la.launches
    got = la.linear_attention_qkv(x, HEADS, DIM_HEAD, SCALE)
    torch.cuda.synchronize()
    assert la.launches == before + 1 and got.dtype == torch.float32
    _assert_close_with_controls(got, la.linear_attention_qkv_plain(x, HEADS, DIM_HEAD, SCALE), REL_TOL[torch.float32])


@pytest.mark.cuda
@pytest.mark.parametrize("engine", ["ddpm", "mcvd"])
def test_baseline_sampler_step_gpu_matches_cpu(engine):
    """One f32 step of the DDPM and the MCVD sampler (T = 2: two denoiser
    forwards, MCVD's the second its final denoise) over a small Unet with
    linear attention, the same weights and noise on both devices, TF32 off:
    within 1e-4 of the largest output; without its step noise the CPU
    result fails the same check."""
    _require_cuda()
    import copy

    from dyffusion_tpu_torch.diffusion import GaussianDiffusionConfig, GaussianDiffusionEngine, McvdConfig, McvdEngine
    from dyffusion_tpu_torch.models import Unet

    torch.manual_seed(0)
    model = Unet(dim=16, num_input_channels=3, num_output_channels=3, num_conditional_channels=1, dim_mults=(1, 2),
                 with_time_emb=True)
    g = torch.Generator().manual_seed(1)
    cond = torch.randn((2, 1, 24, 24), generator=g)
    draws = [torch.randn((2, 3, 24, 24), generator=g) for _ in range(2)]
    make = {"ddpm": lambda m: GaussianDiffusionEngine(GaussianDiffusionConfig(timesteps=2), m, (3, 24, 24)),
            "mcvd": lambda m: McvdEngine(McvdConfig(timesteps=2), m, (3, 24, 24))}[engine]
    tf32 = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        outs = {}
        for tag, device, queue in (("gpu", "cuda", list(draws)), ("cpu", "cpu", list(draws)),
                                   ("no noise", "cpu", [draws[0], torch.zeros_like(draws[1])])):
            e = make(copy.deepcopy(model).to(device))
            e.draw = lambda shape, gen, d, concentration=None, q=queue: q.pop(0).to(d)
            before = la.launches
            with torch.no_grad():
                outs[tag] = e.sample(None, None, cond.to(device)).cpu()
            assert (la.launches > before) == (device == "cuda")
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = tf32
    _assert_close_to_scale(outs["gpu"], outs["cpu"], 1e-4)
    with pytest.raises(AssertionError, match="max abs err"):
        _assert_close_to_scale(outs["no noise"], outs["cpu"], 1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("op", ["upfirdn2d", "upsample_2d", "downsample_2d", "upsample_conv_2d", "conv_downsample_2d"])
def test_fir_ops_on_the_gpu_match_the_cpu(op, deterministic_cudnn, full_f32):
    """The FIR resampling ops of NCSN++ (library convs), f32, GPU against
    CPU within 1e-5 of the largest value, with an asymmetric kernel; the
    unflipped kernel fails the same check."""
    _require_cuda()
    from dyffusion_tpu_torch.ops import upfirdn2d as fir

    g = np.random.default_rng(0)
    x = torch.from_numpy(g.normal(size=(4, 16, 17, 13)).astype(np.float32))
    w = torch.from_numpy(g.normal(size=(8, 16, 3, 3)).astype(np.float32))
    taps = [1.0, 2.0, 5.0, 3.0]

    def run(t, k):
        if op == "upfirdn2d":
            return fir.upfirdn2d(t, np.outer(k, k), up=2, down=1, pad=(-1, 2))
        args = (w.to(t.device),) if "conv" in op else ()
        return getattr(fir, op)(t, *args, k=k)

    want = run(x, taps)
    _assert_close_to_scale(run(x.cuda(), taps).cpu(), want, 1e-5)
    with pytest.raises(AssertionError):
        _assert_close_to_scale(run(x, taps[::-1]), want, 1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["ncsnpp", "ncsnpp_spade"])
def test_ncsnpp_forward_on_the_gpu_matches_the_cpu(name, deterministic_cudnn, full_f32):
    """A small NCSN++ (and SPADE NCSN++) with perturbed weights, f32, GPU
    against CPU within 1e-4 of the largest output."""
    _require_cuda()
    import copy

    from dyffusion_tpu_torch.models import build_backbone
    from dyffusion_tpu_torch.models.base import BackboneSpec

    torch.manual_seed(0)
    cfg = {"name": name, "dim": 16, "dim_mults": (1, 2, 2), "attn_resolutions": (8,), "n_head_channels": 8,
           "num_res_blocks": 2, "spade_dim": 16}
    model = build_backbone(cfg, BackboneSpec(3, 3, 2, spatial_shape=(32, 32)))
    with torch.no_grad():
        for p in model.parameters():
            p.add_(0.05 * torch.randn(p.shape))
    g = np.random.default_rng(1)
    x, c = (torch.from_numpy(g.normal(size=(4, n, 32, 32)).astype(np.float32)) for n in (3, 2))
    t = torch.tensor([0.0, 5.0, 300.0, 999.0])
    with torch.no_grad():
        want = model(x, t, c)
        got = copy.deepcopy(model).cuda()(x.cuda(), t.cuda(), c.cuda()).cpu()
    _assert_close_to_scale(got, want, 1e-4)


def _op_args(op, layout, dtype, device):
    """Inputs of one of the three ops, requiring gradients, contiguous or in
    the other layout ("nchw_view"): B1 the (B, N, 3hd) view of an NCHW
    1x1-conv output, B3 the (BH, d, N) view of (BH, N, d) tensors, B2
    channels-last."""
    g = torch.Generator().manual_seed(0)
    nchw = layout == "nchw_view"

    def put(t):
        return t.to(device=device, dtype=dtype).requires_grad_()

    if op == "linear_attention_qkv":
        x = torch.randn(2, 3 * HEADS * DIM_HEAD, 64, generator=g)
        return (put(x).transpose(1, 2) if nchw else put(x.transpose(1, 2).contiguous()), HEADS, DIM_HEAD, SCALE)
    if op == "linear_attention_core":
        ts = [torch.randn(8, 64, DIM_HEAD, generator=g) for _ in range(3)]  # (BH, N, d)
        return (*[put(t).transpose(1, 2) if nchw else put(t.transpose(1, 2).contiguous()) for t in ts], SCALE)
    x = torch.randn(2, 8, 6, 4, generator=g)
    return (put(x.to(memory_format=torch.channels_last)) if nchw else put(x), put(torch.randn(8, generator=g)),
            0.2, 2**0.5)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("layout", ["nchw_view", "contiguous"])
@pytest.mark.parametrize("op", ["linear_attention_qkv", "linear_attention_core", "fused_leaky_relu"])
def test_ops_pass_opcheck_on_the_gpu(op, layout, dtype):
    """``torch.library.opcheck`` of the kernels' ops on CUDA tensors: the
    schema, the autograd registration, the fake against the kernel's real
    output (shape, dtype and strides) and AOT dispatch with dynamic shapes."""
    _require_cuda()
    torch.library.opcheck(getattr(torch.ops.dyffusion_tpu_torch, op).default,
                          _op_args(op, layout, getattr(torch, dtype), "cuda"))


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["nchw_view", "contiguous"])
@pytest.mark.parametrize("op", ["linear_attention_qkv", "linear_attention_core", "fused_leaky_relu"])
def test_fake_layout_is_the_kernels(op, layout):
    """The fake of each op, which a traced graph takes its strides from, gives
    the strides the kernel writes: B1 keeps tokens fastest for the NCHW view
    (its output is itself NCHW), B3 is contiguous, B2 keeps x's strides."""
    _require_cuda()
    from torch._subclasses.fake_tensor import FakeTensorMode

    args = [a.detach() if isinstance(a, torch.Tensor) else a for a in _op_args(op, layout, torch.bfloat16, "cuda")]
    fn = getattr(torch.ops.dyffusion_tpu_torch, op).default
    real = fn(*args)
    with FakeTensorMode(allow_non_fake_inputs=True) as mode:
        fake = fn(*[mode.from_tensor(a) if isinstance(a, torch.Tensor) else a for a in args])
    assert fake.shape == real.shape and fake.dtype == real.dtype and fake.device.type == "cuda"
    assert fake.stride() == real.stride(), (fake.stride(), real.stride())
    if op == "linear_attention_qkv" and layout == "nchw_view":
        assert real.stride(1) == 1  # tokens fastest: out.transpose(1, 2) is a contiguous NCHW tensor


@pytest.mark.cuda
@pytest.mark.parametrize("prefetch", [1, 4])
def test_prefetched_device_batches_equal_host_indexing(prefetch):
    """The loader's device staging (pinned memory, non_blocking copies on
    the compute stream, made from the worker thread) over many batches
    and epochs, each batch read on the device while the stream is busy with
    other work: every batch equals host indexing, and the stager releases
    the pinned buffers of completed copies."""
    _require_cuda()
    from dyffusion_tpu_torch.data.native_loader import DeviceStager, PrefetchIterator, native_available

    assert native_available()
    g = np.random.default_rng(0)
    tensors = {"dynamics": g.normal(size=(203, 8, 60, 60, 1)).astype(np.float32),
               "condition": g.normal(size=(203, 60, 60, 2)).astype(np.float32)}
    stager = DeviceStager("cuda")
    busy = torch.randn(2048, 2048, device="cuda")
    n = 0
    for epoch in range(4):
        loader = PrefetchIterator(tensors, batch_size=16, rng=np.random.default_rng(epoch), device_put=stager,
                                  prefetch=prefetch)
        order = np.arange(203)
        np.random.default_rng(epoch).shuffle(order)
        for i, batch in enumerate(loader):
            for _ in range(4):  # device work queued ahead of the batch's readers
                busy = busy @ busy / 2048
            sel = order[16 * i:16 * (i + 1)]
            for k, v in tensors.items():
                assert batch[k].is_cuda
                assert torch.equal(batch[k].sum(dim=0).cpu(), torch.from_numpy(v[sel]).cuda().sum(dim=0).cpu())
                assert torch.equal(batch[k].cpu(), torch.from_numpy(v[sel]))
            n += 1
    assert n == 4 * (203 // 16)
    torch.cuda.synchronize()
    stager._retire()
    assert not stager._in_flight


@pytest.mark.cuda
def test_watch_gradients_on_the_gpu_match_the_cpu(deterministic_cudnn, full_f32):
    """One stage-1 step with watch_gradients, f32, GPU against CPU on the
    same weights and batch: the module norms within 1e-4, the histograms
    within a few counts (float-noise gradients below 1e-7 of the norm only
    in their total)."""
    _require_cuda()
    from dyffusion_tpu_torch.config import get_config
    from dyffusion_tpu_torch.interface import build_trainer
    from dyffusion_tpu_torch.training.trainer import GRAD_HIST_EDGES

    overrides = ["datamodule.spatial=(16,16)", "datamodule.channels=1", "datamodule.horizon=2",
                 "datamodule.n_traj=4", "datamodule.n_time=6", "datamodule.batch_size=4", "model.dim=8",
                 "model.dim_mults=(1,2)", "trainer.watch_gradients=true"]
    cfg = get_config("synthetic_interpolation", overrides)
    cpu, gpu = build_trainer(cfg, device="cpu"), build_trainer(cfg, device="cuda")
    gpu.experiment.model.load_state_dict(cpu.experiment.model.state_dict())
    batch = next(cpu.datamodule.train_batches(np.random.default_rng(0)))
    want = cpu.train_step(cpu.state, cpu._put(batch))
    got = gpu.train_step(gpu.state, gpu._put(batch))
    keys = sorted(k for k in want if k.startswith("grads/"))
    assert keys and keys == sorted(k for k in got if k.startswith("grads/"))
    floor = int(np.searchsorted(GRAD_HIST_EDGES, np.log10(1e-7 * float(want["grad_norm"]))))
    for k in keys:
        w, g = want[k], got[k].cpu()
        if k.endswith("/norm"):
            np.testing.assert_allclose(float(g), float(w), rtol=1e-4, err_msg=k)
        else:
            assert int(g.sum()) == int(w.sum()), k
            assert int((g[floor:] - w[floor:]).abs().sum()) <= 4, (k, g, w)


@pytest.mark.cuda
def test_learned_sinusoidal_unet_on_the_gpu_matches_the_cpu(deterministic_cudnn, full_f32):
    _require_cuda()
    from dyffusion_tpu_torch.models import Unet

    torch.manual_seed(0)
    model = Unet(dim=8, dim_mults=(1, 2), num_input_channels=2, num_output_channels=2, with_time_emb=True,
                 learned_sinusoidal_cond=True, learned_sinusoidal_dim=8)
    x, t = torch.randn(3, 2, 16, 16), torch.tensor([0.0, 1.5, 3.0])
    want = model(x, time=t)
    got = model.cuda()(x.cuda(), time=t.cuda()).cpu()
    _assert_close_to_scale(got, want.detach(), 1e-5)


def _unet_simple_cuda(dim, dtype, dropout=0.0):
    """A ``UNetSimple`` (NS's structure: 3 + 2 channels, time embedding, a
    256x256 working grid unless narrowed by the caller) on the card in
    ``dtype``, eval mode, its weights spread to N(0, 1/fan_in) (at the DCGAN
    init the output is ~0)."""
    from dyffusion_tpu_torch.models import unet_simple as us

    torch.manual_seed(0)
    m = us.UNetSimple(dim, 3, 3, 2, with_time_emb=True, upsample_dims=(128, 128) if dim < 64 else (256, 256),
                      dropout=dropout)
    with torch.no_grad():
        for p in m.parameters():
            if p.dim() > 1:
                p.normal_(0.0, p[0].numel() ** -0.5)
    return m.cuda().to(dtype).eval()


def _nchw_call(m, *args):
    """``m(*args)`` with ``UNetSimple``'s interior left NCHW."""
    from dyffusion_tpu_torch.models import unet_simple as us

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(us, "channels_last_interior", lambda x: False)
        return m(*args)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("chunked", [False, True], ids=["whole", "chunked"])
def test_unet_simple_interior_runs_channels_last(dtype, chunked, monkeypatch):
    """``UNetSimple``'s one-device forward on the card: every block's output
    channels-last, the decoder's six upsamples counted so, the answer
    contiguous NCHW and, with the same dropout draws, the forward with the
    interior left NCHW (TF32 off, so f32 holds to the convs' order of
    summation). ``chunked`` lowers the NHWC kernel's element limit so that
    the last decoder block runs in chunks of rows."""
    _require_cuda()
    from dyffusion_tpu_torch.models import unet_simple as us

    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    dt = getattr(torch, dtype)
    m = _unet_simple_cuda(16, dt, dropout=0.15)
    g = torch.Generator().manual_seed(1)
    x, cond = torch.randn(6, 3, 22, 10, generator=g), torch.randn(6, 2, 22, 10, generator=g)
    x, cond, t = x.cuda().to(dt), cond.cuda().to(dt), torch.rand(6, generator=g).cuda()
    if chunked:  # 16 channels x 128 x 128 a row out of the last block: 4 rows a chunk
        monkeypatch.setattr(us, "NHWC_UPSAMPLE_LIMIT", 4 * 16 * 128 * 128 + 1)
    layouts = []
    for b in list(m.input_ops) + list(m.output_ops):
        b.register_forward_hook(lambda mod, i, o: layouts.append(o.is_contiguous(memory_format=torch.channels_last)))
    with torch.no_grad():
        us.reset_upsamples()
        got = m(x, t, cond, torch.Generator("cuda").manual_seed(3))
        assert (us.upsample_channels_last, us.upsample_nchw) == (6, 0)
        assert layouts == [True] * 12 and got.is_contiguous()
        us.reset_upsamples()
        want = _nchw_call(m, x, t, cond, torch.Generator("cuda").manual_seed(3))
        assert (us.upsample_channels_last, us.upsample_nchw) == (0, 6)
    _assert_close_to_scale(got, want, {torch.float32: 1e-4, torch.bfloat16: 1e-2}[dt])


@pytest.mark.cuda
@pytest.mark.parametrize("batch", ["symbolic", "pinned"])
def test_unet_simple_export_serves_past_the_nhwc_limit(batch):
    """NS's ``UNetSimple`` at full width in bf16, exported as the serving
    artifact exports it (``torch.export``, a polymorphic batch by default)
    and run at ns-serve's cold pair of 160 rows, whose last decoder upsample
    holds 160 x 256 x 256 x 256 elements, past the 2**31 that ATen's NHWC
    kernel takes: under a symbolic batch the program stays NCHW, with a
    pinned one it runs channels-last in chunks. Each answers as the eager
    forward in its layout does. (bf16 as served: in f32, eval BatchNorm's
    choice of cuDNN guards the batch to 65535 rows, and a batch without an
    upper bound does not export.)"""
    _require_cuda()
    from dyffusion_tpu_torch.models import unet_simple as us

    dt = torch.bfloat16
    m = _unet_simple_cuda(64, dt)
    g = torch.Generator().manual_seed(1)
    rows = 160
    x, cond = torch.randn(rows, 3, 221, 42, generator=g), torch.randn(rows, 2, 221, 42, generator=g)
    x, cond, t = x.cuda().to(dt), cond.cuda().to(dt), torch.rand(rows, generator=g).cuda()
    assert rows * 256 * 256 * 256 > us.NHWC_UPSAMPLE_LIMIT
    trace = (x[:2], t[:2], cond[:2]) if batch == "symbolic" else (x, t, cond)
    dynamic = None
    if batch == "symbolic":
        b = torch.export.Dim("b", min=1)
        dynamic = ({0: b}, {0: b}, {0: b})
    us.reset_upsamples()
    with torch.no_grad():
        program = torch.export.export(m, trace, dynamic_shapes=dynamic)
    assert (us.upsample_channels_last, us.upsample_nchw) == ((0, 6) if batch == "symbolic" else (6, 0))
    with torch.no_grad():
        got = program.module()(x, t, cond)
        want = _nchw_call(m, x, t, cond) if batch == "symbolic" else m(x, t, cond)
    assert got.shape == (rows, 3, 221, 42) and bool(torch.isfinite(got).all())
    _assert_close_to_scale(got, want, 1e-2)
