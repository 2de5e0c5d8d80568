"""The port's kernels B1, B2 and B3 against the JAX package.

On the CPU each wrapper runs its plain version; it is held against the JAX
Pallas kernel (interpret mode, as ``tests/test_pallas_attention.py`` runs
it) and the XLA composition. The kernels themselves are compared with the
plain versions on the GPU in ``test_torch_port_cuda.py``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dyffusion_tpu.ops.fused_act import fused_leaky_relu as jax_fused_leaky_relu
from dyffusion_tpu.ops.pallas_attention import _core_reference, _xla_qkv
from dyffusion_tpu.ops.pallas_attention import linear_attention_core as jax_linear_attention_core
from dyffusion_tpu.ops.pallas_attention import linear_attention_qkv as jax_linear_attention_qkv
from dyffusion_tpu_torch.ops import fused_act as fa
from dyffusion_tpu_torch.ops import linear_attention as la
from tests._torch_port_helpers import torch_threads_share_of_cores  # noqa: F401 (autouse fixture)

HEADS, DIM_HEAD = 4, 32
SCALE = DIM_HEAD**-0.5
# f32 on both sides; the sums differ only in order. The outputs are small
# (v is divided by N: at most about 3e-5 at N=900), so the tolerance is
# relative to the largest output, not absolute; measured about 7e-7 of it
REL_TOL = 1e-5


def assert_close_to_scale(got, want, r=REL_TOL):
    """No element of ``got`` is further from ``want`` than ``r`` times the
    largest ``|want|``."""
    err = float(np.abs(np.asarray(got) - np.asarray(want)).max())
    limit = r * float(np.abs(want).max())
    assert err <= limit, f"max abs err {err:.3e} > {limit:.3e} ({r} of max |want|)"


def _qkv(B, N, seed=0):
    return np.random.default_rng(seed).normal(size=(B, N, 3 * HEADS * DIM_HEAD)).astype(np.float32)


@pytest.mark.parametrize("N", [100, 225, 900])
def test_plain_matches_jax_pallas_and_xla(N):
    x = _qkv(2, N, seed=N)
    want_pallas = np.asarray(jax_linear_attention_qkv(jnp.asarray(x), HEADS, DIM_HEAD, SCALE, use_pallas=True))
    want_xla = np.asarray(_xla_qkv(jnp.asarray(x), HEADS, DIM_HEAD, SCALE))
    got = la.linear_attention_qkv(torch.from_numpy(x), HEADS, DIM_HEAD, SCALE)
    assert got.shape == (2, N, HEADS * DIM_HEAD) and got.dtype == torch.float32
    assert_close_to_scale(got.numpy(), want_pallas)
    assert_close_to_scale(got.numpy(), want_xla)


@pytest.mark.parametrize("N", [225, 900])
@pytest.mark.parametrize("wrong", ["x1.05", "zeros"])
def test_tolerance_rejects_a_wrong_result(N, wrong):
    """Negative control: the check above fails for a result 5% off or zero."""
    x = _qkv(2, N, seed=N)
    want = np.asarray(jax_linear_attention_qkv(jnp.asarray(x), HEADS, DIM_HEAD, SCALE, use_pallas=True))
    bad = want * 1.05 if wrong == "x1.05" else np.zeros_like(want)
    with pytest.raises(AssertionError, match="max abs err"):
        assert_close_to_scale(bad, want)


@pytest.mark.parametrize("N", [100, 225, 900])
def test_plain_on_strided_nchw_view(N):
    """The (B, N, 3hd) view of an NCHW 1x1-conv output, as LinearAttention
    passes it, gives the same result as the contiguous layout."""
    x = _qkv(2, N, seed=N + 1)
    want = np.asarray(jax_linear_attention_qkv(jnp.asarray(x), HEADS, DIM_HEAD, SCALE, use_pallas=True))
    nchw = torch.from_numpy(np.ascontiguousarray(np.transpose(x, (0, 2, 1))))  # (B, 3hd, N)
    view = nchw.transpose(1, 2)
    assert view.stride(1) == 1
    got = la.linear_attention_qkv(view, HEADS, DIM_HEAD, SCALE)
    assert_close_to_scale(got.numpy(), want)


def test_launch_counter_stays_zero_on_cpu():
    la.reset_launches()
    la.linear_attention_qkv(torch.from_numpy(_qkv(1, 16)), HEADS, DIM_HEAD, SCALE)
    assert la.launches == 0


def test_gradient_matches_jax():
    """The port's gradient (the plain composition) equals the JAX custom VJP
    of the Pallas path."""
    x = _qkv(2, 37, seed=5)
    g = np.random.default_rng(6).normal(size=(2, 37, HEADS * DIM_HEAD)).astype(np.float32)
    want = jax.grad(
        lambda t: jnp.sum(jax_linear_attention_qkv(t, HEADS, DIM_HEAD, SCALE, use_pallas=True) * g)
    )(jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_(True)
    (la.linear_attention_qkv(xt, HEADS, DIM_HEAD, SCALE) * torch.from_numpy(g)).sum().backward()
    assert_close_to_scale(xt.grad.numpy(), np.asarray(want))


def test_plain_bf16_follows_f32_numerics():
    """bf16 in: f32 softmaxes and products, one rounding at the end, so the
    result is the f32 result of the bf16-rounded input, rounded to bf16."""
    x = torch.from_numpy(_qkv(2, 225, seed=7)).to(torch.bfloat16)
    got = la.linear_attention_qkv(x, HEADS, DIM_HEAD, SCALE)
    want = la.linear_attention_qkv_plain(x.float(), HEADS, DIM_HEAD, SCALE).to(torch.bfloat16)
    assert got.dtype == torch.bfloat16
    assert torch.equal(got, want)


def test_wrapper_rejects_wrong_width():
    with pytest.raises(ValueError, match="3\\*heads\\*dim_head"):
        la.linear_attention_qkv(torch.zeros(1, 8, 100), HEADS, DIM_HEAD, SCALE)


# ---------------------------------------------------------------------------
# B1's two launches: chunked partials, then the merge
# ---------------------------------------------------------------------------
def _chunk_tiles(N, S):
    """(tiles, tiles per chunk) of B1's partial pass: chunk s takes the whole
    tiles [s * per, (s + 1) * per) that exist."""
    tiles = -(-N // la.TILE_N)
    return tiles, -(-tiles // S)


def _chunked_qkv(qkv, S, rescale=True):
    """B1's algorithm (``csrc/linear_attention_qkv.cu``) in plain torch, f32.
    Partial pass: each of S chunks walks its tiles with an online softmax and
    keeps its per-channel max m, sum of exponentials l and unnormalised
    context C (an empty chunk keeps m = -inf, l = 0, C = 0). Merge: M =
    max_s m_s, L = sum_s l_s e^{m_s - M}, ctx = sum_s C_s e^{m_s - M} *
    scale / (L N); then out = softmax_d(q) ctx. ``rescale=False`` drops the
    e^{m_s - M} factor (a negative control)."""
    B, N, _ = qkv.shape
    T = la.TILE_N
    x = qkv.float().reshape(B, N, 3, HEADS, DIM_HEAD)
    q, k, v = x[:, :, 0], x[:, :, 1], x[:, :, 2]  # (B, N, h, d)
    tiles, per = _chunk_tiles(N, S)
    ms, ls, cs = [], [], []
    for s in range(S):
        m = torch.full((B, HEADS, DIM_HEAD), -torch.inf)
        l = torch.zeros(B, HEADS, DIM_HEAD)
        c = torch.zeros(B, HEADS, DIM_HEAD, DIM_HEAD)
        for t in range(s * per, min(tiles, (s + 1) * per)):
            kt, vt = k[:, t * T:(t + 1) * T], v[:, t * T:(t + 1) * T]
            new = torch.maximum(m, kt.amax(1))
            alpha = torch.exp(m - new)  # 0 on the chunk's first tile
            p = torch.exp(kt - new[:, None])
            l = l * alpha + p.sum(1)
            c = c * alpha[..., None] + torch.einsum("bnhd,bnhe->bhde", p, vt)
            m = new
        ms.append(m), ls.append(l), cs.append(c)
    m = torch.stack(ms)
    w = torch.exp(m - m.amax(0)) if rescale else torch.ones_like(m)  # e^{-inf} = 0: an empty chunk weighs nothing
    L = (w * torch.stack(ls)).sum(0)
    ctx = (w[..., None] * torch.stack(cs)).sum(0) * SCALE / (L[..., None] * N)
    out = torch.einsum("bnhd,bhde->bnhe", torch.softmax(q, dim=-1), ctx)
    return out.reshape(B, N, HEADS * DIM_HEAD)


def _shifted_qkv(N, S, seed):
    """Inputs whose chunk 1 (chunk 0 when it is the only one with tokens) has
    its k raised by 30, so that the chunks' maxima differ."""
    x = _qkv(2, N, seed=seed)
    tiles, per = _chunk_tiles(N, S)
    c = 1 if per < tiles else 0
    x[:, c * per * la.TILE_N:(c + 1) * per * la.TILE_N, HEADS * DIM_HEAD:2 * HEADS * DIM_HEAD] += 30.0
    return x


@pytest.mark.parametrize("N", [7, 225, 900])
@pytest.mark.parametrize("S", [1, 2, 3, 7, 16])
def test_chunked_merge_matches_jax_pallas(N, S):
    """The merge algebra of B1's two launches equals the JAX Pallas kernel,
    for every split S, with empty chunks (S = 16 leaves some at every N) and
    with chunk maxima 30 apart."""
    x = _shifted_qkv(N, S, seed=N + S)
    tiles, per = _chunk_tiles(N, S)
    if S == 16:
        assert (S - 1) * per >= tiles  # the last chunk holds no token
    want = np.asarray(jax_linear_attention_qkv(jnp.asarray(x), HEADS, DIM_HEAD, SCALE, use_pallas=True))
    got = _chunked_qkv(torch.from_numpy(x), S)
    assert_close_to_scale(got.numpy(), want)


@pytest.mark.parametrize("N", [225, 900])
def test_chunked_merge_without_the_rescale_is_rejected(N):
    """Negative control: the same check fails when the merge drops e^{m_s - M}."""
    x = _shifted_qkv(N, 3, seed=N)
    want = np.asarray(jax_linear_attention_qkv(jnp.asarray(x), HEADS, DIM_HEAD, SCALE, use_pallas=True))
    with pytest.raises(AssertionError, match="max abs err"):
        assert_close_to_scale(_chunked_qkv(torch.from_numpy(x), 3, rescale=False).numpy(), want)


def test_split_counts():
    """S and S' at the serving (B*heads = 480, 960) and batch-64 train
    (B*heads = 256) shapes: more than one chunk, no empty split, each grid
    at least two waves of the card or one unit per block; S = 1 when one
    tile holds N; the same answer every time."""
    for bh in (480, 960, 256):
        for n in (3600, 900, 225):
            S, S2 = la.split_counts(bh, n)
            assert S > 1 and la.split_counts(bh, n) == (S, S2)
            for splits, unit, per_sm in ((S, la.TILE_N, la.PARTIAL_BLOCKS_PER_SM),
                                         (S2, la.OUT_TOKENS, la.OUTPUT_BLOCKS_PER_SM)):
                units = -(-n // unit)
                per = -(-units // splits)
                assert (splits - 1) * per < units
                assert bh * splits >= 2 * la.SMS * per_sm or splits == units
    for bh in (1, 16, 480, 960):
        for n in (1, 7, 64):
            assert la.split_counts(bh, n) == (1, 1)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_load_width(dtype):
    """B1's loads: 16 bytes at N = 3600, and at N = 900 in f32 (8 in bf16);
    one element at N = 225 in the NCHW view; 16 bytes token-major; one
    element from a base pointer one element off, or with neither axis at
    stride 1."""
    dt = getattr(torch, dtype)
    wide = 16 // torch.empty((), dtype=dt).element_size()

    def qkv(N, nchw, offset=0):
        buf = torch.zeros(2 * 384 * N + offset, dtype=dt)[offset:]
        return buf.view(2, 384, N).transpose(1, 2) if nchw else buf.view(2, N, 384)

    assert la.load_width(qkv(3600, True)) == (wide, True)
    assert la.load_width(qkv(900, True)) == (4, True)
    assert la.load_width(qkv(225, True)) == (1, True)
    assert la.load_width(qkv(225, False)) == (wide, False)
    assert la.load_width(qkv(3600, True, offset=1)) == (1, True)
    assert la.load_width(qkv(3600, False, offset=1)) == (1, False)
    assert la.load_width(torch.zeros(2, 10, 768, dtype=dt)[:, :, ::2]) == (1, False)


def _core_view_and_kv(BH, N, dtype, strided, off=(0, 0, 0)):
    """B3's inputs as its wrapper hands them to ``load_width``: the (BH, N,
    d) view of q, then k and v, each (BH, d, N) of one layout (contiguous,
    or views of (BH, N, d) tensors), each ``off`` elements into its own
    buffer."""
    def one(o):
        buf = torch.zeros(BH * DIM_HEAD * N + o, dtype=dtype)[o:]
        return buf.view(BH, N, DIM_HEAD).transpose(1, 2) if strided else buf.view(BH, DIM_HEAD, N)

    q, k, v = (one(o) for o in off)
    return q.transpose(1, 2), k, v


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("BH,N", [(480, 3600), (960, 900), (960, 225)])
def test_core_load_width_over_three_pointers(BH, N, dtype):
    """B3's loads at its path shapes: as B1's at the same N in the NCHW view
    (tokens fast: 16 bytes at N = 3600, 8 in bf16 at 900, one element at
    225) and 16 bytes in both dtypes with channels fast; any one of q, k, v
    one element off its alignment gives one element per load."""
    dt = getattr(torch, dtype)
    wide = 16 // torch.empty((), dtype=dt).element_size()
    nchw = {3600: wide, 900: 4, 225: 1}[N]
    assert la.load_width(*_core_view_and_kv(BH, N, dt, False)) == (nchw, True)
    assert la.load_width(*_core_view_and_kv(BH, N, dt, True)) == (wide, False)
    for off in ((1, 0, 0), (0, 1, 0), (0, 0, 1)):
        assert la.load_width(*_core_view_and_kv(BH, N, dt, False, off)) == (1, True)
        assert la.load_width(*_core_view_and_kv(BH, N, dt, True, off)) == (1, False)
    # the q view alone does not see k's or v's alignment
    x, _, v = _core_view_and_kv(BH, N, dt, True, (0, 0, 1))
    assert la.load_width(x) == (wide, False) and la.load_width(x, v) == (1, False)


def test_core_hands_the_kernels_b1s_geometry(monkeypatch):
    """What each wrapper hands the kernels, read where it would launch them:
    B3 at (BH, d, N) gives the splits, load width and output layout that B1
    gives at batch BH / 4 with 4 heads in the NCHW view, and three base
    pointers where B1 gives its tensor's channel thirds."""
    calls = []

    def record(x, ptrs, width, out, heads, dim_head, scale):
        B, N, _ = x.shape
        calls.append({"splits": la.split_counts(B * heads, N), "width": width, "ptrs": ptrs,
                      "out": (out.shape, out.stride()), "x": x})

    monkeypatch.setattr(la, "_run", record)
    for B, N in ((120, 3600), (240, 900), (240, 225), (1, 7)):
        qkv = torch.zeros(B, 3 * HEADS * DIM_HEAD, N, dtype=torch.bfloat16).transpose(1, 2)  # NCHW view
        q, k, v = (torch.zeros(HEADS * B, DIM_HEAD, N, dtype=torch.bfloat16) for _ in range(3))
        la._launch_qkv(qkv, HEADS, DIM_HEAD, SCALE)
        out = la._launch_core(q, k, v, SCALE)
        b1, b3 = calls[-2:]
        assert b3["splits"] == b1["splits"] and b3["width"] == b1["width"]
        third = HEADS * DIM_HEAD * N * 2  # bytes
        assert b1["ptrs"] == (qkv.data_ptr(), qkv.data_ptr() + third, qkv.data_ptr() + 2 * third)
        assert b3["ptrs"] == (q.data_ptr(), k.data_ptr(), v.data_ptr())
        assert b3["x"].shape == (HEADS * B, N, DIM_HEAD) and b3["x"].stride() == (DIM_HEAD * N, 1, N)
        # the output pass writes tokens at stride 1 into B3's contiguous (BH, d, N) output
        assert out.is_contiguous() and b3["out"] == ((HEADS * B, N, DIM_HEAD), (DIM_HEAD * N, 1, N))


# ---------------------------------------------------------------------------
# B3: the linear-attention core on (BH, d, N)
# ---------------------------------------------------------------------------
def _core_qkv(BH, N, seed):
    g = np.random.default_rng(seed)
    return [g.normal(size=(BH, DIM_HEAD, N)).astype(np.float32) for _ in range(3)]


@pytest.mark.parametrize("N", [7, 225, 900])
def test_core_plain_matches_jax_pallas_and_reference(N):
    q, k, v = _core_qkv(3, N, seed=N)
    want_pallas = np.asarray(jax_linear_attention_core(q, k, v, SCALE, use_pallas=True))
    want_ref = np.asarray(_core_reference(q, k, v, SCALE, N))
    la.reset_launches()
    got = la.linear_attention_core(*(torch.from_numpy(x) for x in (q, k, v)), SCALE)
    assert la.core_launches == 0  # the CPU runs the plain version, never the kernel
    assert got.shape == (3, DIM_HEAD, N) and got.dtype == torch.float32
    assert_close_to_scale(got.numpy(), want_pallas)
    assert_close_to_scale(got.numpy(), want_ref)
    bad = want_pallas * 1.05  # negative control
    with pytest.raises(AssertionError, match="max abs err"):
        assert_close_to_scale(bad, want_pallas)


def test_core_gradient_matches_jax_vjp():
    """The port's B3 gradient (the plain composition) equals ``jax.vjp`` of
    the Pallas path's custom VJP."""
    q, k, v = _core_qkv(2, 37, seed=3)
    g = np.random.default_rng(4).normal(size=(2, DIM_HEAD, 37)).astype(np.float32)
    _, vjp = jax.vjp(lambda a, b, c: jax_linear_attention_core(a, b, c, SCALE, use_pallas=True), q, k, v)
    want = vjp(jnp.asarray(g))
    xs = [torch.from_numpy(x).requires_grad_(True) for x in (q, k, v)]
    (la.linear_attention_core(*xs, SCALE) * torch.from_numpy(g)).sum().backward()
    for x, w in zip(xs, want):
        assert_close_to_scale(x.grad.numpy(), np.asarray(w))


def test_core_wrapper_rejects_mismatched_shapes():
    q = torch.zeros(2, DIM_HEAD, 9)
    with pytest.raises(ValueError, match="one shape"):
        la.linear_attention_core(q, q, torch.zeros(2, DIM_HEAD, 8), SCALE)


# ---------------------------------------------------------------------------
# B2: fused bias + LeakyReLU * sqrt(2), bias over dim 1 (NCHW)
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("shape", [(2, 6, 5, 7), (3, 4)], ids=str)
@pytest.mark.parametrize("with_bias", [True, False])
def test_fused_leaky_relu_plain_matches_jax_pallas(shape, with_bias):
    """The JAX op is NHWC (bias over the last axis): move the channel axis
    to the end for it and back."""
    g = np.random.default_rng(len(shape))
    x = g.normal(size=shape).astype(np.float32)
    bias = g.normal(size=(shape[1],)).astype(np.float32) if with_bias else None
    x_last = np.moveaxis(x, 1, -1)
    want = np.moveaxis(np.asarray(jax_fused_leaky_relu(x_last, bias, use_pallas=True)), -1, 1)
    want_xla = np.moveaxis(np.asarray(jax_fused_leaky_relu(x_last, bias)), -1, 1)
    fa.reset_launches()
    got = fa.fused_leaky_relu(torch.from_numpy(x), None if bias is None else torch.from_numpy(bias))
    assert fa.launches == 0 and got.shape == shape
    # the same f32 operations in the same order on both sides
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(got.numpy(), want_xla, rtol=1e-6, atol=1e-7)


def test_fused_leaky_relu_gradient_matches_jax():
    g = np.random.default_rng(9)
    x = g.normal(size=(2, 5, 4, 3)).astype(np.float32)
    bias = g.normal(size=(5,)).astype(np.float32)
    cot = g.normal(size=x.shape).astype(np.float32)
    want_x, want_b = jax.grad(
        lambda a, b: jnp.sum(jnp.moveaxis(jax_fused_leaky_relu(jnp.moveaxis(a, 1, -1), b), -1, 1) * cot),
        argnums=(0, 1),
    )(jnp.asarray(x), jnp.asarray(bias))
    xt, bt = torch.from_numpy(x).requires_grad_(True), torch.from_numpy(bias).requires_grad_(True)
    (fa.fused_leaky_relu(xt, bt) * torch.from_numpy(cot)).sum().backward()
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(want_x), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(bt.grad.numpy(), np.asarray(want_b), rtol=1e-5, atol=1e-5)


def test_fused_leaky_relu_bf16_computes_in_f32():
    x = torch.from_numpy(np.random.default_rng(2).normal(size=(2, 3, 4, 4)).astype(np.float32)).bfloat16()
    b = torch.tensor([0.1, -0.2, 0.3])
    got = fa.fused_leaky_relu(x, b)
    assert got.dtype == torch.bfloat16
    assert torch.equal(got, fa.fused_leaky_relu_plain(x.float(), b).bfloat16())


B2_PATH = [(120, 64, 60, 60), (120, 128, 30, 30), (120, 256, 15, 15)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("channels_last", [False, True])
@pytest.mark.parametrize("shape", B2_PATH + [(3, 5, 7, 3)], ids=str)
def test_fused_leaky_relu_load_width(shape, channels_last, dtype):
    """B2 loads 16 bytes at its path shapes (and an odd one) in both
    layouts: shape, layout and numel no longer narrow the width, only a base
    pointer off alignment does."""
    dt = getattr(torch, dtype)
    isz = torch.empty((), dtype=dt).element_size()
    numel = int(np.prod(shape))
    mf = torch.channels_last if channels_last else torch.contiguous_format
    x = torch.empty(shape, dtype=dt, memory_format=mf)
    out = torch.empty_strided(x.shape, x.stride(), dtype=dt)
    assert fa.load_width(x, out) * isz == 16
    off = torch.empty(numel + 1, dtype=dt)[1:].as_strided(x.shape, x.stride())  # one element off
    assert fa.load_width(off, out) * isz == isz and fa.load_width(x, off) * isz == isz


def _divide(n, m, s):
    """The kernel's multiply-shift divide, in exact integer arithmetic."""
    return (((n * m) >> 64) + n) >> s


@pytest.mark.parametrize("shape", B2_PATH + [(3, 5, 7, 3), (2, 3, 1, 1)], ids=str)
@pytest.mark.parametrize("channels_last", [False, True])
def test_fused_leaky_relu_channel_divides(shape, channels_last):
    """The wrapper's divisor constants give (j // cstride) % C at every
    index of the first two batch rows of each shape, and near 2**31 and
    2**62; a constant one off does not."""
    mf = torch.channels_last if channels_last else torch.contiguous_format
    x = torch.empty(shape, memory_format=mf)
    C, cstride = shape[1], x.stride(1)
    (mc, sc), (mC, sC) = fa.divisor(cstride), fa.divisor(C)
    js = list(range(min(2 * int(np.prod(shape[1:])), x.numel())))
    js += list(range(2**31 - 4096, 2**31 + 4096)) + list(range(2**62 - 4096, 2**62 + 4096))
    for j in js:
        run = _divide(j, mc, sc)
        assert run == j // cstride and run - _divide(run, mC, sC) * C == (j // cstride) % C
    if cstride > 1:  # negative control
        assert any(_divide(j, mc - 1, sc) != j // cstride for j in js)


def _vector_channels(j, vec, cstride, C):
    """The channels of elements j .. j + vec - 1 (j a multiple of vec) as
    the kernel's ``bias_of`` finds them (``csrc/fused_act.cu``)."""
    (mc, sc), (mC, sC) = fa.divisor(cstride), fa.divisor(C)
    if cstride == 1 and C % vec == 0:  # CHANNELS_LAST: consecutive channels
        c = j - _divide(j, mC, sC) * C
        return [c + t for t in range(vec)]
    run = _divide(j, mc, sc)
    r, c = j - run * cstride, run - _divide(run, mC, sC) * C
    if cstride >= vec:  # one split point
        nxt = 0 if c + 1 == C else c + 1
        return [c if t < cstride - r else nxt for t in range(vec)]
    out = []  # the walk
    for _ in range(vec):
        out.append(c)
        r += 1
        if r == cstride:
            r, c = 0, 0 if c + 1 == C else c + 1
    return out


@pytest.mark.parametrize("vec", [8, 4, 2])
@pytest.mark.parametrize("shape", B2_PATH + [(3, 5, 7, 3), (2, 3, 1, 1), (2, 12, 1, 3)], ids=str)
@pytest.mark.parametrize("channels_last", [False, True])
def test_fused_leaky_relu_vector_channels(channels_last, shape, vec):
    """The kernel's per-vector rule (one divide pair per vector, then a
    split point, a walk or consecutive channels) gives (j // cstride) % C
    for every element of the first batch row, with vectors that span
    channels; the rule without its split point does not."""
    mf = torch.channels_last if channels_last else torch.contiguous_format
    x = torch.empty(shape, memory_format=mf)
    C, cstride = shape[1], x.stride(1)
    n = -(-int(np.prod(shape[1:])) // vec) * vec
    got = [c for j in range(0, n, vec) for c in _vector_channels(j, vec, cstride, C)]
    assert got == [(j // cstride) % C for j in range(n)]
    if cstride >= vec and cstride % vec:  # negative control: every element of a vector in its first channel
        assert got != [c for j in range(0, n, vec) for c in [_vector_channels(j, vec, cstride, C)[0]] * vec]


def test_divisor_constants_fit_and_divide():
    """m < 2**64 and exact division for every divisor up to 4096 and near
    2**31, at the ends of the dividend range."""
    ns = [0, 1, 2**31 - 1, 2**31, 2**62 + 12345, 2**63 - 1]
    for d in list(range(1, 4097)) + list(range(2**31 - 50, 2**31 + 50)):
        m, s = fa.divisor(d)
        assert 0 <= m < 2**64
        for n in ns + [d - 1, d, d + 1, 7 * d - 1]:
            assert _divide(n, m, s) == n // d, (d, n)


def test_fused_leaky_relu_rejects_a_bias_of_the_wrong_width():
    with pytest.raises(ValueError, match="dim 1"):
        fa.fused_leaky_relu(torch.zeros(2, 4, 3, 3), torch.zeros(3))
