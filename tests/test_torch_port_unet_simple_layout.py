"""``UNetSimple``'s one-device interior runs channels-last on CUDA tensors
(``channels_last_interior``); these tests turn it on for CPU tensors and
hold it to the NCHW computation it replaces, and hold the CPU's own
forward, and a forward under export with a symbolic batch, to NCHW.

The NCHW computation is the model's own forward with
``channels_last_interior`` answering False (:func:`_nchw`). f32, dropout on
with a seeded generator, so equal outputs also mean equal mask draws; the two sides differ only by the convs' order of
summation (held to 1e-5 of the largest value; gradients to 1e-4 of the
largest of their leaf, or of the median leaf's where that is larger:
BatchNorm cancels the gradients of the biases before it, which are
round-off). Under a shard (one rank in process) the decoder's upsamples
are fused with their convs and neither counter moves.
"""
import copy

import pytest
import torch
import torch.nn.functional as F

from dyffusion_tpu_torch.models import unet_simple as us
from dyffusion_tpu_torch.models.base import BatchNorm2d
from dyffusion_tpu_torch.models.modules import dropout
from dyffusion_tpu_torch.parallel import spatial
from dyffusion_tpu_torch.training.optim import build_optimizer
from tests._torch_port_helpers import torch_threads_share_of_cores  # noqa: F401 (autouse fixture)

CL = torch.channels_last
REL = 1e-5
GRAD_REL = 1e-4
GRID = (22, 10)


def _model(remat: bool = False) -> us.UNetSimple:
    """The NS backbone's structure at dim 4 on a 128x128 working grid (its
    deepest level 2x2: a 1x1 level would be both NCHW and channels-last), with
    weights spread to N(0, 1/fan_in) (at the DCGAN init the output is ~0)
    and random running statistics."""
    torch.manual_seed(0)
    m = us.UNetSimple(4, 3, 3, 2, with_time_emb=True, upsample_dims=(128, 128), dropout=0.2,
                      input_dropout=0.1, remat=remat)
    with torch.no_grad():
        for mod in m.modules():
            if isinstance(mod, (torch.nn.Conv2d, torch.nn.ConvTranspose2d, torch.nn.Linear)):
                fan_in = mod.weight[0].numel() if not isinstance(mod, torch.nn.ConvTranspose2d) \
                    else mod.weight[:, 0].numel()
                mod.weight.normal_(0.0, fan_in ** -0.5)
                mod.bias.normal_(0.0, 0.02)
            elif isinstance(mod, BatchNorm2d):
                mod.running_mean.normal_(0.0, 0.3)
                mod.running_var.uniform_(0.5, 1.5)
    return m


def _inputs(rows: int = 3):
    g = torch.Generator().manual_seed(1)
    x = torch.randn(rows, 3, *GRID, generator=g)
    cond = torch.randn(rows, 2, *GRID, generator=g)
    return x, torch.rand(rows, generator=g), cond


def _strides(t: torch.Tensor) -> tuple:
    """The strides of the dims longer than 1: those a layout sets."""
    return tuple(s for n, s in zip(t.shape, t.stride()) if n > 1)


def _close(got: torch.Tensor, want: torch.Tensor, rel: float) -> None:
    torch.testing.assert_close(got, want, rtol=0.0, atol=rel * float(want.abs().max()))


@pytest.fixture
def channels_last(monkeypatch):
    monkeypatch.setattr(us, "channels_last_interior", lambda x: True)


def _nchw(m, *args):
    """``m(*args)`` with the interior left NCHW."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(us, "channels_last_interior", lambda x: False)
        return m(*args)


def _block_layouts(m) -> list:
    """Hooks that record, for each block's output in order, whether it is
    channels-last; the list they fill."""
    out = []
    for b in list(m.input_ops) + list(m.output_ops):
        b.register_forward_hook(lambda mod, i, o: out.append(o.is_contiguous(memory_format=CL)))
    return out


def test_dropout_keeps_channels_last_with_the_same_draws():
    x = torch.randn(2, 8, 5, 7)
    nchw = dropout(x, 0.3, torch.Generator().manual_seed(3))
    last = dropout(x.contiguous(memory_format=CL), 0.3, torch.Generator().manual_seed(3), channels_last=True)
    assert last.is_contiguous(memory_format=CL) and not last.is_contiguous()
    assert torch.equal(last, nchw)
    keep = torch.rand(x.shape, generator=torch.Generator().manual_seed(3)) < 0.7
    assert torch.equal(nchw, torch.where(keep, x / 0.7, torch.zeros(())))  # NCHW callers: as before
    assert nchw.is_contiguous()
    # unasked, a channels-last input gets torch.where's answer, as before
    plain = dropout(x.contiguous(memory_format=CL), 0.3, torch.Generator().manual_seed(3))
    assert plain.is_contiguous() and torch.equal(plain, nchw)
    assert 0 < int((nchw == 0).sum()) < x.numel()


def test_cpu_forward_stays_nchw():
    m = _model().eval()
    x, t, cond = _inputs()
    layouts = _block_layouts(m)
    with torch.no_grad():
        us.reset_upsamples()
        got = m(x, t, cond, torch.Generator().manual_seed(11))
    assert (us.upsample_channels_last, us.upsample_nchw) == (0, 6)
    assert layouts == [False] * 12 and got.is_contiguous()


def test_forward_channels_last_matches_nchw(channels_last):
    m = _model().eval()
    x, t, cond = _inputs()
    layouts = _block_layouts(m)
    with torch.no_grad():
        us.reset_upsamples()
        g = torch.Generator().manual_seed(11)
        got = m(x, t, cond, g)
        assert (us.upsample_channels_last, us.upsample_nchw) == (6, 0)
        assert layouts == [True] * 12
        g_ref = torch.Generator().manual_seed(11)
        want = _nchw(m, x, t, cond, g_ref)
        assert layouts[12:] == [False] * 12
        other = m(x, t, cond, torch.Generator().manual_seed(12))
    assert got.shape == (3, 3, *GRID) and got.is_contiguous()
    assert torch.equal(g.get_state(), g_ref.get_state())  # as many draws
    _close(got, want, REL)
    assert float((other - want).abs().max()) > 100 * REL * float(want.abs().max())  # the masks matter


def test_upsample_past_the_nhwc_limit_runs_in_chunks(channels_last, monkeypatch):
    """ATen's NHWC kernel refuses an output of 2**31 elements or more; such
    an upsample and its conv run in even chunks of rows. Here the limit is
    lowered so that the last decoder block (16 x 128 x 128 elements a row
    out) takes 2 rows a chunk."""
    m = _model().eval()
    x, t, cond = _inputs(5)
    rows = []
    m.output_ops[5].ops[0].register_forward_hook(lambda mod, i, o: rows.append(o.shape[0]))
    with torch.no_grad():
        whole = m(x, t, cond, torch.Generator().manual_seed(4))
        assert rows == [5]
        monkeypatch.setattr(us, "NHWC_UPSAMPLE_LIMIT", 2 * 16 * 128 * 128 + 1)
        us.reset_upsamples()
        chunked = m(x, t, cond, torch.Generator().manual_seed(4))
    assert rows == [5, 2, 2, 1]
    assert (us.upsample_channels_last, us.upsample_nchw) == (6, 0)
    _close(chunked, whole, REL)


def test_sharded_forward_counts_no_upsample(channels_last):
    m = _model().eval()
    x, t, cond = _inputs(2)
    with torch.no_grad():
        one = m(x, t, cond)
        us.reset_upsamples()
        with spatial.sharded("h", GRID):
            shard = m(x, t, cond)
    assert (us.upsample_channels_last, us.upsample_nchw) == (0, 0)
    _close(shard, one, REL)


@pytest.mark.parametrize("remat", [False, True], ids=["remat_off", "remat_on"])
def test_train_step_channels_last_matches_nchw(channels_last, remat):
    m = _model(remat)
    ref = copy.deepcopy(m)
    x, t, cond = _inputs()
    target = torch.randn(3, 3, *GRID, generator=torch.Generator().manual_seed(2))
    us.reset_upsamples()
    stats, stats_ref = {}, {}
    F.mse_loss(m(x, t, cond, torch.Generator().manual_seed(21), stats), target).backward()
    # the forward's 6; under remat the backward's recompute runs the decoder again
    assert (us.upsample_channels_last, us.upsample_nchw) == (12 if remat else 6, 0)
    F.mse_loss(_nchw(ref, x, t, cond, torch.Generator().manual_seed(21), stats_ref), target).backward()
    names = {mod: n for n, mod in m.named_modules()}
    ref_mods = dict(ref.named_modules())
    assert len(stats) == len(stats_ref) == 11
    for mod, (mean, var, count) in stats.items():
        mean_ref, var_ref, count_ref = stats_ref[ref_mods[names[mod]]]
        _close(mean, mean_ref, REL)
        _close(var, var_ref, REL)
        assert int(count) == int(count_ref)
    grads_ref = {n: p.grad for n, p in ref.named_parameters()}
    scales = sorted(float(g.abs().max()) for g in grads_ref.values())
    median = scales[len(scales) // 2]
    for name, p in m.named_parameters():
        assert p.grad is not None, name
        assert _strides(p.grad) == _strides(p), name
        want = grads_ref[name]
        torch.testing.assert_close(p.grad, want, rtol=0.0, atol=GRAD_REL * max(float(want.abs().max()), median))
    start = {n: p.detach().clone() for n, p in m.named_parameters()}
    grads = {n: p.grad.clone() for n, p in m.named_parameters()}
    opt = build_optimizer(m.named_parameters(), "adamw", lr=1e-3, weight_decay=1e-5)
    opt.step()
    adam = opt.optimizer
    for name, p in m.named_parameters():
        assert p.grad is None and _strides(p) == _strides(start[name]), name
        assert torch.isfinite(p).all(), name
        torch.testing.assert_close(adam.state[p]["exp_avg"], 0.1 * grads[name])
        moved = (p.detach() - start[name]).abs()
        assert bool((moved[grads[name] != 0] > 0).all()), name


@pytest.mark.parametrize("batch", ["symbolic", "pinned"])
def test_export_keeps_nchw_under_a_symbolic_batch(channels_last, batch):
    """Under ``torch.export`` with a polymorphic batch the rows of a chunk
    cannot be counted, so the whole forward stays NCHW (the decoder counts
    6 NCHW upsamples while tracing, and the program answers any batch, past
    the NHWC kernel's limit too); with a pinned batch it runs channels-last
    as eagerly. Either program answers as the eager forward does."""
    m = _model().eval()
    x, t, cond = _inputs(3)
    dynamic = None
    if batch == "symbolic":
        b = torch.export.Dim("b", min=1)
        dynamic = ({0: b}, {0: b}, {0: b})
    us.reset_upsamples()
    with torch.no_grad():
        program = torch.export.export(m, (x, t, cond), dynamic_shapes=dynamic)
    assert (us.upsample_channels_last, us.upsample_nchw) == ((0, 6) if batch == "symbolic" else (6, 0))
    formats = [n.kwargs.get("memory_format") for n in program.graph.nodes if n.op == "call_function"]
    assert (CL in formats) == (batch == "pinned")
    x2, t2, cond2 = _inputs(5) if batch == "symbolic" else (x, t, cond)
    with torch.no_grad():
        got = program.module()(x2, t2, cond2)
        want = _nchw(m, x2, t2, cond2)
    assert got.shape == (len(x2), 3, *GRID) and got.is_contiguous()
    _close(got, want, REL)
