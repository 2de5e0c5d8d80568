#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (dyffusion_tpu_torch) on one GPU.

    python3 chip_smoke.py

Phases, each printing its results; any failure raises and the exit code is
non-zero:

1. device: requires CUDA; prints the card's name, the device count and
   ``nvidia-smi --query-gpu=name,power.limit``.
2. build: compiles every kernel (B1 and B3 ``linear_attention_qkv.cu``,
   B2 ``fused_act.cu``) from the repo's CUDA sources with nvcc (sm_90a),
   one nvcc per source, all at once, and prints the build times, the ptxas
   reports and each kernel's registers and spills; a spill in any kernel
   fails the run.
3. kernel vs plain: B1 at the shapes of the serving, train, fit and cli
   (the 50-member test ensemble: 300/600 rows) paths,
   B3 and B2 at theirs, bf16 and f32, contiguous and as a strided view,
   against their plain PyTorch versions, with a tolerance relative to the
   output's scale; negative controls show that the same check rejects a
   result that is 5% off or zero; B3's backward against the plain
   composition's. Then kernel and plain times (CUDA events, after a
   warm-up, with the queue filled behind a sleep kernel: device time),
   GB/s and the share of the byte bound, at the serving and the
   batch-64 train shapes, with B1's forward time per request and per step,
   and B1's and B3's splits S, S' (``split_counts``), load width and
   resident blocks per SM at each timed shape; B2's load width at its path
   shapes (16 bytes, or the run fails), and its times in NCHW and
   channels-last over copies of the input that exceed L2 twice over.
4. op path: B2 and B3 through their public ops (``fused_leaky_relu``,
   ``linear_attention_core``, forward and backward) at their path shapes,
   with the launch counts read around it; no model of the JAX package calls
   either op.
5. reference: the serving slice at a small size with dropout off, in f32,
   on the GPU (kernels) against the CPU (plain versions); a negative control
   shows that the check rejects a slice whose linear attention is dropped.
6. train reference: one stage-2 loss (l2 > 0, fixed t, dropout off, f32)
   and every forecaster gradient, GPU against CPU; a negative control shows
   that the check rejects a loss whose gradient skips the interpolator's
   second call.
7. slice: the SST-width workload (60x60, C=1, h=7, k=25, dim-64 UNets with
   mults (1,2,4), 20 members x batch 6, bf16) built through
   ``interface.build_experiment`` with seeded random weights, answering
   requests through ``serving.build_experiment_predict_fn``; checks shapes, finite
   values, live dropout (member spread > 0, seeds differ, a seed repeats),
   the kernel launch count per request, and prints latency, frames/s, peak
   memory and the ensemble metrics.
8. train: the SST-width train steps at batch 64 through
   ``interface.build_trainer``: stage 1 in f32, then stage 2 (the stage-1
   model as its interpolator) in f32, in bf16 mixed precision and in f32
   with remat; per variant a warm-up step, 20 timed steps and 9 more on one
   fixed batch. Checks finite losses that fall, and the B1 launches of each
   variant (per step and in all); prints steps/s, examples/s, peak memory
   and B1's share of the step.
9. fit: ``interface.run_experiment`` at a small size, stage 1 then stage 2,
   two epochs each, in a temporary registry; both best val/crps must be
   finite, and each stage's B1 launches must be what its steps and
   validations imply.
10. cli: the CLI (``train.main``) at SST width in a temporary registry:
   stage 1, stage 2 from the registry by run id, the same command resumed
   from step 4 to 8, ``mode=test`` with 50 members, and
   ``serving.build_predict_fn`` by run id, which must serve the EMA
   weights (the live weights' answer, a negative control, must differ);
   prints each command's wall time and checks its B1 launches.

11. physical reference: for UNetSimple (NS) and SimpleConvNet (spring), small
   and f32, the forecaster's eval forward and a stage-2 loss with every
   forecaster gradient and the BatchNorm running-statistics updates, GPU
   against CPU; negative controls: the running statistics reset, and the
   forecaster's first pass on its running averages.
12. ns, spring: the Navier-Stokes and spring-mesh paths through the CLI at
   their canonical widths (NS: 221x42, C=3+2, horizon 16, UNetSimple dim 64
   at 256x256, dropout 0.15, batch 32 x accumulate 2, refinement,
   forward_conditioning=none, bf16 eval; spring: 10x10, C=4+1, horizon 134,
   SimpleConvNet dim 64 with BatchNorm, dropout 0.2, batch 64, refinement)
   on fake archives at the real grids, in a temporary registry: stage 1,
   stage 2 from the registry, ``mode=test`` over one full test trajectory
   (4 and 6 autoregressive windows, 20 members), serving by run id. Checks
   falling finite losses, running statistics moved by training and kept by
   evaluation and serving, the boundary conditions in every served frame
   (with a negative control), seeds; prints wall times, request times and
   peak memory. No kernel of the port lies on these paths: their launch
   counts must read 0.

Each path (slice, train, fit, each cli command, ns, spring) sets the launch
counts to 0 before it runs and reads them after. The line before the last is the kernel summary as JSON
(B1's top-level launches and times are the train path's; ``by_path`` has
each path's count); the last line is ``{"ok": true, "device": {...}}``.

    python3 chip_smoke.py --profile

runs phases 1 and 2, then profiles one SST request with ``torch.profiler``:
the unprofiled request times, the profiled request's wall time, its summed
kernel time and busy share, and kernel time by category; then one NS and
one spring request and stage-2 train step at their canonical widths. It
prints no ``ok`` line.

    python3 chip_smoke.py --physical

runs phases 1, 2, 11 and 12 (the physical-systems paths) and stops, with
no ``ok`` line.

    python3 chip_smoke.py --kernels

runs phases 1 and 2, then the three kernel phases (B1, B3, B2 against their
plain versions, and their times) and stops, with no ``ok`` line.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time

SEED = 0
N_REQUESTS = 3  # timed requests, after one warm-up request
# the least time of a kernel's work: bytes over the H100's HBM rate, f32
# operations over its CUDA-core f32 rate (the kernels compute in f32 off the
# tensor cores); NVIDIA's data sheet, SXM part
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12
# r of _within: f32 on both sides, sums in another order; bf16 outputs may
# also round one ulp (<= 2**-7 of the largest output) apart
REL_TOL = {"float32": 2e-5, "bfloat16": 1e-2}


def _sync():
    import torch

    torch.cuda.synchronize()


def phase_device():
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False; this smoke run needs a GPU")
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(f"[device] {name}, count={torch.cuda.device_count()}, torch {torch.__version__}, cuda {torch.version.cuda}")
    print(smi)
    # numerics settings: full f32 matmuls and convs (the f32 reference phase
    # compares with the CPU); the serving path itself runs in bf16
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"[device] tf32: matmul={torch.backends.cuda.matmul.allow_tf32} cudnn={torch.backends.cudnn.allow_tf32}")
    return name, smi


def _ptxas_kernels(report):
    """[(kernel, registers, spill store bytes, spill load bytes)] from an
    ``-Xptxas -v`` report, names demangled where ``c++filt`` exists."""
    import re
    import shutil

    rows, name, spill = [], None, (0, 0)
    for line in report.splitlines():
        if m := re.search(r"Compiling entry function '(\w+)'", line):
            name = m.group(1)
        elif m := re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line):
            spill = (int(m.group(1)), int(m.group(2)))
        elif (m := re.search(r"Used (\d+) registers", line)) and name:
            rows.append([name, int(m.group(1)), *spill])
            name, spill = None, (0, 0)
    if rows and shutil.which("c++filt"):
        out = subprocess.run(["c++filt"], input="\n".join(r[0] for r in rows), capture_output=True, text=True,
                             timeout=60).stdout.splitlines()
        if len(out) == len(rows):
            for r, n in zip(rows, out):
                r[0] = n.replace("(anonymous namespace)::", "")
    return rows


def phase_build():
    from dyffusion_tpu_torch.ops import _build

    t0 = time.perf_counter()
    names = ("linear_attention_qkv", "fused_act")
    _build.load_libraries(names)
    for name in names:
        log = _build.build_log[name]
        print(f"[build] {name}: nvcc {log['seconds']:.2f} s")
        print(f"[build] ptxas: {log['ptxas']}")
        for kernel, regs, spill_st, spill_ld in _ptxas_kernels(log["ptxas"]):
            print(f"[build] {name}: {kernel[:150]}: {regs} registers, spill stores {spill_st} B, loads {spill_ld} B")
            if spill_st or spill_ld:
                raise AssertionError(f"the kernel {kernel} spills registers")
    print(f"[build] all kernels built and loaded in {time.perf_counter() - t0:.2f} s")


def _bound(n_bytes, flops):
    """(least ms, what bounds it) for work moving ``n_bytes`` and doing
    ``flops`` f32 operations."""
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S * 1e3, flops / F32_FLOPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _check_vs_plain(label, got, want, r, negative_controls=False):
    """Hold ``got`` to r x max|want|, print, raise on a miss; optionally show
    that the same check rejects a result 5% off and zeros. Returns the max
    abs error."""
    import torch

    ok, e, limit = _within(got, want, r)
    scale = limit / r
    print(f"[kernel] {label}: max_abs_err={e:.3e}, max|plain|={scale:.3e}, rel={e / scale if scale else 0:.2e} (limit {r})")
    if not ok:
        raise AssertionError(f"{label}: the kernel disagrees with its plain version: max_abs_err={e}, limit {limit}")
    if negative_controls:
        for name, wrong in (("x1.05", want * 1.05), ("zeros", torch.zeros_like(want))):
            if _within(wrong, want, r)[0]:
                raise AssertionError(f"{label}: the kernel check accepts a wrong result ({name})")
        print(f"[kernel] {label}: the check rejects x1.05 and zeros")
    return e


def _time_pair(kernel, plain, iters=20):
    """(kernel ms, plain ms) per call, timed in the order plain, kernel,
    kernel, plain, ``iters`` calls each."""
    p1, k1, k2, p2 = (_time_ms(f, iters) for f in (plain, kernel, kernel, plain))
    return (k1 + k2) / 2, (p1 + p2) / 2


def _print_split(label, x, bh, N, *more):
    """B1's/B3's splits S, S', load width (from ``x`` and ``more``, as
    ``load_width`` takes them) and resident blocks per SM."""
    from dyffusion_tpu_torch.ops import linear_attention as la

    S, S2 = la.split_counts(bh, N)
    vec, tokens_fast = la.load_width(x, *more)
    occ = la.qkv_occupancy(x.dtype, vec, tokens_fast)
    print(f"[kernel-split] {label}: S={S}, S'={S2}, {vec * x.element_size()}-byte loads, blocks per SM "
          f"(partial, output) {occ}, grids {bh * S} and {bh * S2} blocks = {bh * S / (132 * occ[0]):.2f} and "
          f"{bh * S2 / (132 * occ[1]):.2f} waves")


def _qkv(B, N, dtype, strided, gen):
    import torch

    F = 384  # 3 * heads(4) * dim_head(32)
    if strided:  # the (B, N, 3hd) view of an NCHW 1x1-conv output
        x = torch.randn((B, F, N), generator=gen, device="cuda", dtype=torch.float32).to(dtype)
        return x.transpose(1, 2)
    return torch.randn((B, N, F), generator=gen, device="cuda", dtype=torch.float32).to(dtype)


# cycles of the sleep kernel that holds the device while the host issues a
# timed window (~0.1 s at the H100's clocks): longer than the host takes to
# issue any window here
HOLD_CYCLES = 200_000_000


def _time_ms(fn, iters=20, warmup=3):
    """Device time per call: CUDA events around ``iters`` calls after a
    warm-up. The device sleeps while the host issues the window, so the
    calls run back to back from a full queue and the host's issue time per
    call does not bound a small kernel's time."""
    import torch

    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(HOLD_CYCLES)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    _sync()
    return start.elapsed_time(end) / iters


def _within(got, want, r):
    """(ok, max_abs_err, limit): the kernel's output agrees with the plain
    version's when no element is further off than ``r`` times the largest
    plain output. The outputs are small (v is divided by N: about 4e-6 at
    N=3600), so an absolute tolerance would pass anything."""
    import torch

    err = float((got.float() - want.float()).abs().max())
    limit = r * float(want.float().abs().max())
    return bool(torch.isfinite(got).all()) and err <= limit, err, limit


# B1 calls per train step at each N (3600, 900, 225), by dtype, of each
# [train] variant: two calls (down and up path) per Unet forward at each N.
# Stage 2 runs two interpolator and two forecaster forwards; remat recomputes
# the two forecaster forwards; in bf16 only the first forecaster forward runs
# in bf16 (the interpolator's weights are f32, and the l2 pass takes its f32
# output, so those calls promote to f32)
TRAIN_CALLS = {
    "stage 1, f32": {"float32": 2},
    "stage 2, f32": {"float32": 8},
    "stage 2, bf16 train_dtype": {"bfloat16": 2, "float32": 6},
    "stage 2, f32, remat": {"float32": 12},
}


def phase_kernel():
    """B1 vs plain at the shapes of the serving, train and fit paths; times
    at the serving and train shapes. Returns the max abs error, per-launch
    times over one request's call mix ("serve") and over the [train] phase's
    call mix ("train"), and the B1 forward time per step of each [train]
    variant ("train_step")."""
    import torch

    from dyffusion_tpu_torch.ops import linear_attention as la

    heads, d = 4, 32
    scale = d**-0.5
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    serve = ((120, 3600), (240, 900), (240, 225), (240, 3600), (120, 900), (120, 225))
    train = ((64, 3600), (64, 900), (64, 225))  # batch 64, both stages
    fit = ((4, 576), (24, 144))  # [fit]: a train batch at 24x24; an interpolator eval call at 12x12
    # [cli]: the 50-member test ensemble folded into eval batches of 6 (forecaster 300, interpolator 600)
    cli = ((300, 3600), (600, 3600), (300, 900), (600, 900), (300, 225), (600, 225))
    controls = ((120, 3600), (240, 900), (64, 3600), (300, 3600))
    max_err = 0.0
    for B, N in serve + train + fit + cli + ((3, 7),):
        for dtype in (torch.bfloat16, torch.float32):
            for strided in (False, True):
                qkv = _qkv(B, N, dtype, strided, gen)
                got = la.linear_attention_qkv(qkv, heads, d, scale)
                _sync()
                want = la.linear_attention_qkv_plain(qkv, heads, d, scale)
                dt = str(dtype)[6:]
                label = f"B1 B={B} N={N} {dt} {'nchw-view' if strided else 'contiguous'}"
                e = _check_vs_plain(label, got, want, REL_TOL[dt], negative_controls=(B, N) in controls and not strided)
                max_err = max(max_err, e)

    def timed(B, N, dtype):  # NCHW view, as the Unet calls it
        qkv = _qkv(B, N, dtype, True, gen)
        _print_split(f"B1 B={B} N={N} {str(dtype)[6:]} nchw-view", qkv, B * heads, N)
        ms_k, ms_p = _time_pair(lambda: la.linear_attention_qkv(qkv, heads, d, scale),
                                lambda: la.linear_attention_qkv_plain(qkv, heads, d, scale))
        n_bytes = B * N * (384 + 128) * qkv.element_size()  # read q, k, v once, write out once
        bound_ms, bound_by = _bound(n_bytes, 4 * B * heads * N * d * d)  # context + out products
        print(f"[kernel-time] B={B} N={N} {str(dtype)[6:]} nchw-view: kernel {ms_k:.4f} ms "
              f"({n_bytes / ms_k / 1e6:.0f} GB/s), plain {ms_p:.4f} ms, plain/kernel {ms_p / ms_k:.2f}x, "
              f"bound {bound_ms:.4f} ms ({bound_by}), share of bound {bound_ms / ms_k:.3f}")
        if bound_by != "bytes":
            raise AssertionError(f"B1 at B={B} N={N} {dtype} is bound by {bound_by}; the summary assumes bytes")
        return ms_k, ms_p, bound_ms

    # the serving path: bf16, per request 32 forecaster / 31 interpolator
    # forwards x 2 calls per level
    calls = {120: 64, 240: 62}
    total = [0.0, 0.0, 0.0]
    for B in (120, 240):
        for N in (3600, 900, 225):
            for i, t in enumerate(timed(B, N, torch.bfloat16)):
                total[i] += calls[B] * t
    n_calls = sum(calls.values()) * 3
    print(f"[kernel-time] per request ({n_calls} calls): kernel {total[0]:.2f} ms, plain {total[1]:.2f} ms, "
          f"bound {total[2]:.2f} ms (share {total[2] / total[0]:.3f})")
    result = {"max_abs_err": max_err, "serve": dict(zip(("ms", "plain_ms", "bound_ms"), (t / n_calls for t in total)))}
    # the train path: batch 64, f32 and bf16
    times = {(dt, N): timed(64, N, getattr(torch, dt)) for dt in ("float32", "bfloat16") for N in (3600, 900, 225)}
    result["train_step"], total, n_calls = {}, [0.0, 0.0, 0.0], 0
    for label, mix in TRAIN_CALLS.items():  # each variant runs the same number of steps
        step = [sum(n * times[(dt, N)][i] for dt, n in mix.items() for N in (3600, 900, 225)) for i in range(3)]
        result["train_step"][label] = step[0]
        n_calls += 3 * sum(mix.values())
        total = [a + b for a, b in zip(total, step)]
        print(f"[kernel-time] B1 forward per train step, {label} ({3 * sum(mix.values())} calls at B=64): "
              f"kernel {step[0]:.3f} ms, plain {step[1]:.3f} ms, bound {step[2]:.3f} ms (share {step[2] / step[0]:.3f})")
    result["train"] = dict(zip(("ms", "plain_ms", "bound_ms"), (t / n_calls for t in total)))
    return result


def phase_kernel_core():
    """B3, the linear-attention core on (BH, d, N) through B1's kernels as
    heads = 1, against its plain version at the shapes of B1's path (BH = B
    x 4), plus an odd N; its backward against the plain composition's; its
    splits and times. Returns the summary."""
    import torch

    from dyffusion_tpu_torch.ops import linear_attention as la

    d = 32
    scale = d**-0.5
    gen = torch.Generator(device="cuda").manual_seed(SEED + 1)
    path = ((480, 3600), (960, 900), (960, 225))

    def inputs(BH, N, dtype, strided):
        if strided:  # (BH, d, N) views of (BH, N, d) tensors: channels on the stride-1 axis
            return [torch.randn((BH, N, d), generator=gen, device="cuda").to(dtype).transpose(1, 2) for _ in range(3)]
        return [torch.randn((BH, d, N), generator=gen, device="cuda").to(dtype) for _ in range(3)]

    max_err = 0.0
    for BH, N in path + ((5, 7),):
        for dtype in (torch.bfloat16, torch.float32):
            for strided in (False, True):
                q, k, v = inputs(BH, N, dtype, strided)
                got = la.linear_attention_core(q, k, v, scale)
                _sync()
                want = la.linear_attention_core_plain(q, k, v, scale)
                dt = str(dtype)[6:]
                label = f"B3 BH={BH} N={N} {dt} {'strided' if strided else 'contiguous'}"
                e = _check_vs_plain(label, got, want, REL_TOL[dt], negative_controls=(BH, N) in path[:2] and not strided)
                max_err = max(max_err, e)
    # backward: the kernel's autograd against the plain composition's
    q, k, v = (t.requires_grad_(True) for t in inputs(960, 900, torch.float32, False))
    g = torch.randn(q.shape, generator=gen, device="cuda")
    torch.autograd.backward(la.linear_attention_core(q, k, v, scale), g)
    xs = [t.detach().clone().requires_grad_(True) for t in (q, k, v)]
    torch.autograd.backward(la.linear_attention_core_plain(*xs, scale), g)
    for name, a, b in zip("qkv", (q, k, v), xs):
        _check_vs_plain(f"B3 backward d{name} BH=960 N=900 float32", a.grad, b.grad, REL_TOL["float32"])
    total = {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0}
    for BH, N in path:
        q, k, v = inputs(BH, N, torch.bfloat16, False)
        _print_split(f"B3 BH={BH} N={N} bf16", q.transpose(1, 2), BH, N, k, v)
        ms_k, ms_p = _time_pair(lambda: la.linear_attention_core(q, k, v, scale),
                                lambda: la.linear_attention_core_plain(q, k, v, scale))
        n_bytes = 4 * BH * d * N * 2  # read q, k, v, write out, bf16
        bound_ms, bound_by = _bound(n_bytes, 4 * BH * N * d * d)
        print(f"[kernel-time] B3 BH={BH} N={N} bf16: kernel {ms_k:.4f} ms ({n_bytes / ms_k / 1e6:.0f} GB/s), "
              f"plain {ms_p:.4f} ms, plain/kernel {ms_p / ms_k:.2f}x, bound {bound_ms:.4f} ms ({bound_by}), "
              f"share of bound {bound_ms / ms_k:.3f}")
        for key, val in (("ms", ms_k), ("plain_ms", ms_p), ("bound_ms", bound_ms)):
            total[key] += val / len(path)
    return {"max_abs_err": max_err, **total, "bound_by": "bytes"}


ACT_PATH = ((120, 64, 60, 60), (120, 128, 30, 30), (120, 256, 15, 15))  # B2's path shapes
# the H100's L2 cache (50 MB): B2's timed inputs rotate over more than twice
# as many bytes, so that no call finds its input in L2
L2_BYTES = 50e6


def time_act(fa, gen, iters=200):
    """Time B2 (``fa``: a checkout's ``ops.fused_act`` module) and its plain
    version at the path shapes, bf16, NCHW and channels-last, each call on
    the next of enough copies of the input to exceed L2 twice over; 200
    calls a window (one call is ~0.01-0.05 ms). Prints a line per shape and
    layout; returns the means over the NCHW shapes."""
    import itertools
    import math

    import torch

    total = {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0}
    for shape in ACT_PATH:
        bias = torch.randn((shape[1],), generator=gen, device="cuda")
        x0 = torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16)
        n_bytes = 2 * x0.numel() * x0.element_size()  # read x, write out
        copies = max(2, math.ceil(2 * L2_BYTES / (n_bytes / 2)))
        for layout, fmt in (("nchw", torch.contiguous_format), ("channels-last", torch.channels_last)):
            xs = itertools.cycle([x0.clone(memory_format=fmt) for _ in range(copies)])
            ms_k, ms_p = _time_pair(lambda: fa.fused_leaky_relu(next(xs), bias),
                                    lambda: fa.fused_leaky_relu_plain(next(xs), bias), iters=iters)
            bound_ms, bound_by = _bound(n_bytes, 4 * x0.numel())
            print(f"[kernel-time] B2 {shape} bf16 {layout}: kernel {ms_k:.4f} ms ({n_bytes / ms_k / 1e6:.0f} GB/s), "
                  f"plain {ms_p:.4f} ms, plain/kernel {ms_p / ms_k:.2f}x, bound {bound_ms:.4f} ms ({bound_by}), "
                  f"share of bound {bound_ms / ms_k:.3f}; {copies} inputs in rotation")
            if layout == "nchw":
                for key, val in (("ms", ms_k), ("plain_ms", ms_p), ("bound_ms", bound_ms)):
                    total[key] += val / len(ACT_PATH)
    return total


def phase_kernel_act():
    """B2, fused bias + LeakyReLU * sqrt(2) over dim 1, against its plain
    version at the forecaster's activation shapes, an odd shape (numel not
    a multiple of the load width), a 1x1 one (channel stride 1 in NCHW too)
    and from a base one element off, NCHW and channels-last, with a bias and
    without; checks 16-byte loads at the path shapes; then its times.
    Returns the summary."""
    import torch

    from dyffusion_tpu_torch.ops import fused_act as fa

    gen = torch.Generator(device="cuda").manual_seed(SEED + 2)
    max_err = 0.0
    for shape in ACT_PATH + ((3, 5, 7, 3), (2, 3, 1, 1)):
        bias = torch.randn((shape[1],), generator=gen, device="cuda")
        for dtype in (torch.bfloat16, torch.float32):
            for strided in (False, True):
                fmt = torch.channels_last if strided else torch.contiguous_format
                x = torch.randn(shape, generator=gen, device="cuda").to(dtype).contiguous(memory_format=fmt)
                dt, layout = str(dtype)[6:], "channels-last" if strided else "nchw"
                width = fa.load_width(x, torch.empty_like(x)) * x.element_size()
                if shape in ACT_PATH:
                    print(f"[kernel-split] B2 {shape} {dt} {layout}: {width}-byte loads")
                    if width != 16:
                        raise AssertionError(f"B2 at {shape} {dt} {layout} loads {width} bytes, not 16")
                for label, xin, b in (("", x, bias), (" no bias", x, None)) + (
                        ((" base one element off", _off_by_one(x), bias),) if shape == ACT_PATH[0] else ()):
                    got = fa.fused_leaky_relu(xin, b)
                    _sync()
                    want = fa.fused_leaky_relu_plain(xin, b)
                    e = _check_vs_plain(f"B2 {shape} {dt} {layout}{label}", got, want, REL_TOL[dt],
                                        negative_controls=shape == ACT_PATH[0] and not strided and not label)
                    max_err = max(max_err, e)
    return {"max_abs_err": max_err, **time_act(fa, gen), "bound_by": "bytes"}


def _off_by_one(x):
    """A copy of ``x`` with its strides whose base pointer is one element
    past an allocation's start."""
    import torch

    buf = torch.empty(x.numel() + 1, dtype=x.dtype, device=x.device)[1:]
    return buf.as_strided(x.shape, x.stride()).copy_(x)


def phase_op_path():
    """B2 and B3 through their public ops at their path shapes, as a user
    calls them (B3 forward and backward); returns their launch counts."""
    import torch

    from dyffusion_tpu_torch.ops import fused_act as fa
    from dyffusion_tpu_torch.ops import linear_attention as la

    gen = torch.Generator(device="cuda").manual_seed(SEED + 3)
    fa.reset_launches()
    la.reset_launches()
    for shape in ACT_PATH:
        x = torch.randn(shape, generator=gen, device="cuda").bfloat16().requires_grad_(True)
        bias = torch.zeros(shape[1], device="cuda", requires_grad=True)
        out = fa.fused_leaky_relu(x, bias)
        out.float().sum().backward()
        assert torch.isfinite(out).all() and bias.grad is not None and x.grad.shape == x.shape
    for BH, N in ((480, 3600), (960, 900), (960, 225)):
        q, k, v = (torch.randn((BH, 32, N), generator=gen, device="cuda").bfloat16().requires_grad_(True)
                   for _ in range(3))
        out = la.linear_attention_core(q, k, v, 32**-0.5)
        out.float().sum().backward()
        assert torch.isfinite(out).all() and q.grad.shape == q.shape
    _sync()
    counts = {"fused_leaky_relu": fa.launches, "linear_attention_core": la.core_launches}
    print(f"[op-path] launches: {counts} (B1 {la.launches})")
    if counts != {"fused_leaky_relu": 3, "linear_attention_core": 3}:
        raise AssertionError(f"the op path did not launch each kernel once per call: {counts}")
    return counts


def _build_slice(extra, device):
    """Stage-1 interpolator and stage-2 experiment (seeded random weights)
    through the port's config and interface, as a user builds them."""
    from dyffusion_tpu_torch.config import get_config
    from dyffusion_tpu_torch.interface import build_experiment, get_datamodule

    c1, c2 = get_config("synthetic_interpolation", extra), get_config("synthetic_dyffusion", extra)
    dm = get_datamodule(c1)
    dm.setup()
    _, interpolator, _, _, _ = build_experiment(c1, dm, device=device)
    exp, _, _, eval_fns, _ = build_experiment(c2, dm, interpolator=interpolator, device=device)
    return exp, eval_fns, dm


def phase_reference():
    """Small slice, dropout off, f32: GPU (kernels) vs CPU (plain versions).

    The linear attention's output is small (v is divided by N), so it moves
    the prediction little: dropping it altogether moves this slice by about
    2.4e-4 of its largest value. The tolerance, 1e-4 of the largest value,
    lies below that and above f32 convs and sums taken in another order over
    7 sampler steps; the negative control shows the drop is caught. Smaller
    kernel errors are phase 3's to catch."""
    from dyffusion_tpu_torch.ops import linear_attention as la
    from dyffusion_tpu_torch.serving import build_experiment_predict_fn

    extra = [
        "datamodule.spatial=(24,24)", "datamodule.channels=1", "datamodule.horizon=3",
        "datamodule.n_traj=5", "datamodule.n_time=8", "datamodule.eval_batch_size=2",
        "model.dim=16", "model.dim_mults=(1,2)", "module.num_predictions=2",
        "diffusion.additional_interpolation_steps=2",
    ]
    outs = {}
    for device in ("cpu", "cuda"):
        exp, eval_fns, dm = _build_slice(extra, device)
        predict, _, _ = build_experiment_predict_fn(exp, eval_fns, dm, None)
        batch = next(dm.predict_batches())
        outs[device] = predict(batch, SEED).cpu()
        if device == "cpu":  # negative control: every linear attention dropped
            plain = la.linear_attention_qkv_plain
            la.linear_attention_qkv_plain = lambda *a: plain(*a) * 0
            try:
                outs["dropped"] = predict(batch, SEED)
            finally:
                la.linear_attention_qkv_plain = plain
    r = 1e-4
    ok, err, limit = _within(outs["cuda"], outs["cpu"], r)
    ok_dropped, err_dropped, _ = _within(outs["dropped"], outs["cpu"], r)
    print(f"[reference] small slice f32, GPU vs CPU: max_abs_err={err:.3e} (max |pred| {limit / r:.3f}, "
          f"limit {limit:.3e}); attention dropped on the CPU: {err_dropped:.3e}")
    if not ok:
        raise AssertionError(f"GPU slice disagrees with the CPU plain path: {err} > {limit}")
    if ok_dropped:
        raise AssertionError("the reference check accepts a slice without its linear attention")


def _grads_within(got, want, r):
    """(ok, worst error over its limit): every gradient within ``r`` of the
    larger of its own largest |value| and 0.1 of the model's largest (some
    gradients vanish mathematically, a conv bias feeding a GroupNorm, and
    are float noise)."""
    import torch

    top = max(float(w.abs().max()) for w in want.values())
    worst = 0.0
    for k, w in want.items():
        if not bool(torch.isfinite(got[k]).all()):
            return False, float("inf")
        limit = r * max(float(w.abs().max()), 0.1 * top)
        worst = max(worst, float((got[k] - w).abs().max()) / limit)
    return worst <= 1.0, worst


def phase_train_reference():
    """One stage-2 loss, f32, dropout off, fixed t over every branch (t = 0,
    the middle, N-1), l2 > 0: loss and every forecaster gradient on the GPU
    (B1 kernel forward) against the CPU (plain versions). Tolerance 1e-3 of
    each gradient's scale: both sides f32 with TF32 off, sums and convs in
    another order. The negative control cuts the gradient through the
    interpolator's second call (a no_grad there), which drops half of the
    l2 term's gradient: the check must reject it."""
    import numpy as np
    import torch

    from dyffusion_tpu_torch.config import get_config
    from dyffusion_tpu_torch.experiments import stack_window
    from dyffusion_tpu_torch.interface import build_experiment, get_datamodule
    from dyffusion_tpu_torch.ops import linear_attention as la

    extra = [
        "datamodule.spatial=(24,24)", "datamodule.channels=1", "datamodule.horizon=3",
        "datamodule.n_traj=5", "datamodule.n_time=8", "datamodule.batch_size=4",
        "model.dim=16", "model.dim_mults=(1,2)", "diffusion.additional_interpolation_steps=2",
    ]
    c1, c2 = get_config("synthetic_interpolation", extra), get_config("synthetic_dyffusion", extra)
    dm = get_datamodule(c1)
    dm.setup()
    batch = next(dm.train_batches(rng=np.random.default_rng(SEED)))
    results = {}
    for device, cut in (("cpu", False), ("cuda", False), ("cuda", True)):
        _, ip, _, _, _ = build_experiment(c1, dm, device=device)
        exp, fc, _, _, engine = build_experiment(c2, dm, interpolator=ip, device=device)
        dyn = exp.to_device(batch["dynamics"])
        n = engine.num_timesteps
        t = torch.tensor([0, 1, n // 2, n - 1], device=device)
        if cut:
            q_sample, calls = engine.q_sample, []

            def q_sample_second_without_grad(*a, **kw):
                calls.append(None)
                if len(calls) % 2 == 0:
                    with torch.no_grad():
                        return q_sample(*a, **kw)
                return q_sample(*a, **kw)

            engine.q_sample = q_sample_second_without_grad
        la.reset_launches()
        loss, aux = engine.p_losses(None, None, None, dyn[:, -1].permute(0, 3, 1, 2), stack_window(dyn, 1), t)
        loss.backward()
        assert float(aux["loss_forward2"].detach()) > 0, "the l2 term is off"
        results[(device, cut)] = (float(loss.detach()), {k: v.grad.cpu() for k, v in fc.named_parameters()}, la.launches)
    (l_cpu, g_cpu, _), (l_gpu, g_gpu, n_b1), (_, g_cut, _) = (
        results[("cpu", False)], results[("cuda", False)], results[("cuda", True)])
    r = 1e-3
    ok, worst = _grads_within(g_gpu, g_cpu, r)
    ok_cut, worst_cut = _grads_within(g_cut, g_cpu, r)
    print(f"[train-ref] stage-2 loss f32: GPU {l_gpu:.7f} vs CPU {l_cpu:.7f} (rel {abs(l_gpu - l_cpu) / abs(l_cpu):.2e}); "
          f"{len(g_cpu)} gradients: worst error {worst * r:.2e} of its scale (limit {r}); "
          f"second interpolator call cut: {worst_cut * r:.2e}; B1 launches {n_b1}")
    if abs(l_gpu - l_cpu) > 1e-4 * abs(l_cpu) or not ok:
        raise AssertionError("the GPU train step disagrees with the CPU plain path")
    if ok_cut:
        raise AssertionError("the gradient check accepts a loss that skips the interpolator's second call")
    if n_b1 == 0:
        raise AssertionError("the GPU loss did not run the B1 kernel")


def phase_train(card, b1_step_ms):
    """SST-width train steps at batch 64 (the reference SST train batch) on
    one fixed batch of synthetic train data, through interface.build_trainer:
    stage 1 f32; stage 2 (the stage-1 model as its interpolator) f32, bf16
    mixed precision, f32 with remat. The B1 launch count is set to 0 before
    each variant and must read its launches per step times its steps.
    ``b1_step_ms``: phase 3's B1 forward time per step of each variant.
    Returns the B1 launches of the four variants."""
    import numpy as np
    import torch

    from dyffusion_tpu_torch.config import get_config
    from dyffusion_tpu_torch.interface import build_trainer, get_datamodule
    from dyffusion_tpu_torch.models.modules import LinearAttention
    from dyffusion_tpu_torch.ops import linear_attention as la
    from dyffusion_tpu_torch.utils.workloads import sst_overrides, time_train_steps

    batch_size, n_timed, n_more = 64, 20, 9
    n_steps = 1 + n_timed + n_more
    extra = sst_overrides(["datamodule.n_traj=5", "datamodule.n_time=13", f"datamodule.batch_size={batch_size}"])
    c1 = get_config("synthetic_interpolation", extra)
    dm = get_datamodule(c1)
    dm.setup()
    tensors = dm.split("train").tensors
    idx = np.arange(batch_size) % len(dm.split("train"))  # one batch of train rows, as bench.py indexes it
    batch = {k: v[idx] for k, v in tensors.items()}
    variants = (
        ("stage 1, f32", "synthetic_interpolation", []),
        ("stage 2, f32", "synthetic_dyffusion", []),
        ("stage 2, bf16 train_dtype", "synthetic_dyffusion", ["module.train_dtype=bfloat16"]),
        ("stage 2, f32, remat", "synthetic_dyffusion", ["model.remat=true"]),
    )
    interpolator, launches = None, 0
    for label, preset, more in variants:
        trainer = build_trainer(get_config(preset, extra + more), dm, interpolator=interpolator)
        model = trainer.experiment.model
        n_attn = sum(isinstance(m, LinearAttention) for m in model.modules())
        # B1 per step: one Unet forward in stage 1; two forecaster and two
        # interpolator forwards in stage 2; remat recomputes the two
        # forecaster forwards in the backward
        expected = n_attn if preset.endswith("interpolation") else n_attn * (4 + 2 * model.remat)
        if expected != 3 * sum(TRAIN_CALLS[label].values()):
            raise AssertionError(f"{label}: {expected} B1 launches per step, but phase 3 timed the mix {TRAIN_CALLS[label]}")
        b = trainer._put(batch)
        losses = []

        def step(state, batch_):  # the train step, keeping every loss (on the device)
            metrics = trainer.train_step(state, batch_)
            losses.append(metrics["loss"])
            return metrics

        torch.cuda.reset_peak_memory_stats()
        la.reset_launches()
        dt = time_train_steps(step, trainer.state, b, n_timed)  # one warm-up step, then n_timed
        per_step = la.launches / (n_timed + 1)
        for _ in range(n_more):
            step(trainer.state, b)
        _sync()
        count = la.launches
        launches += count
        peak = torch.cuda.max_memory_allocated()
        vals = np.asarray([float(v) for v in losses])
        first, last = float(vals[:5].mean()), float(vals[-5:].mean())
        print(f"[train] {label}: {1 / dt:.3f} steps/s, {batch_size / dt:.1f} examples/s "
              f"({dt * 1e3:.1f} ms per step, mean of {n_timed} after a warm-up), peak memory {peak / 2**30:.2f} GiB, "
              f"B1 launches per step {per_step:g} (expected {expected}), {count} in {n_steps} steps; B1 forward "
              f"{b1_step_ms[label]:.2f} ms of the step ({b1_step_ms[label] / (dt * 1e3):.3f}); loss mean of the first "
              f"5 steps {first:.5f}, of the last 5 {last:.5f}; on {card}")
        if not np.isfinite(vals).all():
            raise AssertionError(f"{label}: non-finite losses {vals}")
        if not last < first:
            raise AssertionError(f"{label}: {len(vals)} steps on one batch did not lower the loss ({first} -> {last})")
        if per_step != expected or count != expected * n_steps:
            raise AssertionError(f"{label}: B1 launches per step {per_step}, {count} in all; expected {expected} per step")
        if interpolator is None:
            interpolator = model  # the stage-1 model is stage 2's frozen interpolator
    return launches


def phase_fit(card):
    """interface.run_experiment at a small size, stage 1 then stage 2 with
    the trained stage-1 model in memory. The B1 launch count is set to 0
    before each stage and must read what its steps and validations imply.
    Returns the B1 launches of both stages."""
    import numpy as np

    from dyffusion_tpu_torch.config import get_config
    from dyffusion_tpu_torch.interface import run_experiment
    from dyffusion_tpu_torch.models.modules import LinearAttention
    from dyffusion_tpu_torch.ops import linear_attention as la

    extra = [
        "datamodule.spatial=(24,24)", "datamodule.channels=1", "datamodule.horizon=3",
        "datamodule.n_traj=6", "datamodule.n_time=12", "datamodule.batch_size=4",
        "datamodule.eval_batch_size=4", "model.dim=16", "model.dim_mults=(1,2)",
        "module.num_predictions=3", "diffusion.additional_interpolation_steps=2", "trainer.max_epochs=2",
    ]

    def expected(trainer):
        """B1 launches of a fit: n_attn per Unet forward; a train step runs one
        forward (stage 1) or four (stage 2); a validation batch runs one
        forward per interpolated i (stage 1), or the sampler's forecaster and
        interpolator forward per step plus the peeled last forecaster forward
        (stage 2)."""
        exp = trainer.experiment
        n_attn = sum(isinstance(m, LinearAttention) for m in exp.model.modules())
        n_val = sum(1 for h in trainer.history if "val/crps" in h) * len(list(trainer.datamodule.val_batches()))
        if getattr(exp, "engine", None) is None:
            return n_attn * (trainer.state.step + n_val * len(exp.horizon_range))
        return n_attn * (4 * trainer.state.step + n_val * (2 * len(exp.engine._steps.s) + 1))

    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_fit_") as registry:
        extra.append(f"registry_dir={registry}")
        la.reset_launches()
        tr1, best1 = run_experiment(get_config("synthetic_interpolation", extra))
        _sync()
        n1 = la.launches
        la.reset_launches()
        tr2, best2 = run_experiment(get_config("synthetic_dyffusion", extra), interpolator=tr1.experiment.model)
        _sync()
        n2 = la.launches
    print(f"[fit] stage 1: best val/crps {best1:.5f} after {tr1.state.step} steps, B1 launches {n1} "
          f"(expected {expected(tr1)}); stage 2: best val/crps {best2:.5f} after {tr2.state.step} steps, B1 launches "
          f"{n2} (expected {expected(tr2)}); {time.perf_counter() - t0:.1f} s; on {card}")
    if not (np.isfinite(best1) and np.isfinite(best2)):
        raise AssertionError(f"run_experiment returned a non-finite best val/crps: {best1}, {best2}")
    if (n1, n2) != (expected(tr1), expected(tr2)):
        raise AssertionError(f"[fit] B1 launches {(n1, n2)} != {(expected(tr1), expected(tr2))}")
    return n1 + n2


def phase_cli(card):
    """The CLI at SST width, as a user runs it, in a temporary registry, in
    this process through ``train.main`` (so the built kernels are reused):
    stage 1 for 4 steps; stage 2 from the registry by
    ``diffusion.interpolator_run_id`` for 4 steps; the same stage-2 command
    with ``trainer.max_steps=8``, which must resume (its first logged step
    is 5, ``meta.json`` reads ``last_step`` 8); ``mode=test`` with 50
    members (finite ``test/crps``, curves written); then
    ``serving.build_predict_fn(registry, run id)`` on one batch: the same
    seed answers the same, the answer is the reloaded run's EMA-weights
    eval, and (negative control) its live weights' eval differs. Both stages
    train at batch 64 with the EMA on. The splits share one trajectory
    length, so the 3 train trajectories' 72 rows (one batch per epoch) give
    the val and test trajectories 24 rows each: 4 eval batches of 6 per
    split, the path's eval shapes (120/240 rows at 20 members, 300/600 at
    50). Validation runs once per command (at its last step). The B1 launch
    count is set to 0 before each step and must read what the step's
    forwards imply. Returns the B1 launches of all steps."""
    import numpy as np
    import torch

    from dyffusion_tpu_torch import train
    from dyffusion_tpu_torch.config import get_config
    from dyffusion_tpu_torch.interface import reload_trainer
    from dyffusion_tpu_torch.models.modules import LinearAttention
    from dyffusion_tpu_torch.ops import linear_attention as la
    from dyffusion_tpu_torch.serving import build_predict_fn
    from dyffusion_tpu_torch.utils import registry_api
    from dyffusion_tpu_torch.utils.naming import get_run_id
    from dyffusion_tpu_torch.utils.workloads import SST_FAST_EVAL, sst_overrides

    with tempfile.TemporaryDirectory(prefix="chip_smoke_registry_") as reg:
        common = sst_overrides([
            "datamodule.n_traj=5", "datamodule.n_time=31", "datamodule.batch_size=64",
            "datamodule.eval_batch_size=6", *SST_FAST_EVAL, "module.num_predictions_test=50", "module.use_ema=true",
            "trainer.val_every_n_epochs=100", "trainer.log_every_n_steps=1", f"registry_dir={reg}",
        ])
        id1 = get_run_id(get_config("synthetic_interpolation", common))
        stage2 = [f"diffusion.interpolator_run_id={id1}", *common]
        id2 = get_run_id(get_config("synthetic_dyffusion", stage2))
        steps = {}  # name -> (B1 launches, seconds)

        def step(name, fn):
            la.reset_launches()
            t = time.perf_counter()
            out = fn()
            _sync()
            steps[name] = (la.launches, time.perf_counter() - t)
            print(f"[cli] {name}: {steps[name][1]:.1f} s, B1 launches {steps[name][0]}")
            return out

        def train_steps():
            return [r["step"] for r in registry_api.get_run_metrics(reg, id2) if "train/loss" in r]

        best1 = step("stage 1, 4 steps", lambda: train.main(
            ["experiment=synthetic_interpolation", *common, "trainer.max_steps=4"]))
        best2 = step("stage 2 from the registry, 4 steps", lambda: train.main(
            ["experiment=synthetic_dyffusion", *stage2, "trainer.max_steps=4"]))
        steps_before = train_steps()
        best3 = step("stage 2 resumed to 8 steps", lambda: train.main(
            ["experiment=synthetic_dyffusion", *stage2, "trainer.max_steps=8"]))
        resumed_steps = train_steps()[len(steps_before):]
        meta = registry_api.get_run_meta(reg, id2)
        crps = step("mode=test, 50 members", lambda: train.main(["mode=test", f"run_id={id2}", f"registry_dir={reg}"]))
        curves = sorted(os.listdir(os.path.join(reg, id2, "curves")))

        def serve():
            predict, _, info = build_predict_fn(reg, id2)
            trainer = reload_trainer(reg, id2)
            batch = next(trainer.datamodule.predict_batches())
            a, b = predict(batch, SEED), predict(batch, SEED)

            def members(params):
                out = trainer.eval_fns["predict"](batch, torch.Generator(device=trainer.device).manual_seed(SEED), params)
                return torch.stack([out[k] for k in sorted(out, key=lambda k: (len(k), k)) if k.endswith("_preds")], 2)

            return info, trainer, a, b, members(trainer.state.eval_params()), members(None)

        info, trainer, a, b, ema, live = step("serving by run id, 2 requests + EMA and live evals", serve)

    exp = trainer.experiment
    n_attn = sum(isinstance(m, LinearAttention) for m in exp.model.modules())
    per_sample = n_attn * (2 * len(exp.engine._steps.s) + 1)  # one ensemble sampler call
    n_eval = 4  # eval batches per split
    h = exp.cfg.horizon
    expected = {
        "stage 1, 4 steps": n_attn * (4 + n_eval * (h - 1)),  # one Unet forward per step; one per i per val batch
        "stage 2 from the registry, 4 steps": 4 * 4 * n_attn + n_eval * per_sample,  # 4 forwards per step
        "stage 2 resumed to 8 steps": 4 * 4 * n_attn + n_eval * per_sample,
        "mode=test, 50 members": n_eval * per_sample,
        "serving by run id, 2 requests + EMA and live evals": 4 * per_sample,
    }
    repeat, vs_ema = float((a - b).abs().max()), float((a - ema).abs().max())
    vs_live = float((a - live).abs().max())
    print(f"[cli] best val/crps: stage 1 {best1:.5f}, stage 2 {best2:.5f}, resumed {best3:.5f}; test/crps (50 members) "
          f"{crps:.5f}; steps logged after the restart {resumed_steps}, meta last_step {meta.get('last_step')}; "
          f"curves {curves}")
    print(f"[cli] served {tuple(a.shape)} ({info['ensemble_members']} members, slot {info['slot']}): same seed max "
          f"diff {repeat:.3e}; vs the EMA eval {vs_ema:.3e}; vs the live weights' eval {vs_live:.3e} (must differ); "
          f"EMA updates {trainer.state.ema_num_updates}; on {card}")
    if not all(np.isfinite(x) for x in (best1, best2, best3, crps)):
        raise AssertionError(f"[cli] a non-finite score: {best1}, {best2}, {best3}, {crps}")
    if resumed_steps != [5, 6, 7, 8] or meta.get("last_step") != 8:
        raise AssertionError(f"[cli] stage 2 did not resume from step 4 to 8: {resumed_steps}, meta {meta}")
    if not {"test_crps.npz", "test_crps.json"} <= set(curves):
        raise AssertionError(f"[cli] mode=test wrote no CRPS curve: {curves}")
    if not bool(torch.isfinite(a).all()) or repeat != 0 or vs_ema != 0:
        raise AssertionError("[cli] the served forecast is not the EMA weights' eval, or a seed did not repeat")
    if not vs_live > 1e-3 * float(a.abs().max()):
        raise AssertionError("[cli] the live weights give the served forecast: the EMA is not what is served")
    counts = {name: n for name, (n, _) in steps.items()}
    if counts != expected:
        raise AssertionError(f"[cli] B1 launches {counts} != {expected}")
    return sum(counts.values())


# the physical-systems paths at their canonical widths (utils/workloads.py:
# NS_CORE, SPRING_CORE), through their presets on fake archives at the real
# grids. One trajectory per split: the test trajectory spans the prediction
# horizon (NS 64 = 4 windows of 16, spring 804 = 6 windows of 134), and the
# shared trajectory length gives train and val 49 (NS) or 671 (spring) rows.
# NS evaluates in bf16 (module.eval_dtype), spring in f32.
PHYSICAL = {
    "navier_stokes": {"label": "ns", "system": "navier-stokes", "n_time": 65, "steps": 12,
                      "extra": ["module.eval_dtype=bfloat16"]},
    "spring_mesh": {"label": "spring", "system": "spring-mesh", "n_time": 805, "steps": 8,
                    "extra": ["model.dropout=0.2"]},
}


def _physical_archive(root, key, n_time=None):
    from dyffusion_tpu_torch.data import write_fake_benchmark_dir

    spec = PHYSICAL[key]
    return write_fake_benchmark_dir(root, spec["system"], n_traj={"train": 1, "val": 1, "test": 1},
                                    n_time=n_time or spec["n_time"], seed=SEED)


def _running_stats(model):
    return {k: v.clone() for k, v in model.state_dict().items() if "running" in k}


def _boundary_error(key, frames, batch, time):
    """Largest deviation of frames (N, B, H, W, C) from the boundary
    conditions at simulation time ``time`` (B,): NS fixed cells 0 and the
    inflow in row 0 of channel 0, spring pinned nodes at (p=0, q=base_q)."""
    import numpy as np

    fixed = batch["metadata_fixed_mask"]
    if key == "spring_mesh":
        pinned = np.concatenate([np.zeros_like(batch["metadata_base_q"]), batch["metadata_base_q"]], -1)
        return float(np.abs(np.where(fixed, frames - pinned, 0.0)).max())
    v, vy = batch["metadata_in_velocity"], batch["metadata_vertex_y"]
    inflow = v[:, None] * 4 * vy * (0.41 - vy) / 0.41**2 * (1 - np.exp(-5 * time))[:, None]
    inflow_cells = np.zeros(fixed.shape[1:], bool)
    inflow_cells[0, :, 0] = True
    return max(float(np.abs(np.where(fixed & ~inflow_cells, frames, 0.0)).max()),
               float(np.abs(frames[..., 0, :, 0] - inflow).max()))


def phase_physical(card, key):
    """The NS or spring path through the CLI (``train.main``) as a user runs
    it, at the canonical width, in a temporary registry: stage 1 for a few
    steps and one validation; stage 2 from the registry by run id for a few
    steps and one validation; ``mode=test`` over the full test trajectory
    through the autoregressive chain with 20 members; serving by run id.
    Checks: finite losses that fall; running statistics moved by training
    and left as they are by evaluation and serving; the boundary conditions
    in every served frame of every window (the sampler's output without the
    hook fails the same check); a seed repeats its answer, another does not.
    Prints each command's wall time and peak memory, and the request time.
    The launch counts are set to 0 before the path and read after it: no
    kernel of the port lies on these paths. Returns them."""
    import numpy as np
    import torch

    from dyffusion_tpu_torch import train
    from dyffusion_tpu_torch.config import get_config
    from dyffusion_tpu_torch.interface import reload_trainer
    from dyffusion_tpu_torch.ops import fused_act as fa
    from dyffusion_tpu_torch.ops import linear_attention as la
    from dyffusion_tpu_torch.serving import build_predict_fn
    from dyffusion_tpu_torch.training.checkpoint import CheckpointManager
    from dyffusion_tpu_torch.utils import registry_api
    from dyffusion_tpu_torch.utils.naming import get_run_id

    spec = PHYSICAL[key]
    tag = f"[{spec['label']}]"
    la.reset_launches()
    fa.reset_launches()
    with tempfile.TemporaryDirectory(prefix=f"chip_smoke_{spec['label']}_") as tmp:
        data = _physical_archive(os.path.join(tmp, "data"), key)
        reg = os.path.join(tmp, "runs")
        common = [f"datamodule.data_dir={data}", f"registry_dir={reg}", "module.num_predictions_test=20",
                  f"trainer.max_steps={spec['steps']}", "trainer.val_every_n_epochs=100",
                  "trainer.log_every_n_steps=1", *spec["extra"]]
        id1 = get_run_id(get_config(f"{key}_interpolation", common))
        stage2 = [f"diffusion.interpolator_run_id={id1}", *common]
        id2 = get_run_id(get_config(f"{key}_dyffusion", stage2))

        def command(name, fn):
            torch.cuda.reset_peak_memory_stats()
            _sync()
            t = time.perf_counter()
            out = fn()
            _sync()
            print(f"{tag} {name}: {time.perf_counter() - t:.1f} s wall, peak memory "
                  f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; on {card}")
            return out

        def losses(run_id):
            vals = [r["train/loss"] for r in registry_api.get_run_metrics(reg, run_id) if "train/loss" in r]
            vals = np.asarray(vals)
            half = len(vals) // 2
            print(f"{tag} {run_id}: {len(vals)} train losses {np.round(vals, 5).tolist()}")
            if len(vals) != spec["steps"] or not np.isfinite(vals).all() or not vals[half:].mean() < vals[:half].mean():
                raise AssertionError(f"{tag} losses not finite or not falling: {vals}")

        best1 = command(f"stage 1, {spec['steps']} steps + validation", lambda: train.main(
            [f"experiment={key}_interpolation", *common]))
        losses(id1)
        best2 = command(f"stage 2 from the registry, {spec['steps']} steps + validation", lambda: train.main(
            [f"experiment={key}_dyffusion", *stage2]))
        losses(id2)
        for run_id in (id1, id2):  # fresh BatchNorm: mean 0, var 1
            saved = CheckpointManager(os.path.join(reg, run_id), "val/crps").restore("last")["model"]
            moved = [k for k, v in saved.items() if "running_mean" in k and float(v.abs().max()) > 0]
            if not moved:
                raise AssertionError(f"{tag} training left the running statistics of {run_id} at their init")
        crps = command("mode=test, 20 members, one full trajectory", lambda: train.main(
            ["mode=test", f"run_id={id2}", f"registry_dir={reg}"]))

        def serve():
            trainer = reload_trainer(reg, id2)
            nets = (trainer.experiment.model, trainer.experiment.engine.interpolator)
            before = [_running_stats(m) for m in nets]
            test_metrics = trainer.evaluate("test")
            predict, _, info = build_predict_fn(reg, id2)
            batch = next(trainer.datamodule.predict_batches())
            answers, times = [], []
            for seed in (SEED, SEED, SEED + 1):
                _sync()
                t = time.perf_counter()
                answers.append(predict(batch, seed))
                _sync()
                times.append(time.perf_counter() - t)
            after = [_running_stats(m) for m in nets]
            trainer.experiment.boundary_fn = None  # negative control: the sampler's output as it comes
            raw = trainer.eval_fns["predict"](batch, torch.Generator(device=trainer.device).manual_seed(SEED),
                                              trainer.state.eval_params())
            return trainer, before, after, test_metrics, info, batch, answers, times, raw

        trainer, before, after, test_metrics, info, batch, (a, b, other), times, raw = command(
            "serving by run id: test eval + 3 requests + the raw sampler", serve)
    counts = {"linear_attention_qkv": la.launches, "linear_attention_core": la.core_launches,
              "fused_leaky_relu": fa.launches}
    n_frames = a.shape[2]
    errs = [_boundary_error(key, a[:, :, i - 1].cpu().numpy(), batch, batch["metadata_t0"] + batch["metadata_dt"] * i)
            for i in range(1, n_frames + 1)]
    raw_err = _boundary_error(key, raw[f"t{n_frames}_preds"].cpu().numpy(), batch,
                              batch["metadata_t0"] + batch["metadata_dt"] * n_frames)
    repeat, apart = float((a - b).abs().max()), float((a - other).abs().max())
    unchanged = all(torch.equal(v, was[k]) for now, was in zip(after, before) for k, v in now.items())
    windows = n_frames // trainer.experiment.cfg.horizon
    print(f"{tag} best val/crps: stage 1 {best1:.5f}, stage 2 {best2:.5f}; test/crps {crps:.5f} (reloaded: "
          f"{test_metrics['test/crps']:.5f}); served {tuple(a.shape)} ({info['ensemble_members']} members, "
          f"{windows} windows of {trainer.experiment.cfg.horizon}); request times {[round(x, 3) for x in times]} s; "
          f"on {card}")
    print(f"{tag} boundary conditions: worst error over {n_frames} served frames {max(errs):.3e}; the sampler "
          f"without the hook: {raw_err:.3e}; same seed max diff {repeat:.3e}, other seed {apart:.3e}; running "
          f"statistics unchanged by evaluation and serving: {unchanged}; kernel launches on this path {counts}; "
          f"on {card}")
    if not all(np.isfinite(x) for x in (best1, best2, crps)) or not bool(torch.isfinite(a).all()):
        raise AssertionError(f"{tag} a non-finite score or forecast: {best1}, {best2}, {crps}")
    if max(errs) > 1e-5 or raw_err <= 1e-3:
        raise AssertionError(f"{tag} the boundary conditions do not hold (or the check cannot fail): {errs}, {raw_err}")
    if repeat != 0 or not apart > 1e-3 * float(a.abs().max()):
        raise AssertionError(f"{tag} a seed did not repeat ({repeat}) or another seed gave the same forecast ({apart})")
    if not unchanged:
        raise AssertionError(f"{tag} evaluation or serving changed the running statistics")
    if any(counts.values()):
        raise AssertionError(f"{tag} a kernel launched on a path without linear attention or B2: {counts}")
    return counts


def _randomize_running_stats(net, gen):
    """Random running statistics (mean ~ 0.3 N(0, 1), var ~ U(0.5, 1.5))
    drawn from ``gen`` (a CPU generator), so that eval-mode BatchNorm is not
    the identity."""
    import torch

    with torch.no_grad():
        for name, buf in net.named_buffers():
            if "running_mean" in name:
                buf.copy_(0.3 * torch.randn(buf.shape, generator=gen))
            elif "running_var" in name:
                buf.copy_(0.5 + torch.rand(buf.shape, generator=gen))


def _physical_reference_run(c1, c2, dm, batch, device, control, dtype=None):
    """(eval forward, loss, forecaster gradients, running-statistics
    updates) of the small physical slice on ``device`` (in ``dtype``, f32 by
    default); ``control`` names a negative control or is None."""
    import torch

    from dyffusion_tpu_torch.diffusion import dyffusion as dyff
    from dyffusion_tpu_torch.experiments import stack_window
    from dyffusion_tpu_torch.interface import build_experiment
    from dyffusion_tpu_torch.models.base import MODEL_STATE_UPDATES, apply_model

    gen = torch.Generator().manual_seed(SEED + 5)  # the same statistics on every device
    _, ip, _, _, _ = build_experiment(c1, dm, device=device)
    _randomize_running_stats(ip, gen)
    exp, fc, _, _, engine = build_experiment(c2, dm, interpolator=ip, device=device)
    _randomize_running_stats(fc, gen)
    if control == "fresh statistics":
        for m in fc.modules():
            if hasattr(m, "reset_running_stats"):
                m.reset_running_stats()
    dtype = dtype or torch.float32
    engine.forecaster.to(dtype)
    engine.interpolator.to(dtype)
    dyn = exp.to_device(batch["dynamics"]).to(dtype)
    x0, static = stack_window(dyn, 1), exp.static_condition(batch).to(dtype)
    ones = torch.ones((dyn.shape[0],), device=dyn.device)
    with torch.no_grad():
        fcond = engine._forecaster_condition(x0, ones, static, None)
        fwd = apply_model(fc, None, dyn[:, 1].permute(0, 3, 1, 2), ones, fcond)
    n = engine.num_timesteps
    t = torch.tensor(([0, 1, n // 2, n - 1] * dyn.shape[0])[: dyn.shape[0]], device=dyn.device)
    train_apply = dyff.apply_model_train
    if control == "eval first pass":
        dyff.apply_model_train = lambda m, p, *a: (apply_model(m, p, *a), {})
    try:
        loss, aux = engine.p_losses(None, None, None, dyn[:, -1].permute(0, 3, 1, 2), x0, t, static)
    finally:
        dyff.apply_model_train = train_apply
    loss.backward()
    return (fwd.cpu().float(), float(loss.detach()), {k: p.grad.cpu().float() for k, p in fc.named_parameters()},
            {k: v.cpu() for k, v in aux.get(MODEL_STATE_UPDATES, {}).items()})


def _worst_grad(got, want):
    """(largest error over its scale, its name): each gradient's scale is
    the larger of its own largest |value| and 0.1 of the model's largest
    (as in :func:`_grads_within`)."""
    top = max(float(w.abs().max()) for w in want.values())
    return max((float((got[k] - w).abs().max()) / max(float(w.abs().max()), 0.1 * top), k) for k, w in want.items())


def phase_physical_reference():
    """For each backbone, small and f32 with dropout off, GPU against CPU
    from the same seeded weights and random running statistics: the
    forecaster's eval forward (tolerance 1e-4 of max|CPU|), and a stage-2
    ``p_losses`` over 8 rows at fixed t over every branch (t = 0, 1, the
    middle, N-1) with the running-statistics updates (1e-4) and every
    forecaster gradient. Negative controls: the forward with the running
    statistics reset, and the loss, gradients and updates with the
    forecaster's first pass on its running averages (eval mode), must each
    fail their check.

    UNetSimple's gradients are ill-conditioned in f32 (its DCGAN-initialized
    features are tiny and BatchNorm divides by their spread): at a 64x64
    working grid and 4 rows the CPU's own f32 gradients lie 3.8e-3 of their
    scale from the f64 ones, at 128x128 and 8 rows 3.4e-4. So the check
    runs at the latter and holds the GPU's f32 gradients to the CPU's f64
    ones: within 1e-3 of each gradient's scale, or 3 times the CPU's own
    f32 error, whichever is larger."""
    import torch

    from dyffusion_tpu_torch.config import get_config
    from dyffusion_tpu_torch.interface import get_datamodule

    small = {"navier_stokes": ["model.dim=8", "model.upsample_dims=(128,128)"], "spring_mesh": ["model.dim=32"]}
    for key, widths in small.items():
        tag = f"[{PHYSICAL[key]['label']}-ref]"
        with tempfile.TemporaryDirectory(prefix="chip_smoke_ref_") as tmp:
            extra = widths + [f"datamodule.data_dir={_physical_archive(tmp, key, n_time=12)}", "datamodule.horizon=4",
                              "datamodule.prediction_horizon=8", "model.dropout=0.0", "trainer.save_checkpoints=False"]
            c1, c2 = get_config(f"{key}_interpolation", extra), get_config(f"{key}_dyffusion", extra)
            dm = get_datamodule(c1)
            dm.setup()
            batch = next(dm.split("train").batches(8))
            runs = {(d, c): _physical_reference_run(c1, c2, dm, batch, d, c) for d, c in (
                ("cpu", None), ("cuda", None), ("cuda", "fresh statistics"), ("cuda", "eval first pass"))}
            f64 = _physical_reference_run(c1, c2, dm, batch, "cpu", None, torch.float64)
        cpu, gpu = runs[("cpu", None)], runs[("cuda", None)]
        worst_f64, key_f64 = _worst_grad(cpu[2], f64[2])
        worst_gpu, key_gpu = _worst_grad(gpu[2], f64[2])
        ok_fwd, e_fwd, lim_fwd = _within(gpu[0], cpu[0], 1e-4)
        ok_fresh = _within(runs[("cuda", "fresh statistics")][0], cpu[0], 1e-4)[0]
        rel_loss = abs(gpu[1] - cpu[1]) / abs(cpu[1])
        rel_eval = abs(runs[("cuda", "eval first pass")][1] - cpu[1]) / abs(cpu[1])
        grad_limit = max(1e-3, 3 * worst_f64)
        ok_grads = worst_gpu <= grad_limit
        eval_run = runs[("cuda", "eval first pass")]
        worst_eval = _worst_grad(eval_run[2], f64[2])[0]
        stats_err = max(float((gpu[3][k] - v).abs().max() / v.abs().max()) for k, v in cpu[3].items() if "running" in k)
        print(f"{tag} eval forward f32, GPU vs CPU: max_abs_err {e_fwd:.3e} (limit {lim_fwd:.3e}); with the running "
              f"statistics reset: rejected {not ok_fresh}")
        print(f"{tag} stage-2 loss f32: GPU {gpu[1]:.7f} vs CPU {cpu[1]:.7f} (rel {rel_loss:.2e}, limit 1e-4); "
              f"first pass in eval mode: rel {rel_eval:.2e}, gradients {worst_eval:.2e}, updates {len(eval_run[3])}; "
              f"{len(cpu[2])} gradients against the CPU's f64 ones: "
              f"GPU worst {worst_gpu:.2e} of its scale ({key_gpu}), CPU f32 worst {worst_f64:.2e} ({key_f64}), limit "
              f"{grad_limit:.2e}; "
              f"{len(cpu[3])} running-statistics updates: worst rel {stats_err:.2e} (limit 1e-4)")
        if not ok_fwd or rel_loss > 1e-4 or not ok_grads or stats_err > 1e-4 or set(gpu[3]) != set(cpu[3]):
            raise AssertionError(f"{tag} the GPU disagrees with the CPU")
        if ok_fresh or rel_eval <= 1e-4 or worst_eval <= grad_limit or set(eval_run[3]) == set(cpu[3]):
            raise AssertionError(f"{tag} a negative control passed its check")


def _sst_slice():
    """The SST-width serving slice on the GPU (section 4 of PERF.md)."""
    from dyffusion_tpu_torch.utils.workloads import SST_FAST_EVAL, sst_overrides

    extra = sst_overrides([
        "datamodule.n_traj=5", "datamodule.n_time=13", "datamodule.batch_size=6",
        "datamodule.eval_batch_size=6", *SST_FAST_EVAL, "trainer.save_checkpoints=False",
    ])
    return _build_slice(extra, "cuda")


def phase_slice(card):
    import numpy as np
    import torch

    from dyffusion_tpu_torch.models.modules import LinearAttention
    from dyffusion_tpu_torch.ops import linear_attention as la
    from dyffusion_tpu_torch.serving import build_experiment_predict_fn
    from dyffusion_tpu_torch.utils.evaluation import evaluate_ensemble_prediction

    t0 = time.perf_counter()
    exp, eval_fns, dm = _sst_slice()
    predict, specs, info = build_experiment_predict_fn(exp, eval_fns, dm, None)  # random weights, no EMA
    predict_ms, _, _ = build_experiment_predict_fn(exp, eval_fns, dm, None, reduce="mean_std")
    batch = next(dm.predict_batches())
    w, h = exp.cfg.window, exp.cfg.horizon
    targets = torch.as_tensor(batch["dynamics"][:, w:w + h], device="cuda")
    print(f"[slice] built in {time.perf_counter() - t0:.1f} s: {info}, input {specs['dynamics'].shape}")
    n_members, B = info["ensemble_members"], batch["dynamics"].shape[0]
    want_shape = (n_members, B, h) + tuple(batch["dynamics"].shape[2:])
    # B1 runs in every LinearAttention of each Unet forward: one forecaster
    # and one (2B) interpolator forward per scan step, one more forecaster
    # forward in the peeled last step
    n_attn = sum(isinstance(mod, LinearAttention) for mod in exp.model.modules())
    per_request = n_attn * (2 * len(exp.engine._steps.s) + 1)

    la.reset_launches()
    answers, latencies, counts = [], [], []
    torch.cuda.reset_peak_memory_stats()
    # a warm-up request, N_REQUESTS timed ones, the last repeating the first seed
    for seed in [SEED] + [SEED + 1 + j for j in range(N_REQUESTS - 1)] + [SEED]:
        before = la.launches
        _sync()
        t = time.perf_counter()
        out = predict(batch, seed)
        _sync()
        latencies.append(time.perf_counter() - t)
        counts.append(la.launches - before)
        answers.append(out)
    before = la.launches
    stats = predict_ms(batch, SEED)
    _sync()
    counts.append(la.launches - before)
    launches = la.launches
    peak = torch.cuda.max_memory_allocated()

    for out in answers:
        assert tuple(out.shape) == want_shape, (tuple(out.shape), want_shape)
        assert out.dtype == torch.float32 and bool(torch.isfinite(out).all()), "non-finite predictions"
        spread = float(out.std(dim=0).mean())
        assert spread > 0, "member spread is 0: dropout is not live"
    assert tuple(stats.shape) == (2,) + want_shape[1:], tuple(stats.shape)
    assert all(c == per_request for c in counts), f"B1 launches per request {counts} != {per_request}"
    repeat = float((answers[0] - answers[-1]).abs().max())
    other = float((answers[0] - answers[1]).abs().max())
    ms_err = float((stats[0] - answers[0].mean(0)).abs().max())
    print(f"[slice] same seed max diff {repeat:.3e}; other seed max diff {other:.3e}; "
          f"mean_std vs members mean {ms_err:.3e}")
    assert other > 0.1, "different seeds gave (nearly) the same ensemble"
    assert repeat <= 1e-2 * other, "the same seed did not reproduce its answer"
    assert ms_err <= 1e-4, "reduce='mean_std' disagrees with the members' mean"

    timed = latencies[1:N_REQUESTS + 1]
    frames = n_members * B * h
    lat = float(np.mean(timed))
    m = evaluate_ensemble_prediction(answers[1], targets)
    print(f"[slice] B1 launches: {counts} per request ({per_request} expected), {launches} in all")
    print(f"[slice] first request {latencies[0]:.3f} s (warm-up); timed requests {[round(x, 4) for x in timed]} s")
    print(f"[slice] request latency {lat:.4f} s, {frames / lat:.1f} frames/s ({frames} frames per request), "
          f"peak memory {peak / 2**30:.2f} GiB; on {card}")
    print(f"[slice] untrained-weights metrics vs targets: crps={float(m['crps']):.4f} "
          f"ssr={float(m['ssr']):.4f} mse={float(m['mse']):.4f}")
    return launches


# kernel categories of the profile, by a substring of the kernel's name;
# the first match wins, and what matches nothing is "other elementwise"
_CATEGORIES = (
    ("B1 linear attention", ("linear_attention",)),
    ("cuDNN NCHW<->NHWC layout transposes", ("nchwtonhwc", "nhwctonchw")),
    ("BatchNorm", ("batch_norm", "batchnorm", "bn_fw", "bn_bw")),
    ("bilinear resize", ("bilinear",)),
    ("convolutions", ("fprop", "dgrad", "wgrad", "conv")),
    ("matmuls (mid-block attention, 1x1 projections)", ("gemm", "nvjet", "xmma")),
    ("GroupNorm", ("groupnorm", "rowwisemoments")),
    ("dropout RNG + mask", ("uniform", "compare_scalar", "where")),
    ("reductions (ChannelLayerNorm, weight standardization)", ("reduce_kernel", "welford")),
    ("softmax", ("softmax",)),
    ("SiLU", ("silu",)),
    ("GELU", ("gelu",)),
    ("ReLU, LeakyReLU", ("relu", "leaky", "threshold")),
    ("concat", ("cat",)),
    ("nearest upsample", ("upsample",)),
)


def _profile(tag, fn, card):
    """Run ``fn`` once under ``torch.profiler`` (CUDA activity only, so the
    host records no operators) and print its wall time, summed kernel time,
    busy share (kernel time over wall time; the profiler's host work can
    only lower it), kernel time by category and the top kernels. Returns
    {category: ms}."""
    import torch  # noqa: F401
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        _sync()
        t = time.perf_counter()
        fn()
        _sync()
        wall = time.perf_counter() - t
    kernels = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    key = "self_device_time_total" if kernels and hasattr(kernels[0], "self_device_time_total") else "self_cuda_time_total"
    ms = {e.key: getattr(e, key) / 1e3 for e in kernels}
    total = sum(ms.values())
    if not total > 0:
        raise AssertionError(f"{tag} the profiler recorded no kernel time on the device")
    print(f"{tag} profiled {wall:.4f} s wall, {total / 1e3:.4f} s of kernels "
          f"({sum(e.count for e in kernels)} launches): busy share {total / 1e3 / wall:.3f}; on {card}")
    cats = {}
    for name, t in ms.items():
        n = name.lower()
        cat = next((c for c, subs in _CATEGORIES if any(sub in n for sub in subs)), "other elementwise")
        cats[cat] = cats.get(cat, 0.0) + t
    print(f"{tag} category | ms | share of kernel time")
    for cat, t in sorted(cats.items(), key=lambda x: -x[1]):
        print(f"{tag} {cat} | {t:.1f} | {t / total:.3f}")
    print(f"{tag} top kernels: ms | launches | name")
    for e in sorted(kernels, key=lambda e: -ms[e.key])[:20]:
        print(f"{tag} {ms[e.key]:.1f} | {e.count} | {e.key[:120]}")
    return ms


def phase_profile(card):
    """One SST request under the profiler (:func:`_profile`), after a
    warm-up and two unprofiled requests; then B1's kernels alone."""
    from dyffusion_tpu_torch.serving import build_experiment_predict_fn

    exp, eval_fns, dm = _sst_slice()
    predict, _, _ = build_experiment_predict_fn(exp, eval_fns, dm, None)
    batch = next(dm.predict_batches())

    def timed(seed):
        _sync()
        t = time.perf_counter()
        predict(batch, seed)
        _sync()
        return time.perf_counter() - t

    timed(SEED)  # warm-up
    print(f"[profile] unprofiled requests {[round(timed(SEED + 1 + j), 4) for j in range(2)]} s")
    ms = _profile("[profile] one SST request:", lambda: predict(batch, SEED + 3), card)
    print("[profile] B1 kernels: ms | name")
    for name, t in sorted(((n, t) for n, t in ms.items() if "linear_attention_qkv" in n), key=lambda x: -x[1]):
        print(f"[profile] {t:.2f} | {name[:110]}")


def phase_profile_physical(card, key):
    """The NS or spring path at its canonical width (seeded random weights,
    no registry) under the profiler: one served request (the AR chain over
    the full test trajectory, 20 members) and one stage-2 train step, each
    after a warm-up."""
    import numpy as np

    from dyffusion_tpu_torch.config import get_config
    from dyffusion_tpu_torch.interface import build_experiment, build_trainer, get_datamodule
    from dyffusion_tpu_torch.serving import build_experiment_predict_fn

    spec = PHYSICAL[key]
    tag = f"[profile-{spec['label']}]"
    with tempfile.TemporaryDirectory(prefix="chip_smoke_profile_") as tmp:
        extra = [f"datamodule.data_dir={_physical_archive(tmp, key)}", "trainer.save_checkpoints=False", *spec["extra"]]
        c1, c2 = get_config(f"{key}_interpolation", extra), get_config(f"{key}_dyffusion", extra)
        dm = get_datamodule(c1)
        dm.setup()
        _, ip, _, _, _ = build_experiment(c1, dm)
        exp, _, _, eval_fns, _ = build_experiment(c2, dm, interpolator=ip)
        predict, _, _ = build_experiment_predict_fn(exp, eval_fns, dm, None)
        batch = next(dm.predict_batches())
        predict(batch, SEED)  # warm-up
        _profile(f"{tag} one request ({exp.num_autoregressive_steps + 1} windows):", lambda: predict(batch, SEED + 1), card)
        trainer = build_trainer(c2, dm, interpolator=ip)
        train_batch = trainer._put(next(dm.train_batches(rng=np.random.default_rng(SEED))))
        trainer.train_step(trainer.state, train_batch)  # warm-up
        _profile(f"{tag} one stage-2 train step (batch {dm.batch_size}):",
                 lambda: trainer.train_step(trainer.state, train_batch), card)


def main(argv) -> int:
    import torch

    if argv not in ([], ["--profile"], ["--kernels"], ["--physical"]):
        raise SystemExit("usage: python3 chip_smoke.py [--profile | --kernels | --physical]")
    name, smi = phase_device()
    phase_build()
    if argv == ["--profile"]:
        phase_profile(smi)
        for key in PHYSICAL:
            phase_profile_physical(smi, key)
        return 0
    if argv == ["--physical"]:
        phase_physical_reference()
        for key in PHYSICAL:
            phase_physical(smi, key)
        return 0
    if argv == ["--kernels"]:
        phase_kernel()
        phase_kernel_core()
        phase_kernel_act()
        return 0
    from dyffusion_tpu_torch.ops import fused_act as fa
    from dyffusion_tpu_torch.ops import linear_attention as la

    b1, b3, b2 = phase_kernel(), phase_kernel_core(), phase_kernel_act()
    op_launches = phase_op_path()
    phase_reference()
    phase_train_reference()
    serve = phase_slice(smi)
    train = phase_train(smi, b1["train_step"])
    fit = phase_fit(smi)
    cli = phase_cli(smi)
    phase_physical_reference()
    physical = {spec["label"]: phase_physical(smi, key) for key, spec in PHYSICAL.items()}
    # B1's top-level numbers are the [train] path's (this slice's main path);
    # by_path keeps each path's own count, read after setting it to 0.
    # No single PyTorch call computes any of the three functions: library_ms is null
    print(json.dumps({"kernels": [
        {"name": "linear_attention_qkv", "route": "cuda", "source": la.SOURCE, "replaces": la.REPLACES,
         "launches": train, "max_abs_err": b1["max_abs_err"], **b1["train"], "bound_by": "bytes", "library_ms": None,
         "by_path": {"serve": {"launches": serve, **b1["serve"]}, "train": {"launches": train, **b1["train"]},
                     "fit": {"launches": fit}, "cli": {"launches": cli},
                     **{p: {"launches": c["linear_attention_qkv"]} for p, c in physical.items()}}},
        {"name": "fused_leaky_relu", "route": "cuda", "source": fa.SOURCE, "replaces": fa.REPLACES,
         "launches": op_launches["fused_leaky_relu"], **b2, "library_ms": None,
         "by_path": {p: {"launches": c["fused_leaky_relu"]} for p, c in physical.items()}},
        {"name": "linear_attention_core", "route": "cuda", "source": la.CORE_SOURCE, "replaces": la.CORE_REPLACES,
         "launches": op_launches["linear_attention_core"], **b3, "library_ms": None,
         "by_path": {p: {"launches": c["linear_attention_core"]} for p, c in physical.items()}},
    ]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
