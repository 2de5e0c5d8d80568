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
   fails the run. Then the native batch gather of the train loader
   (``csrc/batch_gather.cpp``, host C++) with g++; without g++ the run fails.
3. kernel vs plain: B1 at the shapes of the serving, train, fit, cli
   (the 50-member test ensemble: 300/600 rows) and oisst (256 and 128 rows
   in f32, 250/500 at the test ensemble) paths,
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
   forward_conditioning=none, bf16 eval, validation at 4 members; spring:
   10x10, C=4+1, horizon 134,
   SimpleConvNet dim 64 with BatchNorm, dropout 0.2, batch 64, refinement)
   on fake archives at the real grids, in a temporary registry: stage 1,
   stage 2 from the registry, ``mode=test`` over one full test trajectory
   (4 and 6 autoregressive windows, 20 members), serving by run id. Checks
   falling finite losses, running statistics moved by training and kept by
   evaluation and serving, the boundary conditions in every served frame
   (with a negative control), seeds; prints wall times, request times and
   peak memory. No kernel of the port lies on these paths: their launch
   counts must read 0.

13. baselines: the five baselines (time-conditioned, simultaneous, DDPM,
   MCVD, LDM-DDPM) through the CLI at SST width (``synthetic_<method>``,
   f32, 20 members) in a temporary registry: a few train steps and one
   validation, ``mode=test`` (50 members), serving by run id (a seed
   repeats, another does not, the members differ; a sampler whose members
   share their noise fails that check), the DDPM and MCVD commands with
   their samplers subsampled to 10 steps and the LDM's at T = 10, and for
   each diffusion engine one request with its preset's full sampler
   (1000 / 1001 / 1000 forwards).
   B1 is checked against its plain version at the path's rows in f32 first,
   and one DDPM and one MCVD step of the trained SST denoiser GPU against
   CPU. B1 launches per command and per request (42 / 6 / 6,000 / 6,006 /
   6,000) are asserted. The trained DDPM and MCVD runs are exported with
   their full samplers in the background (each sampler's loop one loop op)
   and served by a fresh process at the end of the phase: one full request
   each at the eager request's batch and seed, bit for bit or within 1e-5
   of max, B1 6,000 / 6,006 times.

14. ncsnpp-ref: the MCVD NCSN++ slice, f32, GPU against CPU, each check
   with a negative control that must fail it: the FIR resampling ops at the
   ladder's shapes with an asymmetric kernel (control: unflipped), an NCSN++
   and a SPADE NCSN++ forward at full width on 2 rows (control: the
   condition moved by a pixel), one MCVD loss and its gradients (control:
   no condition), three levels of annealed Langevin dynamics with the CPU's
   draws (control: a draw zeroed).
15. ncsnpp: ``synthetic_mcvd`` over NCSN++ at MCVD's published width
   (64x64, C=1, horizon 7, nf 64, mults (1,2,3,4), 2 res blocks, attention
   at 8/16/32, dropout 0.1, 20 members, f32) through the CLI in a temporary
   registry: 4 train steps + a validation (10 sampler steps), falling
   losses, ``mode=test`` (50 members), serving by run id with the seed and
   members-differ checks (members sharing their noise must fail), one
   full-sampler request (1001 forwards at 10 rows, timed), the busy share
   of a 21-forward request of the same run under the CUDA-activity
   profiler, and three short commands: the Fourier embedding with the EMA
   (its features unchanged bit for bit), the DDPM residual blocks, SPADE.
   No kernel of the port lies on this path: B1-B3 must read 0 launches.
16. export: [cli]'s stage-2 run exported by the serving CLI (``python -m
   dyffusion_tpu_torch.serving``) as ``torch.export`` artifacts, each
   sampler loop one loop op: with a symbolic batch; pinned to batch 6
   (``reduce=mean_std``, and the members in f32); data-parallel
   (``devices=2``, 3 rows a replica, bf16 and f32) and the same with each
   replica drawing at its own batch's shape (the planted fault); and a
   small two-stage run like [fit]'s, trained in its pipeline, exported for
   ``platforms=cuda,cpu``. The exports run in subprocesses started right
   after [cli] (beside phases 11-15, two at a time, one CPU thread each);
   a fresh process per artifact loads it with
   ``load_exported`` (the replicas on cuda:0 twice, the two-platform one on
   the CPU). Checks, in that process: the members artifact gives the eager
   ``build_predict_fn`` answer (batch 6 at four seeds, batches 1 and 7) bit
   for bit, or within 1e-2 of max|eager| in bf16 with the difference
   printed; seeds 0 and 1 differ; B1 launches 378 times per request; the
   mean_std artifact is the host reduction of the members; the two replicas
   answer as one device, within 1e-1 of max in bf16 (against the members
   artifact at four seeds) and 1e-3 in f32 (against the pinned f32 one),
   B1 378 times per replica, and the fault exceeds both limits;
   the CPU-served two-platform artifact answers as the eager CPU predict,
   bit for bit or within 1e-5 of max; nothing of the package but
   ``serving`` and ``ops`` was imported. Prints each artifact's nodes, loop
   ops, export, load and first-request times beside those of the unrolled
   artifact (the sampler's loop unrolled into the graph), the request times
   against the eager ones, and B1's host cost per call through its
   ``torch.library`` op against the direct launch.
17. oisst: the OISST presets through the CLI at full width (60x60, C=1,
   h=7, k=25, Unet dim 64 mults (1,2,4), 20 members folded, eval batch 6,
   bf16 eval) on the 11 Pacific boxes written by ``write_fake_oisst_dir``
   and cut to 31 / 13 / 8 days of 2018 / 2019 / 2020, in a temporary
   registry: ``oisst_pacific_interpolation perf=measured`` (B64 x 4 folded
   into batches of 256), ``oisst_pacific_dyffusion perf=measured`` by the
   stage-1 run id (B128 x accumulate 2, remat), ``mode=test`` (50 members),
   ``serving.build_predict_fn`` by run id. Checks the run ids against the
   parity layout's, falling finite losses, both layouts, B1 per command
   (from its steps and validations) and 378 per request, seeds and member
   spread, the prefetched device-staged batches against host indexing, one
   ``watch_gradients`` step, and each command's peak memory against the
   card; prints wall times, steps/s of both recipes, the request latency
   (and that of the same run served with ``forward_conditioning=data``,
   whose forecaster stays in bf16) and ``device_memory_report()``.
18. members: ``[slice]``'s workload served with
   ``module.fold_members_into_batch=false`` (20 members, one B-row sampler
   each, on generators of their own) beside the folded layout of the same
   weights: dropout off, the members of a 2-member unfolded request (each
   member the same computation) equal the folded answer (in f32 at 1e-3
   of max; in bf16 at 1e-2 of max against the folded layout at one member,
   the same 6-row forwards; negative control: the folded answer shifted by
   a row); dropout on, members differ, a 2-member request repeats the
   first two members of the full request bit for bit, and another seed
   differs; B1 launches 7,560 times per full request.
   Prints latency, frames/s and peak memory of both layouts.
19. ddp: data parallelism. A one-rank NCCL group in this process runs the
   gradient all-reduce, the metric-sum all-reduce and the cross-rank
   BatchNorm on the card; then two gloo ranks sharing cuda:0 (``chip_smoke.py
   --ddp-rank``, started with the launcher's environment) run stage 1,
   stage 2 and ``mode=test`` through ``train.main`` at SST width with
   ``trainer.devices=2`` (B64 global, f32, TF32 off, dropout off, stage 2
   at lr 1e-4, an odd last eval batch) and one spring-mesh step, against
   the same with ``trainer.devices=1`` in this process and ``mode=test``
   through the CLI's own spawn of two ranks: losses, weights, val and test metrics, B1
   launches per rank, the spring step's loss, gradients and running
   statistics (negative control: per-rank statistics). One-rank
   witnesses run beside the ranks (``--ddp-witness``): the rows permuted
   (the drift that the order of the sums alone makes, held to the same
   limit) and a planted fault (stage 2 on half the rows from step 2,
   which must exceed it). Prints the wall times; two ranks on one card
   measure no scaling.
20. spatial: spatial sharding, eval and training. The split B1 kernel (its
   partial pass, merge and output pass, two ranks emulated) against B1's
   plain version over all tokens at the per-rank SST shapes, bf16 and f32
   (negative control: rank 0's tokens alone), with its per-rank times;
   then, on ``[ddp]``'s one-rank stage-2 run (trained here when the phase
   runs alone), two gloo ranks sharing cuda:0 (``chip_smoke.py
   --spatial-rank``) split the grid's H axis for one-batch requests (f32
   with the workload's dropout; the same with every halo zeroed, the
   negative control; a bf16 request without dropout; all with the sampler
   cut to 13 forwards), beside a one-rank witness and the CLI's own two
   ranks running ``mode=test`` (cut alike) on the W axis: answers within
   1e-3 of max|one rank| (the zeroed halos beyond it), B1 78 split calls
   per request on each rank, each rank's peak device memory at most 0.7x
   one rank's. Training: the same processes reload both stages
   with the workload's dropout: stage 2's loss and forecaster gradients at
   16 rows within 1e-3 of max|one rank| (the halo's backward zeroed beyond
   it), two f32 train steps of each stage at the global batch of 64 with
   B1 6 / 24 split calls a step on each rank, each rank's stage-2 step
   peak at most 0.8x one rank's, the step times printed; then the CLI's
   own spawn trains both stages (2 steps, B64, stage 2 by run id) on two
   ranks sharding H beside a one-rank witness: losses within 1e-3
   relative, final weights within 1e-2 of their change. The physical
   systems, first in the same processes: NS at full width (``UNetSimple``
   dim 64 on a 256x256 working grid, 221x42 split on W, dropout 0.15, f32,
   TF32 off, seeded random weights, fake archive): one val request (4 rows
   x 4 members) within 1e-3 of max|one rank| (zeroed halos beyond it);
   stage 2's loss and gradients at 8 rows in f32 within 1e-2 (one rank
   against itself with torch's convs for cuDNN's within it too) and in f64
   within 1e-5 (the halo's backward zeroed beyond each); two stage-2 train
   steps at B32, each rank's peak at most 0.8x one rank's; one spring
   stage-2 step on H (B64) within 1e-3; no B1-B3 launch on these paths.
   Then, in the same processes, the diffusion baselines on H: MCVD over
   NCSN++ at ``[ncsnpp]``'s width (f32, TF32 off, weights moved off their
   near-zero init): one forward at 4 rows within 1e-3 of max|one rank|
   (every halo zeroed, the FIR resampling's too, and the attention over
   each rank's own tokens beyond it), the MCVD loss and gradients at 4 rows
   within 1e-3 (the halo's backward zeroed beyond it), a request of 2 rows
   x 4 members through the 10-step sampler within 1e-3; the SPADE NCSN++
   forward with the same checks; the DDPM over the SST ``Unet``: a request
   of 2 rows x 20 members through the 10-step sampler within 1e-3 (each
   rank drawing its noise at its slab's shape beyond it), B1 6 split calls
   a forward (60 a request) on each rank, one train step's loss within
   1e-5 relative; each rank's peak memory printed against the witness's.
21. spatial-thin (started with phase 20's processes, checked after them):
   four gloo ranks sharing cuda:0 split the H axis of a 12x60 grid under
   the SST ``Unet`` at full width, whose 3-row level leaves rank 3 no row,
   beside a one-rank witness: the f32 forward within 1e-3 of max|one
   rank| (every halo zeroed beyond it), bf16 within 5e-2 (zeroed halos
   beyond it), the gradients at 4 rows within 1e-3 of their scale, the
   'qk' linear attention at the SST widths of the 12x60 and 3x15 levels
   forward and backward, NS's 221x42 -> 256x256 -> 221x42 resample by
   five ``jax.image.resize`` methods on four ranks (W) against the
   witness and on the card against the CPU within 1e-5; B1 6 split calls
   a forward on each rank, rank 3's partial and output passes 4 (none at
   the 3x15 level); then the split B1 kernel against plain at the ranks'
   shapes, the rank of no tokens launching neither pass, with times.

Each path (slice, train, fit, each cli command, ns, spring, each baseline
command and request, ncsnpp, each export request, each oisst command, the
unfolded members, ddp, spatial, its baselines' DDPM request, spatial-thin's
forward) sets the
launch counts to 0 before it runs and reads them after. The line before
the last is the kernel summary as JSON
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

    python3 chip_smoke.py --baselines

runs phases 1, 2 and 13 (the baselines) and stops, with no ``ok`` line.
``--profile`` also profiles one full-sampler DDPM request.

    python3 chip_smoke.py --ncsnpp

runs phases 1, 2, 14 and 15 (MCVD over NCSN++) and stops, with no ``ok``
line. ``--profile`` also profiles one full-sampler MCVD NCSN++ request.

    python3 chip_smoke.py --export

runs phases 1, 2, 10 and 16 (the CLI's runs, then their export) and stops,
with no ``ok`` line.

    python3 chip_smoke.py --oisst

runs phases 1, 2 and 17 (the OISST path) and stops, with no ``ok`` line.

    python3 chip_smoke.py --members
    python3 chip_smoke.py --ddp
    python3 chip_smoke.py --spatial

run phases 1, 2 and 18 (or 19, or 20) and stop, with no ``ok`` line.

    python3 chip_smoke.py --spatial-physical

runs phase 1, then only the physical systems of phase 20 (NS on W and
spring on H, in its three processes, with their checks; no kernel runs
there, so nothing is built) and stops, with no ``ok`` line.

    python3 chip_smoke.py --spatial-baselines

runs phases 1 and 2, then only the split B1 check and the diffusion
baselines of phase 20 (MCVD over NCSN++ and the DDPM over the SST ``Unet``
on H, in its three processes, with their checks) and stops, with no ``ok``
line.

    python3 chip_smoke.py --spatial-thin

runs phases 1, 2 and 21 and stops, with no ``ok`` line.

    python3 chip_smoke.py --kernels

runs phases 1 and 2, then the three kernel phases (B1, B3, B2 against their
plain versions, and their times) and stops, with no ``ok`` line.
"""
from __future__ import annotations

import contextlib
import json
import os
import subprocess
import sys
import tempfile
import threading
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
    from dyffusion_tpu_torch.data import native_loader

    if not native_loader.native_available():
        raise AssertionError("[build] no g++: the native batch gather of the OISST path cannot be built")
    log = native_loader.build_log
    print(f"[build] {native_loader.SOURCE.name}: g++ {log['seconds']:.2f} s -> {os.path.basename(log['path'])}")


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
    # [oisst]: stage 1 folded (256) and stage 2 (128) in f32, the 50-member test batch of 5 rows (250, 500)
    oisst = ((256, 3600), (256, 900), (256, 225), (128, 3600), (128, 900), (128, 225),
             (250, 3600), (500, 3600), (250, 900), (500, 900), (250, 225), (500, 225))
    controls = ((120, 3600), (240, 900), (64, 3600), (300, 3600), (256, 3600))
    max_err = 0.0
    for B, N in serve + train + fit + cli + oisst + MEMBERS_B1 + DDP_B1 + ((3, 7),):
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


def phase_cli(card, reg):
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
    forwards imply. The registry is ``reg``, a directory the caller removes
    (``[export]`` serves its stage-2 run). Returns the B1 launches of all
    steps and the stage-2 run id."""
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
    return sum(counts.values()), id2


# [export]: [cli]'s stage-2 run as artifacts, written by the serving CLI in
# subprocesses that start right after [cli] and trace while the later phases
# run: the members artifact with a symbolic batch, the mean_std one pinned
# to the eval batch of 6, the data-parallel one (devices=2, 3 rows a
# replica) and the same with each replica drawing at its own batch's shape
# (the planted fault, ``--export-own-draws``), both data-parallel and pinned
# in f32; and a small run like [fit]'s (``--export-small-run``) exported for
# the platforms cuda and cpu. A fresh
# process per artifact (``chip_smoke.py --serve-exported``) then loads it
# with ``load_exported`` (the replicas on cuda:0 twice; the two-platform
# artifact on the CPU) and waits; the phase itself hands it the requests
# once the GPU is free of other work.
EXPORT_BATCH = 6
EXPORT_SEEDS = (SEED, SEED + 1, SEED + 2, SEED + 3)  # warm-up, then the timed requests
EXPORT_DEVICES = 2  # replicas of the data-parallel artifact, both on cuda:0
# the data-parallel check's limits, of max|one device|: in f32 (TF32 off) 1e-3; in
# bf16 1e-1, where the replicas' 60-row forwards round otherwise than 120-row
# ones and 63 sampler steps carry it on (1.7e-2-3.0e-2 measured; the planted
# fault reads 1.47)
EXPORT_F32 = "module.eval_dtype=float32"
DP_TOL = {"float32": 1e-3, "bfloat16": 1e-1}
# the SST members artifact on this card when the sampler's loop was unrolled
# into its graph (PERF.md §6), beside which [export] prints its own
UNROLLED_EXPORT = "46,547 nodes; trace 114.8-125.4 s, CLI export 188.1-214.2 s, load 75.0-94.1 s"
# the run of the platform leg: [fit]'s size, a few steps a stage
PLATFORM_RUN = [
    "datamodule.spatial=(24,24)", "datamodule.channels=1", "datamodule.horizon=3", "datamodule.n_traj=6",
    "datamodule.n_time=12", "datamodule.batch_size=4", "datamodule.eval_batch_size=4", "model.dim=16",
    "model.dim_mults=(1,2)", "module.num_predictions=3", "diffusion.additional_interpolation_steps=2",
    "trainer.max_steps=2", "trainer.val_every_n_epochs=100",
]


# exports and loads running at once, each on one CPU thread (of the host's
# 8; the phases beside them are bound by the host's launch rate); with two
# at once the nine pipelines (~75 s each) outlasted phases 11-15 and
# [export] waited ~200 s for them. An idle loaded server holds no core
EXPORT_CONCURRENCY = 4
_EXPORT_SLOTS = threading.BoundedSemaphore(EXPORT_CONCURRENCY)
_ONE_THREAD = {**os.environ, "OMP_NUM_THREADS": "1", "MKL_NUM_THREADS": "1"}


class _ExportPipeline:
    """One artifact: the CLI's export (or ``cmd``), then a serving process
    that loads it (on ``serve_on``: a device, or devices joined by commas)
    and waits for its requests on stdin."""

    def __init__(self, reg, run_id, out_dir, extra, serve_on=None, cmd=None):
        self.out_dir, self.server, self.error, self.serve_on, self.run_id = out_dir, None, None, serve_on, run_id
        args = ([f"run_id={run_id}"] if run_id else []) + [f"out={out_dir}", f"registry_dir={reg}", *extra]
        self.cmd = (cmd or [sys.executable, "-m", "dyffusion_tpu_torch.serving"]) + args
        self.thread = threading.Thread(target=self._run, daemon=True)
        self.thread.start()

    def _run(self):
        with _EXPORT_SLOTS:
            self._export_and_load()

    def _export_and_load(self):
        t = time.perf_counter()
        proc = subprocess.run(self.cmd, capture_output=True, text=True, cwd=os.path.dirname(os.path.abspath(__file__)),
                              env=_ONE_THREAD)
        self.export_wall = time.perf_counter() - t
        if proc.returncode != 0:
            self.error = f"export failed (exit {proc.returncode}): {' '.join(self.cmd)}\n{proc.stdout}{proc.stderr[-4000:]}"
            return
        self.stderr = open(self.out_dir + ".stderr", "w+")
        self.server = subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--serve-exported", self.out_dir,
             *([self.serve_on] if self.serve_on else [])],
            stdin=subprocess.PIPE, stdout=subprocess.PIPE, stderr=self.stderr, text=True,
            env=None if self.serve_on == "cpu" else _ONE_THREAD,  # a CPU server sums as the main process does
        )
        lines = []
        for line in self.server.stdout:  # {"loaded": seconds} once the artifact is loaded
            lines.append(line)
            if line.startswith('{"loaded"'):
                self.loaded = json.loads(line)
                return
        self.error = f"the serving process did not load {self.out_dir}: {''.join(lines)}{self._stderr()}"

    def _stderr(self):
        self.stderr.seek(0)
        return self.stderr.read()[-4000:]

    def wait_loaded(self):
        """Wait until the artifact is exported and loaded (or has failed)."""
        self.thread.join()
        if self.error:
            raise AssertionError(f"[export] {self.error}")

    def request(self, job, timeout=900):
        """Hand the loaded artifact its requests; the serving process's report."""
        self.wait_loaded()
        out, _ = self.server.communicate(json.dumps(job) + "\n", timeout=timeout)
        if self.server.returncode != 0:
            raise AssertionError(f"[export] the serving process failed: {self._stderr()}")
        return json.loads(out.strip().splitlines()[-1])

    def stop(self):
        self.thread.join(timeout=1)
        if self.server is not None:
            if self.server.poll() is None:
                self.server.kill()
                self.server.wait()
            self.stderr.close()


def export_small_run_main(args):
    """``--export-small-run out=DIR registry_dir=REG key=value ...``: the
    platform leg's run in its pipeline's process: both stages of
    ``PLATFORM_RUN`` trained in REG, then the serving CLI on the stage-2
    run with ``args``; the run id goes to DIR.run_id."""
    from dyffusion_tpu_torch import serving
    from dyffusion_tpu_torch.config import get_config
    from dyffusion_tpu_torch.interface import run_experiment

    kw = dict(a.split("=", 1) for a in args)
    common = PLATFORM_RUN + [f"registry_dir={kw['registry_dir']}"]
    tr1, _ = run_experiment(get_config("synthetic_interpolation", common))
    run1 = os.path.basename(tr1.ckpt.run_dir)
    tr2, _ = run_experiment(get_config("synthetic_dyffusion", common + [f"diffusion.interpolator_run_id={run1}"]))
    run2 = os.path.basename(tr2.ckpt.run_dir)
    serving._main([f"run_id={run2}", *args])
    with open(kw["out"] + ".run_id", "w") as f:
        f.write(run2)
    return 0


def start_exports(reg, run_id, work):
    """The artifacts' pipelines of ``[export]``, started in the background
    (the platform leg's pipeline trains its run first)."""
    pinned = ["polymorphic_batch=false", f"batch_size={EXPORT_BATCH}"]
    dp = pinned + [f"devices={EXPORT_DEVICES}"]
    on_card = ",".join(["cuda:0"] * EXPORT_DEVICES)
    own = [sys.executable, os.path.abspath(__file__), "--export-own-draws"]
    small = [sys.executable, os.path.abspath(__file__), "--export-small-run"]
    return {
        "members": _ExportPipeline(reg, run_id, os.path.join(work, "members"), []),
        "mean_std": _ExportPipeline(reg, run_id, os.path.join(work, "mean_std"), ["reduce=mean_std", *pinned]),
        "dp": _ExportPipeline(reg, run_id, os.path.join(work, "dp"), dp, serve_on=on_card),
        "dp_own_draws": _ExportPipeline(reg, run_id, os.path.join(work, "dp_own"), dp, serve_on=on_card, cmd=own),
        "pinned_f32": _ExportPipeline(reg, run_id, os.path.join(work, "pinned_f32"), pinned + [EXPORT_F32]),
        "dp_f32": _ExportPipeline(reg, run_id, os.path.join(work, "dp_f32"), dp + [EXPORT_F32], serve_on=on_card),
        "platforms": _ExportPipeline(reg, None, os.path.join(work, "platforms"), ["platforms=cuda,cpu"],
                                     serve_on="cpu", cmd=small),
    }


def export_own_draws_main(args):
    """``--export-own-draws key=value ...``: the serving CLI with the planted
    fault of ``[export]``'s data-parallel check: each replica draws at its
    own batch's shape (``utils.rng.replica_rows`` does nothing)."""
    from dyffusion_tpu_torch import serving
    from dyffusion_tpu_torch.utils import rng

    rng.replica_rows = lambda total, rows: contextlib.nullcontext()
    serving._main(args)
    return 0


def serve_exported_main(out_dir, serve_on=None):
    """``--serve-exported DIR [DEVICES]``: the serving side of ``[export]``
    in a fresh process, TF32 off as in the main process. Loads the artifact
    with ``load_exported`` (on DEVICES, a device or devices joined by commas,
    else its own) and prints
    ``{"loaded": seconds}``; then reads one job from stdin ({"batches": npz,
    "requests": [[name, batch key, seed], ...], "out": npz, optionally
    "threads"}), runs the requests in order (each ending in a device sync,
    the B1 launch count set to 0 before each and read after), saves the
    outputs and prints the report as its last line."""
    import numpy as np
    import torch

    t = time.perf_counter()
    from dyffusion_tpu_torch.serving import load_exported

    # f32 as this script's main process computes it (phase_device): TF32 off
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = None if serve_on is None else (serve_on.split(",") if "," in serve_on else serve_on)
    predict, manifest = load_exported(out_dir, device=device)
    print(json.dumps({"loaded": time.perf_counter() - t}), flush=True)
    job = json.loads(sys.stdin.readline())
    if "threads" in job:  # the CPU's sums split by thread: the eager side's count
        torch.set_num_threads(job["threads"])
    from dyffusion_tpu_torch.ops import linear_attention as la

    batches = dict(np.load(job["batches"]))
    outs, seconds, launches = {}, {}, {}
    for name, key, seed in job["requests"]:
        la.reset_launches()
        _sync()
        t = time.perf_counter()
        out = predict({"dynamics": batches[key]}, seed)
        _sync()
        seconds[name], launches[name] = time.perf_counter() - t, la.launches
        outs[name] = out.cpu().numpy()
    np.savez(job["out"], **outs)
    print(json.dumps({"seconds": seconds, "launches": launches, "peak_bytes": torch.cuda.max_memory_allocated(),
                      "modules": sorted(m for m in sys.modules if m.split(".")[0] == "dyffusion_tpu_torch"),
                      "manifest": manifest}))
    return 0


def _op_host_us(rounds=5, calls=200):
    """Host microseconds per call of B1 through its torch.library op against
    the direct launch (``_launch_qkv``, the ctypes call the op wraps), at
    (120, 3600, 384) bf16 in the NCHW view: the loop issues ``calls``
    launches without waiting (the device takes longer per call than the
    host), timed by the host clock; rounds alternate op, direct, direct, op."""
    import statistics

    import torch

    from dyffusion_tpu_torch.ops import linear_attention as la

    x = _qkv(120, 3600, torch.bfloat16, True, torch.Generator(device="cuda").manual_seed(3))
    ways = {"op": lambda: la.linear_attention_qkv(x, 4, 32, 32**-0.5),
            "direct": lambda: la._launch_qkv(x, 4, 32, 32**-0.5)}
    times = {k: [] for k in ways}
    with torch.no_grad():
        for k in ways:
            ways[k]()
        _sync()
        for r in range(rounds):
            for k in (("op", "direct") if r % 2 == 0 else ("direct", "op")):
                t = time.perf_counter()
                for _ in range(calls):
                    ways[k]()
                times[k].append((time.perf_counter() - t) / calls * 1e6)
                _sync()
    return {k: statistics.median(v) for k, v in times.items()}


def phase_export(card, reg, run_id, pipelines, work):
    """The exported SST sampler against the eager one (``build_predict_fn``
    of [cli]'s stage-2 run, EMA weights, bf16, 20 members): in the fresh
    serving process, the members artifact answers each eager request (batch 6
    at 4 seeds, batches 1 and 7 at seed 0) bit for bit, or within 1e-2 of
    max|eager| in bf16 with the difference printed; seeds 0 and 1 differ (an
    artifact whose generator were a traced constant would fail it); B1
    launches 378 times per artifact request; the mean_std artifact is the
    host reduction of the members'; the serving process imported nothing
    of the package but ``serving`` and ``ops``. The data-parallel artifact
    (2 replicas of 3 rows, both on cuda:0) answers as one device does at
    batch 6 within ``DP_TOL`` (bf16 against the members artifact at 4
    seeds, f32 against the pinned f32 artifact at one), with B1 378 times
    per replica per request; the same with each
    replica drawing at its own batch's shape must exceed both limits. The
    platform leg: a small run's artifact exported for cuda and cpu, served
    on the CPU in a fresh process, answers as the eager CPU predict does,
    bit for bit or within 1e-5 of max with the difference printed. Prints
    the export times, file sizes, node and loop counts beside the
    unrolled artifact's, the load times, the first request of each fresh
    process, the request times against the eager ones, and the op's host
    cost per call. Returns B1's launches over the artifact requests, those
    per request, and the data-parallel artifact's."""
    import numpy as np
    import torch

    from dyffusion_tpu_torch.interface import reload_trainer
    from dyffusion_tpu_torch.models.modules import LinearAttention
    from dyffusion_tpu_torch.serving import build_predict_fn

    for p in pipelines.values():  # no trace or load beside the timed requests
        p.wait_loaded()
    host_us = _op_host_us()
    print(f"[export] B1 host cost per call at (120, 3600, 384) bf16: torch.library op {host_us['op']:.1f} us, "
          f"direct ctypes launch {host_us['direct']:.1f} us; on {card}")

    predict, specs, info = build_predict_fn(reg, run_id)
    trainer = reload_trainer(reg, run_id)
    exp = trainer.experiment
    per_request = sum(isinstance(m, LinearAttention) for m in exp.model.modules()) * (2 * len(exp.engine._steps.s) + 1)
    b6 = np.asarray(next(trainer.datamodule.predict_batches())["dynamics"])[:, :info["dynamics_frames"]]
    assert b6.shape[0] == EXPORT_BATCH, b6.shape
    batches = {"b6": b6, "b1": b6[:1], "b7": np.concatenate([b6, b6[:1]])}
    np.savez(os.path.join(work, "batches.npz"), **batches)
    requests = [[f"b6_seed{s}", "b6", s] for s in EXPORT_SEEDS] + [["b1_seed0", "b1", SEED], ["b7_seed0", "b7", SEED]]

    eager, eager_s = {}, {}
    for name, key, seed in requests:
        _sync()
        t = time.perf_counter()
        eager[name] = predict({"dynamics": batches[key]}, seed)
        _sync()
        eager_s[name] = time.perf_counter() - t
        eager[name] = eager[name].cpu().numpy()

    def job(name, reqs):
        return {"batches": os.path.join(work, "batches.npz"), "requests": reqs, "out": os.path.join(work, f"{name}.npz")}

    b6_requests = [[f"b6_seed{s}", "b6", s] for s in EXPORT_SEEDS]
    reports = {
        "members": pipelines["members"].request(job("members_out", requests)),
        "mean_std": pipelines["mean_std"].request(job("mean_std_out", [["b6_seed0", "b6", SEED]])),
        "dp": pipelines["dp"].request(job("dp_out", b6_requests)),
        "dp_own_draws": pipelines["dp_own_draws"].request(job("dp_own_out", b6_requests[:1])),
        "pinned_f32": pipelines["pinned_f32"].request(job("pinned_f32_out", b6_requests[:1])),
        "dp_f32": pipelines["dp_f32"].request(job("dp_f32_out", b6_requests[:1])),
    }
    members = reports["members"]
    got = dict(np.load(os.path.join(work, "members_out.npz")))
    reduced = np.load(os.path.join(work, "mean_std_out.npz"))["b6_seed0"]
    manifest = members["manifest"]
    timed = [n for n, _, _ in requests[1:len(EXPORT_SEEDS)]]
    art_ms, eager_ms = (float(np.mean([t[n] for n in timed])) for t in (members["seconds"], eager_s))
    for name in reports:
        pl, g = pipelines[name], reports[name]["manifest"]["graph"]
        first = next(iter(reports[name]["seconds"].values()))
        print(f"[export] {name} artifact: {g['nodes']} graph nodes in all, {g['loops']} loop ops, {g['b1_nodes']} B1 "
              f"nodes; {os.path.getsize(os.path.join(pl.out_dir, 'sampler.pt2'))} bytes; trace "
              f"{g['export_seconds']:.1f} s, CLI export (reload, trace, save) {pl.export_wall:.1f} s; load in a fresh "
              f"process {pl.loaded['loaded']:.1f} s; its first request {first:.4f} s")
    print(f"[export] the members artifact with the sampler's loop unrolled: {UNROLLED_EXPORT}; on {card}")
    print(f"[export] request latency, batch {EXPORT_BATCH}: artifact {art_ms:.4f} s, eager {eager_ms:.4f} s, artifact "
          f"/ eager {art_ms / eager_ms:.3f} (mean of {len(timed)} after the first request of each side); artifact "
          f"{[round(members['seconds'][n], 4) for n, _, _ in requests]} s, eager "
          f"{[round(eager_s[n], 4) for n, _, _ in requests]} s; serving process peak memory "
          f"{members['peak_bytes'] / 2**30:.2f} GiB; on {card}")

    failures = []
    for name, key, _ in requests:
        want, have = eager[name], got[name]
        if have.shape != want.shape or not np.isfinite(have).all():
            failures.append(f"{name}: shape {have.shape} (eager {want.shape}) or non-finite values")
            continue
        diff, scale = float(np.abs(have - want).max()), float(np.abs(want).max())
        verdict = "bit for bit" if diff == 0 else (
            f"not bit for bit: max diff {diff:.3e}, {diff / scale:.2e} of max|eager| (limit 1e-2 in bf16)")
        print(f"[export] {name} ({batches[key].shape[0]} rows): artifact vs eager {verdict}")
        if diff > 1e-2 * scale:
            failures.append(f"{name}: artifact vs eager max diff {diff:.3e} > 1e-2 x {scale:.3e}")
    seeds = float(np.abs(got["b6_seed0"] - got["b6_seed1"]).max())
    print(f"[export] seeds 0 and 1 max diff {seeds:.3e} (must differ); B1 launches per artifact request "
          f"{members['launches']} ({per_request} expected)")
    if not seeds > 0.1:
        failures.append(f"seeds 0 and 1 gave (nearly) the same ensemble: max diff {seeds:.3e}")
    if any(n != per_request for n in members["launches"].values()):
        failures.append(f"B1 launches per artifact request {members['launches']} != {per_request}")
    host = got["b6_seed0"].astype(np.float64)
    ms_err = [float(np.abs(reduced[i] - r).max()) / float(np.abs(r).max())
              for i, r in enumerate((host.mean(0), host.std(0)))]
    print(f"[export] mean_std artifact vs the host reduction of the members artifact: mean {ms_err[0]:.2e}, "
          f"std {ms_err[1]:.2e} of scale (limit 1e-4); shape {reduced.shape}")
    if reduced.shape != (2,) + host.shape[1:] or max(ms_err) > 1e-4:
        failures.append(f"the mean_std artifact is not the host reduction: {ms_err}, shape {reduced.shape}")

    # the data-parallel artifact against one device: in bf16 the members artifact's batch-6 answers (bit
    # for bit the eager ones, as a pinned artifact's were in every run that served one), in f32 the
    # pinned f32 artifact
    def rel(a, b):
        return float(np.abs(a - b).max()) / float(np.abs(b).max())

    out = {n: dict(np.load(os.path.join(work, f"{n}_out.npz"))) for n in ("dp", "pinned_f32", "dp_f32")}
    out["one"] = {n: got[n] for n in out["dp"]}
    own = np.load(os.path.join(work, "dp_own_out.npz"))["b6_seed0"]
    dp_err = {dt: {n: rel(out[dp][n], out[ref][n]) for n in out[dp]}
              for dt, dp, ref in (("bfloat16", "dp", "one"), ("float32", "dp_f32", "pinned_f32"))}
    own_err = rel(own, out["one"]["b6_seed0"])
    dp_launches = reports["dp"]["launches"]
    print(f"[export] data-parallel artifact ({EXPORT_DEVICES} replicas of {EXPORT_BATCH // EXPORT_DEVICES} rows on "
          f"cuda:0) vs one device, max diff / max|one device| (bf16: the members artifact; f32: pinned): bf16 "
          f"{ {n: float(f'{e:.3e}') for n, e in dp_err['bfloat16'].items()} } (limit {DP_TOL['bfloat16']}), f32 "
          f"{ {n: float(f'{e:.3e}') for n, e in dp_err['float32'].items()} } (limit {DP_TOL['float32']}); each replica "
          f"drawing at its own batch's shape (bf16): {own_err:.3e} (must exceed both limits); B1 launches per request "
          f"{dp_launches} "
          f"({EXPORT_DEVICES} x {per_request} expected); request times dp "
          f"{[round(v, 4) for v in reports['dp']['seconds'].values()]} s, f32 dp "
          f"{[round(v, 4) for v in reports['dp_f32']['seconds'].values()]} s, f32 pinned "
          f"{[round(v, 4) for v in reports['pinned_f32']['seconds'].values()]} s (two replicas on one card: no "
          f"throughput is measured)")
    for dt, errs in dp_err.items():
        if max(errs.values()) > DP_TOL[dt] or not all(np.isfinite(v).all() for v in out["dp"].values()):
            failures.append(f"the {dt} data-parallel artifact disagrees with the one-device one: {errs}")
    if not own_err > max(DP_TOL.values()):
        failures.append(f"replicas drawing at their own shape pass the data-parallel check: {own_err:.3e}")
    if any(n != EXPORT_DEVICES * per_request for n in dp_launches.values()):
        failures.append(f"B1 launches per data-parallel request {dp_launches} != {EXPORT_DEVICES} x {per_request}")

    # the platform leg: a two-platform artifact traced on the card, served on the CPU
    small = pipelines["platforms"]
    with open(small.out_dir + ".run_id") as f:
        small_run = f.read()
    cpu_predict, _, cpu_info = build_predict_fn(reg, small_run, device="cpu")
    tr_small = reload_trainer(reg, small_run, device="cpu")
    xb = np.asarray(next(tr_small.datamodule.predict_batches())["dynamics"])[:, :cpu_info["dynamics_frames"]]
    np.savez(os.path.join(work, "small_batch.npz"), b=xb)
    t = time.perf_counter()
    want_cpu = cpu_predict({"dynamics": xb}, SEED).numpy()
    eager_cpu_s = time.perf_counter() - t
    rep = small.request({"batches": os.path.join(work, "small_batch.npz"), "requests": [["seed0", "b", SEED]],
                         "out": os.path.join(work, "small_out.npz"), "threads": torch.get_num_threads()})
    have_cpu = np.load(os.path.join(work, "small_out.npz"))["seed0"]
    diff = float(np.abs(have_cpu - want_cpu).max()) if have_cpu.shape == want_cpu.shape else float("inf")
    scale = float(np.abs(want_cpu).max())
    print(f"[export] platforms {rep['manifest']['platforms']} (traced on {rep['manifest']['device']}), served on the "
          f"CPU in a fresh process, {xb.shape[0]} rows x {cpu_info['ensemble_members']} members: vs the eager CPU "
          f"predict {'bit for bit' if diff == 0 else f'max diff {diff:.3e}, {diff / scale:.2e} of max (limit 1e-5)'}; "
          f"CLI export {small.export_wall:.1f} s, load {small.loaded['loaded']:.1f} s, request "
          f"{rep['seconds']['seed0']:.3f} s (eager CPU {eager_cpu_s:.3f} s), B1 launches {rep['launches']['seed0']} "
          f"(the plain version runs on the CPU)")
    if rep["manifest"]["platforms"] != ["cuda", "cpu"] or not diff <= 1e-5 * scale:
        failures.append(f"the two-platform artifact on the CPU disagrees with eager: {diff:.3e} of {scale:.3e}")
    if rep["launches"]["seed0"] != 0:
        failures.append(f"the CPU-served artifact launched B1 {rep['launches']['seed0']} times")

    allowed = {"dyffusion_tpu_torch", "dyffusion_tpu_torch.serving"}
    for report in (*reports.values(), rep):
        extra = [m for m in report["modules"] if m not in allowed and not m.startswith("dyffusion_tpu_torch.ops")]
        if extra:
            failures.append(f"the serving process imported {extra}")
    print(f"[export] serving process imported {members['modules']}")
    if failures:
        raise AssertionError("[export] " + "; ".join(failures))
    return sum(members["launches"].values()), per_request, {
        "launches": sum(dp_launches.values()), "per_request": dp_launches["b6_seed0"]}


# the physical-systems paths at their canonical widths (utils/workloads.py:
# NS_CORE, SPRING_CORE), through their presets on fake archives at the real
# grids. One trajectory per split: the test trajectory spans the prediction
# horizon (NS 64 = 4 windows of 16, spring 804 = 6 windows of 134), and the
# shared trajectory length gives train and val 49 (NS) or 671 (spring) rows.
# NS evaluates in bf16 (module.eval_dtype), spring in f32.
PHYSICAL = {
    # NS validates with 4 members (its validation over the val split's 49 windows took most of
    # the phase's time at 20); serving and mode=test keep 20
    "navier_stokes": {"label": "ns", "system": "navier-stokes", "n_time": 65, "steps": 12,
                      "extra": ["module.eval_dtype=bfloat16", "module.num_predictions=4"]},
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


SERVED_MEMBERS = 20  # the members of a served NS or spring request


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
    kernel of the port lies on these paths. Returns them. So are
    ``UNetSimple``'s decoder upsamples: on NS all channels-last (one
    device, CUDA), on spring none."""
    import numpy as np
    import torch

    from dyffusion_tpu_torch import train
    from dyffusion_tpu_torch.config import get_config
    from dyffusion_tpu_torch.interface import reload_trainer
    from dyffusion_tpu_torch.models import unet_simple as us
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
    us.reset_upsamples()
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
            predict, _, info = build_predict_fn(reg, id2, overrides=[f"module.num_predictions={SERVED_MEMBERS}"])
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
    upsamples = {"channels_last": us.upsample_channels_last, "nchw": us.upsample_nchw}
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
          f"UNetSimple decoder upsamples {upsamples}; on {card}")
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
    if upsamples["nchw"] or bool(upsamples["channels_last"]) != (key == "navier_stokes"):
        raise AssertionError(f"{tag} UNetSimple's decoder did not run channels-last throughout: {upsamples}")
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


# The baselines at SST width (section 4 of PERF.md): the presets
# synthetic_<method> with the SST workload (utils/workloads.py), f32, 20
# members. 5 trajectories of 9 frames: 2 rows each, so one train batch of 4
# per epoch, and one eval batch of 2 rows per split (40 rows at 20 members,
# 100 at the test ensemble's 50). Validation, mode=test and serving's seed
# checks (on one row: 20 rows per forward) subsample DDPM (DDIM) and MCVD to
# BASELINE_EVAL_STEPS steps; the LDM-DDPM has no subsampling and runs its
# 1000 steps everywhere. The full-sampler requests serve the predict split's
# eval batch of 2 (40 rows per forward): the largest that keeps the phase
# within its share of the run's time.
BASELINES = ("time_conditioned", "simultaneous", "ddpm", "mcvd", "ddpm_v2")
BASELINE_DIFFUSION = ("ddpm", "mcvd", "ddpm_v2")
BASELINE_EVAL_STEPS = 10
# the LDM preset's T, for its full request: its commands train and sample at
# T = BASELINE_EVAL_STEPS (it has no sampling_timesteps to subsample with)
BASELINE_FULL_STEPS = 1000
# the runs whose full sampler is also exported and served as an artifact
BASELINE_ARTIFACTS = ("ddpm", "mcvd")
BASELINE_TRAIN_STEPS = 4
BASELINE_DATA = ["datamodule.n_traj=5", "datamodule.n_time=9", "datamodule.batch_size=4",
                 "datamodule.eval_batch_size=2"]


def _sampler_forwards(exp):
    """Network forwards of one eval window of a baseline experiment (its
    engine as configured): h for the time-conditioned forecaster, 1 for the
    simultaneous one, the sampler's steps (+ MCVD's final denoise)."""
    from dyffusion_tpu_torch.diffusion import GaussianDiffusionEngine, McvdEngine
    from dyffusion_tpu_torch.experiments import TimeConditionedForecastingExperiment

    engine = getattr(exp, "diffusion_engine", None)
    if engine is None:
        return exp.cfg.horizon if isinstance(exp, TimeConditionedForecastingExperiment) else 1
    if isinstance(engine, GaussianDiffusionEngine):
        return len(engine.ddim_steps()) if engine.is_ddim_sampling else engine.num_timesteps
    if isinstance(engine, McvdEngine):
        return len(engine.subsampled_schedule()[0]) + int(engine.cfg.sampling_denoise)
    return engine.num_timesteps


def _baseline_one_step_vs_cpu(model, spatial):
    """One f32 DDPM step and one MCVD step of the trained SST denoiser
    (``model``, on the GPU, samples of ``spatial`` (H, W)) against its copy
    on the CPU, on one row with the
    same noise: each engine at T = 2 runs its two denoiser forwards (MCVD
    then its final denoise). Tolerance 1e-4 of the largest output (f32 both
    sides, TF32 off). Negative control: the CPU step without its noise.
    Returns the worst relative error."""
    import copy

    import torch

    from dyffusion_tpu_torch.diffusion import GaussianDiffusionConfig, GaussianDiffusionEngine, McvdConfig, McvdEngine

    c_in, c_out = model.init_conv.in_channels, model.final_conv.out_channels
    shape = (c_out,) + tuple(spatial)
    gen = torch.Generator().manual_seed(SEED)
    cond = torch.randn((1, c_in - c_out) + tuple(spatial), generator=gen)
    draws = [torch.randn((1,) + shape, generator=gen) for _ in range(2)]
    cpu_model = copy.deepcopy(model).cpu()
    worst = 0.0
    for name, make in (("DDPM", lambda m: GaussianDiffusionEngine(GaussianDiffusionConfig(timesteps=2), m, shape)),
                       ("MCVD", lambda m: McvdEngine(McvdConfig(timesteps=2), m, shape))):
        outs = {}
        for tag, m, dev, queue in (("gpu", model, "cuda", list(draws)), ("cpu", cpu_model, "cpu", list(draws)),
                                   ("no noise", cpu_model, "cpu", [draws[0], torch.zeros_like(draws[1])])):
            engine = make(m)
            engine.draw = lambda shape, g, d, concentration=None, q=queue: q.pop(0).to(d)
            with torch.no_grad():
                outs[tag] = engine.sample(None, None, cond.to(dev)).cpu()
        ok, err, limit = _within(outs["gpu"], outs["cpu"], 1e-4)
        ok_neg, err_neg, _ = _within(outs["no noise"], outs["cpu"], 1e-4)
        print(f"[baselines] one {name} step f32, GPU vs CPU: max_abs_err={err:.3e} (limit {limit:.3e}); "
              f"the CPU step without its noise: {err_neg:.3e}")
        if not ok:
            raise AssertionError(f"[baselines] the GPU {name} step disagrees with the CPU: {err} > {limit}")
        if ok_neg:
            raise AssertionError(f"[baselines] the {name} step check accepts a step without its noise")
        worst = max(worst, err / (limit / 1e-4))
    return worst


def phase_baselines(card):
    """The five baselines through the CLI (``train.main``) at SST width, in a
    temporary registry, each: a few train steps and one validation,
    ``mode=test`` (50 members), serving by run id (a seed repeats its
    answer, another does not, the members differ), the diffusion engines
    at 10 sampler steps (the LDM trained and sampled at T = 10), and for
    them one request with the preset's full sampler (DDPM 1000, MCVD
    1000 + the final denoise, LDM-DDPM 1000 forwards) at 20 members. B1's
    launches are set to 0 before each command and request and must read
    what its forwards imply (6 per ``Unet`` forward). B1 is first held
    against its plain version at the path's rows (train 4, eval 20, 40 and
    100; 8, ``[spatial]``'s DDPM train step) and dtype (f32); then one DDPM
    and one MCVD step GPU against CPU; a
    negative control shows that a sampler whose members share their noise
    fails the members-differ check. The trained DDPM and MCVD runs are
    exported with their full samplers (batch pinned to the request's 1 row)
    in the background; at the phase's end each artifact, loaded in a fresh
    process, answers the full request at the eager one's batch and seed, bit
    for bit or within 1e-5 of max with the difference printed, with B1
    6,000 / 6,006 times. Returns {method: B1 launches of all its commands
    and requests}, the per-request counts, and the artifacts' counts."""
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
    from dyffusion_tpu_torch.utils.workloads import sst_baseline_overrides

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    max_err = 0.0
    # train batch; [spatial]'s DDPM train step (B8); 20 members x 1 (seed checks, the full requests), x 2
    # (eval); 50 x 2 (test)
    for B in (4, 8, 20, 40, 100):
        for N in (3600, 900, 225):
            qkv = _qkv(B, N, torch.float32, True, gen)
            got = la.linear_attention_qkv(qkv, 4, 32, 32**-0.5)
            _sync()
            want = la.linear_attention_qkv_plain(qkv, 4, 32, 32**-0.5)
            e = _check_vs_plain(f"B1 B={B} N={N} float32 nchw-view (baselines)", got, want, REL_TOL["float32"],
                                negative_controls=N == 3600)
            max_err = max(max_err, e)

    totals, per_request, timings = {}, {}, {}
    pipelines, eager_full, artifacts = {}, {}, {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_baselines_") as reg, \
            tempfile.TemporaryDirectory(prefix="chip_smoke_baseline_artifacts_") as work, \
            contextlib.ExitStack() as stops:
        common = sst_baseline_overrides([*BASELINE_DATA, f"trainer.max_steps={BASELINE_TRAIN_STEPS}",
                                         "trainer.val_every_n_epochs=100", "trainer.log_every_n_steps=1",
                                         f"registry_dir={reg}"])
        for method in BASELINES:
            tag = f"[baselines-{method}]"
            args = list(common)
            if method in ("ddpm", "mcvd"):
                args.append(f"diffusion.sampling_timesteps={BASELINE_EVAL_STEPS}")
            elif method == "ddpm_v2":  # no subsampling: the LDM runs its commands at T = 10
                args.append(f"diffusion.timesteps={BASELINE_EVAL_STEPS}")
            run_id = get_run_id(get_config(f"synthetic_{method}", args))
            counts, seconds = {}, {}

            def step(name, fn):
                la.reset_launches()
                _sync()
                t = time.perf_counter()
                out = fn()
                _sync()
                counts[name], seconds[name] = la.launches, time.perf_counter() - t
                print(f"{tag} {name}: {seconds[name]:.2f} s, B1 launches {counts[name]}; on {card}")
                return out

            best = step("train + validation", lambda: train.main([f"experiment=synthetic_{method}", *args]))
            losses = [r["train/loss"] for r in registry_api.get_run_metrics(reg, run_id) if "train/loss" in r]
            crps = step("mode=test, 50 members", lambda: train.main(["mode=test", f"run_id={run_id}", f"registry_dir={reg}"]))

            def serve():
                predict, _, info = build_predict_fn(reg, run_id)
                trainer = reload_trainer(reg, run_id)
                batch = next(trainer.datamodule.predict_batches())
                one = {k: v[:1] for k, v in batch.items()}
                return trainer, info, batch, [predict(one, s) for s in (SEED, SEED, SEED + 1)]

            trainer, info, batch, (a, b, other) = step("serving by run id, 3 requests", serve)
            exp = trainer.experiment
            n_attn = sum(isinstance(m, LinearAttention) for m in exp.model.modules())
            fwd = _sampler_forwards(exp)
            n_eval = 1  # one val and one test batch
            expected = {"train + validation": n_attn * (BASELINE_TRAIN_STEPS + n_eval * fwd),
                        "mode=test, 50 members": n_attn * n_eval * fwd, "serving by run id, 3 requests": 3 * n_attn * fwd}
            repeat, apart = float((a - b).abs().max()), float((a - other).abs().max())
            spread = float(a.std(dim=0).max())
            print(f"{tag} losses {np.round(losses, 5).tolist()}; best val/crps {best:.5f}; test/crps {crps:.5f}; "
                  f"served {tuple(a.shape)} ({info['ensemble_members']} members, {fwd} forwards per request): "
                  f"same seed max diff {repeat:.3e}, other seed {apart:.3e}, member spread {spread:.3e}")
            if len(losses) != BASELINE_TRAIN_STEPS or not np.isfinite(losses).all() or not np.isfinite([best, crps]).all():
                raise AssertionError(f"{tag} a non-finite loss or score: {losses}, {best}, {crps}")
            if not bool(torch.isfinite(a).all()) or repeat != 0 or not apart > 1e-3 * float(a.abs().max()):
                raise AssertionError(f"{tag} a seed did not repeat ({repeat}) or another gave the same answer ({apart})")
            if not spread > 0:
                raise AssertionError(f"{tag} the members do not differ")

            if method in BASELINE_DIFFUSION:
                engine = exp.diffusion_engine
                if method == "ddpm":
                    with torch.no_grad():  # negative control: members sharing their noise
                        def shared(shape, g, d, concentration=None, draw=engine.draw):
                            n = exp.num_members("predict")
                            one = draw((shape[0] // n,) + tuple(shape[1:]), g, d)
                            return one.repeat((n,) + (1,) * (len(shape) - 1))
                        engine.draw = shared
                        one = {k: v[:1] for k, v in batch.items()}
                        same = trainer.eval_fns["predict"](one, torch.Generator(device="cuda").manual_seed(SEED),
                                                           trainer.state.eval_params())["t1_preds"]
                        del engine.draw
                    if float(same.std(dim=0).max()) > 0:
                        raise AssertionError(f"{tag} members sharing their noise still differ: the check cannot fail")
                    print(f"{tag} negative control: members sharing their noise spread "
                          f"{float(same.std(dim=0).max()):.3e} (must be 0)")
                full = ["diffusion.sampling_timesteps=null"] if method in ("ddpm", "mcvd") else [
                    f"diffusion.timesteps={BASELINE_FULL_STEPS}"]

                def full_request():
                    predict, _, info = build_predict_fn(reg, run_id, overrides=full)
                    la.reset_launches()
                    _sync()
                    t = time.perf_counter()
                    # one row x 20 members, for the full run's time limit
                    out = predict({k: v[:1] for k, v in batch.items()}, SEED)
                    _sync()
                    return out, time.perf_counter() - t, la.launches

                trainer_full = reload_trainer(reg, run_id, full)
                fwd_full = _sampler_forwards(trainer_full.experiment)
                out, latency, launches = step(f"full sampler request ({fwd_full} forwards)", full_request)
                expected[f"full sampler request ({fwd_full} forwards)"] = n_attn * fwd_full
                rows = out.shape[0] * out.shape[1]
                print(f"{tag} full-sampler request: {latency:.3f} s for {out.shape[0]} members x eval batch "
                      f"{out.shape[1]} ({rows} rows per forward), {fwd_full} forwards, "
                      f"{latency / fwd_full * 1e3:.2f} ms per forward, B1 {launches}; on {card}")
                if not bool(torch.isfinite(out).all()) or not float(out.std(dim=0).max()) > 0:
                    raise AssertionError(f"{tag} the full-sampler request is not finite or its members do not differ")
                per_request[method] = launches
                timings[method] = latency
                if method in BASELINE_ARTIFACTS:  # the artifact of the same full sampler, exported meanwhile
                    frames = np.asarray(batch["dynamics"][:1])[:, :info["dynamics_frames"]]
                    np.savez(os.path.join(work, f"{method}_batch.npz"), b=frames)
                    eager_full[method] = (out.cpu().numpy(), latency)
                    pipelines[method] = _ExportPipeline(reg, run_id, os.path.join(work, method),
                                                        full + ["polymorphic_batch=false", "batch_size=1"])
                    stops.callback(pipelines[method].stop)
                if method == "ddpm":
                    _baseline_one_step_vs_cpu(exp.model, batch["dynamics"].shape[2:4])
            else:
                per_request[method] = counts["serving by run id, 3 requests"] // 3
            if counts != expected:
                raise AssertionError(f"{tag} B1 launches {counts} != {expected}")
            totals[method] = sum(counts.values())
        for method, pipeline in pipelines.items():  # the GPU is free of the phase's other work now
            tag = f"[baselines-{method}]"
            rep = pipeline.request({"batches": os.path.join(work, f"{method}_batch.npz"),
                                    "requests": [["full", "b", SEED]], "out": os.path.join(work, f"{method}_out.npz")},
                                   timeout=1200)
            have = np.load(os.path.join(work, f"{method}_out.npz"))["full"]
            (want, eager_s), g = eager_full[method], rep["manifest"]["graph"]
            diff = float(np.abs(have - want).max()) if have.shape == want.shape else float("inf")
            scale = float(np.abs(want).max())
            print(f"{tag} full-sampler artifact: {g['nodes']} graph nodes in all, {g['loops']} loop op(s), "
                  f"{g['b1_nodes']} B1 nodes; trace {g['export_seconds']:.1f} s, CLI export {pipeline.export_wall:.1f} s, "
                  f"load in a fresh process {pipeline.loaded['loaded']:.1f} s; its one request "
                  f"{rep['seconds']['full']:.3f} s (eager {eager_s:.3f} s), B1 {rep['launches']['full']}; vs the eager "
                  f"full request {'bit for bit' if diff == 0 else f'max diff {diff:.3e}, {diff / scale:.2e} of max'} "
                  f"(limit 1e-5 of max); on {card}")
            if not diff <= 1e-5 * scale:
                raise AssertionError(f"{tag} the full-sampler artifact disagrees with eager: {diff:.3e} of {scale:.3e}")
            if rep["launches"]["full"] != per_request[method]:
                raise AssertionError(f"{tag} the artifact launched B1 {rep['launches']['full']} times, eager "
                                     f"{per_request[method]}")
            artifacts[method] = {"launches": rep["launches"]["full"], "per_request": rep["launches"]["full"]}
    print(f"[baselines] B1 launches per request {per_request}; full-sampler request times "
          f"{ {m: round(t, 3) for m, t in timings.items()} } s; B1 max_abs_err {max_err:.3e}; on {card}")
    return totals, per_request, artifacts


# The MCVD NCSN++ path (utils/workloads.py::NCSNPP_CORE: MCVD's published
# width on its 64x64 grid, f32, 20 members): 4 train steps at batch 4 and
# one validation (40 rows, sampling subsampled to 10 steps + the denoise),
# mode=test (50 members x 2 rows), serving's seed checks on one row, and one
# request with the preset's full sampler (1000 steps + the denoise = 1001
# forwards at 10 members x one row = 10 rows: the request is launch-bound,
# and 20 rows cost ~6 s more of the run's time).
NCSNPP_TRAIN_STEPS = 4
NCSNPP_EVAL_STEPS = 10
NCSNPP_FULL_FORWARDS = 1001
NCSNPP_FULL_BATCH = 1  # rows of the full-sampler request
NCSNPP_FULL_MEMBERS = 10  # its members (cut from 20 for the run's time)
NCSNPP_BUSY_STEPS = 20
NCSNPP_DATA = ["datamodule.n_traj=5", "datamodule.n_time=9", "datamodule.batch_size=4",
               "datamodule.eval_batch_size=2"]
FIR_TAPS = [1.0, 2.0, 5.0, 3.0]  # asymmetric: the unflipped kernel gives other numbers


def _ncsnpp_pair(name, gen):
    """A full-width NCSN++ (``name``: 'ncsnpp' or 'ncsnpp_spade'; the model
    section of the workload's config) for 7 frames after 1 on 64x64, with
    seeded weights moved off their near-zero output init by N(0, 0.05)
    draws: on the CPU, and a copy on the GPU."""
    import copy

    import torch

    from dyffusion_tpu_torch.config import get_config
    from dyffusion_tpu_torch.models import BackboneSpec, build_backbone
    from dyffusion_tpu_torch.utils.workloads import ncsnpp_overrides

    model_cfg = get_config("synthetic_mcvd", ncsnpp_overrides([f"model.name={name}"]))["model"]
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(SEED)
        cpu = build_backbone(model_cfg, BackboneSpec(7, 7, 1, spatial_shape=(64, 64)))
    with torch.no_grad():
        for p in cpu.parameters():
            p.add_(0.05 * torch.randn(p.shape, generator=gen))
    return cpu, copy.deepcopy(cpu).cuda()


def phase_ncsnpp_reference():
    """GPU against CPU, f32 (TF32 off), each check with a negative control
    that must fail it: the FIR ops at the ladder's shapes with an
    asymmetric kernel (control: the kernel unflipped); an NCSN++ and a SPADE
    NCSN++ forward at full width on 2 rows (control: the condition moved by
    one pixel); one MCVD loss and every gradient at fixed t with the same
    noise (control: the loss without its condition); three levels of
    annealed Langevin dynamics with the draws made on the CPU (control: the
    last draw zeroed). Tolerance: 1e-4 of max|CPU| for outputs and the loss,
    1e-3 of each gradient's scale (as ``[train-ref]``)."""
    import torch

    from dyffusion_tpu_torch.diffusion import McvdConfig, McvdEngine, anneal_langevin_dynamics, get_sigmas
    from dyffusion_tpu_torch.ops import upfirdn2d as fir

    tag, r = "[ncsnpp-ref]", 1e-4
    gen = torch.Generator().manual_seed(SEED)
    start = time.perf_counter()

    def check(label, got, want, control):
        ok, err, limit = _within(got.cpu(), want, r)
        ok_neg, err_neg, _ = _within(control.cpu(), want, r)
        print(f"{tag} {label}: max_abs_err={err:.3e} (limit {limit:.3e}); negative control {err_neg:.3e}")
        if not ok:
            raise AssertionError(f"{tag} {label}: the GPU disagrees with the CPU: {err} > {limit}")
        if ok_neg:
            raise AssertionError(f"{tag} {label}: the negative control passed the check")

    w = torch.randn(64, 64, 3, 3, generator=gen) * 0.05
    for C, S in ((64, 64), (128, 32), (192, 16), (256, 8)):  # the BigGAN ladder's resampled activations
        x = torch.randn(40, C, S, S, generator=gen)
        for name, op in (("upsample_2d", fir.upsample_2d), ("downsample_2d", fir.downsample_2d)):
            check(f"{name} {tuple(x.shape)}", op(x.cuda(), FIR_TAPS), op(x, FIR_TAPS), op(x, FIR_TAPS[::-1]))
    x = torch.randn(40, 64, 32, 32, generator=gen)
    for name, op in (("upsample_conv_2d", fir.upsample_conv_2d), ("conv_downsample_2d", fir.conv_downsample_2d)):
        check(f"{name} {tuple(x.shape)}", op(x.cuda(), w.cuda(), FIR_TAPS), op(x, w, FIR_TAPS),
              op(x, w, FIR_TAPS[::-1]))

    x = torch.randn(2, 7, 64, 64, generator=gen)
    cond = torch.randn(2, 1, 64, 64, generator=gen)
    t = torch.tensor([3.0, 517.0])
    for name in ("ncsnpp", "ncsnpp_spade"):
        cpu, gpu = _ncsnpp_pair(name, gen)
        with torch.no_grad():
            want = cpu(x, t, cond)
            got = gpu(x.cuda(), t.cuda(), cond.cuda())
            control = cpu(x, t, torch.roll(cond, 1, dims=-1))
        check(f"{name} forward nf 64, 2 rows", got, want, control)
        if name == "ncsnpp":
            model_cpu, model_gpu = cpu, gpu

    losses, grads = {}, {}
    noise = torch.randn(2, 7, 64, 64, generator=gen)
    t_rows = torch.tensor([100, 900])
    for tag2, model, dev, c in (("gpu", model_gpu, "cuda", cond), ("cpu", model_cpu, "cpu", cond),
                                ("no condition", model_cpu, "cpu", torch.zeros_like(cond))):
        engine = McvdEngine(McvdConfig(timesteps=1000), model, (7, 64, 64))
        engine.draw = lambda shape, g, d, concentration=None: noise.to(d)
        model.zero_grad()
        loss, _ = engine.p_losses(None, None, x.to(dev), c.to(dev), t_rows.to(dev))
        loss.backward()
        losses[tag2] = float(loss.detach())
        grads[tag2] = {k: p.grad.cpu() for k, p in model.named_parameters() if p.grad is not None}
    rg = 1e-3
    ok, worst = _grads_within(grads["gpu"], grads["cpu"], rg)
    ok_neg, worst_neg = _grads_within(grads["no condition"], grads["cpu"], rg)
    rel = abs(losses["gpu"] - losses["cpu"]) / abs(losses["cpu"])
    rel_neg = abs(losses["no condition"] - losses["cpu"]) / abs(losses["cpu"])
    print(f"{tag} MCVD loss f32 at t={t_rows.tolist()}: GPU {losses['gpu']:.7f} vs CPU {losses['cpu']:.7f} "
          f"(rel {rel:.2e}, limit {r}); {len(grads['cpu'])} gradients: worst {worst * rg:.2e} of its scale "
          f"(limit {rg}); negative control (no condition): loss rel {rel_neg:.2e}, gradients {worst_neg * rg:.2e}")
    if rel > r or not ok or set(grads["gpu"]) != set(grads["cpu"]):
        raise AssertionError(f"{tag} the GPU MCVD loss or its gradients disagree with the CPU")
    if ok_neg:
        raise AssertionError(f"{tag} the gradient check accepts a loss without its condition")

    sigmas = get_sigmas("geometric", 1.0, 0.01, 3)
    draws = [torch.randn(2, 7, 64, 64, generator=gen) for _ in range(3)]
    outs = {}
    for tag2, model, dev, queue in (("gpu", model_gpu, "cuda", list(draws)), ("cpu", model_cpu, "cpu", list(draws)),
                                    ("zeroed draw", model_cpu, "cpu", draws[:2] + [torch.zeros_like(draws[2])])):
        with torch.no_grad():
            outs[tag2] = anneal_langevin_dynamics(model, None, None, noise.to(dev), cond.to(dev), sigmas,
                                                  draw=lambda shape, g, d, q=queue: q.pop(0).to(d))
    check("anneal_langevin_dynamics, 3 levels + denoise (4 forwards)", outs["gpu"], outs["cpu"], outs["zeroed draw"])
    print(f"{tag} phase wall time {time.perf_counter() - start:.1f} s")


def phase_ncsnpp(card):
    """MCVD over NCSN++ through the CLI (``train.main``) at MCVD's published
    width (:data:`NCSNPP_CORE`), f32, in a temporary registry: 4 train
    steps at batch 4 and one validation (sampling subsampled to 10 steps);
    ``mode=test`` (50 members); serving by run id (a seed repeats its
    answer, another does not, the members differ; members sharing their
    noise must fail that check); one request with the full sampler (1001
    forwards at 10 rows), timed, and the busy share of a 21-forward request
    of the same run under the CUDA-activity profiler. Then three short commands: the
    Fourier time embedding with the EMA (its features must stay bit for bit
    as initialized, in the weights and the EMA), the DDPM residual blocks,
    and the SPADE variant. No kernel of the port lies on this path: the
    launch counts are set to 0 before it and must read 0 after. Returns
    them."""
    import numpy as np
    import torch

    from dyffusion_tpu_torch import train
    from dyffusion_tpu_torch.config import get_config
    from dyffusion_tpu_torch.interface import build_experiment, get_datamodule, reload_trainer
    from dyffusion_tpu_torch.ops import fused_act as fa
    from dyffusion_tpu_torch.ops import linear_attention as la
    from dyffusion_tpu_torch.serving import build_predict_fn
    from dyffusion_tpu_torch.training.checkpoint import CheckpointManager
    from dyffusion_tpu_torch.utils import registry_api
    from dyffusion_tpu_torch.utils.naming import get_run_id
    from dyffusion_tpu_torch.utils.workloads import ncsnpp_overrides

    tag = "[ncsnpp]"
    start = time.perf_counter()
    la.reset_launches()
    fa.reset_launches()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_ncsnpp_") as reg:
        common = ncsnpp_overrides([*NCSNPP_DATA, f"trainer.max_steps={NCSNPP_TRAIN_STEPS}",
                                   "trainer.val_every_n_epochs=100", "trainer.log_every_n_steps=1",
                                   f"diffusion.sampling_timesteps={NCSNPP_EVAL_STEPS}", f"registry_dir={reg}"])
        run_id = get_run_id(get_config("synthetic_mcvd", common))

        def step(name, fn):
            torch.cuda.reset_peak_memory_stats()
            _sync()
            t = time.perf_counter()
            out = fn()
            _sync()
            print(f"{tag} {name}: {time.perf_counter() - t:.2f} s, peak memory "
                  f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; on {card}")
            return out

        def losses(rid, n):
            vals = np.asarray([r["train/loss"] for r in registry_api.get_run_metrics(reg, rid) if "train/loss" in r])
            if len(vals) != n or not np.isfinite(vals).all():
                raise AssertionError(f"{tag} {rid}: train losses missing or not finite: {vals}")
            return vals

        best = step(f"train {NCSNPP_TRAIN_STEPS} steps + validation ({NCSNPP_EVAL_STEPS}+1 forwards, 40 rows)",
                    lambda: train.main(["experiment=synthetic_mcvd", *common]))
        vals = losses(run_id, NCSNPP_TRAIN_STEPS)
        half = len(vals) // 2
        print(f"{tag} train losses {np.round(vals, 5).tolist()}; best val/crps {best:.5f}")
        if not np.isfinite(best) or not vals[half:].mean() < vals[:half].mean():
            raise AssertionError(f"{tag} the losses do not fall or the validation is not finite: {vals}, {best}")
        crps = step("mode=test, 50 members", lambda: train.main(
            ["mode=test", f"run_id={run_id}", f"registry_dir={reg}"]))

        def serve():
            predict, _, info = build_predict_fn(reg, run_id)
            trainer = reload_trainer(reg, run_id)
            batch = next(trainer.datamodule.predict_batches())
            one = {k: v[:1] for k, v in batch.items()}
            return trainer, info, batch, [predict(one, s) for s in (SEED, SEED, SEED + 1)]

        trainer, info, batch, (a, b, other) = step("serving by run id, 3 requests on one row", serve)
        repeat, apart, spread = float((a - b).abs().max()), float((a - other).abs().max()), float(a.std(dim=0).max())
        exp = trainer.experiment
        engine = exp.diffusion_engine
        with torch.no_grad():  # negative control: members sharing their noise
            def shared(shape, g, d, concentration=None, draw=engine.draw):
                n = exp.num_members("predict")
                first = draw((shape[0] // n,) + tuple(shape[1:]), g, d)
                return first.repeat((n,) + (1,) * (len(shape) - 1))
            engine.draw = shared
            one = {k: v[:1] for k, v in batch.items()}
            same = trainer.eval_fns["predict"](one, torch.Generator(device="cuda").manual_seed(SEED),
                                               trainer.state.eval_params())["t1_preds"]
            del engine.draw
        print(f"{tag} test/crps {crps:.5f}; served {tuple(a.shape)} ({info['ensemble_members']} members): same seed "
              f"max diff {repeat:.3e}, other seed {apart:.3e}, member spread {spread:.3e}; negative control: members "
              f"sharing their noise spread {float(same.std(dim=0).max()):.3e} (must be 0)")
        if not np.isfinite(crps) or not bool(torch.isfinite(a).all()):
            raise AssertionError(f"{tag} a non-finite test score or forecast")
        if repeat != 0 or not apart > 1e-3 * float(a.abs().max()) or not spread > 0:
            raise AssertionError(f"{tag} a seed did not repeat ({repeat}), another gave the same answer ({apart}) "
                                 f"or the members do not differ ({spread})")
        if float(same.std(dim=0).max()) > 0:
            raise AssertionError(f"{tag} members sharing their noise still differ: the check cannot fail")

        members = [f"module.num_predictions={NCSNPP_FULL_MEMBERS}"]
        full = ["diffusion.sampling_timesteps=null", *members]
        predict_full, _, _ = build_predict_fn(reg, run_id, overrides=full)
        fwd = _sampler_forwards(reload_trainer(reg, run_id, full).experiment)
        # one row of the predict batch at 10 members (10 rows a forward), for the clock of the whole run
        batch = {k: v[:NCSNPP_FULL_BATCH] for k, v in batch.items()}
        rows = NCSNPP_FULL_MEMBERS * batch["dynamics"].shape[0]
        out = step(f"full-sampler request ({fwd} forwards, {rows} rows)", lambda: predict_full(batch, SEED))
        if fwd != NCSNPP_FULL_FORWARDS or not bool(torch.isfinite(out).all()) or not float(out.std(dim=0).max()) > 0:
            raise AssertionError(f"{tag} the full-sampler request ({fwd} forwards) is not finite or its members agree")
        # the busy share, from the profiler over a request of the same run and rows with fewer steps:
        # every forward is the same work, and the profiler's processing of the full request's
        # 1.14 million kernel records takes minutes (--profile does it, by category)
        window = [f"diffusion.sampling_timesteps={NCSNPP_BUSY_STEPS}", *members]
        predict_window, _, _ = build_predict_fn(reg, run_id, overrides=window)
        fwd_window = _sampler_forwards(reload_trainer(reg, run_id, window).experiment)
        _profile(f"{tag} busy share over a {fwd_window}-forward request of the same run ({rows} rows):",
                 lambda: predict_window(batch, SEED), card, detail=False)

        short = [o for o in common if not o.startswith(("trainer.max_steps", "diffusion.sampling_timesteps"))]
        short += ["trainer.max_steps=2", "diffusion.sampling_timesteps=2"]
        fourier = short + ["model.embedding_type=fourier", "module.use_ema=true"]
        config = get_config("synthetic_mcvd", fourier)
        dm = get_datamodule(config)
        dm.setup()
        init = build_experiment(config, dm, device="cpu")[1]
        W0, dense0 = init.fourier_emb.W.detach().clone(), init.all_modules[0].weight.detach().clone()
        del init
        for name, args in (("fourier embedding + EMA", fourier), ("DDPM residual blocks", short +
                           ["model.resblock_type=ddpm"]), ("SPADE", short + ["model.name=ncsnpp_spade"])):
            rid = get_run_id(get_config("synthetic_mcvd", args))
            score = step(f"{name}: 2 steps + validation", lambda: train.main(["experiment=synthetic_mcvd", *args]))
            vals = losses(rid, 2)
            print(f"{tag} {name}: losses {np.round(vals, 5).tolist()}, best val/crps {score:.5f}")
            if not np.isfinite(score):
                raise AssertionError(f"{tag} {name}: the validation is not finite")
            if args is fourier:
                saved = CheckpointManager(os.path.join(reg, rid), "val/crps").restore("last")
                kept = [torch.equal(saved[s]["fourier_emb.W"].cpu(), W0) for s in ("model", "ema")]
                moved = not torch.equal(saved["model"]["all_modules.0.weight"].cpu(), dense0)
                print(f"{tag} the Fourier features unchanged in the weights and the EMA: {kept}; "
                      f"the time MLP moved: {moved}")
                if not all(kept) or not moved:
                    raise AssertionError(f"{tag} the Fourier features changed, or nothing trained")
    counts = {"linear_attention_qkv": la.launches, "linear_attention_core": la.core_launches,
              "fused_leaky_relu": fa.launches}
    print(f"{tag} kernel launches on this path {counts} (must be 0: NCSN++ runs none of B1-B3); phase wall time "
          f"{time.perf_counter() - start:.1f} s; on {card}")
    if any(counts.values()):
        raise AssertionError(f"{tag} a kernel launched on the NCSN++ path: {counts}")
    return counts


# kernel categories of the profile, by a substring of the kernel's name;
# the first match wins, and what matches nothing is "other elementwise"
_CATEGORIES = (
    ("B1 linear attention", ("linear_attention",)),
    ("FIR depthwise convs (upfirdn2d)", ("depthwise",)),
    ("cuDNN FFT convolutions", ("fft", "pointwise_mult_and_sum_complex")),
    ("FIR zero-stuffing pads", ("constant_pad",)),
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


def _profile(tag, fn, card, detail=True):
    """Run ``fn`` once under ``torch.profiler`` (CUDA activity only, so the
    host records no operators) and print its wall time, summed kernel time,
    busy share (kernel time over wall time; the profiler's host work can
    only lower it) and, with ``detail``, kernel time by category and the
    top kernels. Returns {kernel name: ms}."""
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
    if not detail:
        return ms
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


def phase_profile_baseline(card):
    """One DDPM request with the preset's full sampler (1000 forwards, SST
    width, f32, 20 members x eval batch 2, seeded random weights) under the
    profiler, after a warm-up request."""
    from dyffusion_tpu_torch.config import get_config
    from dyffusion_tpu_torch.interface import build_experiment, get_datamodule
    from dyffusion_tpu_torch.serving import build_experiment_predict_fn
    from dyffusion_tpu_torch.utils.workloads import sst_baseline_overrides

    config = get_config("synthetic_ddpm", sst_baseline_overrides([*BASELINE_DATA, "trainer.save_checkpoints=False"]))
    dm = get_datamodule(config)
    dm.setup()
    exp, _, _, eval_fns, _ = build_experiment(config, dm)
    predict, _, _ = build_experiment_predict_fn(exp, eval_fns, dm, None)
    batch = next(dm.predict_batches())
    _sync()
    t = time.perf_counter()
    predict(batch, SEED)  # warm-up
    _sync()
    print(f"[profile-ddpm] unprofiled request {time.perf_counter() - t:.4f} s ({_sampler_forwards(exp)} forwards)")
    _profile(f"[profile-ddpm] one DDPM request ({_sampler_forwards(exp)} forwards, "
             f"{exp.num_members('predict') * batch['dynamics'].shape[0]} rows):", lambda: predict(batch, SEED + 1), card)


def phase_profile_ncsnpp(card):
    """One MCVD request over the full-width NCSN++ with the preset's full
    sampler (1001 forwards, f32, 20 members x eval batch 2, seeded random
    weights): unprofiled (it also warms up), then under the profiler; then
    unprofiled again with ``torch.backends.cudnn.benchmark`` on (cuDNN times
    its algorithms per shape instead of taking its heuristic's pick; the
    search runs in a 2-forward request first), and the setting restored."""
    import torch

    from dyffusion_tpu_torch.config import get_config
    from dyffusion_tpu_torch.interface import build_experiment, get_datamodule
    from dyffusion_tpu_torch.serving import build_experiment_predict_fn
    from dyffusion_tpu_torch.utils.workloads import ncsnpp_overrides

    def predictor(extra):
        config = get_config("synthetic_mcvd", ncsnpp_overrides([*NCSNPP_DATA, "trainer.save_checkpoints=False", *extra]))
        dm = get_datamodule(config)
        dm.setup()
        exp, _, _, eval_fns, _ = build_experiment(config, dm)
        predict, _, _ = build_experiment_predict_fn(exp, eval_fns, dm, None)
        return exp, predict, next(dm.predict_batches())

    def timed(fn):
        _sync()
        t = time.perf_counter()
        fn()
        _sync()
        return time.perf_counter() - t

    exp, predict, batch = predictor([])
    fwd = _sampler_forwards(exp)
    rows = exp.num_members("predict") * batch["dynamics"].shape[0]
    print(f"[profile-ncsnpp] unprofiled request {timed(lambda: predict(batch, SEED)):.4f} s ({fwd} forwards, "
          f"{rows} rows, cudnn.benchmark {torch.backends.cudnn.benchmark})")
    _profile(f"[profile-ncsnpp] one MCVD NCSN++ request ({fwd} forwards, {rows} rows):",
             lambda: predict(batch, SEED + 1), card)
    before = torch.backends.cudnn.benchmark
    torch.backends.cudnn.benchmark = True
    try:
        _, short, _ = predictor(["diffusion.sampling_timesteps=1"])
        search = timed(lambda: short(batch, SEED))
        print(f"[profile-ncsnpp] cudnn.benchmark on: the 2-forward request with the algorithm search {search:.4f} s; "
              f"then the full request {timed(lambda: predict(batch, SEED + 1)):.4f} s ({fwd} forwards); on {card}")
    finally:
        torch.backends.cudnn.benchmark = before


# [oisst]: the OISST presets through the CLI at their full width (section 4
# of PERF.md) on fake Pacific boxes written by the port, cut to these days:
# 31 of 2018 (11 boxes x 24 windows = 264 train rows: one folded stage-1
# batch of 256 and two stage-2 batches of 128 per epoch), 13 of 2019 with
# validation on one box (6 rows: one eval batch of 6), 8 of 2020 (one window
# per box: 11 rows, 50-member test batches of 6 and 5; the predict slice is
# set to the same days for serving). Eval in bf16 with the members folded,
# as [slice] serves.
OISST_DAYS = {2018: 31, 2019: 13, 2020: 8}
OISST_STAGE1_STEPS = 32  # micro-batches of 64: 8 optimizer steps at B256, folded
OISST_STAGE2_STEPS = 16  # micro-batches of 128: 8 optimizer steps, accumulate 2
OISST_PREDICT = ["datamodule.predict_slice=('2020-01-01','2020-01-08')"]


def _oisst_archive(root):
    """The 11 Pacific boxes at 60x60 from ``write_fake_oisst_dir``, cut to
    ``OISST_DAYS``; returns the archive's directory."""
    import glob

    import numpy as np

    from dyffusion_tpu_torch.data.oisstv2 import PACIFIC_BOXES, write_fake_oisst_dir

    data_dir = write_fake_oisst_dir(root, boxes=PACIFIC_BOXES, n_days_per_year=max(OISST_DAYS.values()), seed=SEED)
    for path in glob.glob(os.path.join(data_dir, "*", "sst.day.mean.box*.npz")):
        with np.load(path) as f:
            sst, days = f["sst"], f["time"]
        year = days.astype("datetime64[Y]").astype(int) + 1970
        day_of_year = (days - days.astype("datetime64[Y]")).astype(int)
        keep = np.zeros(len(days), bool)
        for y, n in OISST_DAYS.items():
            keep |= (year == y) & (day_of_year < n)
        np.savez_compressed(path, sst=sst[keep], time=days[keep])
    return data_dir


def phase_oisst(card):
    """The OISST path through ``train.main`` at the presets' full width
    (60x60, C=1, h=7, k=25, Unet dim 64 mults (1,2,4), 20 members, eval
    batch 6) on ``_oisst_archive``, in a temporary registry:
    ``oisst_pacific_interpolation perf=measured`` (stage 1 folded: B64 x 4
    as one batch of 256), ``oisst_pacific_dyffusion perf=measured`` with the
    stage-1 run id (B128 x accumulate 2, remat), ``mode=test`` (50 members),
    then ``serving.build_predict_fn`` by run id. Checks: the run ids equal
    the parity layout's; finite, falling losses; the layouts of both runs;
    B1's launches per command, from its steps and validations, and 378 per
    request; seeds repeat and differ and the members spread; the prefetched,
    device-staged batches of the stage-2 run equal host indexing; one
    ``watch_gradients`` step gives finite norms and histograms that count
    every weight; each command's peak memory fits the card. Prints each
    command's wall time and peak memory, the train steps/s of both recipes,
    the request latency at eval batch 6, and ``device_memory_report()``.
    Returns (B1 launches of the phase, per request)."""
    import numpy as np
    import torch

    from dyffusion_tpu_torch import train
    from dyffusion_tpu_torch.config import get_config
    from dyffusion_tpu_torch.data.native_loader import DeviceStager, native_available
    from dyffusion_tpu_torch.interface import accumulation_layout, get_datamodule, reload_trainer
    from dyffusion_tpu_torch.models.modules import LinearAttention
    from dyffusion_tpu_torch.ops import linear_attention as la
    from dyffusion_tpu_torch.serving import build_predict_fn
    from dyffusion_tpu_torch.utils import registry_api
    from dyffusion_tpu_torch.utils.naming import get_run_id
    from dyffusion_tpu_torch.utils.profiling import device_memory_report
    from dyffusion_tpu_torch.utils.workloads import SST_FAST_EVAL

    tag = "[oisst]"
    t_phase = time.perf_counter()
    if not native_available():
        raise AssertionError(f"{tag} the native batch gather is not available")
    total_gib = torch.cuda.get_device_properties(0).total_memory / 2**30
    with tempfile.TemporaryDirectory(prefix="chip_smoke_oisst_") as root:
        data_dir = _oisst_archive(os.path.join(root, "data"))
        reg = os.path.join(root, "registry")
        common = [
            f"datamodule.data_dir={data_dir}", "datamodule.validation_boxes=[84]", *SST_FAST_EVAL,
            "trainer.val_every_n_epochs=100", "trainer.log_every_n_steps=1", f"registry_dir={reg}",
        ]
        c1 = [*common, f"trainer.max_steps={OISST_STAGE1_STEPS}"]
        id1 = get_run_id(get_config("oisst_pacific_interpolation", c1))
        c2 = [*common, f"diffusion.interpolator_run_id={id1}", f"trainer.max_steps={OISST_STAGE2_STEPS}"]
        id2 = get_run_id(get_config("oisst_pacific_dyffusion", c2))
        for preset, args, run_id in (("oisst_pacific_interpolation", c1, id1), ("oisst_pacific_dyffusion", c2, id2)):
            if get_run_id(get_config(preset, [*args, "perf=measured"])) != run_id:
                raise AssertionError(f"{tag} perf=measured changed the run id of {preset}")
        commands = {}  # name -> (B1 launches, seconds, peak GiB)

        def command(name, fn):
            la.reset_launches()
            torch.cuda.reset_peak_memory_stats()
            t = time.perf_counter()
            out = fn()
            _sync()
            commands[name] = (la.launches, time.perf_counter() - t, torch.cuda.max_memory_allocated() / 2**30)
            print(f"{tag} {name}: {commands[name][1]:.1f} s wall, B1 launches {commands[name][0]}, peak memory "
                  f"{commands[name][2]:.2f} GiB of {total_gib:.1f}; on {card}")
            return out

        def train_log(run_id):
            rows = [r for r in registry_api.get_run_metrics(reg, run_id) if "train/loss" in r]
            return [r["step"] for r in rows], np.asarray([r["train/loss"] for r in rows]), \
                np.asarray([r["time/train/step"] for r in rows])

        best1 = command("stage 1 perf=measured", lambda: train.main(
            ["experiment=oisst_pacific_interpolation", *c1, "perf=measured"]))
        best2 = command("stage 2 perf=measured from the registry", lambda: train.main(
            ["experiment=oisst_pacific_dyffusion", *c2, "perf=measured"]))
        print(f"{tag} after training: {device_memory_report()}")
        crps = command("mode=test, 50 members", lambda: train.main(["mode=test", f"run_id={id2}", f"registry_dir={reg}"]))

        # one reload of the stage-2 run for the layout, prefetch and watch_gradients checks
        trainer = reload_trainer(reg, id2, overrides=["trainer.watch_gradients=true"])
        layout2 = (trainer.datamodule.batch_size, trainer.state.optimizer.accumulate_grad_batches,
                   trainer.experiment.model.remat)
        cfg1 = registry_api.get_run_config(reg, id1)
        layout1 = (cfg1["datamodule"]["batch_size"] * accumulation_layout(cfg1)[1], accumulation_layout(cfg1))
        dm = trainer.datamodule
        stager, n_checked = DeviceStager("cuda"), 0
        for _ in range(3):  # epochs; each staged batch is read back as it arrives
            seed = int(np.random.default_rng(n_checked).integers(1 << 30))
            host = dm.train_batches(rng=np.random.default_rng(seed))
            for staged, want in zip(dm.train_loader(rng=np.random.default_rng(seed), device_put=stager), host):
                if not torch.equal(staged["dynamics"].cpu(), torch.from_numpy(want["dynamics"])):
                    raise AssertionError(f"{tag} a prefetched batch differs from host indexing")
                n_checked += 1
        la.reset_launches()
        watch = trainer.train_step(trainer.state, trainer._put(next(dm.train_batches(rng=np.random.default_rng(SEED)))))
        _sync()
        watch_launches = la.launches
        n_weights = sum(p.numel() for p in trainer.state.params.values())
        norms = {k: float(v) for k, v in watch.items() if k.endswith("/norm")}
        hists = {k: v.cpu() for k, v in watch.items() if k.endswith("/hist")}
        hist_total = int(sum(h.sum() for h in hists.values()))
        norm2 = sum(v * v for v in norms.values())

        predict_cfg = registry_api.get_run_config(reg, id2)
        predict_dm = get_datamodule({**predict_cfg, "datamodule": {
            **predict_cfg["datamodule"], "predict_slice": ("2020-01-01", "2020-01-08")}})
        batch = next(predict_dm.predict_batches())

        def serve():
            predict, _, info = build_predict_fn(reg, id2, overrides=OISST_PREDICT)
            answers, latencies, counts = [], [], []
            for seed in [SEED] + [SEED + 1 + j for j in range(N_REQUESTS - 1)] + [SEED]:
                before = la.launches
                _sync()
                t = time.perf_counter()
                answers.append(predict(batch, seed))
                _sync()
                latencies.append(time.perf_counter() - t)
                counts.append(la.launches - before)
            return info, answers, latencies, counts

        info, answers, latencies, counts = command(f"serving by run id, {N_REQUESTS + 1} requests", serve)
        # where the request time goes: data+noise blends the condition with
        # f32 weights t/(N-1), so the forecaster's input, and with it the
        # forecaster, runs in f32 under the bf16 eval (in the JAX package
        # too); the same run served with forward_conditioning=data stays bf16
        data_predict, _, _ = build_predict_fn(reg, id2, overrides=[*OISST_PREDICT, "diffusion.forward_conditioning=data"])
        data_predict(batch, SEED)
        la.reset_launches()
        _sync()
        t = time.perf_counter()
        for seed in range(N_REQUESTS):
            data_predict(batch, seed)
        _sync()
        data_latency, data_launches = (time.perf_counter() - t) / N_REQUESTS, la.launches
        steps1, losses1, times1 = train_log(id1)
        steps2, losses2, times2 = train_log(id2)

    exp = trainer.experiment
    n_attn = sum(isinstance(m, LinearAttention) for m in exp.model.modules())
    per_request = n_attn * (2 * len(exp.engine._steps.s) + 1)
    h = exp.cfg.horizon
    n_test_batches = 2
    expected = {
        # one Unet forward per folded step; one per i of the one val batch
        "stage 1 perf=measured": n_attn * (OISST_STAGE1_STEPS // 4 + (h - 1)),
        # 4 forwards per micro-batch, 2 more in the remat recompute; one val request
        "stage 2 perf=measured from the registry": 6 * n_attn * OISST_STAGE2_STEPS + per_request,
        "mode=test, 50 members": n_test_batches * per_request,
        f"serving by run id, {N_REQUESTS + 1} requests": (N_REQUESTS + 1) * per_request,
    }
    got = {name: n for name, (n, _, _) in commands.items()}
    # steps/s of the optimizer; the first logged step holds the warm-up
    s1, s2 = float(np.median(times1[1:])), float(np.median(times2[1:]))
    print(f"{tag} stage 1 (B256 folded): logged steps {steps1}, losses {np.round(losses1, 5).tolist()}; "
          f"{1 / (4 * s1):.3f} steps/s, {64 / s1:.1f} examples/s")
    print(f"{tag} stage 2 (B128 x 2, remat): logged steps {steps2}, losses {np.round(losses2, 5).tolist()}; "
          f"{1 / (2 * s2):.3f} steps/s ({1 / s2:.3f} micro-batches/s), {128 / s2:.1f} examples/s")
    print(f"{tag} layouts: stage 1 physical batch {layout1[0]}, (accumulate, fold) {layout1[1]}; stage 2 "
          f"(batch, accumulate, remat) {layout2}")
    print(f"{tag} best val/crps: stage 1 {best1:.5f}, stage 2 {best2:.5f}; test/crps (50 members) {crps:.5f}")
    print(f"{tag} prefetched batches equal to host indexing: {n_checked}; watch_gradients: {len(norms)} modules, "
          f"sum of squared norms {norm2:.6e} vs grad_norm^2 {float(watch['grad_norm']) ** 2:.6e}, histogram counts "
          f"{hist_total} of {n_weights} weights, B1 launches {watch_launches}")
    timed = latencies[1:N_REQUESTS + 1]
    lat = float(np.mean(timed))
    out = answers[1]
    repeat = float((answers[0] - answers[-1]).abs().max())
    other = float((answers[0] - answers[1]).abs().max())
    spread = float(out.std(dim=0).mean())
    print(f"{tag} served {tuple(out.shape)} ({info['ensemble_members']} members): first request {latencies[0]:.3f} s, "
          f"timed {[round(x, 4) for x in timed]} s, latency {lat:.4f} s at eval batch {out.shape[1]}, "
          f"{out.shape[0] * out.shape[1] * h / lat:.1f} frames/s; B1 per request {counts}; same seed max diff "
          f"{repeat:.3e}, other seed {other:.3e}, member spread {spread:.4f}; on {card}")
    print(f"{tag} the same run served with forward_conditioning=data (bf16 forecaster): latency {data_latency:.4f} s "
          f"({data_latency / lat:.3f} of data+noise's), B1 {data_launches} in {N_REQUESTS} requests")
    if got != expected:
        raise AssertionError(f"{tag} B1 launches {got} != {expected}")
    if any(c != per_request for c in counts) or per_request != 378:
        raise AssertionError(f"{tag} B1 launches per request {counts}, expected 378")
    if steps1 != list(range(4, OISST_STAGE1_STEPS + 1, 4)) or steps2 != list(range(1, OISST_STAGE2_STEPS + 1)):
        raise AssertionError(f"{tag} logged steps {steps1}, {steps2}")
    if layout1 != (256, (1, 4)) or layout2 != (128, 2, True):
        raise AssertionError(f"{tag} the perf=measured layouts are {layout1}, {layout2}")
    for losses in (losses1, losses2):
        half = len(losses) // 2
        if not np.isfinite(losses).all() or not losses[half:].mean() < losses[:half].mean():
            raise AssertionError(f"{tag} losses not finite or not falling: {losses}")
    if not all(np.isfinite(x) for x in (best1, best2, crps)):
        raise AssertionError(f"{tag} a non-finite score: {best1}, {best2}, {crps}")
    if n_checked < 6:
        raise AssertionError(f"{tag} only {n_checked} prefetched batches were checked")
    if watch_launches != 6 * n_attn or not all(np.isfinite(v) for v in norms.values()) or hist_total != n_weights:
        raise AssertionError(f"{tag} watch_gradients: launches {watch_launches}, norms {norms}, counts {hist_total}")
    if not abs(norm2 - float(watch["grad_norm"]) ** 2) <= 1e-3 * norm2:
        raise AssertionError(f"{tag} the module norms do not add up to grad_norm")
    if not (bool(torch.isfinite(out).all()) and repeat == 0 and other > 0.1 and spread > 0):
        raise AssertionError(f"{tag} served forecast: finite, seeds repeat {repeat}, differ {other}, spread {spread}")
    if any(peak >= total_gib for _, _, peak in commands.values()):
        raise AssertionError(f"{tag} a command's peak memory exceeds the card: {commands}")
    print(f"{tag} phase wall time {time.perf_counter() - t_phase:.1f} s")
    return sum(got.values()), per_request


def _b1_path_check(label, shapes, dtype):
    """B1 against its plain version at a path's (rows, tokens) shapes, as
    the ``Unet`` calls it (an NCHW view), with the negative controls at the
    first shape."""
    import torch

    from dyffusion_tpu_torch.ops import linear_attention as la

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    for i, (B, N) in enumerate(shapes):
        qkv = _qkv(B, N, dtype, True, gen)
        got = la.linear_attention_qkv(qkv, 4, 32, 32**-0.5)
        _sync()
        want = la.linear_attention_qkv_plain(qkv, 4, 32, 32**-0.5)
        dt = str(dtype)[6:]
        _check_vs_plain(f"[{label}] B1 B={B} N={N} {dt}", got, want, REL_TOL[dt], negative_controls=i == 0)


# the (rows, tokens) of B1's calls on the unfolded path (6 rows per member,
# 12 in the 2B interpolator call) and on [ddp]'s (32-row train steps;
# eval shards of 3 rows x 20 members: 60 forecaster, 120 interpolator rows)
MEMBERS_B1 = tuple((B, N) for B in (6, 12) for N in (3600, 900, 225))
DDP_B1 = tuple((B, N) for B in (32, 60, 120) for N in (3600, 900, 225))


# [members]: the SST serving slice with the members unfolded (one B-row
# sampler per member, each on its own generator), against the folded layout
# of the same weights in the same process.
def phase_members(card):
    """The unfolded member layout at SST width (``[slice]``'s workload, 20
    members x eval batch 6) with ``module.fold_members_into_batch=false``
    beside the folded layout of the same seeded weights, in this process.
    Dropout off (``generator=None``, so every unfolded member runs the same
    computation and two members stand for all): in f32 (TF32 off) every
    member of a 2-member unfolded request equals the 20-member folded
    answer within 1e-3 of max|folded| (63 network forwards at 6 rows
    against 120; the folded layout at 10 members against 20 is printed
    beside it); in bf16 every member of a 2-member unfolded request equals
    the folded answer at 1 member (the
    same 6-row forwards: bf16 rounding depends on the batch, and the
    sampler carries it to a fifth of the output between 6 and 120 rows)
    within the repo's bf16 tolerance, 1e-2 of max|folded|. The folded
    answer shifted by one row (the negative control) fails both, and the
    members of each layout are bit for bit equal. Dropout on, bf16,
    through ``build_experiment_predict_fn``: a full request (timed; its
    members differ), then 2-member requests at its seed, whose members
    must be the first two of the 20-member answer bit for bit (a seed
    repeats, and a member's answer does not depend on the ensemble size),
    and at another seed (they differ). B1 launches exactly 20 x 378 =
    7,560 times per full unfolded request (its count set to 0 before the
    unfolded path).
    Prints latency, frames/s and peak memory of both layouts. Returns the
    unfolded path's B1 launches and the per-request count."""
    import numpy as np
    import torch

    from dyffusion_tpu_torch.models.modules import LinearAttention
    from dyffusion_tpu_torch.ops import linear_attention as la
    from dyffusion_tpu_torch.serving import build_experiment_predict_fn
    from dyffusion_tpu_torch.utils.workloads import sst_overrides

    _b1_path_check("members", MEMBERS_B1, torch.bfloat16)
    _b1_path_check("members", MEMBERS_B1[:1], torch.float32)
    t0 = time.perf_counter()
    base = ["datamodule.n_traj=5", "datamodule.n_time=13", "datamodule.batch_size=6", "datamodule.eval_batch_size=6",
            "trainer.save_checkpoints=False"]
    dtypes = {"f32": [], "bf16": ["module.eval_dtype=bfloat16"]}
    folded, unfolded = "module.fold_members_into_batch=True", "module.fold_members_into_batch=False"
    layouts = {"folded": [folded], "folded, 10 members": [folded, "module.num_predictions=10"],
               "folded, 1 member": [folded, "module.num_predictions=1"], "unfolded": [unfolded],
               "unfolded, 2 members": [unfolded, "module.num_predictions=2"]}
    variants = [("f32", "folded"), ("f32", "folded, 10 members"), ("f32", "unfolded, 2 members"), ("bf16", "folded"),
                ("bf16", "folded, 1 member"), ("bf16", "unfolded"), ("bf16", "unfolded, 2 members")]
    built = {(dt, lay): _build_slice(sst_overrides(base + dtypes[dt] + layouts[lay]), "cuda") for dt, lay in variants}
    exp, _, dm = built[("bf16", "unfolded")]
    batch = next(dm.predict_batches())
    n_members, B, h = exp.cfg.num_predictions, batch["dynamics"].shape[0], exp.cfg.horizon
    n_attn = sum(isinstance(mod, LinearAttention) for mod in exp.model.modules())
    per_member = n_attn * (2 * len(exp.engine._steps.s) + 1)
    per_request = n_members * per_member
    print(f"[members] {len(built)} slices built in {time.perf_counter() - t0:.1f} s; {n_members} members x batch {B}, "
          f"B1 {per_member} per member")

    def stacked(out):
        return torch.stack([out[k] for k in sorted(out, key=lambda k: (len(k), k)) if k.endswith("_preds")], 2)

    def request(fn, *args):
        before = la.launches
        _sync()
        t = time.perf_counter()
        out = fn(*args)
        _sync()
        return out, time.perf_counter() - t, la.launches - before

    quiet = {}

    def quiet_request(key):  # dropout off
        quiet[key], _, n = request(lambda: stacked(built[key][1]["predict"](batch, None, None)))
        return n

    def served(layout, seeds):  # dropout on, bf16, through the serving entry point
        exp_l, eval_fns, dm_l = built[("bf16", layout)]
        predict = build_experiment_predict_fn(exp_l, eval_fns, dm_l, None)[0]
        torch.cuda.reset_peak_memory_stats()
        resident = torch.cuda.memory_allocated()
        runs = [request(predict, batch, seed) for seed in seeds]
        return runs, torch.cuda.max_memory_allocated() - resident  # peak above the slices' weights

    # the folded requests first: the unfolded path's count starts at 0 after them
    counts, latencies, peaks = {"folded": [quiet_request(("f32", "folded"))]}, {}, {}
    quiet_request(("f32", "folded, 10 members"))
    quiet_request(("bf16", "folded, 1 member"))
    runs, peaks["folded"] = served("folded", (SEED, SEED, SEED + 1))
    latencies["folded"], counts["folded"] = [r[1] for r in runs], counts["folded"] + [r[2] for r in runs]
    la.reset_launches()
    counts["unfolded"] = [quiet_request((dt, "unfolded, 2 members")) for dt in ("f32", "bf16")]
    runs, peaks["unfolded"] = served("unfolded", (SEED,))
    latencies["unfolded"], counts["unfolded"] = [r[1] for r in runs], counts["unfolded"] + [r[2] for r in runs]
    [(a, _, _)] = runs
    runs, _ = served("unfolded, 2 members", (SEED, SEED + 1))
    (two, _, _), (other, _, _) = runs
    counts["unfolded"] += [r[2] for r in runs]
    launches = la.launches

    for key, q in quiet.items():
        assert bool(torch.isfinite(q).all()) and (q == q[:1]).all(), f"{key}: dropout-off members differ"
    assert quiet[("f32", "unfolded, 2 members")].shape == (2, B, h) + tuple(batch["dynamics"].shape[2:])
    ten = float((quiet[("f32", "folded, 10 members")] - quiet[("f32", "folded")][:10]).abs().max())
    for dt, (unf, fold), tol in (("f32", ("unfolded, 2 members", "folded"), MEMBERS_F32_TOL),
                                 ("bf16", ("unfolded, 2 members", "folded, 1 member"), MEMBERS_BF16_TOL)):
        want, got = quiet[(dt, fold)][:1], quiet[(dt, unf)]  # the folded members are equal (checked above)
        scale = float(want.abs().max())
        err = float((got - want).abs().max())
        control = float((got - want.roll(1, dims=1)).abs().max())
        note = (f"folded at 10 members vs 20 {ten:.3e}" if dt == "f32" else
                f"the same 6-row forwards{', bit for bit' if err == 0 else ''}")
        print(f"[members] dropout off, {dt}: {unf} vs {fold} max abs err {err:.3e} of max {scale:.3f} (limit "
              f"{tol * scale:.3e}; {note}); negative control (folded shifted by a row) {control:.3e}")
        assert err <= tol * scale, f"an unfolded member disagrees with the folded answer (dropout off, {dt})"
        assert control > tol * scale, f"the negative control passed: the {dt} member check does not bite"
    want = [2 * per_member, 2 * per_member, per_request, 2 * per_member, 2 * per_member]
    assert counts["unfolded"] == want, f"B1 per unfolded request {counts['unfolded']} != {want}"
    assert launches == sum(want), (launches, sum(want))
    assert all(bool(torch.isfinite(x).all()) for x in (a, other, two)), "non-finite predictions"
    assert torch.equal(two, a[:2]), "a seed's first two members did not repeat bit for bit in a 2-member request"
    spread, diff = float(a.std(dim=0).mean()), float((two - other).abs().max())
    print(f"[members] dropout on, bf16: member spread {spread:.4f}; seed {SEED} at 2 members repeats the first two of "
          f"20 bit for bit; seeds {SEED} and {SEED + 1} at 2 members differ by {diff:.3e}")
    assert spread > 0 and diff > 0.1, "members or seeds do not differ"
    frames = n_members * B * h
    for layout in ("folded", "unfolded"):
        lat = float(np.mean(latencies[layout]))
        print(f"[members] {layout}, bf16, dropout on: requests {[round(x, 4) for x in latencies[layout]]} s; latency "
              f"{lat:.4f} s, {frames / lat:.1f} frames/s, peak memory above the resident weights "
              f"{peaks[layout] / 2**30:.3f} GiB; B1 per request {counts[layout]} (dropout off: f32"
              f"{' and bf16 at 2 members' if layout == 'unfolded' else ''}; then dropout on"
              f"{', and at 2 members at two seeds' if layout == 'unfolded' else ''}); on {card}")
    print(f"[members] unfolded / folded: latency {np.mean(latencies['unfolded']) / np.mean(latencies['folded']):.2f}x, "
          f"peak memory {peaks['unfolded'] / peaks['folded']:.3f}x")
    return launches, per_request


# [ddp]: data parallelism. The NCCL collectives in this process (a group of
# one rank), then two gloo ranks sharing cuda:0 through the CLI against one
# rank at the same global batch.
MEMBERS_F32_TOL = 1e-3  # relative to max|folded|: 63 f32 forwards at 6 rows against 120
MEMBERS_BF16_TOL = 1e-2  # relative to max|folded|: the repo's bf16 tolerance ([export], the kernels)

DDP_STEPS = 8
DDP_BATCH = 64  # the global train batch
# stage 2's learning rate: at the preset's 3e-4 this randomly initialised stage 2
# oscillates and carries any rounding difference (the order of the batch's sums)
# to 5e-3 of its val metrics in 8 steps; at 1e-4 its losses fall steadily
DDP_STAGE2_LR = 1e-4
DDP_TIMEOUT_S = 600
# relative: the first step's losses; every later comparison, between the order-only drift
# (the permuted witness, two ranks: up to 1.3e-3) and the planted fault (from 3.8e-2)
DDP_FIRST_TOL, DDP_TOL = 1e-5, 1e-2


def _ddp_commands(reg, devices):
    from dyffusion_tpu_torch.config import get_config
    from dyffusion_tpu_torch.utils.naming import get_run_id
    from dyffusion_tpu_torch.utils.workloads import sst_overrides

    # 5 trajectories of 30 frames: 69 train rows (one global batch of 64 per
    # epoch), 23 val and test rows (eval batches 6, 6, 6, 5: the last one
    # odd, so two ranks pad it to 6); dropout off, f32, TF32 off
    common = sst_overrides([
        "datamodule.n_traj=5", "datamodule.n_time=30", f"datamodule.batch_size={DDP_BATCH // devices}",
        "datamodule.eval_batch_size=6", "model.block_dropout=0", "model.attn_dropout=0",
        "module.num_predictions_test=10", "trainer.val_every_n_epochs=100", "trainer.log_every_n_steps=1",
        f"trainer.max_steps={DDP_STEPS}", "matmul_precision=highest", f"trainer.devices={devices}",
        f"registry_dir={reg}",
    ])
    id1 = get_run_id(get_config("synthetic_interpolation", common))
    stage2 = [f"diffusion.interpolator_run_id={id1}", f"module.optimizer.lr={DDP_STAGE2_LR}", *common]
    id2 = get_run_id(get_config("synthetic_dyffusion", stage2))
    return [("stage 1", ["experiment=synthetic_interpolation", *common]),
            ("stage 2", ["experiment=synthetic_dyffusion", *stage2]),
            ("mode=test", ["mode=test", f"run_id={id2}", f"registry_dir={reg}"])], id1, id2


def _spring_config(data_dir, batch, devices):
    from dyffusion_tpu_torch.config import get_config

    return get_config("spring_mesh_interpolation", [
        f"datamodule.data_dir={data_dir}", f"datamodule.batch_size={batch}", "model.dropout=0",
        "matmul_precision=highest", f"trainer.devices={devices}", "trainer.save_checkpoints=False"])


def _spring_step(config, rank=0, world=1):
    """One stage-1 spring-mesh train step (``SimpleConvNet`` with BatchNorm)
    through ``Trainer.train_step`` on this rank's rows of the first global
    batch: the loss, the gradients the optimizer received and the running
    statistics after the step, on the host."""
    import numpy as np
    import torch

    from dyffusion_tpu_torch.interface import build_trainer

    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    trainer = build_trainer(config, device="cuda")
    n = trainer.datamodule.batch_size // world
    batch = next(iter(trainer.datamodule.train_loader(
        rng=np.random.default_rng(SEED), device_put=trainer._put, rows=slice(rank * n, (rank + 1) * n))))
    state, grads = trainer.state, {}
    apply = state.apply_gradients

    def capture(updates=None):
        grads.update({k: p.grad.detach().cpu().clone() for k, p in state.params.items()})
        return apply(updates)

    state.apply_gradients = capture
    metrics = trainer.train_step(state, batch)
    stats = {k: v.cpu().clone() for k, v in trainer.experiment.model.state_dict().items() if "running" in k}
    return {"loss": float(metrics["loss"]), "grads": grads, "stats": stats}


def ddp_rank_main(work):
    """One rank of ``[ddp]``'s two-rank run (started by ``phase_ddp`` with
    the launcher's environment): the three CLI commands through
    ``train.main``, each with its B1 launches and wall time, then the spring
    step; results in ``work``."""
    import torch

    from dyffusion_tpu_torch import train
    from dyffusion_tpu_torch.ops import linear_attention as la
    from dyffusion_tpu_torch.parallel import distributed

    with open(os.path.join(work, "commands.json")) as f:
        spec = json.load(f)
    rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    out = {}
    for name, argv in spec["commands"]:
        la.reset_launches()
        t = time.perf_counter()
        value = train.main(argv)
        _sync()
        out[name] = {"launches": la.launches, "seconds": time.perf_counter() - t, "value": value}
    spring = _spring_step(_spring_config(spec["spring"], DDP_BATCH // world, world), rank, world)
    torch.save(spring, os.path.join(work, f"spring{rank}.pt"))
    with open(os.path.join(work, f"rank{rank}.json"), "w") as f:
        json.dump({"commands": out, "device": str(torch.cuda.current_device()),
                   "backend": distributed.backend()}, f)
    distributed.barrier()
    torch.distributed.destroy_process_group()
    return 0



# [ddp]'s two one-rank witnesses at the global batch, one after the other
# in a process of their own beside the two ranks: "permuted" trains both
# stages on the rows of every batch permuted, each row keeping its own
# draws, so that only the order of the batch's sums changes (the drift that
# order alone makes); "fault" then trains stage 2 again from the same stage
# 1, on the first half of the rows alone from its second step on, with the
# global batch's draws (rank 0 skipping the gradient all-reduce: a planted
# data-parallel fault that starts after step 1).
DDP_WITNESSES = ("permuted", "fault")


def _witness_train_step(kind, make):
    """``make`` (``make_train_step``) with the loss of ``kind`` (see
    :data:`DDP_WITNESSES`)."""
    import numpy as np
    import torch

    from dyffusion_tpu_torch.utils import rng

    draws = (rng.row_randint, rng.row_randn)

    def rows(batch, n, idx):
        return {k: v[idx] if torch.is_tensor(v) and v.ndim and v.shape[0] == n else v for k, v in batch.items()}

    def make_train_step(loss_fn, watch_gradients=False, **kw):
        steps = [0]

        def loss(params, batch, generator):
            steps[0] += 1
            n = int(batch["dynamics"].shape[0])
            device = batch["dynamics"].device
            if kind == "fault":
                if steps[0] == 1:
                    return loss_fn(params, batch, generator)
                with rng.row_shard(generator, n, 0):
                    return loss_fn(params, rows(batch, n, torch.arange(n // 2, device=device)), generator)
            idx = torch.from_numpy(np.random.default_rng(SEED).permutation(n)).to(device)
            rng.row_randint = lambda *a, **k: draws[0](*a, **k)[idx]
            rng.row_randn = lambda *a, **k: draws[1](*a, **k)[idx]
            try:
                return loss_fn(params, rows(batch, n, idx), generator)
            finally:
                rng.row_randint, rng.row_randn = draws

        return make(loss, watch_gradients, **kw)

    return make_train_step


def ddp_witness_main(work):
    """``[ddp]``'s witnesses (:data:`DDP_WITNESSES`) through ``train.main``
    at the global batch on one rank: the permuted stage 1 and stage 2 in
    ``work/registry_permuted``, then the fault's stage 2 from a copy of that
    stage 1 in ``work/registry_fault``."""
    import shutil

    from dyffusion_tpu_torch import train
    from dyffusion_tpu_torch.training import trainer as trainer_mod

    make = trainer_mod.make_train_step
    regs = {kind: os.path.join(work, f"registry_{kind}") for kind in DDP_WITNESSES}
    commands, id1, _ = _ddp_commands(regs["permuted"], 1)
    try:
        trainer_mod.make_train_step = _witness_train_step("permuted", make)
        for _, argv in commands[:2]:
            train.main(argv)
        shutil.copytree(os.path.join(regs["permuted"], id1), os.path.join(regs["fault"], id1))
        trainer_mod.make_train_step = _witness_train_step("fault", make)
        train.main(_ddp_commands(regs["fault"], 1)[0][1][1])
    finally:
        trainer_mod.make_train_step = make
    return 0

def _max_rel(got, want):
    """max |got - want| / max |want| over a dict of tensors, each tensor
    measured against the larger of its own largest |value| and 0.1 of the
    largest of all (gradients of a conv bias in front of a norm are float
    noise)."""
    top = max(float(w.abs().max()) for w in want.values())
    return max(float((got[k] - w).abs().max()) / max(float(w.abs().max()), 0.1 * top, 1e-30) for k, w in want.items())


def _ddp_nccl():
    """A one-rank NCCL group in this process: the gradient all-reduce, the
    metric-sum all-reduce and the cross-rank BatchNorm on the card."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from dyffusion_tpu_torch.models.base import BatchNorm2d
    from dyffusion_tpu_torch.parallel import distributed
    from dyffusion_tpu_torch.training.trainer import metric_sums

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    x = torch.randn((64, 64, 10, 10), generator=gen, device="cuda") * 2 + 1
    cot = torch.randn(x.shape, generator=gen, device="cuda")

    def batch_norm():
        bn = BatchNorm2d(64).cuda()
        with torch.no_grad():
            bn.weight.copy_(torch.rand(64, generator=gen, device="cuda") + 0.5)
            bn.bias.normal_(generator=gen)
        xs, stats = x.clone().requires_grad_(True), {}
        (bn(xs, stats) * cot).sum().backward()
        mean, var, _ = stats[bn]
        return {"y": bn(x, {}).detach(), "dx": xs.grad, "dweight": bn.weight.grad, "dbias": bn.bias.grad,
                "mean": mean, "var": var}

    plain = batch_norm()
    gen.manual_seed(SEED + 1)
    preds = torch.randn((20, 5, 60, 60, 1), generator=gen, device="cuda")
    targets = torch.randn((5, 60, 60, 1), generator=gen, device="cuda")
    sums = metric_sums(preds, targets, torch.arange(5, device="cuda") < 4)
    weights = [torch.nn.Parameter(torch.randn(1000, generator=gen, device="cuda")) for _ in range(3)]
    (weights[0].square().sum() + weights[1].sum()).backward()  # weights[2] is not reached: grad None
    before = [w.grad.clone() for w in weights[:2]]
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{_free_port()}", rank=0, world_size=1)
    try:
        assert distributed.backend() == "nccl" and distributed.collective_device().type == "cuda"
        gen.manual_seed(SEED)
        x = torch.randn((64, 64, 10, 10), generator=gen, device="cuda") * 2 + 1
        cot = torch.randn(x.shape, generator=gen, device="cuda")
        grouped = batch_norm()  # the global-statistics path through an autograd all_reduce
        distributed.all_reduce_gradients(weights, bucket_elements=1500)
        flat = distributed.all_reduce_sum(torch.stack([sums[k] for k in ("n", "sq", "var", "crps")]))
    finally:
        dist.destroy_process_group()
    bn_err = _max_rel(grouped, plain)
    control = _max_rel({**plain, "y": plain["y"] * 1.001}, plain)
    print(f"[ddp] NCCL, one rank: BatchNorm through the group vs cuDNN's batch statistics, max rel err {bn_err:.3e} "
          f"(limit 1e-4; control 0.1% off: {control:.3e}); gradient all-reduce {[float((w.grad - b).abs().max()) for w, b in zip(weights, before)]} "
          f"unreached grad {float(weights[2].grad.abs().max())}; metric sums {flat.tolist()}")
    assert bn_err <= 1e-4 < control, "the cross-rank BatchNorm disagrees on the card"
    assert all(torch.equal(w.grad, b) for w, b in zip(weights, before)) and torch.equal(
        weights[2].grad, torch.zeros_like(weights[2])), "the NCCL gradient all-reduce changed a one-rank gradient"
    assert np.allclose(flat.tolist(), [float(sums[k]) for k in ("n", "sq", "var", "crps")], rtol=0, atol=0)



def _ddp_disagreement(reg, ref, run_id, init, steps=DDP_STEPS):
    """A run's disagreement with the same run id in the registry ``ref``:
    the first step's loss and the worst step's (relative), the worst val
    metric (relative; not the SSR, not frames/s), and the relative L2 of
    the difference of the final weights (and EMA) to the change ``ref``'s
    made from ``init``. Returns it and (the relative loss differences,
    ``ref``'s losses)."""
    import torch

    from dyffusion_tpu_torch.utils import registry_api

    recs = {w: registry_api.get_run_metrics(r, run_id) for w, r in (("run", reg), ("ref", ref))}
    losses = {w: [r["train/loss"] for r in recs[w] if "train/loss" in r] for w in recs}
    assert len(losses["run"]) == len(losses["ref"]) == steps, losses
    rel = [abs(a - b) / abs(b) for a, b in zip(losses["run"], losses["ref"])]
    val = {w: [r for r in recs[w] if "val/crps" in r][-1] for w in recs}
    out = {"first loss": rel[0], "loss": max(rel), "val": max(
        abs(val["run"][k] - v) / max(abs(v), 1e-6) for k, v in val["ref"].items()
        if k.startswith("val/") and "frames_per_sec" not in k and not k.endswith("ssr"))}
    state = {w: torch.load(os.path.join(r, run_id, "last", "state.pt"), weights_only=True)
             for w, r in (("run", reg), ("ref", ref))}
    for part in ("model", "ema"):
        if state["ref"][part] is None:
            continue
        keys = [k for k, v in state["ref"][part].items() if v.is_floating_point() and k in init]
        num = sum(float(((state["run"][part][k] - state["ref"][part][k]) ** 2).sum()) for k in keys)
        den = sum(float(((state["ref"][part][k] - init[k]) ** 2).sum()) for k in keys)
        out[f"{part} (rel L2 of the change)"] = (num / den) ** 0.5
    return out, (rel, losses["ref"])

def _free_port():
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]



def _ddp_start(work, name, argv, env=None):
    """``python3 argv`` from the repo's root, its output in ``work/{name}.log``;
    returns (process, log, a thread that waits for it and keeps its end time
    as ``thread.end``)."""
    import threading

    log = open(os.path.join(work, f"{name}.log"), "w")
    p = subprocess.Popen([sys.executable, *argv], stdout=log, stderr=subprocess.STDOUT, env=env,
                         cwd=os.path.dirname(os.path.abspath(__file__)))

    def wait():
        p.wait()
        watcher.end = time.perf_counter()

    watcher = threading.Thread(target=wait, daemon=True)
    watcher.start()
    return p, log, watcher


def _ddp_finish(work, procs, t):
    """Wait for ``procs`` (name -> :func:`_ddp_start`'s) within
    :data:`DDP_TIMEOUT_S` of ``t``, kill any left, print the log of any that
    failed and fail; returns each one's seconds from ``t`` to its end."""
    codes = {}
    try:
        for name, (p, _, watcher) in procs.items():
            try:
                codes[name] = p.wait(timeout=max(1.0, DDP_TIMEOUT_S - (time.perf_counter() - t)))
            except subprocess.TimeoutExpired:
                codes[name] = "timed out"
            watcher.join(timeout=1.0)
    finally:
        for p, log, _ in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()
            log.close()
    for name, code in codes.items():
        if code != 0:
            with open(os.path.join(work, f"{name}.log")) as f:
                print(f"[{name}, {code}]", f.read()[-3000:])
    assert all(c == 0 for c in codes.values()), f"[ddp] processes exited with {codes}"
    return {name: watcher.end - t for name, (_, _, watcher) in procs.items()}

def phase_ddp(card, work=None):
    """Data parallelism on the card. 1. NCCL: :func:`_ddp_nccl`. 2. Two
    gloo ranks sharing cuda:0 (this process starts them with the launcher's
    environment, ``RANK``/``WORLD_SIZE``...; each runs ``chip_smoke.py
    --ddp-rank``): ``train.main`` for ``synthetic_interpolation``, then
    ``synthetic_dyffusion`` from the registry by run id, at SST width with
    ``trainer.devices=2`` (B64 global, 32 rows a rank, 8 steps a stage, f32,
    TF32 off, dropout off, stage 2 at lr 1e-4), then ``mode=test`` on the
    two ranks, and one spring-mesh ``SimpleConvNet`` step. Beside them, the two one-rank
    witnesses of :data:`DDP_WITNESSES` in one process (``chip_smoke.py
    --ddp-witness``). 3. The same commands with ``trainer.devices=1`` at B64
    in this process, and beside them ``python3 -m dyffusion_tpu_torch.train
    mode=test`` of the two-rank run, which spawns its two ranks itself.
    Checks: the first step's loss of each stage within 1e-5 relative
    (the same weights and rows; the sums' order differs), every step's
    loss, the final weights (relative L2 of their change), the val metrics
    and test/crps within 1e-2 of one rank's, for two ranks and for the
    permuted witness (the order of the sums alone: stage 2 carries its
    rounding on), while the planted fault's stage-2 loss, val metrics and
    weights must each read above 1e-2; B1 launches per rank per command are
    what 32-row steps and 3-row eval shards imply (the one-rank counts);
    the spring step's loss, gradients and running statistics on two ranks
    equal one rank's at the global batch (1e-4), and rank 0's rows with
    their own statistics (the negative control) do not. Two ranks on one
    card measure no scaling: the wall times are printed, not compared (the
    witnesses share the card with the two ranks, the CLI's ranks with the
    one-rank commands).
    ``work``: a directory to work in, which keeps the runs (default: a
    temporary one). Returns the two-rank path's B1 launches (both ranks, all
    commands)."""
    import numpy as np
    import torch

    from dyffusion_tpu_torch import train
    from dyffusion_tpu_torch.interface import build_trainer
    from dyffusion_tpu_torch.models.modules import LinearAttention
    from dyffusion_tpu_torch.ops import linear_attention as la
    from dyffusion_tpu_torch.utils import registry_api

    _b1_path_check("ddp", DDP_B1, torch.float32)
    _ddp_nccl()
    with contextlib.nullcontext(work) if work else tempfile.TemporaryDirectory(prefix="chip_smoke_ddp_") as work:
        data = os.path.join(work, "spring")
        _physical_archive(data, "spring_mesh")
        regs = {w: os.path.join(work, f"registry{w}") for w in (1, 2)}
        regs.update({kind: os.path.join(work, f"registry_{kind}") for kind in DDP_WITNESSES})
        cmds = {w: _ddp_commands(regs[w], w) for w in (1, 2)}
        assert cmds[1][1:] == cmds[2][1:], "the run ids must hash the same global batch"
        _, id1, id2 = cmds[2]
        with open(os.path.join(work, "commands.json"), "w") as f:
            json.dump({"commands": cmds[2][0], "spring": data}, f)
        port = _free_port()
        torch.cuda.empty_cache()  # three processes share the card next
        t = time.perf_counter()
        procs = {}
        for rank in range(2):
            env = {**os.environ, "RANK": str(rank), "LOCAL_RANK": str(rank), "WORLD_SIZE": "2",
                   "LOCAL_WORLD_SIZE": "2", "MASTER_ADDR": "localhost", "MASTER_PORT": str(port)}
            procs[f"rank{rank}"] = _ddp_start(work, f"rank{rank}", [os.path.abspath(__file__), "--ddp-rank", work], env)
        procs["witnesses"] = _ddp_start(work, "witnesses", [os.path.abspath(__file__), "--ddp-witness", work])
        two_ranks_s = _ddp_finish(work, procs, t)["rank1"]
        ranks = []
        for rank in range(2):
            with open(os.path.join(work, f"rank{rank}.json")) as f:
                ranks.append(json.load(f))
        print(f"[ddp] two gloo ranks: {two_ranks_s:.1f} s in all; backends {[r['backend'] for r in ranks]}, "
              f"devices cuda:{[r['device'] for r in ranks]}")
        assert all(r["backend"] == "gloo" and r["device"] == "0" for r in ranks)

        # the one-rank commands in this process, while the CLI, started as a user starts it,
        # runs mode=test of the two-rank run on the two ranks it spawns itself
        t = time.perf_counter()
        cli = {"cli": _ddp_start(work, "cli", ["-m", "dyffusion_tpu_torch.train", "mode=test", f"run_id={id2}",
                                               f"registry_dir={regs[2]}"])}
        one = {}
        try:
            for name, argv in cmds[1][0]:
                la.reset_launches()
                t_cmd = time.perf_counter()
                value = train.main(argv)
                _sync()
                one[name] = {"launches": la.launches, "seconds": time.perf_counter() - t_cmd, "value": value}
        finally:
            cli_test_s = _ddp_finish(work, cli, t)["cli"]
        with open(os.path.join(work, "cli.log")) as f:
            cli_test = [json.loads(x) for x in f if x.startswith('{"test/')][-1]["test/crps"]
        for name in one:
            print(f"[ddp] {name}: one rank {one[name]['seconds']:.1f} s, two ranks "
                  f"{[round(r['commands'][name]['seconds'], 1) for r in ranks]} s; B1 one rank "
                  f"{one[name]['launches']}, per rank {[r['commands'][name]['launches'] for r in ranks]}; on {card}")
        print(f"[ddp] mode=test on two ranks started by the CLI itself: {cli_test_s:.1f} s (beside the one-rank commands)")

        # B1 per rank per command: the one-rank counts (a rank's 32-row step runs the same forwards)
        trainer = build_trainer({**registry_api.get_run_config(regs[1], id2), "trainer": {"devices": 1}}, device="cuda")
        exp = trainer.experiment
        n_attn = sum(isinstance(m, LinearAttention) for m in exp.model.modules())
        per_sample = n_attn * (2 * len(exp.engine._steps.s) + 1)
        n_eval, h = 4, exp.cfg.horizon
        expected = {"stage 1": n_attn * (DDP_STEPS + n_eval * (h - 1)),
                    "stage 2": DDP_STEPS * 4 * n_attn + n_eval * per_sample, "mode=test": n_eval * per_sample}
        for name, want in expected.items():
            got = [one[name]["launches"]] + [r["commands"][name]["launches"] for r in ranks]
            assert got == [want] * 3, f"B1 launches of {name}: {got} != {want}"

        # losses, weights, metrics: two ranks, and the two witnesses, against one rank
        init = {}
        for run_id in (id1, id2):
            init_cfg = {**registry_api.get_run_config(regs[1], run_id), "trainer": {"devices": 1}}
            init[run_id] = build_trainer(init_cfg, device="cpu").state.model.state_dict()
        worst, losses = {run: {} for run in (2,) + DDP_WITNESSES}, {}
        for run, run_id, stage in ((2, id1, "stage 1"), (2, id2, "stage 2"), ("permuted", id1, "stage 1"),
                                   ("permuted", id2, "stage 2"), ("fault", id2, "stage 2")):  # the fault's stage 1 is the permuted one
            got, losses[(run, stage)] = _ddp_disagreement(regs[run], regs[1], run_id, init[run_id])
            worst[run].update({f"{stage} {k}": v for k, v in got.items()})
        for stage in ("stage 1", "stage 2"):
            print(f"[ddp] {stage} losses: one rank {[round(x, 6) for x in losses[(2, stage)][1]]}; relative "
                  f"differences to it: " + "; ".join(
                      f"{'two ranks' if run == 2 else run} {[float(f'{x:.2e}') for x in losses[(run, stage)][0]]}"
                      for run in (2,) + DDP_WITNESSES if (run, stage) in losses))
        tests = [one["mode=test"]["value"], ranks[0]["commands"]["mode=test"]["value"], cli_test]
        worst[2]["test/crps"] = max(abs(x - tests[0]) / abs(tests[0]) for x in tests)
        print(f"[ddp] test/crps: one rank {tests[0]:.6f}, two ranks {tests[1]:.6f}, two ranks from the CLI "
              f"{tests[2]:.6f}")
        for run in (2,) + DDP_WITNESSES:
            print(f"[ddp] worst disagreement with one rank, {'two ranks' if run == 2 else run}: "
                  f"{json.dumps(worst[run])}")
        # the first step sees the same weights and rows: only the sums' order differs. Later
        # steps drift by what the permuted witness shows the order of the sums alone makes;
        # the limit lies between that and the planted fault
        for run in (2, "permuted"):
            for k, v in worst[run].items():
                assert v <= (DDP_FIRST_TOL if "first" in k else DDP_TOL), f"{run} vs one rank: {k} {v:.3e}"
        fault = min(v for k, v in worst["fault"].items() if k.startswith("stage 2") and "first" not in k)
        assert fault > DDP_TOL, f"the planted fault reads {fault:.3e}, within the limit {DDP_TOL}: the check does not bite"

        # the spring step
        spring_one = _spring_step(_spring_config(data, DDP_BATCH, 1))
        spring_two = [torch.load(os.path.join(work, f"spring{r}.pt"), weights_only=True) for r in range(2)]
        alone = _spring_step(_spring_config(data, DDP_BATCH // 2, 1))  # rank 0's 32 rows, their own statistics
        errs = {"loss": max(abs(s["loss"] - spring_one["loss"]) / abs(spring_one["loss"]) for s in spring_two)}
        for what in ("grads", "stats"):
            errs[what] = max(_max_rel(s[what], spring_one[what]) for s in spring_two)
        control = {"loss": abs(alone["loss"] - spring_one["loss"]) / abs(spring_one["loss"]),
                   "grads": _max_rel(alone["grads"], spring_one["grads"]),
                   "stats": _max_rel(alone["stats"], spring_one["stats"])}
        print(f"[ddp] spring step, two ranks vs one at B{DDP_BATCH}: {json.dumps(errs)}; negative control (rank 0's "
              f"rows, own statistics): {json.dumps(control)}")
        assert all(v <= 1e-4 for v in errs.values()), "the spring step disagrees between one and two ranks"
        assert all(v > 1e-4 for v in control.values()), "the negative control passed: the spring check does not bite"
    print("[ddp] two ranks on one card measure no scaling: the ranks share the card")
    return sum(r["commands"][n]["launches"] for r in ranks for n in expected)


# [spatial]: spatial sharding on the eval path. Two gloo ranks sharing
# cuda:0 (chip_smoke.py --spatial-rank) split the SST grid's H (or W) axis,
# beside a one-rank witness of the same commands in a process of its own.
SPATIAL_TOL = 1e-3  # relative to max|one rank|: f32 (TF32 off), sums over slabs in another order
SPATIAL_MEMORY_LIMIT = 0.7  # a rank's peak memory over the one-rank request's
SPATIAL_DROPOUT = ["model.block_dropout=0.3", "model.attn_dropout=0.1"]  # the SST workload's
SPATIAL_NO_DROPOUT = ["model.block_dropout=0", "model.attn_dropout=0"]
# the per-rank tokens of B1 at K = 2 on H: 60 -> 30 -> 15 rows, split 30/30,
# 15/15 and 8/7, times the 60, 30 and 15 columns
SPATIAL_B1 = ((1800, 1800), (450, 450), (120, 105))


def _b1_split_emulated(parts, heads=4, dim_head=32, scale=32**-0.5):
    """The split B1 kernel over ``parts``, each one rank's (B, N_r, 3hd)
    tokens, the ranks emulated in one process: the partial pass of each,
    the maximum over them, the merge of each, the sum, the output pass of
    each."""
    import torch

    from dyffusion_tpu_torch.ops import linear_attention as la

    steps = [la.split_partial(q, heads, dim_head) for q in parts]
    top = torch.stack([m for _, _, m in steps]).amax(dim=0)
    merged = sum(la.split_merge(q, ws, S, top) for q, (ws, S, _) in zip(parts, steps))
    n = sum(q.shape[1] for q in parts)
    return [la.split_output(q, merged, heads, dim_head, scale, n) for q in parts]


def _spatial_b1_check():
    """The split B1 kernel against B1's plain version over all the tokens,
    two ranks emulated, at the per-rank SST shapes: 120 rows in bf16 and
    f32, and in f32 also the 40 rows of ``[spatial]``'s DDPM request and the
    8 of its train step; times one rank's three steps at 120 rows (no
    collectives) against the plain split (one rank's arithmetic) and its
    bound. Negative control: the output pass of rank 0 with its own
    tokens' partial alone (k's softmax over the local N)."""
    import torch

    from dyffusion_tpu_torch.ops import linear_attention as la

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    times = {}
    for dtype in (torch.bfloat16, torch.float32):
        dt = str(dtype)[6:]
        for n0, n1 in SPATIAL_B1:
            for B in (120,) if dtype == torch.bfloat16 else (120, 40, 8):
                full = _qkv(B, n0 + n1, dtype, True, gen)
                parts = [full[:, :n0], full[:, n0:]]
                got = torch.cat(_b1_split_emulated(parts), dim=1)
                want = la.linear_attention_qkv_plain(full, 4, 32, 32**-0.5)
                _check_vs_plain(f"[spatial] split B1 B={B} N={n0}+{n1} {dt}", got, want, REL_TOL[dt],
                                negative_controls=n0 == 1800 and B == 120)
                ws, S, m = la.split_partial(parts[0], 4, 32)
                local = la.split_output(parts[0], la.split_merge(parts[0], ws, S, m), 4, 32, 32**-0.5, n0)
                ok = _within(local, want[:, :n0], REL_TOL[dt])[0]
                assert not ok, "the split B1 check accepts rank 0's tokens alone (k's softmax over the local N)"
            full = _qkv(120, n0 + n1, dtype, True, gen)
            parts = [full[:, :n0], full[:, n0:]]

            def kernel(q=parts[0], n=n0 + n1):
                ws, S, m = la.split_partial(q, 4, 32)
                return la.split_output(q, la.split_merge(q, ws, S, m), 4, 32, 32**-0.5, n)

            ms, plain_ms = _time_pair(kernel, lambda q=parts[0]: la.linear_attention_qkv_split_plain(
                q, 4, 32, 32**-0.5, n0 + n1))
            bound, by = _bound(120 * n0 * 512 * full.element_size(), 0)
            times[f"(120, {n0}, 384) {dt}"] = {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound}
            print(f"[spatial] split B1, one rank of two, (120, {n0}, 384) {dt}: {ms:.4f} ms (three steps, no "
                  f"collectives), plain {plain_ms:.4f} ms, bound {bound:.4f} ms ({by}); local-only control rejected")
    return times


# On two ranks sharing the card each Unet forward waits on ~80 gloo round
# trips (1.4-2.1 ms each): a full request (63 forwards) takes 21-52 s. So
# the requests run the sampler without its 25 auxiliary steps (13 forwards;
# the bf16 request, which holds the memory and B1 checks, ran in full
# before: each forward's peak is the same). mode=test: the test split's 23
# rows as one batch (10 members)
SPATIAL_SHORT = ["diffusion.additional_interpolation_steps=0", *SPATIAL_DROPOUT]
SPATIAL_TEST = ["datamodule.eval_batch_size=24", *SPATIAL_SHORT]
# one forecaster forward at a request's 120 rows (6 rows x 20 members),
# dropout off: the sharded answer at the eval precision, bf16, against one
# rank's (bf16 rounds each layer's output, the two layouts' convs and norms
# sum in other orders), between the sound reading and the zeroed halos
SPATIAL_FORWARD_ROWS = 120
SPATIAL_BF16_TOL = 5e-2  # relative to max|one rank|


# [spatial] training. Each rank process (and the witness) reloads the stored
# stages with the workload's dropout (0.3 / 0.1; f32, TF32 off) and runs
# three Trainer.train_step calls of each at the global batch of 64 on its box
# of the first train batch (its slab of H): each one's B1 launches, time and
# peak memory; before them one stage-2 step's forecaster gradients at 16
# rows, and the same with the halo's backward returning no row (the negative
# control). Then the CLI's own spawn trains both stages anew on two ranks
# sharding H, beside a one-rank witness of the same commands: 2 steps a
# stage at B64 (3 before; cut for the run's time), one validation each
# (4 members, the sampler without its auxiliary steps, the val split as one
# batch).
SPATIAL_TRAIN_STEPS = 2
SPATIAL_GRAD_ROWS = 16
SPATIAL_TRAIN_MEMORY_LIMIT = 0.8  # a rank's stage-2 step peak over one rank's
SPATIAL_WEIGHTS_TOL = 1e-2  # relative L2 of the weights' difference to their change, as [ddp]'s
SPATIAL_B1_PER_STEP = {"stage 1": 6, "stage 2": 24}  # one Unet forward a step; four in stage 2
SPATIAL_TRAIN_MEMBERS = 4  # the CLI training's validation ensemble


def _spatial_train_commands(reg, k):
    """The CLI's training commands of ``[spatial]`` on ``k`` ranks sharding
    H (1: the witness): stage 1, then stage 2 by run id; with their run
    ids, which do not depend on ``k``."""
    from dyffusion_tpu_torch.config import get_config
    from dyffusion_tpu_torch.utils.naming import get_run_id
    from dyffusion_tpu_torch.utils.workloads import sst_overrides

    common = sst_overrides([
        "datamodule.n_traj=5", "datamodule.n_time=30", f"datamodule.batch_size={DDP_BATCH}",
        "datamodule.eval_batch_size=24", "diffusion.additional_interpolation_steps=0", *SPATIAL_DROPOUT,
        f"module.num_predictions={SPATIAL_TRAIN_MEMBERS}",
        f"trainer.max_steps={SPATIAL_TRAIN_STEPS}", "trainer.val_every_n_epochs=100", "trainer.log_every_n_steps=1",
        "matmul_precision=highest", f"trainer.devices={k}", f"trainer.spatial_shards={k}", f"registry_dir={reg}"])
    id1 = get_run_id(get_config("synthetic_interpolation", common))
    stage2 = [f"diffusion.interpolator_run_id={id1}", *common]
    id2 = get_run_id(get_config("synthetic_dyffusion", stage2))
    return [["experiment=synthetic_interpolation", *common], ["experiment=synthetic_dyffusion", *stage2]], id1, id2


def _spatial_train_batch(trainer):
    """This process's box of the first global train batch (its slab of the
    grid under a shard), on its device."""
    import numpy as np

    from dyffusion_tpu_torch.parallel import distributed

    k = distributed.model_size()
    slab = (trainer.spatial_axis, distributed.model_rank(), k) if k > 1 else None
    loader = trainer.datamodule.train_loader(rng=np.random.default_rng(SEED), device_put=trainer._put, slab=slab)
    return next(iter(loader))


def _spatial_train_steps(trainer, n=SPATIAL_TRAIN_STEPS):
    """``n`` calls of ``Trainer.train_step`` on :func:`_spatial_train_batch`:
    each one's seconds, B1 and split B1 launches and peak device memory."""
    import torch

    from dyffusion_tpu_torch.ops import linear_attention as la

    batch = _spatial_train_batch(trainer)
    steps = []
    for _ in range(n):
        la.reset_launches()
        _sync()
        torch.cuda.reset_peak_memory_stats()
        t = time.perf_counter()
        trainer.train_step(trainer.state, batch)
        _sync()
        steps.append({"seconds": time.perf_counter() - t, "launches": la.launches, "split": la.split_launches,
                      "peak": torch.cuda.max_memory_allocated()})
    return steps


def _spatial_grads(trainer, zero_halo_backward, rows=SPATIAL_GRAD_ROWS):
    """One stage-2 loss and every forecaster gradient the optimizer would
    receive (summed over the world and divided by it, as the train step
    does) at the first ``rows`` rows of the first train batch, the step
    generator seeded with SEED; no weight moves. With
    ``zero_halo_backward`` the halo's backward returns no row to its owner
    (the negative control)."""
    import torch

    from dyffusion_tpu_torch.parallel import spatial

    batch = {k: v[:rows] for k, v in _spatial_train_batch(trainer).items()}
    state, grads = trainer.state, {}
    apply, halo_backward = state.apply_gradients, spatial._Rows.backward

    def backward(ctx, grad):
        transfer = spatial._halo_all_reduce
        spatial._halo_all_reduce = lambda buf: buf
        try:
            return halo_backward(ctx, grad)
        finally:
            spatial._halo_all_reduce = transfer

    for p in state.params.values():
        p.grad = None
    state.apply_gradients = lambda updates=None: grads.update(
        {k: p.grad.detach().cpu().clone() for k, p in state.params.items()})
    if zero_halo_backward:
        spatial._Rows.backward = staticmethod(backward)
    state.generator.manual_seed(SEED)
    try:
        metrics = trainer.train_step(state, batch)
    finally:
        state.apply_gradients, spatial._Rows.backward = apply, halo_backward
    return {"loss": float(metrics["loss"]), "grads": grads}


def _spatial_commands(k):
    """The [spatial] process's work at ``k`` ranks (1: the witness), on the
    H axis: each (name, kind, overrides over the stored run) of its
    one-batch requests of the predict split (6 rows, 20 members), of the
    forecaster forward and, for the witness, of mode=test (the two ranks
    run it through the CLI, on W)."""
    layout = [f"trainer.devices={k}", f"trainer.spatial_shards={k}"]
    out = [("request f32", "request", layout + SPATIAL_SHORT)]
    if k > 1:  # the negative control
        out.append(("request f32, halos zeroed", "request", layout + SPATIAL_SHORT))
    bf16 = layout + SPATIAL_NO_DROPOUT + ["module.eval_dtype=bfloat16", "diffusion.additional_interpolation_steps=0"]
    out.append(("request bf16", "request", bf16))
    out.append(("forward", "forward", bf16))  # casts the weights itself; the bf16 request's trainer
    if k == 1:
        out.append(("test f32", "test", layout + SPATIAL_TEST))
    return out


def _spatial_request(trainer):
    """One request: the first batch of the predict split, this rank's box
    of it (``Trainer.local_eval_batches``), through the predict eval
    function inside ``Trainer.sharded``; every rank of the model group and
    the witness draw from one seed. This rank's slab of the predictions."""
    import torch

    batch = next(iter(trainer.local_eval_batches("predict")))[0]
    generator = torch.Generator(device=trainer.device).manual_seed(SEED)
    with trainer.sharded():
        out = trainer.eval_fns["predict"](batch, generator, trainer.state.eval_params())
    return {k: v.cpu().numpy() for k, v in out.items() if k.endswith("_preds")}


def _spatial_forward(trainer, halo_all_reduce):
    """The stored forecaster's forward at a request's rows, f32 and bf16
    (its weights cast as the bf16 eval casts them), on seeded inputs at the
    global grid, this rank taking its slab of H inside ``Trainer.sharded``;
    on two ranks also bf16 with every halo zeroed. This rank's output slab
    of each."""
    import torch

    from dyffusion_tpu_torch.experiments.base import cast_params
    from dyffusion_tpu_torch.models.base import apply_model
    from dyffusion_tpu_torch.parallel import distributed, spatial

    net = trainer.experiment.engine.forecaster
    n_cond = net.num_conditional_channels
    H, W = trainer.experiment.dims["spatial"]
    dev = trainer.device
    gen = torch.Generator(device=dev).manual_seed(SEED)
    x = torch.randn((SPATIAL_FORWARD_ROWS, net.init_conv.in_channels - n_cond, H, W), generator=gen, device=dev)
    cond = torch.randn((SPATIAL_FORWARD_ROWS, n_cond, H, W), generator=gen, device=dev) if n_cond else None
    t = torch.rand((SPATIAL_FORWARD_ROWS,), generator=gen, device=dev)
    a, b = spatial.blocks(H, distributed.model_size())[distributed.model_rank()]
    x = x[:, :, a:b]
    cond = None if cond is None else cond[:, :, a:b]
    runs = [("f32", torch.float32, halo_all_reduce), ("bf16", torch.bfloat16, halo_all_reduce)]
    if distributed.model_size() > 1:
        runs.append(("bf16, halos zeroed", torch.bfloat16, lambda buf: buf))
    out = {}
    for name, dtype, transfer in runs:
        spatial._halo_all_reduce = transfer
        try:
            with torch.no_grad(), trainer.sharded():
                y = apply_model(net, cast_params(net, dtype), x.to(dtype), t,
                                None if cond is None else cond.to(dtype))
            out[name] = y.float().cpu().numpy()
        finally:
            spatial._halo_all_reduce = halo_all_reduce
    return out


def _peak_blocks(snapshot, top=3):
    """The ``top`` largest blocks alive at the peak of a memory history
    (``torch.cuda.memory._snapshot()`` with ``stacks='python'``): the peak
    over what the history allocated, and each block's MiB with the two
    innermost frames of this repo that allocated it."""
    trace = [e for dev in snapshot["device_traces"] for e in dev]
    total = peak = peak_at = 0
    for i, e in enumerate(trace):
        if e["action"] == "alloc":
            total += e["size"]
            if total > peak:
                peak, peak_at = total, i
        elif e["action"] == "free_requested":
            total -= e["size"]
    live = {}
    for e in trace[:peak_at + 1]:
        if e["action"] == "alloc":
            live[e["addr"]] = e
        elif e["action"] == "free_requested":
            live.pop(e["addr"], None)
    blocks = []
    for e in sorted(live.values(), key=lambda e: -e["size"])[:top]:
        frames = [f"{os.path.basename(f['filename'])}:{f['line']} {f['name']}" for f in e.get("frames", [])
                  if "dyffusion_tpu_torch" in f["filename"]][:2]
        blocks.append({"MiB": round(e["size"] / 2**20, 1), "at": frames})
    return {"peak_MiB": round(peak / 2**20, 1), "blocks": blocks}


# [spatial]'s physical systems, in the same processes, before the SST work:
# NS at full width on W (221x42 -> the 256x256 working grid; f32, TF32 off,
# the preset's dropout 0.15), seeded random weights (stage 2 takes the
# stage-1 model as its interpolator), fake archives at the real grids; one
# spring stage-2 step on H (10 rows split 5/5) at the preset's B64
SPATIAL_NS_TRAIN_STEPS = 2
SPATIAL_NS_GRAD_ROWS = 8
SPATIAL_NS = ["datamodule.batch_size=32", "trainer.accumulate_grad_batches=1", "datamodule.eval_batch_size=4",
              "module.num_predictions=4", "matmul_precision=highest"]
SPATIAL_SPRING = ["matmul_precision=highest", "model.dropout=0.2"]


def _spatial_physical_archives(work):
    """NS and spring-mesh fake archives at the real grids, long enough for
    the presets' prediction horizons (64, 804): NS 68 frames a trajectory
    (52 train windows of horizon 16: one batch of 32), spring 808."""
    from dyffusion_tpu_torch.data import write_fake_benchmark_dir

    return {system: write_fake_benchmark_dir(os.path.join(work, system), name, n_traj={"train": 1, "val": 1, "test": 1},
                                             n_time=n_time, seed=SEED)
            for system, name, n_time in (("navier_stokes", "navier-stokes", 68), ("spring_mesh", "spring-mesh", 808))}


def _spread_weights(model, seed):
    """Every conv's weights drawn anew from ``seed`` at N(0, 1/fan_in), its
    bias at N(0, 0.1^2): the DCGAN init's N(0, 0.02) shrinks the activations
    layer by layer through BatchNorm's initial running averages (mean 0,
    var 1), so that an eval forward at init answers ~0 whatever its halos."""
    import torch
    from torch import nn

    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, (nn.Conv2d, nn.ConvTranspose2d)):
                w = m.weight
                fan_in = w[0].numel() if isinstance(m, nn.Conv2d) else w.shape[0] * w[0, 0].numel() // 4
                w.copy_(torch.randn(w.shape, generator=gen) / fan_in**0.5)
                m.bias.copy_(0.1 * torch.randn(m.bias.shape, generator=gen))


def _spatial_physical_trainers(system, data, k, extra):
    """The stage-2 trainer of ``system`` on ``k`` ranks (1: the witness)
    sharding W (NS) or H (spring), the stage-1 model its interpolator; the
    weights of both from :func:`_spread_weights`."""
    from dyffusion_tpu_torch.config import get_config
    from dyffusion_tpu_torch.interface import build_trainer

    axis = "w" if system == "navier_stokes" else "h"
    overrides = [f"datamodule.data_dir={data}", f"trainer.devices={k}", f"trainer.spatial_shards={k}",
                 f"trainer.spatial_axis={axis}", *extra]
    stage1 = build_trainer(get_config(f"{system}_interpolation", overrides), device="cuda")
    _spread_weights(stage1.experiment.model, SEED + 1)
    stage2 = build_trainer(get_config(f"{system}_dyffusion", overrides), interpolator=stage1.experiment.model,
                           device="cuda")
    _spread_weights(stage2.experiment.model, SEED + 2)
    return stage2


def _wait_for(paths, timeout=DDP_TIMEOUT_S, stop=lambda: False):
    """Until every file of ``paths`` exists, ``stop()`` is true, or
    ``timeout`` seconds (the processes' deadline then reports what
    failed)."""
    t = time.perf_counter()
    while not all(os.path.exists(f) for f in paths) and not stop() and time.perf_counter() - t < timeout:
        time.sleep(0.5)


@contextlib.contextmanager
def _in_float64(trainer):
    """The trainer's train step in float64: the loss on float64 casts of the
    forecaster's weights and of the batch (``mixed_precision_loss``), the
    frozen interpolator in float64; the norms' statistics
    (``distributed.mean_var``, ``F.batch_norm``, ``F.group_norm``) and the
    loss's reductions then run in float64 too, on one rank and on two; the
    gradients come back to the float32 weights."""
    import torch

    from dyffusion_tpu_torch.training.trainer import make_train_step, mixed_precision_loss

    step, interpolator = trainer.train_step, trainer.experiment.engine.interpolator
    loss = mixed_precision_loss(trainer.experiment.make_loss_fn(), trainer.state.model, torch.float64)
    trainer.train_step = make_train_step(loss, sharded=trainer.sharded)
    interpolator.double()
    try:
        yield
    finally:
        trainer.train_step = step
        interpolator.float()


@contextlib.contextmanager
def _cudnn(enabled):
    """``torch.backends.cudnn.enabled`` set to ``enabled`` (False: torch's
    own convs), restored after."""
    import torch

    saved = torch.backends.cudnn.enabled
    torch.backends.cudnn.enabled = enabled
    try:
        yield
    finally:
        torch.backends.cudnn.enabled = saved


# NS stage 2's gradients at SPATIAL_NS_GRAD_ROWS rows: (name, halo backward zeroed, float64, cuDNN on);
# the two ranks' and the witness's, then the planted faults (two ranks) or the controls (the witness:
# a repeat, and f32 with torch's own convs in place of cuDNN's)
SPATIAL_NS_GRADS = [("f32", False, False, True), ("f64", False, True, True)]
SPATIAL_NS_GRADS_RANKS = [("f32 halo backward zeroed", True, False, True), ("f64 halo backward zeroed", True, True, True)]
SPATIAL_NS_GRADS_WITNESS = [("f32 repeat", False, False, True), ("f32 without cudnn", False, False, False)]
# f32: any two f32 computations of these gradients differ by ~1e-3 of scale, one rank's too
# (cuDNN's convs against torch's own: 1.1e-3): where they round a ReLU's or LeakyReLU's
# input to another sign the gradient takes the other slope there
# (scripts/torch_ns_rounding.py); the limit lies between that control and the planted
# fault (9.6e-2). f64: two float64 computations agree to a few float32 units in the last
# place of the gradients they are stored in (2^-23 = 1.2e-7 each)
SPATIAL_NS_F32_TOL, SPATIAL_F64_TOL = 1e-2, 1e-5


def spatial_physical(work, data, world, rank):
    """The physical systems of one [spatial] process: NS sharding W: one
    val request (the first batch, 4 rows x 4 members, seeded) and, on two
    ranks, the same with every halo zeroed; stage 2's loss and gradients
    at :data:`SPATIAL_NS_GRAD_ROWS` rows in float32 and float64, and the
    variants of :data:`SPATIAL_NS_GRADS_RANKS` (two ranks) or
    :data:`SPATIAL_NS_GRADS_WITNESS` (one); two stage-2
    train steps at B32 (seconds, peak memory); then one spring stage-2
    step on H (loss and gradients). Each with its wall time and peak
    memory, and the B1-B3 launches of all of it. Arrays and gradients into
    ``work``. ``UNetSimple``'s one-device decoder upsamples, channels-last
    and NCHW, counted over the NS work."""
    import gc

    import numpy as np
    import torch

    from dyffusion_tpu_torch.models import unet_simple as us
    from dyffusion_tpu_torch.ops import fused_act as fa
    from dyffusion_tpu_torch.ops import linear_attention as la
    from dyffusion_tpu_torch.parallel import spatial

    t0 = time.perf_counter()

    def progress(what):
        print(f"[spatial physical, rank {rank} of {world}] {what} at {time.perf_counter() - t0:.1f} s", flush=True)

    def free():
        gc.collect()
        torch.cuda.empty_cache()

    la.reset_launches()
    fa.reset_launches()
    us.reset_upsamples()
    out, arrays, grads = {}, {}, {}
    trainer = _spatial_physical_trainers("navier_stokes", data["navier_stokes"], world, SPATIAL_NS)
    progress("NS trainers built")
    halo = spatial._halo_all_reduce
    batch = next(iter(trainer.local_eval_batches("val")))[0]
    for name in ["request"] + ["request, halos zeroed"] * (world > 1):
        if "zeroed" in name:
            spatial._halo_all_reduce = lambda buf: buf
        try:
            generator = torch.Generator(device=trainer.device).manual_seed(SEED)
            _sync()
            torch.cuda.reset_peak_memory_stats()
            t = time.perf_counter()
            with trainer.sharded():
                got = trainer.eval_fns["val"](batch, generator, trainer.state.eval_params())
            _sync()
            out[f"ns {name}"] = {"seconds": time.perf_counter() - t, "peak": torch.cuda.max_memory_allocated()}
        finally:
            spatial._halo_all_reduce = halo
        arrays.update({f"ns {name}|{k}": v.cpu().numpy() for k, v in got.items() if k.endswith("_preds")})
        progress(f"NS {name}")
    for name, zeroed, f64, cudnn in SPATIAL_NS_GRADS + (SPATIAL_NS_GRADS_RANKS if world > 1 else SPATIAL_NS_GRADS_WITNESS):
        _sync()
        t = time.perf_counter()
        with _in_float64(trainer) if f64 else contextlib.nullcontext(), _cudnn(cudnn):
            grads[f"ns {name}"] = _spatial_grads(trainer, zeroed, rows=SPATIAL_NS_GRAD_ROWS)
        _sync()
        out[f"ns grads {name}"] = {"seconds": time.perf_counter() - t}
        progress(f"NS gradients, {name}")
    free()
    # the B32 steps of the two ranks, then the witness's, one set on the card at a time
    ranks_done = [os.path.join(work, f"done ns train 2 {r}") for r in range(2)]
    witness_done = os.path.join(work, "done ns train 1 0")
    if world == 1:
        _wait_for(ranks_done)
    progress("NS train steps start")
    out["ns train"] = _spatial_train_steps(trainer, SPATIAL_NS_TRAIN_STEPS)
    progress("NS train steps")
    out["upsamples"] = {"channels_last": us.upsample_channels_last, "nchw": us.upsample_nchw}
    del trainer, batch, got
    free()
    open(os.path.join(work, f"done ns train {world} {rank}"), "w").close()
    if world > 1:
        _wait_for([witness_done])
    trainer = _spatial_physical_trainers("spring_mesh", data["spring_mesh"], world, SPATIAL_SPRING)
    _sync()
    torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    grads["spring"] = _spatial_grads(trainer, False, rows=trainer.datamodule.batch_size)
    _sync()
    out["spring grads"] = {"seconds": time.perf_counter() - t, "peak": torch.cuda.max_memory_allocated()}
    progress("spring step")
    del trainer
    free()
    out["launches"] = {"linear_attention_qkv": la.launches + la.split_launches,
                       "linear_attention_core": la.core_launches, "fused_leaky_relu": fa.launches}
    np.savez(os.path.join(work, f"physical{world}_rank{rank}.npz"), **arrays)
    torch.save(grads, os.path.join(work, f"physical_grads{world}_rank{rank}.pt"))
    open(os.path.join(work, f"done physical {world} {rank}"), "w").close()
    return out


# [spatial]'s diffusion baselines, in the same processes, after the physical
# systems: MCVD over NCSN++ at [ncsnpp]'s width (64x64, C=1, horizon 7,
# 27,941,767 parameters, dropout 0.1) and the DDPM over the SST Unet (60x60,
# dim 64, mults (1,2,4)), both sharding H; f32, TF32 off; seeded weights, every
# NCSN++ parameter moved by N(0, 0.05) draws (its output convs start at 1e-10)
SPATIAL_NCSNPP = ["datamodule.n_traj=5", "datamodule.n_time=9", "datamodule.batch_size=4",
                  "datamodule.eval_batch_size=2", "module.num_predictions=4", "diffusion.sampling_timesteps=10",
                  "matmul_precision=highest"]
SPATIAL_NCSNPP_ROWS = 4  # the forward's and the gradients' rows
SPATIAL_DDPM = ["datamodule.n_traj=5", "datamodule.n_time=20", "datamodule.batch_size=8",
                "datamodule.eval_batch_size=2", "diffusion.timesteps=10", "matmul_precision=highest"]
SPATIAL_DDPM_B1 = 6  # split B1 calls per Unet forward on each rank (mults (1,2,4): 3 downs, 3 ups)
SPATIAL_LOSS_TOL = 1e-5  # the DDPM train step's loss, relative


@contextlib.contextmanager
def _patched(module, name, value):
    """``module.name`` set to ``value`` within the block."""
    saved = getattr(module, name)
    setattr(module, name, value)
    try:
        yield
    finally:
        setattr(module, name, saved)


def _spatial_baseline_trainer(preset, overrides, world):
    """The trainer of ``preset`` at ``overrides`` on ``world`` ranks
    sharding H (1: the witness); NCSN++'s weights moved off their init by
    seeded N(0, 0.05) draws, the same on every process."""
    import torch

    from dyffusion_tpu_torch.config import get_config
    from dyffusion_tpu_torch.interface import build_trainer

    trainer = build_trainer(get_config(preset, [*overrides, f"trainer.devices={world}",
                                                f"trainer.spatial_shards={world}", "trainer.spatial_axis=h"]),
                            device="cuda")
    if "model.name=ncsnpp" in overrides:
        gen = torch.Generator().manual_seed(SEED)
        with torch.no_grad():
            for p in trainer.experiment.model.parameters():
                p.add_(0.05 * torch.randn(p.shape, generator=gen).to(p.device))
    return trainer


def _spatial_ncsnpp_forwards(net, world, faults):
    """``net`` (an NCSN++ for 7 frames after 1 on 64x64) on seeded inputs at
    SPATIAL_NCSNPP_ROWS rows of the global grid, this rank taking its slab
    of H, dropout off; then under each of ``faults`` (name -> (module,
    attribute, value)). This rank's output slab of each, and the sound
    forward's seconds and peak memory."""
    import torch

    from dyffusion_tpu_torch.parallel import distributed, spatial

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    x = torch.randn((SPATIAL_NCSNPP_ROWS, 7, 64, 64), generator=gen, device="cuda")
    cond = torch.randn((SPATIAL_NCSNPP_ROWS, 1, 64, 64), generator=gen, device="cuda")
    t = 1000 * torch.rand((SPATIAL_NCSNPP_ROWS,), generator=gen, device="cuda")
    a, b = spatial.blocks(64, world)[distributed.model_rank()]
    out, info = {}, {}
    for name, patch in [("sound", None)] + list(faults.items()):
        with _patched(*patch) if patch else contextlib.nullcontext():
            _sync()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            with torch.no_grad(), spatial.sharded("h", (64, 64)):
                y = net(x[:, :, a:b], t, cond[:, :, a:b])
            _sync()
        if name == "sound":
            info = {"seconds": time.perf_counter() - t0, "peak": torch.cuda.max_memory_allocated()}
        out[name] = y.cpu().numpy()
    return out, info


def spatial_baselines(work, world, rank):
    """The diffusion baselines of one [spatial] process (sharding H; the
    witness: one rank). MCVD over NCSN++ at full width: one forward at 4
    rows, and on two ranks the same with every halo zeroed (the FIR
    resampling's too) and with the attention over each rank's own tokens;
    the MCVD loss and its gradients at 4 rows (dropout on), and on two
    ranks with the halo's backward zeroed; one request of 2 rows x 4
    members through the 10-step sampler (11 forwards); the SPADE NCSN++
    forward with the same controls. The DDPM over the SST Unet: one request
    of 2 rows x 20 members through the 10-step sampler (B1's launches
    counted from 0), on two ranks again with every draw taken at the
    slab's shape (the negative control); one train step's loss and
    gradients at 8 rows. Each with its wall time and peak memory. Arrays
    and gradients into ``work``; returns the rest."""
    import gc

    import numpy as np
    import torch

    from dyffusion_tpu_torch.config import get_config
    from dyffusion_tpu_torch.models import BackboneSpec, build_backbone
    from dyffusion_tpu_torch.ops import fused_act as fa
    from dyffusion_tpu_torch.ops import linear_attention as la
    from dyffusion_tpu_torch.parallel import spatial
    from dyffusion_tpu_torch.utils import rng
    from dyffusion_tpu_torch.utils.workloads import ncsnpp_overrides, sst_baseline_overrides

    t0 = time.perf_counter()
    la.reset_launches()
    fa.reset_launches()

    def progress(what):
        print(f"[spatial baselines, rank {rank} of {world}] {what} at {time.perf_counter() - t0:.1f} s", flush=True)

    faults = {} if world == 1 else {"halos zeroed": (spatial, "_halo_all_reduce", lambda buf: buf),
                                   "attention per rank": (spatial, "gather", lambda x, level: x)}
    out, arrays, grads = {}, {}, {}
    trainer = _spatial_baseline_trainer("synthetic_mcvd", ncsnpp_overrides(SPATIAL_NCSNPP), world)
    n_params = sum(p.numel() for p in trainer.experiment.model.parameters())
    progress(f"NCSN++ trainer built ({n_params} parameters)")
    got, out["ncsnpp forward"] = _spatial_ncsnpp_forwards(trainer.experiment.model, world, faults)
    arrays.update({f"ncsnpp forward|{k}": v for k, v in got.items()})
    progress("NCSN++ forwards")
    for name, zeroed in (("sound", False), ("halo backward zeroed", True)):
        if zeroed and world == 1:
            continue
        t = time.perf_counter()
        grads[f"ncsnpp {name}"] = _spatial_grads(trainer, zeroed, rows=SPATIAL_NCSNPP_ROWS)
        _sync()
        out[f"ncsnpp grads {name}"] = {"seconds": time.perf_counter() - t}
    progress("NCSN++ gradients")
    _sync()
    torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    got = _spatial_request(trainer)
    _sync()
    out["ncsnpp request"] = {"seconds": time.perf_counter() - t, "peak": torch.cuda.max_memory_allocated(),
                             "members": trainer.experiment.num_members("predict")}
    arrays.update({f"ncsnpp request|{k}": v for k, v in got.items()})
    progress("NCSN++ request")
    del trainer
    gc.collect()
    torch.cuda.empty_cache()
    model_cfg = get_config("synthetic_mcvd", ncsnpp_overrides(["model.name=ncsnpp_spade"]))["model"]
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(SEED)
        spade = build_backbone(model_cfg, BackboneSpec(7, 7, 1, spatial_shape=(64, 64)))
    gen = torch.Generator().manual_seed(SEED + 1)
    with torch.no_grad():
        for p in spade.parameters():
            p.add_(0.05 * torch.randn(p.shape, generator=gen))
    got, out["spade forward"] = _spatial_ncsnpp_forwards(spade.cuda(), world, faults)
    arrays.update({f"spade forward|{k}": v for k, v in got.items()})
    del spade
    gc.collect()
    torch.cuda.empty_cache()
    progress("SPADE NCSN++ forwards")
    launches = {"linear_attention_qkv": la.launches, "linear_attention_core": la.core_launches}

    trainer = _spatial_baseline_trainer("synthetic_ddpm", sst_baseline_overrides(SPATIAL_DDPM), world)
    requests = [("ddpm request", None)] + [("ddpm request, draws per slab", (rng, "grid_slab", lambda: None))] * (
        world > 1)
    for name, patch in requests:
        la.reset_launches()
        _sync()
        torch.cuda.reset_peak_memory_stats()
        t = time.perf_counter()
        with _patched(*patch) if patch else contextlib.nullcontext():
            got = _spatial_request(trainer)
        _sync()
        out[name] = {"seconds": time.perf_counter() - t, "peak": torch.cuda.max_memory_allocated(),
                     "launches": la.launches, "split": la.split_launches,
                     "members": trainer.experiment.num_members("predict")}
        arrays.update({f"{name}|{k}": v for k, v in got.items()})
        progress(name)
    la.reset_launches()
    t = time.perf_counter()
    grads["ddpm"] = _spatial_grads(trainer, False, rows=trainer.datamodule.batch_size)
    _sync()
    out["ddpm step"] = {"seconds": time.perf_counter() - t, "launches": la.launches, "split": la.split_launches}
    progress("DDPM train step")
    out["ncsnpp launches"] = {**launches, "fused_leaky_relu": fa.launches}  # B2: over all of it
    del trainer
    gc.collect()
    torch.cuda.empty_cache()
    np.savez(os.path.join(work, f"baselines{world}_rank{rank}.npz"), **arrays)
    torch.save(grads, os.path.join(work, f"baselines_grads{world}_rank{rank}.pt"))
    return out


def _spatial_baselines_checks(work, ranks, one, card):
    """[spatial]'s diffusion baselines, two ranks against the one-rank
    witness, each answer relative to max|one rank|: the NCSN++ and SPADE
    NCSN++ forwards within 1e-3, every halo zeroed and the attention per
    rank each beyond it; the MCVD loss and gradients within 1e-3 (the
    halo's backward zeroed beyond it); the NCSN++ request within 1e-3; the
    DDPM request within 1e-3 and its draws at the slab's shape beyond it,
    B1 6 split calls a forward on each rank (60 a request); the DDPM train
    step's loss within 1e-5 relative; no B1-B3 launch on the NCSN++ work
    and no B2 launch at all. Prints the times and each rank's peak memory
    against the witness's. Returns the two ranks' B1 launches on
    this path (the sound request and the train step) and the per-request
    count."""
    import numpy as np
    import torch

    base = [r["baselines"] for r in ranks]
    one = one["baselines"]
    p1 = dict(np.load(os.path.join(work, "baselines1_rank0.npz")))
    slabs = [np.load(os.path.join(work, f"baselines2_rank{r}.npz")) for r in range(2)]
    # the H slabs joined: axis 2 of NCHW and of (members, rows, H, W, C)
    p2 = {k: np.concatenate([s[k] for s in slabs], axis=2) for k in slabs[0].files}
    g2 = [torch.load(os.path.join(work, f"baselines_grads2_rank{r}.pt"), weights_only=True) for r in range(2)]
    g1 = torch.load(os.path.join(work, "baselines_grads1_rank0.pt"), weights_only=True)

    def rel(name2, name1):
        keys = [k for k in p1 if k.startswith(f"{name1}|")]
        assert keys, name1
        return max(float(np.abs(p2[k.replace(name1, name2, 1)] - p1[k]).max()) / float(np.abs(p1[k]).max())
                   for k in keys)

    def peaks(name):
        return f"one rank {one[name]['peak'] / 2**30:.3f} GiB, two ranks " + ", ".join(
            f"{b[name]['peak'] / 2**30:.3f} GiB ({b[name]['peak'] / one[name]['peak']:.3f}x)" for b in base)

    def seconds(name):
        return f"one rank {one[name]['seconds']:.2f} s, two ranks {[round(b[name]['seconds'], 2) for b in base]} s"

    for net in ("ncsnpp", "spade"):
        want = p1[f"{net} forward|sound"]
        fwd = {k: float(np.abs(p2[f"{net} forward|{k}"] - want).max()) / float(np.abs(want).max())
               for k in ("sound", "halos zeroed", "attention per rank")}
        print(f"[spatial] {'SPADE ' if net == 'spade' else ''}NCSN++ at full width (nf 64, mults (1,2,3,4), 64x64 "
              f"split on H, f32, dropout off): one forward at {SPATIAL_NCSNPP_ROWS} rows, two ranks vs one, rel. to "
              f"max|one rank|: {fwd['sound']:.3e} (limit {SPATIAL_TOL}); every halo zeroed {fwd['halos zeroed']:.3e}, "
              f"the attention per rank {fwd['attention per rank']:.3e} (each must exceed it); "
              f"{seconds(f'{net} forward')}, peak {peaks(f'{net} forward')}; on {card}")
        assert np.isfinite(want).all() and fwd["sound"] <= SPATIAL_TOL, \
            f"the sharded {net} forward disagrees"
        assert fwd["halos zeroed"] > SPATIAL_TOL and fwd["attention per rank"] > SPATIAL_TOL, \
            f"a control of the {net} forward passes the check: it does not bite"
    assert all(torch.equal(g2[1][n]["grads"][k], v) for n in g2[0] for k, v in g2[0][n]["grads"].items()), \
        "the two ranks hold different summed gradients"
    errs = {n: (abs(g2[0][f"ncsnpp {n}"]["loss"] - g1["ncsnpp sound"]["loss"]) / abs(g1["ncsnpp sound"]["loss"]),
                _max_rel(g2[0][f"ncsnpp {n}"]["grads"], g1["ncsnpp sound"]["grads"]))
            for n in ("sound", "halo backward zeroed")}
    print(f"[spatial] MCVD over NCSN++: the loss and its {len(g1['ncsnpp sound']['grads'])} gradients at "
          f"{SPATIAL_NCSNPP_ROWS} rows (dropout 0.1 on), two ranks vs one (loss rel., gradients rel. to scale): "
          f"{errs['sound'][0]:.3e}, {errs['sound'][1]:.3e} (limit {SPATIAL_TOL}); the halo's backward zeroed "
          f"{errs['halo backward zeroed'][0]:.3e}, {errs['halo backward zeroed'][1]:.3e} (must exceed it); "
          f"{seconds('ncsnpp grads sound')}; on {card}")
    assert max(errs["sound"]) <= SPATIAL_TOL, "the sharded NCSN++ gradients disagree"
    assert errs["halo backward zeroed"][1] > SPATIAL_TOL, "the NCSN++ halo backward's control does not bite"
    req = rel("ncsnpp request", "ncsnpp request")
    print(f"[spatial] MCVD over NCSN++, one request of 2 rows x {one['ncsnpp request']['members']} members through "
          f"the 10-step sampler (11 forwards), two ranks vs one, rel. to max|one rank|: {req:.3e} (limit "
          f"{SPATIAL_TOL}); {seconds('ncsnpp request')}, peak {peaks('ncsnpp request')}; on {card}")
    assert req <= SPATIAL_TOL, "the sharded NCSN++ request disagrees"
    ddpm, own = rel("ddpm request", "ddpm request"), rel("ddpm request, draws per slab", "ddpm request")
    b1 = [(b["ddpm request"]["launches"], b["ddpm request"]["split"]) for b in base]
    loss = abs(g2[0]["ddpm"]["loss"] - g1["ddpm"]["loss"]) / abs(g1["ddpm"]["loss"])
    print(f"[spatial] DDPM over the SST Unet (60x60 split on H, dim 64, mults (1,2,4)), one request of 2 rows x "
          f"{one['ddpm request']['members']} members through the 10-step sampler, two ranks vs one, rel. to "
          f"max|one rank|: {ddpm:.3e} (limit {SPATIAL_TOL}); each rank drawing at its slab's shape {own:.3e} "
          f"(must exceed it); {seconds('ddpm request')}, peak {peaks('ddpm request')}; B1 one rank "
          f"{one['ddpm request']['launches']}, two ranks {b1} "
          f"(all, split); one train step at B8: loss {g1['ddpm']['loss']:.7f}, two ranks rel. {loss:.3e} (limit "
          f"{SPATIAL_LOSS_TOL}), gradients {_max_rel(g2[0]['ddpm']['grads'], g1['ddpm']['grads']):.3e}; "
          f"{seconds('ddpm step')}; on {card}")
    assert ddpm <= SPATIAL_TOL and own > SPATIAL_TOL, "the sharded DDPM request disagrees, or its control passes"
    assert loss <= SPATIAL_LOSS_TOL, "the sharded DDPM train step's loss disagrees"
    per_request = 10 * SPATIAL_DDPM_B1
    launches = [b["ncsnpp launches"] for b in base] + [one["ncsnpp launches"]]
    print(f"[spatial] kernel launches on the NCSN++ work (B2 over all of the baselines' work), each process: "
          f"{launches}")
    assert not any(v for c in launches for v in c.values()), f"a kernel launched on the NCSN++ work: {launches}"
    assert one["ddpm request"]["launches"] == per_request and one["ddpm request"]["split"] == 0, one["ddpm request"]
    for b in base:
        assert b["ddpm request"]["launches"] == b["ddpm request"]["split"] == per_request, b["ddpm request"]
        assert b["ddpm step"]["launches"] == b["ddpm step"]["split"] == SPATIAL_DDPM_B1, b["ddpm step"]
    return sum(b["ddpm request"]["launches"] + b["ddpm step"]["launches"] for b in base), per_request


def spatial_rank_main(work, only=None):
    """One process of ``[spatial]`` (a rank of the two-rank group, or the
    one-rank witness with WORLD_SIZE=1): each of :func:`_spatial_commands`,
    a request (:func:`_spatial_request`), the forward
    (:func:`_spatial_forward`) or ``interface.reload_and_test``
    (mode=test), each with its B1 launches, split B1 launches, wall time
    and peak device memory; the zeroed-halo request under a memory history
    (:func:`_peak_blocks`); then, on the stored stages reloaded with the
    workload's dropout, stage 2's gradients at 16 rows
    (:func:`_spatial_grads`, sound and, on two ranks, with the halo's
    backward zeroed) and each stage's train steps
    (:func:`_spatial_train_steps`); results in ``work``. First of all
    :func:`spatial_physical`, then :func:`spatial_baselines`; ``only``
    ('physical' or 'baselines') runs that one alone."""
    import gc

    import numpy as np
    import torch

    from dyffusion_tpu_torch.interface import reload_and_test, reload_trainer
    from dyffusion_tpu_torch.ops import linear_attention as la
    from dyffusion_tpu_torch.parallel import distributed, spatial

    with open(os.path.join(work, "spatial.json")) as f:
        spec = json.load(f)
    world = int(os.environ.get("WORLD_SIZE", "1"))
    rank = int(os.environ.get("RANK", "0"))
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    physical = spatial_physical(work, spec["physical"], world, rank) if only in (None, "physical") else None
    baselines = spatial_baselines(work, world, rank) if only in (None, "baselines") else None
    if only is not None:
        with open(os.path.join(work, f"spatial{world}_rank{rank}.json"), "w") as f:
            json.dump({"physical": physical, "baselines": baselines}, f)
        if distributed.active():
            torch.distributed.destroy_process_group()
        return 0
    # training first, stage 2 (the most memory) then stage 1, each followed by a file that the
    # CLI's training commands wait for: the stored stages reloaded with the workload's dropout
    layout = [f"trainer.devices={world}", f"trainer.spatial_shards={world}", *SPATIAL_DROPOUT]
    train = {}
    for stage, run_id in (("stage 2", spec["run_id"]), ("stage 1", spec["run_id1"])):
        trainer = reload_trainer(spec["registry"], run_id, layout, device="cuda")
        if stage == "stage 2":
            grads = {name: _spatial_grads(trainer, zeroed) for name, zeroed in
                     (("sound", False), ("repeat", False), ("halo backward zeroed", True)) if world > 1 or not zeroed}
            torch.save(grads, os.path.join(work, f"grads{world}_rank{rank}.pt"))
        train[stage] = _spatial_train_steps(trainer)
        del trainer
        gc.collect()
        torch.cuda.empty_cache()
        open(os.path.join(work, f"done {stage} {world} {rank}"), "w").close()
    out, arrays, history = {}, {}, None
    halo = spatial._halo_all_reduce
    trainer, loaded = None, None  # consecutive commands with the same overrides share one trainer
    for name, kind, overrides in _spatial_commands(world):
        if overrides != loaded:
            trainer, loaded = None, None
        gc.collect()
        torch.cuda.empty_cache()
        zeroed = "zeroed" in name
        try:
            la.reset_launches()
            _sync()
            torch.cuda.reset_peak_memory_stats()
            t = time.perf_counter()
            value = None
            if kind == "test":
                value = reload_and_test(spec["registry"], spec["run_id"], overrides, device="cuda")
            else:
                if trainer is None:
                    trainer = reload_trainer(spec["registry"], spec["run_id"], overrides, device="cuda")
                    loaded = overrides
                _sync()
                if zeroed:
                    spatial._halo_all_reduce = lambda buf: buf
                    torch.cuda.memory._record_memory_history(max_entries=2_000_000, stacks="python")
                torch.cuda.reset_peak_memory_stats()
                t = time.perf_counter()
                got = _spatial_request(trainer) if kind == "request" else _spatial_forward(trainer, halo)
                _sync()
                arrays.update({f"{name}|{k}": v for k, v in got.items()})
                if zeroed:
                    history = _peak_blocks(torch.cuda.memory._snapshot())
                    torch.cuda.memory._record_memory_history(enabled=None)
            _sync()
            out[name] = {"seconds": time.perf_counter() - t, "launches": la.launches, "split": la.split_launches,
                         "peak": torch.cuda.max_memory_allocated(), "value": value}
        finally:
            spatial._halo_all_reduce = halo
    del trainer
    np.savez(os.path.join(work, f"out{world}_rank{rank}.npz"), **arrays)

    # the cost of a global-size draw: a dropout mask at the stage-2 step's top level
    # (B64 x 64 channels x 60 x 60), drawn whole and sliced to this rank's 30 rows,
    # against a draw of the slab's size alone
    draws = {}
    if distributed.model_size() > 1:
        from dyffusion_tpu_torch.utils import rng

        gen = torch.Generator(device="cuda").manual_seed(SEED)
        for name, slab in (("slab only", None), ("global, sliced", rng.Slab(-2, 60, 30 * rank))):
            for i in range(23):
                if i == 3:
                    _sync()
                    t = time.perf_counter()
                rng.rand((DDP_BATCH, 64, 30, 60), gen, "cuda", slab=slab)
            _sync()
            draws[name] = (time.perf_counter() - t) / 20
    # the host round trip of one collective over the model group: a GroupNorm's
    # moments at 120 rows (2 x 120 x 8 f32) on the card, and the same on the host,
    # timed with the card idle
    round_trip = {}
    if distributed.model_size() > 1:
        for where in ("cuda", "cpu"):
            moments = torch.ones((2, 120, 8), device=where)
            for _ in range(20):
                distributed.model_all_reduce(moments)
            _sync()
            t = time.perf_counter()
            for _ in range(200):
                distributed.model_all_reduce(moments)
            _sync()
            round_trip[where] = (time.perf_counter() - t) / 200
    with open(os.path.join(work, f"spatial{world}_rank{rank}.json"), "w") as f:
        json.dump({"commands": out, "train": train, "physical": physical, "baselines": baselines, "draw_s": draws,
                   "backend": distributed.backend(),
                   "model_size": distributed.model_size(), "all_reduce_s": round_trip, "history": history}, f)
    distributed.barrier()
    if distributed.active():
        torch.distributed.destroy_process_group()
    return 0


def _spatial_physical_checks(work, ranks, one, card):
    """[spatial]'s physical systems, two ranks against the one-rank
    witness: the NS val request (W slabs joined) within 1e-3 of max|one
    rank| and its zeroed halos beyond it; NS stage 2's loss and gradients
    at 8 rows in float32 within :data:`SPATIAL_NS_F32_TOL` (as is one
    rank against itself with torch's own convs) and in float64 within
    :data:`SPATIAL_F64_TOL` (the halo's backward zeroed beyond each); each
    rank's NS stage-2 step peak at most 0.8x the witness's; the spring
    step's loss and gradients within 1e-3; no B1-B3 launch. Prints the
    times and peaks."""
    import numpy as np
    import torch

    phys = [r["physical"] for r in ranks]
    p1 = dict(np.load(os.path.join(work, "physical1_rank0.npz")))
    slabs = [np.load(os.path.join(work, f"physical2_rank{r}.npz")) for r in range(2)]
    # (members, rows, H, W, C): the W slabs joined
    p2 = {k: np.concatenate([s[k] for s in slabs], axis=3) for k in slabs[0].files}
    grads = [torch.load(os.path.join(work, f"physical_grads2_rank{r}.pt"), weights_only=True) for r in range(2)]
    g1 = torch.load(os.path.join(work, "physical_grads1_rank0.pt"), weights_only=True)

    def rel(name):
        keys = [k for k in p1 if k.startswith("ns request|")]
        assert keys
        return max(float(np.abs(p2[k.replace("ns request", name, 1)] - p1[k]).max()) / float(np.abs(p1[k]).max())
                   for k in keys)

    req, zeroed = rel("ns request"), rel("ns request, halos zeroed")
    shape = p1[sorted(p1)[0]].shape
    print(f"[spatial] NS at full width on W (UNetSimple dim 64, 256x256 working grid, f32, dropout on): one val "
          f"request {shape} (members, rows, H, W, C), two ranks vs one, rel. to max|one rank|: {req:.3e}; every halo "
          f"zeroed {zeroed:.3e} (must exceed {SPATIAL_TOL}); one rank {one['physical']['ns request']['seconds']:.2f} s, "
          f"peak {one['physical']['ns request']['peak'] / 2**30:.3f} GiB; two ranks "
          + "; ".join(f"{p['ns request']['seconds']:.2f} s, peak {p['ns request']['peak'] / 2**30:.3f} GiB" for p in phys)
          + f"; on {card}")
    assert np.isfinite(p1[sorted(p1)[0]]).all() and req <= SPATIAL_TOL, "the sharded NS request disagrees"
    assert zeroed > SPATIAL_TOL, "the NS request's zeroed halos pass the check: it does not bite"
    assert all(torch.equal(grads[1][n]["grads"][k], v) for n in grads[0] for k, v in grads[0][n]["grads"].items()), \
        "the two ranks hold different summed gradients"

    def rel(got, want):
        return abs(got["loss"] - want["loss"]) / abs(want["loss"]), _max_rel(got["grads"], want["grads"])

    def furthest(got, want):
        top = max(float(w.abs().max()) for w in want.values())
        worst = sorted(((float((got[k] - w).abs().max()) / max(float(w.abs().max()), 0.1 * top), k,
                         float(w.abs().max()) / top) for k, w in want.items()), reverse=True)[:4]
        return [(f"{e:.2e}", k, f"{m:.2e}") for e, k, m in worst]

    ns = {n: g for n, g in grads[0].items() if n.startswith("ns ")}
    errs = {n: rel(ns[f"ns {n}"], g1["ns " + n.replace(" halo backward zeroed", "")]) for n in
            ("f32", "f32 halo backward zeroed", "f64", "f64 halo backward zeroed")}
    errs["spring"] = rel(grads[0]["spring"], g1["spring"])
    # the witness alone: its f32 against its f64, against a repeat, and against torch's own convs (the control)
    convs = "cuDNN's convs vs torch's"
    own = {"f32 vs f64": rel(g1["ns f32"], g1["ns f64"]), "f32 vs a repeat": rel(g1["ns f32 repeat"], g1["ns f32"]),
           convs: rel(g1["ns f32 without cudnn"], g1["ns f32"])}
    print(f"[spatial] NS stage-2 loss and its {len(g1['ns f32']['grads'])} forecaster gradients at "
          f"{SPATIAL_NS_GRAD_ROWS} rows, two ranks vs one (loss, gradients rel. to scale): f32 "
          f"{errs['f32'][0]:.3e}, {errs['f32'][1]:.3e} (limit {SPATIAL_NS_F32_TOL}; one rank against itself, "
          f"{convs}: {own[convs][1]:.3e}, must be within it), "
          f"the halo's backward zeroed {errs['f32 halo backward zeroed'][1]:.3e} (must exceed it); f64 "
          f"{errs['f64'][0]:.3e}, {errs['f64'][1]:.3e} (limit {SPATIAL_F64_TOL}), the halo's backward zeroed "
          f"{errs['f64 halo backward zeroed'][1]:.3e} (must exceed it); spring stage-2 step on H at the preset's "
          f"batch: {errs['spring'][0]:.3e}, {errs['spring'][1]:.3e}; one rank "
          f"{one['physical']['spring grads']['seconds']:.2f} s, two ranks "
          f"{[round(p['spring grads']['seconds'], 2) for p in phys]} s; on {card}")
    print("[spatial] NS stage-2 gradients of one rank (loss, gradients rel. to scale): "
          + "; ".join(f"{k} {a:.3e}, {b:.3e}" for k, (a, b) in own.items()))
    for name, got, want in (("f32, two ranks vs one", ns["ns f32"], g1["ns f32"]),
                            ("f64, two ranks vs one", ns["ns f64"], g1["ns f64"]),
                            ("one rank, f32 vs f64", g1["ns f32"], g1["ns f64"])):
        print(f"[spatial] NS stage-2 gradients, {name}, furthest off (error / scale, tensor, its max|g| / max of "
              f"all): {furthest(got['grads'], want['grads'])}")
    assert max(errs["f32"]) <= SPATIAL_NS_F32_TOL and max(errs["spring"]) <= SPATIAL_TOL, \
        "the sharded gradients disagree"
    assert max(own[convs]) <= SPATIAL_NS_F32_TOL, "one rank's own spread reaches the f32 limit: it separates nothing"
    assert max(errs["f64"]) <= SPATIAL_F64_TOL, "the sharded float64 gradients disagree"
    assert errs["f32 halo backward zeroed"][1] > SPATIAL_NS_F32_TOL, "the NS halo backward's f32 control does not bite"
    assert errs["f64 halo backward zeroed"][1] > SPATIAL_F64_TOL, "the NS halo backward's f64 control does not bite"
    w_peak = max(c["peak"] for c in one["physical"]["ns train"])
    peaks = [max(c["peak"] for c in p["ns train"]) / w_peak for p in phys]
    print(f"[spatial] NS stage-2 train step at B32 (f32, dropout on): one rank "
          f"{[round(c['seconds'] * 1e3, 1) for c in one['physical']['ns train']]} ms, peak {w_peak / 2**30:.3f} GiB; "
          f"two ranks " + "; ".join(f"{[round(c['seconds'] * 1e3, 1) for c in p['ns train']]} ms, peak "
                                     f"{max(c['peak'] for c in p['ns train']) / 2**30:.3f} GiB" for p in phys)
          + f"; per rank over one rank's peak {', '.join(f'{x:.3f}' for x in peaks)} (limit "
          f"{SPATIAL_TRAIN_MEMORY_LIMIT}); the processes share {card}")
    assert max(peaks) <= SPATIAL_TRAIN_MEMORY_LIMIT, f"a rank's NS stage-2 step peak is {max(peaks):.3f} of one rank's"
    launches = [p["launches"] for p in phys] + [one["physical"]["launches"]]
    print(f"[spatial] kernel launches on the NS and spring paths, each process: {launches}")
    assert not any(v for c in launches for v in c.values()), f"a kernel launched on the physical paths: {launches}"
    upsamples = [p["upsamples"] for p in phys] + [one["physical"]["upsamples"]]
    print(f"[spatial] UNetSimple's one-device decoder upsamples over the NS work (channels-last input or not), "
          f"the two ranks, then the witness: {upsamples}")
    assert not any(v for p in upsamples[:2] for v in p.values()) and upsamples[2]["channels_last"], \
        f"the ranks ran a one-device upsample, or the witness none channels-last: {upsamples}"


def _metrics_rel(got, want):
    """The largest |got - want| / max(|want|) over the test metrics (no
    throughput)."""
    keys = [k for k in want if "frames_per_sec" not in k]
    scale = max(abs(want[k]) for k in keys)
    return max(abs(got[k] - want[k]) for k in keys) / scale


def _spatial_start(work, flag, world=2):
    """The ``world`` gloo ranks sharing cuda:0 (the launcher's environment)
    and the one-rank witness (``WORLD_SIZE=1``) of ``[spatial]`` (or of
    ``[spatial-thin]``), each ``chip_smoke.py flag work``: name ->
    :func:`_ddp_start`'s."""
    port = _free_port()
    procs = {}
    for rank in range(world):
        env = {**os.environ, "RANK": str(rank), "LOCAL_RANK": str(rank), "WORLD_SIZE": str(world),
               "LOCAL_WORLD_SIZE": str(world), "MASTER_ADDR": "localhost", "MASTER_PORT": str(port)}
        procs[f"rank{rank}"] = _ddp_start(work, f"rank{rank}", [os.path.abspath(__file__), flag, work], env)
    env = {k: v for k, v in os.environ.items() if k not in ("RANK", "WORLD_SIZE", "LOCAL_RANK")}
    procs["witness"] = _ddp_start(work, "witness", [os.path.abspath(__file__), flag, work], env)
    return procs


def phase_spatial_part(card, part):
    """One part of ``[spatial]`` alone, in its three processes
    (``chip_smoke.py --spatial-physical-rank`` or ``--spatial-baselines-rank``):
    the physical systems (:func:`spatial_physical`,
    :func:`_spatial_physical_checks`) or the diffusion baselines
    (:func:`spatial_baselines`, :func:`_spatial_baselines_checks`; returns
    theirs)."""
    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix=f"chip_smoke_spatial_{part}_") as work:
        with open(os.path.join(work, "spatial.json"), "w") as f:
            json.dump({"physical": _spatial_physical_archives(work) if part == "physical" else None}, f)
        t = time.perf_counter()
        seconds = _ddp_finish(work, _spatial_start(work, f"--spatial-{part}-rank"), t)
        ranks = [json.load(open(os.path.join(work, f"spatial2_rank{r}.json"))) for r in range(2)]
        one = json.load(open(os.path.join(work, "spatial1_rank0.json")))
        checks = (_spatial_physical_checks if part == "physical" else _spatial_baselines_checks)(work, ranks, one, card)
    print(f"[spatial] processes: {json.dumps({k: round(v, 1) for k, v in seconds.items()})} s (sharing the card); "
          f"phase wall time {time.perf_counter() - t_phase:.1f} s")
    return checks


def phase_spatial(card, reg=None, ids=None, also_start=None):
    """Spatial sharding on the card, eval and training. 1. The split B1
    kernel against its plain version at the per-rank SST shapes
    (:func:`_spatial_b1_check`). 2. The SST stages trained on one rank
    (``[ddp]``'s one-rank commands: 8 steps a stage, f32, TF32 off; the
    full run reuses ``[ddp]``'s run, ``reg`` and ``ids`` = its two run
    ids). 3. Two gloo ranks sharing cuda:0 (``chip_smoke.py
    --spatial-rank``, the launcher's environment) split the grid's H axis,
    beside a one-rank witness (``WORLD_SIZE=1``) and the CLI's own spawn of
    two ranks on the W axis (``mode=test``, the test split's 23 rows as one
    batch of 10 members): requests of the predict split (6 rows, 20
    members): in f32 with the SST workload's dropout, the same with every
    halo zeroed (the negative control, under a memory history), both, and
    ``mode=test``, with the sampler cut to 13 forwards (no auxiliary steps;
    :data:`SPATIAL_SHORT`); one bf16 request with dropout off, cut alike; one
    forecaster forward in f32, bf16 and bf16 with every halo zeroed; then
    each process's training work (:func:`spatial_rank_main`). 4. The CLI's
    own spawn trains both stages on two ranks sharding H, beside a one-rank
    witness of the same commands (:func:`_spatial_train_commands`). Checks:
    the f32 request within 1e-3 of max|one rank| and the zeroed-halo request
    beyond it; the bf16 forward within 5e-2 of max|one rank| and its zeroed
    halos beyond it; the W-axis test metrics within 1e-3 relative; B1 78
    calls per (cut) request on each rank, every one split
    across the ranks; each rank's peak device memory for the bf16 request at
    most 0.7x the witness's; stage 2's loss and forecaster gradients at 16
    rows within 1e-3 of max|one rank| and, with the halo's backward zeroed,
    beyond it; B1 6 calls per stage-1 step and 24 per stage-2 step on each
    rank, every one split; each rank's stage-2 step peak at most 0.8x the
    witness's; the CLI's two-rank training within 1e-3 of the witness in
    every logged loss and within 1e-2 of its change in the final weights.
    Before all of it, in the same processes, the physical systems
    (:func:`spatial_physical`, :func:`_spatial_physical_checks`), then the
    diffusion baselines (:func:`spatial_baselines`,
    :func:`_spatial_baselines_checks`); the CLI's ``mode=test`` starts once
    the physical systems are done. Returns the two ranks' B1 launches, the
    per-request count, the split kernel's times and the baselines' B1
    launches and per-request count. ``also_start``: called right after
    its processes start (the full run starts ``[spatial-thin]``'s there, so
    that their startup overlaps)."""
    import gc

    import numpy as np
    import torch

    t_phase = time.perf_counter()
    times = _spatial_b1_check()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_spatial_") as work:
        if reg is None:  # train the SST stages on one rank, as [ddp] does
            from dyffusion_tpu_torch import train

            reg = os.path.join(work, "registry")
            commands, id1, id2 = _ddp_commands(reg, 1)
            for _, argv in commands[:2]:
                train.main(argv)
            ids = (id1, id2)
        with open(os.path.join(work, "spatial.json"), "w") as f:
            json.dump({"registry": reg, "run_id1": ids[0], "run_id": ids[1],
                       "physical": _spatial_physical_archives(work)}, f)
        run_id = ids[1]
        gc.collect()
        torch.cuda.empty_cache()  # this process's cached blocks, for the processes below
        t = time.perf_counter()
        procs = _spatial_start(work, "--spatial-rank")
        if also_start is not None:
            also_start()
        # the CLI's mode=test on W once the physical systems' B32 steps have left the card
        _wait_for([os.path.join(work, f"done physical {w} {r}") for w, r in ((2, 0), (2, 1), (1, 0))],
                  stop=lambda: any(p.poll() not in (None, 0) for p, _, _ in procs.values()))
        procs["cli w"] = _ddp_start(work, "cli_w", [
            "-m", "dyffusion_tpu_torch.train", "mode=test", f"run_id={run_id}", f"registry_dir={reg}",
            "trainer.devices=2", "trainer.spatial_shards=2", "trainer.spatial_axis=w", *SPATIAL_TEST])
        # the CLI trains both stages on two ranks and on one beside the requests above, each stage
        # once the processes above have left their B64 steps of that stage (the card holds one
        # set of stage-2 steps)
        train_regs = {k: os.path.join(work, f"train{k}") for k in (1, 2)}
        train_cmds = {k: _spatial_train_commands(train_regs[k], k) for k in (1, 2)}
        assert train_cmds[1][1:] == train_cmds[2][1:], "the run ids must not depend on the shards"
        seconds = {}
        try:
            for i, (stage, wait_for) in enumerate((("stage 1", "stage 2"), ("stage 2", "stage 1"))):
                done = [os.path.join(work, f"done {wait_for} {w} {r}") for w, r in ((2, 0), (2, 1), (1, 0))]
                while not all(os.path.exists(f) for f in done):
                    if any(p.poll() not in (None, 0) for p, _, _ in procs.values()) or \
                            time.perf_counter() - t > DDP_TIMEOUT_S:
                        break  # _ddp_finish reports it
                    time.sleep(0.5)
                seconds.update(_ddp_finish(work, {f"train {stage}, {k} rank{'s' * (k > 1)}": _ddp_start(
                    work, f"train{k}_{i + 1}", ["-m", "dyffusion_tpu_torch.train", *train_cmds[k][0][i]])
                    for k in (1, 2)}, t))
        finally:  # every process ends here, also when a training command failed
            seconds.update(_ddp_finish(work, procs, t))
        ranks = [json.load(open(os.path.join(work, f"spatial2_rank{r}.json"))) for r in range(2)]
        one = json.load(open(os.path.join(work, "spatial1_rank0.json")))
        grads = {r: torch.load(os.path.join(work, f"grads2_rank{r}.pt"), weights_only=True) for r in range(2)}
        grads["one"] = torch.load(os.path.join(work, "grads1_rank0.pt"), weights_only=True)
        _spatial_physical_checks(work, ranks, one, card)
        baselines = _spatial_baselines_checks(work, ranks, one, card)
        with open(os.path.join(work, "cli_w.log")) as f:
            cli_w = [json.loads(x) for x in f if x.startswith('{"test/')][-1]
        slabs = [np.load(os.path.join(work, f"out2_rank{r}.npz")) for r in range(2)]
        p1 = dict(np.load(os.path.join(work, "out1_rank0.npz")))
        # the two ranks' H slabs joined: axis 2 of (members, rows, H, W, C) and of NCHW
        p2 = {k: np.concatenate([s[k] for s in slabs], axis=2) for k in slabs[0].files}
        # the CLI's two-rank training against the one-rank witness's
        from dyffusion_tpu_torch.interface import build_trainer
        from dyffusion_tpu_torch.utils import registry_api

        _, id1, id2 = train_cmds[1]
        trained = {}
        for stage, run in (("stage 1", id1), ("stage 2", id2)):
            init_cfg = {**registry_api.get_run_config(train_regs[1], run), "trainer": {"devices": 1}}
            init = build_trainer(init_cfg, device="cpu").state.model.state_dict()
            trained[stage] = _ddp_disagreement(train_regs[2], train_regs[1], run, init, steps=SPATIAL_TRAIN_STEPS)
    print(f"[spatial] processes: {json.dumps({k: round(v, 1) for k, v in seconds.items()})} s (sharing the card); "
          f"backends {[r['backend'] for r in ranks]}, model axis {[r['model_size'] for r in ranks]}; one gloo "
          f"all_reduce of a GroupNorm's moments (7.7 KB on cuda:0 and on the host), card idle, ms: "
          f"{json.dumps([{k: round(v * 1e3, 3) for k, v in r['all_reduce_s'].items()} for r in ranks])}")
    assert all(r["backend"] == "gloo" and r["model_size"] == 2 for r in ranks)
    for name, c1 in one["commands"].items():
        print(f"[spatial] {name}: one rank {c1['seconds']:.2f} s, peak {c1['peak'] / 2**30:.3f} GiB, B1 "
              f"{c1['launches']}; on {card}")
    for name in ranks[0]["commands"]:
        print(f"[spatial] {name}: two ranks " + "; ".join(
            f"{r['commands'][name]['seconds']:.2f} s, peak {r['commands'][name]['peak'] / 2**30:.3f} GiB, "
            f"B1 {r['commands'][name]['launches']} ({r['commands'][name]['split']} split)" for r in ranks)
            + f"; on {card}")

    # the answers, relative to max|one rank|
    def rel(name2, name1):
        keys = [k for k in p1 if k.startswith(f"{name1}|")]
        assert keys, name1
        return max(float(np.abs(p2[k.replace(name1, name2, 1)] - p1[k]).max()) / float(np.abs(p1[k]).max())
                   for k in keys)

    req = rel("request f32", "request f32")
    zeroed = rel("request f32, halos zeroed", "request f32")
    bf16 = rel("request bf16", "request bf16")
    t_w = _metrics_rel(cli_w, one["commands"]["test f32"]["value"])
    print(f"[spatial] two ranks vs one, rel. to max|one rank|: f32 request (dropout on, no auxiliary steps) "
          f"{req:.3e}, the same with every halo zeroed {zeroed:.3e} (must exceed {SPATIAL_TOL}), bf16 request "
          f"(dropout off) {bf16:.3e}; mode=test f32 metrics on W (the CLI's own ranks) {t_w:.3e}, "
          f"test/crps one rank {one['commands']['test f32']['value']['test/crps']:.6f}, two ranks "
          f"{cli_w['test/crps']:.6f}")
    assert req <= SPATIAL_TOL and t_w <= SPATIAL_TOL, "two ranks disagree with one rank"
    assert zeroed > SPATIAL_TOL, "the zeroed halos pass the check: it does not bite"

    # the forecaster's forward: bf16 (the eval precision) and f32, two ranks against one
    fwd = {name: float(np.abs(p2[f"forward|{name}"] - p1[f"forward|{ref}"]).max())
           / float(np.abs(p1[f"forward|{ref}"]).max())
           for name, ref in (("f32", "f32"), ("bf16", "bf16"), ("bf16, halos zeroed", "bf16"))}
    bf16_vs_f32 = float(np.abs(p1["forward|bf16"] - p1["forward|f32"]).max()) / float(np.abs(p1["forward|f32"]).max())
    print(f"[spatial] one forecaster forward ({SPATIAL_FORWARD_ROWS} rows, dropout off), two ranks vs one, rel. to "
          f"max|one rank|: f32 {fwd['f32']:.3e}, bf16 {fwd['bf16']:.3e} (limit {SPATIAL_BF16_TOL}), bf16 with every "
          f"halo zeroed {fwd['bf16, halos zeroed']:.3e} (must exceed it); one rank's bf16 vs its f32 {bf16_vs_f32:.3e}")
    assert fwd["f32"] <= SPATIAL_TOL and fwd["bf16"] <= SPATIAL_BF16_TOL, "the sharded forward disagrees with one rank"
    assert fwd["bf16, halos zeroed"] > SPATIAL_BF16_TOL, "the zeroed halos pass the bf16 check: it does not bite"

    # B1: on each rank the one-rank count of each request (78 at 13 forwards), every call split
    per_request = one["commands"]["request bf16"]["launches"]
    assert per_request == 78, per_request
    for r in ranks:
        for name, c in r["commands"].items():
            want = one["commands"][name.replace(", halos zeroed", "")]["launches"]
            if name == "forward":  # the ranks' three forwards (the zeroed one too) against the witness's two
                want = want * 3 // 2
            assert c["launches"] == want == c["split"], (name, c["launches"], c["split"], want)
    assert all(c["split"] == 0 for c in one["commands"].values())

    # memory: each rank's peak for the dropout-off bf16 request against one rank's (the check), and
    # for the dropout-on f32 request (printed), with the largest blocks alive at the zeroed-halo
    # request's peak (the same request under a memory history)
    def ratios(name):
        return [r["commands"][name]["peak"] / one["commands"][name]["peak"] for r in ranks]

    ratio = max(ratios("request bf16"))
    print(f"[spatial] peak device memory of the bf16 request (dropout off), per rank over one rank's: "
          f"{', '.join(f'{x:.3f}' for x in ratios('request bf16'))} (limit {SPATIAL_MEMORY_LIMIT}); of the f32 request "
          f"(dropout on, no auxiliary steps): {', '.join(f'{x:.3f}' for x in ratios('request f32'))}")
    for r, rk in enumerate(ranks):
        print(f"[spatial] rank {r}, the f32 request with its halos zeroed under a memory history: the largest blocks "
              f"alive at its peak: {json.dumps(rk['history'])}")
    assert ratio <= SPATIAL_MEMORY_LIMIT, f"a rank's peak memory is {ratio:.3f} of one rank's"

    # training: stage 2's loss and forecaster gradients at 16 rows, two ranks against one
    g1 = grads["one"]["sound"]
    assert all(torch.equal(grads[1][n]["grads"][k], v) for n in grads[0] for k, v in grads[0][n]["grads"].items()), \
        "the two ranks hold different summed gradients"

    def worst(got, want, n=3):  # the n tensors furthest off, as _max_rel measures them
        top = max(float(w.abs().max()) for w in want.values())
        return sorted(((float((got[k] - w).abs().max()) / max(float(w.abs().max()), 0.1 * top), k,
                        float(w.abs().max()) / top) for k, w in want.items()), reverse=True)[:n]

    grad_err = {n: _max_rel(grads[0][n]["grads"], g1["grads"]) for n in grads[0]}
    loss_err = {n: abs(grads[0][n]["loss"] - g1["loss"]) / abs(g1["loss"]) for n in grads[0]}
    print(f"[spatial] stage-2 loss and its {len(g1['grads'])} forecaster gradients at {SPATIAL_GRAD_ROWS} rows "
          f"(dropout on), two ranks vs one, rel. to max|one rank| (each tensor against the larger of its own and "
          f"0.1 of the largest): sound: loss {loss_err['sound']:.3e}, gradients {grad_err['sound']:.3e} (limit "
          f"{SPATIAL_TOL}); the halo's backward zeroed: loss {loss_err['halo backward zeroed']:.3e}, gradients "
          f"{grad_err['halo backward zeroed']:.3e} (must exceed it); the same step again, one rank "
          f"{_max_rel(grads['one']['repeat']['grads'], g1['grads']):.3e}, two ranks "
          f"{_max_rel(grads[0]['repeat']['grads'], grads[0]['sound']['grads']):.3e}")
    for what, got, want in (("two ranks vs one", grads[0]["sound"], g1), ("one rank vs itself", grads["one"]["repeat"], g1)):
        print(f"[spatial] stage-2 gradients, {what}, furthest off (error / scale, tensor, its max|g| / max of all): "
              f"{[(f'{e:.2e}', k, f'{m:.2e}') for e, k, m in worst(got['grads'], want['grads'])]}")
    assert loss_err["sound"] <= SPATIAL_TOL and grad_err["sound"] <= SPATIAL_TOL, "the sharded gradients disagree"
    assert grad_err["halo backward zeroed"] > SPATIAL_TOL, "the zeroed halo backward passes the check: it does not bite"
    # training: B1 per step, step times and peak memory at B64
    for stage, per_step in SPATIAL_B1_PER_STEP.items():
        for r in ranks:
            got = [(c["launches"], c["split"]) for c in r["train"][stage]]
            assert got == [(per_step, per_step)] * SPATIAL_TRAIN_STEPS, (stage, got)
        assert [c["launches"] for c in one["train"][stage]] == [per_step] * SPATIAL_TRAIN_STEPS, one["train"][stage]
        peaks = [max(c["peak"] for c in r["train"][stage]) / max(c["peak"] for c in one["train"][stage]) for r in ranks]
        print(f"[spatial] {stage} train step at B{DDP_BATCH} (f32, dropout on): one rank "
              f"{[round(c['seconds'] * 1e3, 1) for c in one['train'][stage]]} ms, peak "
              f"{max(c['peak'] for c in one['train'][stage]) / 2**30:.3f} GiB; two ranks "
              + "; ".join(f"{[round(c['seconds'] * 1e3, 1) for c in r['train'][stage]]} ms, peak "
                          f"{max(c['peak'] for c in r['train'][stage]) / 2**30:.3f} GiB" for r in ranks)
              + f"; per rank over one rank's peak {', '.join(f'{x:.3f}' for x in peaks)}; B1 {per_step} a step on "
              f"each, every one split; the processes share {card}")
        if stage == "stage 2":
            assert max(peaks) <= SPATIAL_TRAIN_MEMORY_LIMIT, f"a rank's stage-2 step peak is {max(peaks):.3f} of one rank's"
    print(f"[spatial] one dropout mask at the stage-2 step's top level, ({DDP_BATCH}, 64, 30, 60) a rank, ms: "
          f"{json.dumps([{k: round(v * 1e3, 4) for k, v in r['draw_s'].items()} for r in ranks])} (drawn at the "
          f"global ({DDP_BATCH}, 64, 60, 60) and sliced, as a sharded step draws, against the slab's size alone)")
    # training: the CLI's two ranks against its one-rank witness
    for stage, (worst, (rel, ref)) in trained.items():
        print(f"[spatial] the CLI's {stage} on two ranks vs one ({SPATIAL_TRAIN_STEPS} steps at B{DDP_BATCH}, f32, "
              f"dropout on): losses one rank {[round(x, 6) for x in ref]}, relative differences "
              f"{[float(f'{x:.2e}') for x in rel]}; {json.dumps(worst)}")
        assert worst["loss"] <= SPATIAL_TOL, f"the CLI's {stage} losses disagree: {worst['loss']:.3e}"
        assert all(v <= SPATIAL_WEIGHTS_TOL for k, v in worst.items() if "rel L2" in k), f"{stage} weights: {worst}"
    print(f"[spatial] two ranks on one card measure no scaling and no NVLink traffic; phase wall time "
          f"{time.perf_counter() - t_phase:.1f} s")
    launches = sum(c["launches"] for r in ranks for c in r["commands"].values())
    launches += sum(c["launches"] for r in ranks for steps in r["train"].values() for c in steps)
    return launches, per_request, times, baselines


# ---------------------------------------------------------------------------
# [spatial-thin]: the layouts a shard once refused, on the card. Four gloo
# ranks sharing cuda:0 (chip_smoke.py --spatial-thin-rank) split the H axis
# of a 12 x 60 grid under the SST Unet at full width (dim 64, mults
# (1, 2, 4), 4 heads x 32): its levels of 12, 6 and 3 rows split 3/3/3/3,
# 2/2/1/1 and 1/1/1/0, so rank 3 holds no row of the deepest level; beside
# a one-rank witness. f32 with TF32 off and dropout off.
THIN_WORLD = 4
THIN_GRID = (12, 60)
THIN_ROWS = 16  # the forwards' rows
THIN_GRAD_ROWS = 4
THIN_TOL = 1e-3  # relative to max|one rank| (gradients: to their scale, as _grads_within)
# bf16 against one rank: bf16 rounds each layer's output, and the two layouts'
# convs and norms sum in other orders (the card read 1.2e-2 where the CPU read
# 9.0e-3): [spatial]'s limit, with a zeroed-halo control in bf16 beyond it
THIN_BF16_TOL = SPATIAL_BF16_TOL
THIN_RESIZE_TOL = 1e-5  # f32 resamples, TF32 off: the contractions sum in another order
# the split B1's tokens on each of the four ranks, (12 x 60, 6 x 30, 3 x 15) levels
THIN_B1 = ((180, 180, 180, 180), (60, 60, 30, 30), (15, 15, 15, 0))
# the 'qk' linear attention at the SST widths of the top and deepest levels: (channels, grid)
THIN_QK = ((64, (12, 60)), (256, (3, 15)))
# NS's outer resample, 221 x 42 -> 256 x 256 -> 221 x 42, sharded on W as NS is
THIN_NS = ((221, 42), (256, 256))
THIN_METHODS = ("nearest", "bilinear", "bicubic", "lanczos3", "lanczos5")


def _thin_unet():
    import torch

    from dyffusion_tpu_torch.models import Unet

    torch.manual_seed(SEED)
    return Unet(dim=64, num_input_channels=1, num_output_channels=1, num_conditional_channels=1,
                dim_mults=(1, 2, 4), with_time_emb=True, attn_heads=4, attn_dim_head=32).cuda()


def spatial_thin_rank_main(work):
    """One process of ``[spatial-thin]`` (a rank of the four-rank group, or
    the witness with WORLD_SIZE=1): on seeded inputs at the global grid,
    this rank's slab of the ``Unet``'s forward in f32 (with its B1 split
    calls and their partial and output passes, counted from 0), the same
    with every halo zeroed, bf16, the gradients of sum(output * cot) at
    :data:`THIN_GRAD_ROWS` rows, the 'qk' attention forward and backward
    (:data:`THIN_QK`) and NS's resample there and back by each of
    :data:`THIN_METHODS` (sharding W); the witness also each resample on
    the CPU. Results in ``work``."""
    import numpy as np
    import torch

    from dyffusion_tpu_torch.experiments.base import cast_params
    from dyffusion_tpu_torch.models.base import apply_model
    from dyffusion_tpu_torch.models.modules import LinearAttention
    from dyffusion_tpu_torch.ops import linear_attention as la
    from dyffusion_tpu_torch.parallel import distributed, spatial
    from dyffusion_tpu_torch.utils import resize as resize_ops

    world = int(os.environ.get("WORLD_SIZE", "1"))
    rank = int(os.environ.get("RANK", "0"))
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    if world > 1:
        distributed.init_distributed("cuda")
        distributed.set_model_axis(world)
    t0 = time.perf_counter()
    H, W = THIN_GRID
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    x, cond = (torch.randn((THIN_ROWS, 1, H, W), generator=gen, device="cuda") for _ in range(2))
    cot = torch.randn((THIN_GRAD_ROWS, 1, H, W), generator=gen, device="cuda")
    t = torch.rand((THIN_ROWS,), generator=gen, device="cuda") * 4
    a, b = spatial.blocks(H, world)[rank]

    def slab(v, dim=2):
        lo, hi = spatial.blocks(v.shape[dim], world)[rank]
        return v.narrow(dim, lo, hi - lo)

    context = (lambda grid: spatial.sharded("h", grid)) if world > 1 else (lambda grid: contextlib.nullcontext())
    net = _thin_unet()
    out, info = {}, {"world": world, "rank": rank, "rows": [a, b]}

    def forward(dtype, rows=THIN_ROWS):
        with context((H, W)):
            return apply_model(net, cast_params(net, dtype), slab(x[:rows]).to(dtype), t[:rows],
                               slab(cond[:rows]).to(dtype))

    with torch.no_grad():
        forward(torch.float32)  # warm-up
        _sync()
        la.reset_launches()
        t1 = time.perf_counter()
        out["f32"] = forward(torch.float32).cpu()
        _sync()
        info["forward_ms"] = (time.perf_counter() - t1) * 1e3
        info["b1"] = {"calls": la.launches, "split_calls": la.split_launches,
                      "partial_passes": la.split_partial_launches, "output_passes": la.split_output_launches}
        out["bf16"] = forward(torch.bfloat16).float().cpu()
        if world > 1:
            halo = spatial._halo_all_reduce
            spatial._halo_all_reduce = lambda buf: buf
            try:
                out["f32, halos zeroed"] = forward(torch.float32).cpu()
                out["bf16, halos zeroed"] = forward(torch.bfloat16).float().cpu()
            finally:
                spatial._halo_all_reduce = halo

    def group_grads(module):
        return {k: distributed.model_sum(torch.zeros_like(p) if p.grad is None else p.grad.clone()).cpu()
                for k, p in module.named_parameters()}

    xg = slab(x[:THIN_GRAD_ROWS]).clone().requires_grad_(True)
    t1 = time.perf_counter()
    with context((H, W)):
        y = net(xg, t[:THIN_GRAD_ROWS], slab(cond[:THIN_GRAD_ROWS]))
    (y * slab(cot)).sum().backward()
    _sync()
    info["backward_ms"] = (time.perf_counter() - t1) * 1e3
    out["grads"] = {"x": xg.grad.cpu(), **group_grads(net)}
    del net, xg, y
    for dim, grid in THIN_QK:
        torch.manual_seed(SEED + dim)
        attn = LinearAttention(dim, 4, 32, rescale="qk").cuda()
        xq = torch.randn((THIN_GRAD_ROWS, dim, *grid), generator=gen, device="cuda")
        cq = torch.randn((THIN_GRAD_ROWS, dim, *grid), generator=gen, device="cuda")
        xq = slab(xq).clone().requires_grad_(True)
        with context(grid):
            yq = attn(xq, None, spatial.current().top()) if world > 1 else attn(xq)
        (yq * slab(cq)).sum().backward()
        out[f"qk {grid}"] = {"out": yq.detach().cpu(), "grads": {"x": xq.grad.cpu(), **group_grads(attn)}}
    src, size = THIN_NS
    xs = torch.randn((2, 3, *src), generator=gen, device="cuda")
    errs = {}
    for method in THIN_METHODS:
        mode = resize_ops.mode(method)
        if world > 1:  # on W, as NS shards
            level = spatial.Level(-1, src[1], src[0], distributed.model_rank(), world)
            up, up_level = spatial.resize(slab(xs, 3), level, size, mode)
            back, _ = spatial.resize(up, up_level, src, mode)
        else:
            up = resize_ops.resize(xs, size, method)
            back = resize_ops.resize(up, src, method)
            cpu_up = resize_ops.resize(xs.cpu(), size, method)
            cpu_back = resize_ops.resize(cpu_up, src, method)
            errs[method] = [float((up.cpu() - cpu_up).abs().max() / cpu_up.abs().max()),
                            float((back.cpu() - cpu_back).abs().max() / cpu_back.abs().max())]
        out[f"resize {method}"] = {"up": up.cpu(), "back": back.cpu()}
    info["card_vs_cpu"] = errs
    info["seconds"] = time.perf_counter() - t0
    torch.save(out, os.path.join(work, f"thin{world}_rank{rank}.pt"))
    with open(os.path.join(work, f"thin{world}_rank{rank}.json"), "w") as f:
        json.dump(info, f)
    if world > 1:
        distributed.barrier()
        torch.distributed.destroy_process_group()
    return 0


def spatial_thin_start(work):
    """The four ranks and the witness of ``[spatial-thin]``, started: its
    processes (:func:`_spatial_start`'s) and their start time."""
    return _spatial_start(work, "--spatial-thin-rank", world=THIN_WORLD), time.perf_counter()


def _thin_b1_check():
    """The split B1 kernel against B1's plain version over all the tokens at
    the four ranks' shapes of ``[spatial-thin]`` (:data:`THIN_B1`, at
    :data:`THIN_ROWS` rows, f32 and bf16), the ranks emulated in one
    process; the rank of no tokens launches no partial and no output pass.
    Times each rank's three steps (no collectives; the rank of no tokens:
    its two merges) against its plain split and its bound: its qkv read
    and output written, and the partial and maxima its merges write."""
    import numpy as np
    import torch

    from dyffusion_tpu_torch.ops import linear_attention as la

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    rows, bh = THIN_ROWS, THIN_ROWS * 4
    times, empty = {}, {}
    for dtype in (torch.float32, torch.bfloat16):
        dt = str(dtype)[6:]
        for tokens in THIN_B1:
            full = _qkv(rows, sum(tokens), dtype, True, gen)
            bounds = np.cumsum((0,) + tokens)
            parts = [full[:, i:j] for i, j in zip(bounds[:-1], bounds[1:])]
            la.reset_launches()
            got = _b1_split_emulated(parts)
            _sync()
            passes = (la.split_partial_launches, la.split_output_launches)
            assert passes == (sum(1 for n in tokens if n),) * 2, (tokens, passes)
            want = la.linear_attention_qkv_plain(full, 4, 32, 32**-0.5)
            _check_vs_plain(f"[spatial-thin] split B1 B={rows} N={'+'.join(map(str, tokens))} {dt}",
                            torch.cat(got, dim=1), want, REL_TOL[dt], negative_controls=tokens[0] == 180)
            for r, (q, n) in enumerate(zip(parts, tokens)):
                if n == 0:
                    la.reset_launches()
                    ws, S, m = la.split_partial(q, 4, 32)
                    y = la.split_output(q, la.split_merge(q, ws, S, m), 4, 32, 32**-0.5, sum(tokens))
                    _sync()
                    empty[f"{tokens} {dt}"] = {"partial_passes": la.split_partial_launches,
                                               "output_passes": la.split_output_launches,
                                               "output_shape": list(y.shape), "maxima_all_-inf": bool(
                                                   torch.isinf(m).all())}
                    assert empty[f"{tokens} {dt}"]["partial_passes"] == 0 == empty[f"{tokens} {dt}"]["output_passes"]
                key = f"({rows}, {n}, 384) {dt}"
                if key in times:
                    continue

                def kernel(q=q, n_total=sum(tokens)):
                    ws, S, m = la.split_partial(q, 4, 32)
                    return la.split_output(q, la.split_merge(q, ws, S, m), 4, 32, 32**-0.5, n_total)

                ms, plain_ms = _time_pair(kernel, lambda q=q, n_total=sum(tokens): la.linear_attention_qkv_split_plain(
                    q, 4, 32, 32**-0.5, n_total))
                bound, by = _bound(rows * n * 512 * full.element_size() + bh * (la.PARTIAL_FLOATS + 32) * 4,
                                   0)
                times[key] = {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound, "share": bound / ms}
                print(f"[spatial-thin] split B1, one rank of four, {key}: {ms:.4f} ms (three steps, no collectives), "
                      f"plain {plain_ms:.4f} ms, bound {bound:.5f} ms ({by}), share {bound / ms:.3f}")
    print(f"[spatial-thin] the rank of no tokens, launches of its B1 passes (partial, output): {json.dumps(empty)}")
    return times


def spatial_thin_finish(card, work, procs, t):
    """Wait for ``[spatial-thin]``'s processes, then check them against the
    witness and print: the f32 forward within :data:`THIN_TOL` of
    max|one rank| and the zeroed-halo forward beyond it; bf16 within
    :data:`THIN_BF16_TOL`; the gradients at 4 rows within THIN_TOL of their
    scale; the 'qk' attention's outputs and gradients likewise; each
    resample method on four ranks within :data:`THIN_RESIZE_TOL` of the
    witness and the witness's card within it of the CPU; B1's split calls,
    6 a forward on each rank, and the empty rank's partial and output
    passes (4 each: none at the 3 x 15 level). Then the split B1 kernel at
    the ranks' shapes (:func:`_thin_b1_check`). Returns the ranks' B1
    launches and the kernel's times."""
    import torch

    seconds = _ddp_finish(work, procs, t)
    ranks = [torch.load(os.path.join(work, f"thin{THIN_WORLD}_rank{r}.pt"), weights_only=True)
             for r in range(THIN_WORLD)]
    infos = [json.load(open(os.path.join(work, f"thin{THIN_WORLD}_rank{r}.json"))) for r in range(THIN_WORLD)]
    one = torch.load(os.path.join(work, "thin1_rank0.pt"), weights_only=True)
    one_info = json.load(open(os.path.join(work, "thin1_rank0.json")))
    joined = lambda get, dim=2: torch.cat([get(r) for r in ranks], dim=dim)  # noqa: E731

    def rel(got, want):
        return float((got.float() - want.float()).abs().max() / want.float().abs().max())

    f32, zeroed, bf16, bf16_zeroed = (rel(joined(lambda r: r[k]), one[k.split(",")[0]])
                                      for k in ("f32", "f32, halos zeroed", "bf16", "bf16, halos zeroed"))
    grads = dict(ranks[0]["grads"])
    grads["x"] = joined(lambda r: r["grads"]["x"])
    ok, worst = _grads_within(grads, one["grads"], THIN_TOL)
    print(f"[spatial-thin] SST Unet (dim 64, mults (1,2,4), 4 heads x 32) on a 12x60 grid split on H over four ranks "
          f"(levels 12/6/3 rows: 3/3/3/3, 2/2/1/1, 1/1/1/0) vs one rank, rel. to max|one rank|: f32 forward "
          f"({THIN_ROWS} rows) {f32:.2e} (limit {THIN_TOL}), halos zeroed {zeroed:.2e} (must exceed it); bf16 "
          f"{bf16:.2e} (limit {THIN_BF16_TOL}), halos zeroed {bf16_zeroed:.2e} (must exceed it); gradients at "
          f"{THIN_GRAD_ROWS} rows, worst {worst:.3g} of the limit")
    assert f32 <= THIN_TOL, f"[spatial-thin] the f32 forward on four ranks is {f32:.2e} of max off one rank's"
    assert zeroed > THIN_TOL, f"[spatial-thin] the check accepts the forward with its halos zeroed ({zeroed:.2e})"
    assert bf16 <= THIN_BF16_TOL, f"[spatial-thin] the bf16 forward on four ranks is {bf16:.2e} of max off"
    assert bf16_zeroed > THIN_BF16_TOL, f"[spatial-thin] the bf16 check accepts zeroed halos ({bf16_zeroed:.2e})"
    assert ok, f"[spatial-thin] the gradients on four ranks are {worst:.2f} of their limit off one rank's"
    qk = {}
    for _, grid in THIN_QK:
        key = f"qk {grid}"
        g = dict(ranks[0][key]["grads"])
        g["x"] = joined(lambda r: r[key]["grads"]["x"])
        qk[key] = [rel(joined(lambda r: r[key]["out"]), one[key]["out"]),
                   _grads_within(g, one[key]["grads"], THIN_TOL)[1]]
    resize = {method: [rel(joined(lambda r: r[f"resize {method}"][w], 3), one[f"resize {method}"][w])
                       for w in ("up", "back")] for method in THIN_METHODS}
    b1 = [info["b1"] for info in infos]
    print(f"[spatial-thin] 'qk' attention (forward rel., gradients' worst share of the limit): {json.dumps(qk)}")
    print(f"[spatial-thin] NS resample 221x42 -> 256x256 -> 221x42 on W, four ranks vs one (up, back): "
          f"{json.dumps(resize)}; one card vs the CPU: {json.dumps(one_info['card_vs_cpu'])}")
    print(f"[spatial-thin] B1 per f32 forward, each rank (calls, split calls, partial passes, output passes): "
          f"{[[c['calls'], c['split_calls'], c['partial_passes'], c['output_passes']] for c in b1]}")
    print(f"[spatial-thin] f32 forward / backward wall ms, ranks {[round(i['forward_ms'], 1) for i in infos]} / "
          f"{[round(i['backward_ms'], 1) for i in infos]}, one rank {one_info['forward_ms']:.1f} / "
          f"{one_info['backward_ms']:.1f} (four ranks share the card: no scaling measured); processes "
          f"{json.dumps({k: round(v, 1) for k, v in seconds.items()})} s")
    for key, (err, grad_share) in qk.items():
        assert err <= THIN_TOL and grad_share <= 1.0, f"[spatial-thin] {key}: {qk[key]}"
    for method in THIN_METHODS:
        assert max(resize[method]) <= THIN_RESIZE_TOL, f"[spatial-thin] {method} on four ranks: {resize[method]}"
        assert max(one_info["card_vs_cpu"][method]) <= THIN_RESIZE_TOL, (method, one_info["card_vs_cpu"][method])
    assert all(c["split_calls"] == 6 == c["calls"] for c in b1), b1
    assert [c["partial_passes"] for c in b1] == [6, 6, 6, 4] == [c["output_passes"] for c in b1], b1
    times = _thin_b1_check()
    print(f"[spatial-thin] on {card}")
    return sum(c["calls"] for c in b1), times


def phase_spatial_thin(card):
    """``[spatial-thin]`` alone: its processes, then their checks."""
    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_spatial_thin_") as work:
        out = spatial_thin_finish(card, work, *spatial_thin_start(work))
    print(f"[spatial-thin] phase wall time {time.perf_counter() - t_phase:.1f} s")
    return out


def main(argv) -> int:
    import torch

    t_run = time.perf_counter()

    if len(argv) in (2, 3) and argv[0] == "--serve-exported":  # a serving process of [export] or [baselines]
        return serve_exported_main(*argv[1:])
    if argv and argv[0] == "--export-own-draws":  # [export]'s planted data-parallel fault
        return export_own_draws_main(argv[1:])
    if argv and argv[0] == "--export-small-run":  # [export]'s platform leg
        return export_small_run_main(argv[1:])
    if len(argv) == 2 and argv[0] == "--ddp-rank":  # a rank of [ddp]'s two-rank run
        return ddp_rank_main(argv[1])
    if len(argv) == 2 and argv[0] == "--ddp-witness":  # the one-rank witnesses of [ddp]
        return ddp_witness_main(argv[1])
    if len(argv) == 2 and argv[0] == "--spatial-rank":  # a rank (or the witness) of [spatial]
        return spatial_rank_main(argv[1])
    if len(argv) == 2 and argv[0] in ("--spatial-physical-rank", "--spatial-baselines-rank"):  # one part alone
        return spatial_rank_main(argv[1], only=argv[0].split("-")[3])
    if len(argv) == 2 and argv[0] == "--spatial-thin-rank":  # a rank (or the witness) of [spatial-thin]
        return spatial_thin_rank_main(argv[1])
    modes = ([], ["--profile"], ["--kernels"], ["--physical"], ["--baselines"], ["--ncsnpp"], ["--export"], ["--oisst"],
             ["--members"], ["--ddp"], ["--spatial"], ["--spatial-physical"], ["--spatial-baselines"],
             ["--spatial-thin"])
    if argv not in modes:
        raise SystemExit(
            "usage: python3 chip_smoke.py [--profile | --kernels | --physical | --baselines | --ncsnpp | --export "
            "| --oisst | --members | --ddp | --spatial | --spatial-physical | --spatial-baselines | --spatial-thin]")
    name, smi = phase_device()
    if argv == ["--spatial-physical"]:  # no kernel runs on these paths
        phase_spatial_part(smi, "physical")
        return 0
    phase_build()
    if argv == ["--spatial-baselines"]:
        _spatial_b1_check()
        phase_spatial_part(smi, "baselines")
        return 0
    if argv == ["--spatial"]:
        phase_spatial(smi)
        return 0
    if argv == ["--spatial-thin"]:
        phase_spatial_thin(smi)
        return 0
    if argv == ["--members"]:
        phase_members(smi)
        return 0
    if argv == ["--ddp"]:
        phase_ddp(smi)
        return 0
    if argv == ["--oisst"]:
        phase_oisst(smi)
        return 0
    if argv == ["--export"]:
        with tempfile.TemporaryDirectory(prefix="chip_smoke_registry_") as reg, \
                tempfile.TemporaryDirectory(prefix="chip_smoke_export_") as work:
            _, run2 = phase_cli(smi, reg)
            pipelines = start_exports(reg, run2, work)
            try:
                phase_export(smi, reg, run2, pipelines, work)
            finally:
                for p in pipelines.values():
                    p.stop()
        return 0
    if argv == ["--profile"]:
        phase_profile(smi)
        for key in PHYSICAL:
            phase_profile_physical(smi, key)
        phase_profile_baseline(smi)
        phase_profile_ncsnpp(smi)
        return 0
    if argv == ["--baselines"]:
        phase_baselines(smi)
        return 0
    if argv == ["--ncsnpp"]:
        phase_ncsnpp_reference()
        phase_ncsnpp(smi)
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
    with tempfile.TemporaryDirectory(prefix="chip_smoke_registry_") as reg, \
            tempfile.TemporaryDirectory(prefix="chip_smoke_export_") as work:
        cli, run2 = phase_cli(smi, reg)
        # [export]'s two artifacts are traced in the background while the
        # next phases run; their requests wait for phase_export
        pipelines = start_exports(reg, run2, work)
        try:
            phase_physical_reference()
            physical = {spec["label"]: phase_physical(smi, key) for key, spec in PHYSICAL.items()}
            baselines, baseline_requests, baseline_artifacts = phase_baselines(smi)
            phase_ncsnpp_reference()
            ncsnpp = phase_ncsnpp(smi)
            export, export_per_request, export_dp = phase_export(smi, reg, run2, pipelines, work)
        finally:
            for p in pipelines.values():
                p.stop()
    oisst, oisst_per_request = phase_oisst(smi)
    members, members_per_request = phase_members(smi)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_ddp_") as work, \
            tempfile.TemporaryDirectory(prefix="chip_smoke_spatial_thin_") as thin_work:
        ddp = phase_ddp(smi, work)  # [spatial] tests [ddp]'s one-rank stage-2 run
        thin = []  # [spatial-thin]'s processes start beside [spatial]'s and are checked after them
        try:
            spatial, spatial_per_request, spatial_times, (spatial_baselines, baselines_per_request) = phase_spatial(
                smi, os.path.join(work, "registry1"), _ddp_commands(os.path.join(work, "registry1"), 1)[1:],
                also_start=lambda: thin.append(spatial_thin_start(thin_work)))
        finally:  # they end here if [spatial] failed
            if thin and sys.exc_info()[0] is not None:
                for p, log, _ in thin[0][0].values():
                    p.kill()
                    p.wait()
                    log.close()
        thin_launches, thin_times = spatial_thin_finish(smi, thin_work, *thin[0])
    print(f"[run] the full run took {time.perf_counter() - t_run:.1f} s of this script's 1150 s budget")
    # B1's top-level numbers are the [train] path's (this slice's main path);
    # by_path keeps each path's own count, read after setting it to 0.
    # No single PyTorch call computes any of the three functions: library_ms is null
    print(json.dumps({"kernels": [
        {"name": "linear_attention_qkv", "route": "cuda", "source": la.SOURCE, "replaces": la.REPLACES,
         "launches": train, "max_abs_err": b1["max_abs_err"], **b1["train"], "bound_by": "bytes", "library_ms": None,
         "by_path": {"serve": {"launches": serve, **b1["serve"]}, "train": {"launches": train, **b1["train"]},
                     "fit": {"launches": fit}, "cli": {"launches": cli},
                     **{p: {"launches": c["linear_attention_qkv"]} for p, c in physical.items()},
                     **{f"baselines_{m}": {"launches": n, "per_request": baseline_requests[m]}
                        for m, n in baselines.items()},
                     **{f"baselines_{m}_artifact": c for m, c in baseline_artifacts.items()},
                     "ncsnpp": {"launches": ncsnpp["linear_attention_qkv"]},
                     "export": {"launches": export, "per_request": export_per_request},
                     "export_data_parallel": export_dp,
                     "oisst": {"launches": oisst, "per_request": oisst_per_request},
                     "members": {"launches": members, "per_request": members_per_request},
                     "ddp": {"launches": ddp},
                     "spatial": {"launches": spatial, "per_request": spatial_per_request,
                                 "split_per_rank": spatial_times},
                     "spatial_baselines": {"launches": spatial_baselines, "per_request": baselines_per_request},
                     "spatial_thin": {"launches": thin_launches, "split_per_rank": thin_times}}},
        {"name": "fused_leaky_relu", "route": "cuda", "source": fa.SOURCE, "replaces": fa.REPLACES,
         "launches": op_launches["fused_leaky_relu"], **b2, "library_ms": None,
         "by_path": {p: {"launches": c["fused_leaky_relu"]} for p, c in {**physical, "ncsnpp": ncsnpp}.items()}},
        {"name": "linear_attention_core", "route": "cuda", "source": la.CORE_SOURCE, "replaces": la.CORE_REPLACES,
         "launches": op_launches["linear_attention_core"], **b3, "library_ms": None,
         "by_path": {p: {"launches": c["linear_attention_core"]} for p, c in {**physical, "ncsnpp": ncsnpp}.items()}},
    ]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
