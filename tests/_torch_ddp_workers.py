"""Spawned gloo ranks on the CPU for the data-parallel tests of the port.

:func:`run_ranks` starts ``world`` fresh processes (``spawn``), each with the
launcher's environment (``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``,
``MASTER_PORT`` on a free port), one torch thread and ``OMP_NUM_THREADS=1``,
joins them into one gloo group through ``parallel.init_distributed`` and
runs ``fn(rank, world, *args)``. Each rank's return value comes back
through a queue. Every rank has a deadline of its own (120 s unless the
caller gives another): a rank that hangs is killed and fails the test, as
does one that raises (its traceback is in the failure). This module
imports no JAX, so that a rank starts fast.
"""
from __future__ import annotations

import builtins
import contextlib
import os
import queue
import shutil
import socket
import time
import traceback
from typing import Any, Callable, List, Optional

import numpy as np

JOIN_TIMEOUT_S = 120.0


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _entry(fn, rank: int, world: int, port: int, out, args) -> None:
    os.environ.update(RANK=str(rank), LOCAL_RANK=str(rank), WORLD_SIZE=str(world), LOCAL_WORLD_SIZE=str(world),
                      MASTER_ADDR="localhost", MASTER_PORT=str(port))
    import torch

    from dyffusion_tpu_torch.parallel import distributed

    torch.set_num_threads(1)
    try:
        distributed.init_distributed("cpu", timeout_s=JOIN_TIMEOUT_S)
        out.put((rank, "ok", fn(rank, world, *args)))
    except Exception:  # noqa: BLE001 (handed to the test, which fails with it)
        out.put((rank, "error", traceback.format_exc()))
    finally:
        if distributed.active():
            torch.distributed.destroy_process_group()


def run_ranks(fn: Callable, world: int, *args, timeout: float = JOIN_TIMEOUT_S) -> List[Any]:
    """``[fn(rank, world, *args) for rank in range(world)]``, each in a rank
    of its own; raises ``AssertionError`` if a rank raises or outlives
    ``timeout`` seconds."""
    import multiprocessing as mp

    ctx = mp.get_context("spawn")
    out = ctx.Queue()
    port = free_port()
    old = os.environ.get("OMP_NUM_THREADS")
    os.environ["OMP_NUM_THREADS"] = "1"
    try:
        procs = [ctx.Process(target=_entry, args=(fn, r, world, port, out, args), daemon=True) for r in range(world)]
        for p in procs:
            p.start()
    finally:
        if old is None:
            os.environ.pop("OMP_NUM_THREADS")
        else:
            os.environ["OMP_NUM_THREADS"] = old
    deadline = time.monotonic() + timeout
    results, errors = {}, []
    try:
        while len(results) + len(errors) < world:
            try:
                rank, status, value = out.get(timeout=max(0.1, min(1.0, deadline - time.monotonic())))
            except queue.Empty:
                if time.monotonic() > deadline:
                    raise AssertionError(f"ranks {sorted(set(range(world)) - set(results))} did not finish "
                                         f"within {timeout} s")
                if any(p.exitcode not in (None, 0) for p in procs) and out.empty():
                    raise AssertionError(f"a rank died: exit codes {[p.exitcode for p in procs]}")
                continue
            if status == "ok":
                results[rank] = value
            else:
                errors.append(f"rank {rank}:\n{value}")
        if errors:
            raise AssertionError("\n".join(errors))
        for p in procs:
            p.join(timeout=max(1.0, deadline - time.monotonic()))
        return [results[r] for r in range(world)]
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(5.0)


# ---------------------------------------------------------------------------
# rank functions (module level: a spawned rank imports them by name)


def batch_norm_rank(rank: int, world: int, x: np.ndarray, cot: np.ndarray, params: dict) -> dict:
    """The cross-rank BatchNorm on this rank's rows of the global batch
    ``x`` (NCHW): its output, the gradients of sum(y * cot) by x (this
    rank's rows), weight and bias (summed over ranks), and the updated
    running statistics."""
    import torch

    from dyffusion_tpu_torch.models.base import BatchNorm2d
    from dyffusion_tpu_torch.parallel import distributed
    from dyffusion_tpu_torch.parallel.mesh import process_local_rows

    rows = process_local_rows(x.shape[0], rank, world)
    bn = BatchNorm2d(x.shape[1])
    with torch.no_grad():
        for k, v in params.items():
            getattr(bn, k).copy_(torch.as_tensor(v))
    xs = torch.tensor(x[rows], requires_grad=True)
    stats: dict = {}
    y = bn(xs, stats)
    (y * torch.as_tensor(cot[rows])).sum().backward()
    grads = torch.cat([bn.weight.grad, bn.bias.grad])
    distributed.all_reduce_sum(grads)
    mean, var, count = stats[bn]
    C = x.shape[1]
    return {"y": y.detach().numpy(), "dx": xs.grad.numpy(), "dweight": grads[:C].numpy(),
            "dbias": grads[C:].numpy(), "mean": mean.numpy(), "var": var.numpy(), "count": int(count)}


def metric_sums_rank(rank: int, world: int, preds: np.ndarray, targets: np.ndarray) -> dict:
    """The trainer's padded eval path on one odd batch: pad to the world,
    this rank's rows, ``metric_sums`` with the valid mask, the sums
    all-reduced."""
    import torch

    from dyffusion_tpu_torch.data.base import pad_batch
    from dyffusion_tpu_torch.parallel import distributed
    from dyffusion_tpu_torch.parallel.mesh import process_local_rows
    from dyffusion_tpu_torch.training.trainer import metric_sums

    n = targets.shape[0]
    target = -(-n // world) * world
    padded, n_valid = pad_batch({"targets": targets, "preds": np.moveaxis(preds, 1, 0)}, target)
    rows = process_local_rows(target, rank, world)
    valid = torch.arange(rows.start, rows.stop) < n_valid
    sums = metric_sums(torch.as_tensor(np.moveaxis(padded["preds"][rows], 0, 1)),
                       torch.as_tensor(padded["targets"][rows]), valid)
    flat = distributed.all_reduce_sum(torch.stack([sums[k] for k in ("n", "sq", "var", "crps")]))
    return dict(zip(("n", "sq", "var", "crps"), flat.tolist()))


def gradients_rank(rank: int, world: int) -> list:
    """``all_reduce_gradients`` over a weight only rank 1 reaches (grad
    None on rank 0) and one every rank reaches, with buckets of 3 elements
    (so the flat gradient spans several buckets)."""
    import torch

    from dyffusion_tpu_torch.parallel import distributed

    a = torch.nn.Parameter(torch.zeros(4))
    b = torch.nn.Parameter(torch.zeros(5))
    loss = (b * (rank + 1)).sum() + ((a * 2.0).sum() if rank == 1 else 0.0)
    loss.backward()
    distributed.all_reduce_gradients([a, b], bucket_elements=3)
    return [a.grad.tolist(), b.grad.tolist()]


class _WriteSpy:
    """Records every write this process makes under ``root``: files opened
    for writing, ``os.replace``, ``shutil.rmtree``, ``torch.save``."""

    def __init__(self, root: str):
        import torch

        self.root, self.writes = os.path.abspath(root), []
        self._saved = (builtins.open, os.replace, shutil.rmtree, torch.save)

        def under(path) -> bool:
            return isinstance(path, (str, os.PathLike)) and os.path.abspath(path).startswith(self.root)

        def spy_open(file, mode="r", *a, **k):
            if under(file) and any(c in mode for c in "wax+"):
                self.writes.append(("open", str(file)))
            return self._saved[0](file, mode, *a, **k)

        def spy_replace(src, dst, *a, **k):
            if under(dst):
                self.writes.append(("replace", str(dst)))
            return self._saved[1](src, dst, *a, **k)

        def spy_rmtree(path, *a, **k):
            if under(path):
                self.writes.append(("rmtree", str(path)))
            return self._saved[2](path, *a, **k)

        def spy_save(obj, f, *a, **k):
            if under(f):
                self.writes.append(("save", str(f)))
            return self._saved[3](obj, f, *a, **k)

        builtins.open, os.replace, shutil.rmtree, torch.save = spy_open, spy_replace, spy_rmtree, spy_save

    def close(self) -> None:
        import torch

        builtins.open, os.replace, shutil.rmtree, torch.save = self._saved


@contextlib.contextmanager
def own_gamma():
    """The planted fault of MCVD's Gamma noise in a data-parallel step: each
    rank draws the Gamma noise of its own rows from its own step generator
    (instead of its rows of the global batch's draw)."""
    import torch

    from dyffusion_tpu_torch.utils import rng

    saved = rng.row_gamma
    rng.row_gamma = lambda conc, shape, generator, device, grid=False: torch._standard_gamma(
        conc.expand(tuple(shape)).contiguous(), generator=generator)
    try:
        yield
    finally:
        rng.row_gamma = saved


def train_rank(rank: int, world: int, stage1: list, stage2: list, spring: list, registry: str,
               mcvd: Optional[list] = None, mcvd_fault: Optional[list] = None) -> dict:
    """Stage 1 (``run_experiment`` into ``registry``), stage 2 from the
    registry by run id, then :func:`spring_step` on this rank's rows, then
    the MCVD run of ``mcvd`` and, under :func:`own_gamma`, of
    ``mcvd_fault``; returns the run ids, the stage-2 ``Trainer.predict`` of
    the val split, the writes this rank made under the registry and the
    spring step."""
    import torch

    from dyffusion_tpu_torch.config import get_config
    from dyffusion_tpu_torch.interface import run_experiment
    from dyffusion_tpu_torch.parallel import distributed

    spy = _WriteSpy(registry)
    try:
        tr1, _ = run_experiment(get_config("synthetic_interpolation", stage1), device="cpu")
        run1 = os.path.basename(tr1.ckpt.run_dir)
        tr2, _ = run_experiment(get_config("synthetic_dyffusion", stage2 + [f"diffusion.interpolator_run_id={run1}"]),
                                device="cpu")
        predicted = tr2.predict("val")
    finally:
        spy.close()
    out = {"run1": run1, "run2": os.path.basename(tr2.ckpt.run_dir), "writes": spy.writes,
           "predict": {k: v for k, v in predicted.items()}}
    out["spring"] = spring_step(get_config("spring_mesh_interpolation", spring), rank, world)
    for key, overrides, fault in (("mcvd", mcvd, contextlib.nullcontext()), ("mcvd_fault", mcvd_fault, own_gamma())):
        if overrides is not None:
            with fault:
                out[key] = os.path.basename(run_experiment(get_config("synthetic_mcvd", overrides),
                                                           device="cpu")[0].ckpt.run_dir)
    distributed.barrier()
    return out


def spring_step(config: dict, rank: int = 0, world: int = 1) -> dict:
    """One stage-1 train step of the spring mesh's ``SimpleConvNet`` (with
    BatchNorm) through ``Trainer.train_step`` on this rank's rows of the
    first global batch: the logged metrics, the gradients the optimizer
    received (averaged over ranks) and the running statistics after the
    step."""
    import torch

    from dyffusion_tpu_torch.interface import build_trainer
    from dyffusion_tpu_torch.models.base import BatchNorm2d

    trainer = build_trainer(config, device="cpu")
    n = trainer.datamodule.batch_size // world
    batch = next(iter(trainer.datamodule.train_loader(
        rng=np.random.default_rng(0), device_put=trainer._put, rows=slice(rank * n, (rank + 1) * n))))
    state, grads = trainer.state, {}
    apply = state.apply_gradients

    def capture(updates=None):
        grads.update({k: p.grad.detach().numpy().copy() for k, p in state.params.items()})
        return apply(updates)

    state.apply_gradients = capture
    metrics = trainer.train_step(state, batch)
    model = trainer.experiment.model
    return {
        "loss": float(metrics["loss"]),
        "grads": grads,
        "stats": {k: v.numpy().copy() for k, v in model.state_dict().items() if "running" in k},
        "n_batch_norms": sum(isinstance(m, BatchNorm2d) for m in model.modules()),
    }


def collectives_rank(rank: int, world: int, bn_args: tuple, sums_args: tuple) -> dict:
    """:func:`batch_norm_rank`, :func:`metric_sums_rank` and
    :func:`gradients_rank` in one spawn."""
    return {"bn": batch_norm_rank(rank, world, *bn_args), "sums": metric_sums_rank(rank, world, *sums_args),
            "grads": gradients_rank(rank, world)}
