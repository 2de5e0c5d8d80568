"""Native host batch gather, a prefetching train iterator, and device staging.

Counterpart of ``dyffusion_tpu/data/native_loader.py``:

- :func:`gather_batch`: ``src[indices]`` through the threaded C++ row gather
  of ``csrc/batch_gather.cpp`` (the port's own copy of the JAX package's
  source), with a fused f64 -> f32 variant. ``g++`` builds it on first use
  into ``build/native/`` beside the package, in a file named by a hash of
  the source, the flags and the compiler, and ``ctypes`` loads it. A
  non-contiguous source, and a host without ``g++``, take numpy indexing
  instead; :func:`native_available` says which path runs, and the numpy
  one is announced once. A build that ``g++`` attempts and fails raises.
- :class:`PrefetchIterator`: a background thread assembles the next batches
  (and stages them on the device) while the current train step runs.
- :class:`DeviceStager`: the staging. On CUDA each array goes into pinned
  host memory and then to the device with ``non_blocking=True``, on the
  stream that was current where the stager was made (the train step's
  stream), so every kernel the step queues later on that stream runs after
  the copy. Each pinned buffer is held until an event recorded after its
  copy has completed, so none is freed or reused while its copy is in
  flight. JAX's ``device_put`` has no such hazards; this class is the
  port's own.
"""
from __future__ import annotations

import collections
import ctypes
import hashlib
import os
import platform
import shutil
import subprocess
import sys
import threading
import time
from pathlib import Path
from queue import Empty, Full, Queue
from typing import Any, Dict, Iterator, Optional

import numpy as np
import torch

from dyffusion_tpu_torch.parallel.mesh import local_batch

SOURCE = Path(__file__).resolve().parent.parent / "csrc" / "batch_gather.cpp"
BUILD_DIR = Path(__file__).resolve().parent.parent.parent / "build" / "native"
# no -march=native: a library built on one host may be loaded on another
# (the compiler and machine are part of the file's hash, the CPU model is not)
GXX_FLAGS = ("-O3", "-shared", "-fPIC")

_lock = threading.Lock()
_state: Dict[str, Any] = {"checked": False, "lib": None}
# {"seconds": build time (0.0 when an earlier build was loaded), "path": the library}
build_log: Dict[str, Any] = {}


def _compiler_id(gxx: str) -> str:
    version = subprocess.run([gxx, "-dumpfullversion"], capture_output=True, text=True, check=True).stdout.strip()
    return f"g++ {version} {platform.machine()}"


def _load_native() -> Optional[ctypes.CDLL]:
    """The gather library, built on first use; ``None`` where no ``g++``
    exists. Raises when ``g++`` exists and the build fails."""
    with _lock:
        if _state["checked"]:
            return _state["lib"]
        gxx = shutil.which("g++")
        if gxx is None:
            _state["checked"] = True
            print("[native_loader] no g++ on PATH: train batches are gathered with numpy indexing",
                  file=sys.stderr, flush=True)
            return None
        salt = (" ".join(GXX_FLAGS) + _compiler_id(gxx)).encode()
        digest = hashlib.sha256(SOURCE.read_bytes() + salt).hexdigest()[:16]
        lib_path = BUILD_DIR / f"batch_gather-{digest}.so"
        seconds = 0.0
        if not lib_path.exists():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = BUILD_DIR / f".batch_gather-{digest}.{os.getpid()}.so"
            cmd = [gxx, *GXX_FLAGS, str(SOURCE), "-o", str(tmp), "-lpthread"]
            t0 = time.perf_counter()
            proc = subprocess.run(cmd, capture_output=True, text=True)
            seconds = time.perf_counter() - t0
            if proc.returncode != 0:
                raise RuntimeError(
                    f"g++ failed to build {SOURCE.name} (exit {proc.returncode}):\n{' '.join(cmd)}\n"
                    f"{proc.stdout}{proc.stderr}"
                )
            os.replace(tmp, lib_path)  # atomic: a concurrent process never loads half a file
        lib = ctypes.CDLL(str(lib_path))
        for fn in (lib.gather_rows, lib.gather_rows_f64_to_f32):
            fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64, ctypes.c_void_p,
                           ctypes.c_int]
            fn.restype = None
        build_log.update(seconds=seconds, path=str(lib_path))
        _state.update(checked=True, lib=lib)
        return lib


def native_available() -> bool:
    """True when :func:`gather_batch` runs the C++ gather (a contiguous
    source on a host with ``g++``), False when it takes numpy indexing."""
    return _load_native() is not None


def gather_batch(
    src: np.ndarray,
    indices: np.ndarray,
    n_threads: int = 0,
    out_dtype: Optional[np.dtype] = None,
) -> np.ndarray:
    """``src[indices]`` through the native threaded gather (numpy for a
    non-contiguous source or without ``g++``).

    ``out_dtype=np.float32`` on a float64 source runs the fused gather +
    cast (one pass). Negative indices count from the end, as in numpy;
    out-of-bounds indices raise ``IndexError`` on every path (the C++ gather
    would read out of bounds, so they are checked here). ``n_threads=0``
    uses one thread per core.
    """
    indices = np.ascontiguousarray(indices, np.int64)
    n = src.shape[0]
    if indices.size == 0:
        return np.empty((0,) + src.shape[1:], out_dtype if out_dtype is not None else src.dtype)
    if indices.min() < -n or indices.max() >= n:
        raise IndexError(f"gather_batch: index out of bounds for axis 0 with size {n}")
    indices = np.where(indices < 0, indices + n, indices)
    lib = _load_native()
    if lib is None or not src.flags["C_CONTIGUOUS"]:
        out = src[indices]
        return out.astype(out_dtype) if out_dtype is not None else out
    row_elems = int(np.prod(src.shape[1:], dtype=np.int64))
    if out_dtype is not None and np.dtype(out_dtype) == np.float32 and src.dtype == np.float64:
        out = np.empty((len(indices),) + src.shape[1:], np.float32)
        lib.gather_rows_f64_to_f32(src.ctypes.data, indices.ctypes.data, len(indices), row_elems,
                                   out.ctypes.data, n_threads)
        return out
    out = np.empty((len(indices),) + src.shape[1:], src.dtype)
    lib.gather_rows(src.ctypes.data, indices.ctypes.data, len(indices), row_elems * src.itemsize,
                    out.ctypes.data, n_threads)
    return out.astype(out_dtype) if out_dtype is not None else out


class DeviceStager:
    """Host batch (dict of numpy arrays) -> dict of tensors on ``device``;
    safe to call from :class:`PrefetchIterator`'s worker thread.

    On CUDA: pinned host copy, then ``non_blocking`` copy to the device on
    the stream current where the stager was made; the pinned buffers of
    each batch stay referenced until an event recorded after its copies has
    completed. On the CPU: the arrays as tensors (no copy)."""

    def __init__(self, device: torch.device | str):
        self.device = torch.device(device)
        self.stream = torch.cuda.current_stream(self.device) if self.device.type == "cuda" else None
        self._lock = threading.Lock()
        self._in_flight: collections.deque = collections.deque()  # (event, pinned buffers)

    def __call__(self, batch: Dict[str, Any]) -> Dict[str, torch.Tensor]:
        if self.stream is None:
            return {k: torch.as_tensor(v).to(self.device) for k, v in batch.items()}
        self._retire()
        pinned = {k: torch.as_tensor(v).pin_memory() for k, v in batch.items()}
        with torch.cuda.stream(self.stream):
            out = {k: p.to(self.device, non_blocking=True) for k, p in pinned.items()}
            copied = torch.cuda.Event()
            copied.record(self.stream)
        with self._lock:
            self._in_flight.append((copied, list(pinned.values())))
        return out

    def _retire(self) -> None:
        """Drop the pinned buffers whose copies have completed."""
        with self._lock:
            while self._in_flight and self._in_flight[0][0].query():
                self._in_flight.popleft()


class PrefetchIterator:
    """Shuffled batches of ``tensors`` (drop_last by default), assembled
    ahead by a background thread with :func:`gather_batch` and passed
    through ``device_put`` there, up to ``prefetch`` batches ahead of the
    consumer.

    The order is that of ``DatasetSplit.batches``: one shuffle of
    ``np.arange(n)`` by ``rng`` per iteration. ``rows`` (a slice) keeps
    only those rows of every batch: a data-parallel rank gathers and stages
    its own rows of the global batch, and nothing else. ``slab`` = (axis,
    model rank, model size) then keeps the rank's slab of every grid value
    (``parallel.mesh.local_batch``), sliced on the host after the gather and
    copied contiguous before it is staged. A worker's error is
    raised in the consumer; a consumer that stops early (a ``max_steps``
    break) stops and joins the worker."""

    def __init__(
        self,
        tensors: Dict[str, np.ndarray],
        batch_size: int,
        shuffle: bool = True,
        rng: Optional[np.random.Generator] = None,
        drop_last: bool = True,
        device_put=None,
        prefetch: int = 2,
        rows: Optional[slice] = None,
        slab: Optional[tuple] = None,
    ):
        self.tensors = tensors
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.rng = rng or np.random.default_rng()
        self.drop_last = drop_last
        self.device_put = device_put
        self.prefetch = prefetch
        self.rows = rows
        self.slab = slab

    def __iter__(self) -> Iterator[Dict[str, Any]]:
        n = next(iter(self.tensors.values())).shape[0]
        idx = np.arange(n)
        if self.shuffle:
            self.rng.shuffle(idx)
        stop = n - (n % self.batch_size) if self.drop_last else n
        starts = list(range(0, stop, self.batch_size))
        if not starts:
            return
        q: Queue = Queue(maxsize=self.prefetch)
        stop_evt = threading.Event()

        def put(item) -> None:
            # bounded put, so that a consumer that stopped unblocks the worker
            while not stop_evt.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return
                except Full:
                    continue

        def worker() -> None:
            try:
                for s in starts:
                    if stop_evt.is_set():
                        return
                    sel = idx[s:s + self.batch_size]
                    if self.rows is not None:
                        sel = sel[self.rows]
                    batch = {k: gather_batch(v, sel) for k, v in self.tensors.items()}
                    if self.slab is not None:
                        batch = {k: np.ascontiguousarray(v)
                                 for k, v in local_batch(batch, slice(None), *self.slab).items()}
                    put(self.device_put(batch) if self.device_put is not None else batch)
                put(None)
            except Exception as e:  # noqa: BLE001 (handed to the consumer, which raises it)
                put(e)

        t = threading.Thread(target=worker, name="PrefetchIterator", daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if item is None:
                    break
                if isinstance(item, Exception):
                    raise item
                yield item
        finally:
            stop_evt.set()
            while True:  # unblock a worker waiting on a full queue
                try:
                    q.get_nowait()
                except Empty:
                    break
            t.join(timeout=30.0)
