"""Serving: a trained run's ensemble sampler as one predict function, and
as one exported artifact.

Counterpart of ``dyffusion_tpu/serving.py``. :func:`build_predict_fn`
reloads a finished run from the registry by ``(registry_dir, run_id)`` and
serves its eval weights (the EMA when the run trained with
``module.use_ema``), as the JAX package does; :func:`build_experiment_predict_fn`
serves an experiment built in memory, with the eval weights the caller
passes. ``predict(batch, seed)`` runs the experiment's eval path (for
DYffusion the folded MC-dropout ensemble cold sampler) and returns the
(N, B, T, H, W, C) f32 ensemble forecast on the experiment's device; with
``reduce='mean_std'`` it returns (2, B, T, H, W, C), the ensemble mean and
(population) std, reduced on the device. ``batch`` is a dict of arrays in
the JAX package's layout: ``dynamics`` (B, frames, H, W, C), of which
``info['dynamics_frames_read']`` are read (the conditioning window; for an
interpolation run also the last of its window + horizon frames), plus any
static ``condition`` and the ``metadata_*`` arrays of a datamodule with
boundary conditions.

:func:`export_run` writes the same sampler as one ``torch.export`` program
(``sampler.pt2``, the eval weights embedded, cast to the eval dtype once)
with a ``manifest.json`` of its input/output contract; by default its
batch is symbolic, so one artifact serves any batch of at least 1.
:func:`load_exported` serves it with no model code: it imports ``torch``
and :mod:`dyffusion_tpu_torch.ops` (the kernels' ops) and nothing else of
the package. :func:`export_experiment` is the in-memory counterpart over
an experiment. ``python -m dyffusion_tpu_torch.serving`` is the CLI.

The seed contract: the same seed gives the same answer. Eagerly, ``predict``
seeds one fresh ``torch.Generator`` on the device and draws from it in a
fixed order; the artifact draws the same sequence from the device's default
generator, which its ``predict`` seeds per request (restoring the caller's
RNG state afterwards). On one device, eager and artifact answers to one
seed are the same.
"""
from __future__ import annotations

import contextlib
import copy
import inspect
import json
import os
import re
import time
import typing
from typing import TYPE_CHECKING, Any, Callable, Dict, List, Mapping, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

if TYPE_CHECKING:  # imported where used: load_exported needs none of them
    from dyffusion_tpu_torch.data import DataModule
    from dyffusion_tpu_torch.experiments import Experiment

_ARTIFACT = "sampler.pt2"
_MANIFEST = "manifest.json"
# the op of the B1 kernel, as the exported graph names it
_B1_OP = "dyffusion_tpu_torch.linear_attention_qkv"


class TensorSpec(NamedTuple):
    shape: Tuple[int, ...]
    dtype: np.dtype


def _dynamics_frame_contract(exp: Experiment) -> Tuple[int, List[int]]:
    """(frames, frames read) of ``batch['dynamics']``: a forecaster reads
    its conditioning window; an interpolator takes window + horizon frames
    (the training layout) and reads the window and the last frame."""
    from dyffusion_tpu_torch.experiments import InterpolationExperiment

    w = exp.cfg.window
    if isinstance(exp, InterpolationExperiment):
        h = exp.cfg.horizon
        return w + h, list(range(w)) + [w + h - 1]
    return w, list(range(w))


def _t_index(key: str) -> int:
    m = re.fullmatch(r"t(\d+)_preds", key)
    return int(m.group(1)) if m else -1


def _check_reduce(reduce: Optional[str]) -> None:
    if reduce not in (None, "mean_std"):
        raise ValueError(f"unknown reduce '{reduce}' (choose None or 'mean_std')")


def _serving_contract(
    experiment: Experiment, datamodule: DataModule, split: str, batch_size: Optional[int], reduce: Optional[str]
) -> Tuple[Dict[str, TensorSpec], Dict[str, Any]]:
    """``(input_specs, info)`` of ``split``: the layout of the split's own
    data, dynamics cut to the frames served, leading dim ``batch_size``
    (default: the datamodule's eval batch size)."""
    example = next(iter(datamodule.split(split).batches(1)), None)
    if example is None:
        raise ValueError(f"split '{split}' is empty: cannot derive the serving input spec")
    frames, frames_read = _dynamics_frame_contract(experiment)
    if batch_size is None:
        batch_size = int(datamodule.eval_batch_size)
    if batch_size < 1:
        raise ValueError(f"batch_size must be >= 1, got {batch_size}")
    input_specs = {}
    for k, v in example.items():
        v = np.asarray(v)
        tail = (frames,) + v.shape[2:] if k == "dynamics" else v.shape[1:]
        input_specs[k] = TensorSpec((batch_size,) + tuple(tail), v.dtype)
    info = {
        "experiment": type(experiment).__name__,
        "ensemble_members": int(experiment.num_members(split)),
        "dynamics_frames": int(frames),
        "dynamics_frames_read": frames_read,
        "device": str(experiment.device),
        "batch_size": int(batch_size),
        "reduce": reduce,
    }
    return input_specs, info


def _predict_body(eval_fn: Callable, reduce: Optional[str]) -> Callable:
    """``body(batch, generator, params)``: the eval function's per-t
    predictions stacked to (N, B, T, H, W, C), or their mean and std."""

    def body(batch: Dict[str, Any], generator, params) -> torch.Tensor:
        out = eval_fn(batch, generator, params)
        keys = sorted((k for k in out if _t_index(k) > 0), key=_t_index)
        members = torch.stack([out[k] for k in keys], dim=2)  # (N, B, T, H, W, C)
        if reduce == "mean_std":
            return torch.stack([members.mean(dim=0), members.std(dim=0, unbiased=False)], dim=0)
        return members

    return body


def build_experiment_predict_fn(
    experiment: Experiment,
    eval_fns: Dict[str, Callable],
    datamodule: DataModule,
    params: Optional[Mapping[str, torch.Tensor]],
    split: str = "predict",
    batch_size: Optional[int] = None,
    reduce: Optional[str] = None,
) -> Tuple[Callable, Dict[str, TensorSpec], Dict[str, Any]]:
    """Return ``(predict, input_specs, info)`` for ``experiment``'s ``split``
    eval function (``eval_fns`` as :func:`dyffusion_tpu_torch.interface.
    build_experiment` returns them), served with the weights ``params``:
    the eval weights (``TrainState.eval_params()``, the EMA when it is on;
    ``None`` is the model's own weights). ``input_specs`` takes its layout
    from the split's own data, dynamics cut to the frames served, leading
    dim ``batch_size`` (default: the datamodule's eval batch size)."""
    _check_reduce(reduce)
    input_specs, info = _serving_contract(experiment, datamodule, split, batch_size, reduce)
    body = _predict_body(eval_fns[split], reduce)

    def predict(batch: Dict[str, Any], seed: int) -> torch.Tensor:
        generator = torch.Generator(device=experiment.device)
        generator.manual_seed(int(seed))
        return body(batch, generator, params)

    return predict, input_specs, info


# serving runs on one device, whatever world the run trained on
ONE_DEVICE = ("trainer.devices=1",)


def build_predict_fn(
    registry_dir: str,
    run_id: str,
    overrides: Optional[List[str]] = None,
    slot: str = "best",
    split: str = "predict",
    batch_size: Optional[int] = None,
    reduce: Optional[str] = None,
    device: torch.device | str = "cuda",
) -> Tuple[Callable, Dict[str, TensorSpec], Dict[str, Any]]:
    """Reload run ``run_id`` of the registry (its ``slot`` checkpoint, else
    ``last``; ``overrides`` over its stored config) and serve its ``split``
    eval path with the run's eval weights: ``(predict, input_specs, info)``
    as :func:`build_experiment_predict_fn` returns them, ``info`` also
    naming the run and slot. ``split`` sets the ensemble size (``test``:
    ``module.num_predictions_test``). Serving runs on one device: a run
    trained on several ranks is reloaded with ``trainer.devices=1``."""
    _check_reduce(reduce)  # before the reload
    from dyffusion_tpu_torch.interface import reload_trainer

    trainer = reload_trainer(registry_dir, run_id, [*ONE_DEVICE, *(overrides or [])], slot=slot, device=device)
    predict, specs, info = build_experiment_predict_fn(
        trainer.experiment, trainer.eval_fns, trainer.datamodule, trainer.state.eval_params(),
        split=split, batch_size=batch_size, reduce=reduce,
    )
    return predict, specs, {"run_id": run_id, "slot": slot, **info}


# ---------------------------------------------------------------------------
# the exported artifact
# ---------------------------------------------------------------------------
def _networks(experiment: Experiment) -> List[nn.Module]:
    """The networks the eval path runs: the trained model first (the one
    that ``params`` replaces), then a DYffusion stage 2's frozen
    interpolator."""
    nets = [experiment.model]
    interpolator = getattr(getattr(experiment, "engine", None), "interpolator", None)
    if interpolator is not None and interpolator is not experiment.model:
        nets.append(interpolator)
    return nets


class _Runner(nn.Module):
    """The predict body over the experiment's own networks, registered
    here so that :class:`_SamplerProgram` can substitute their weights. It
    draws from the device's default generator and passes no ``params``:
    the substituted weights are the eval weights."""

    def __init__(self, body: Callable, networks: Sequence[nn.Module]):
        super().__init__()
        self.networks = nn.ModuleList(networks)
        self.body = body

    def forward(self, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        from dyffusion_tpu_torch.utils.rng import DEVICE_DEFAULT

        return self.body(batch, DEVICE_DEFAULT, None)


class _SamplerProgram(nn.Module):
    """What :func:`export_experiment` traces: ``forward(batch)`` is the
    predict body, run on this module's own state, a copy of each network at
    its eval weights (``params`` over the trained model's, the EMA when it
    is on) cast once to the eval dtype. The experiment's networks are
    neither changed nor part of this module's state, so the program stores
    each weight once, in the dtype it computes in."""

    def __init__(self, body: Callable, networks: Sequence[nn.Module], params, dtype: torch.dtype):
        super().__init__()
        copies = []
        for i, net in enumerate(networks):
            c = copy.deepcopy(net)
            if i == 0 and params is not None:
                c.load_state_dict(dict(params), strict=False)
            copies.append(c.to(dtype).requires_grad_(False))
        self.networks = nn.ModuleList(copies)
        self._runner = (_Runner(body, networks),)  # in a tuple: not a submodule, its weights are not our state

    def forward(self, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        weights = {**dict(self.networks.named_parameters("networks")), **dict(self.networks.named_buffers("networks"))}
        return torch.func.functional_call(self._runner[0], weights, (batch,))


def _dims(shape) -> list:
    """A shape for the manifest: the symbolic batch as ``"b"``."""
    return [int(d) if isinstance(d, int) else "b" for d in shape]


def _drop_no_op_nodes(exported: torch.export.ExportedProgram) -> None:
    """Drop what the trace records and the run does not need: the
    ``_assert_tensor_metadata`` checks, ``to`` casts to the dtype a tensor
    already has (eager ``Tensor.to`` returns the tensor itself) and unused
    ``promote_types`` calls: a quarter to a third of an unrolled sampler's
    nodes, and saving and loading take time per node."""
    aten = torch.ops.aten
    graph = exported.graph
    for n in list(graph.nodes):
        if n.op != "call_function":
            continue
        if n.target is aten._assert_tensor_metadata.default or (n.target is aten.promote_types.default and not n.users):
            graph.erase_node(n)
        elif n.target is aten.to.dtype and len(n.args) == 2 and not n.kwargs and n.args[0].meta["val"].dtype == n.args[1]:
            n.replace_all_uses_with(n.args[0])
            graph.erase_node(n)
    exported.graph_module.recompile()


def export_experiment(
    experiment: Experiment,
    eval_fns: Dict[str, Callable],
    datamodule: DataModule,
    params: Optional[Mapping[str, torch.Tensor]],
    split: str = "predict",
    batch_size: Optional[int] = None,
    polymorphic_batch: bool = True,
    reduce: Optional[str] = None,
) -> Tuple[torch.export.ExportedProgram, Dict[str, Any]]:
    """Export ``experiment``'s ``split`` sampler as a ``torch.export``
    program on the experiment's device; ``(program, manifest)``. The
    in-memory counterpart of :func:`export_run`, with the arguments of
    :func:`build_experiment_predict_fn`; serve the program with
    :func:`serve_exported`.

    ``polymorphic_batch=True`` traces a symbolic batch ``Dim("b", min=1)``
    at an example batch of ``max(batch_size, 2)``; ``False`` pins the batch
    to ``batch_size`` (default: the datamodule's eval batch size). The
    sampler's Python loop is unrolled: the graph holds every forward of one
    request."""
    _check_reduce(reduce)
    specs, info = _serving_contract(experiment, datamodule, split, batch_size, reduce)
    # the eval function without its @torch.no_grad: the export runs under
    # no_grad, and the decorator's grad-mode switches would be traced as
    # regions that export then splits the whole graph at
    eval_fn = inspect.unwrap(eval_fns[split])
    program = _SamplerProgram(_predict_body(eval_fn, reduce), _networks(experiment), params, experiment.eval_dtype())
    trace_batch = max(info["batch_size"], 2) if polymorphic_batch else info["batch_size"]
    example = {
        k: torch.zeros((trace_batch,) + s.shape[1:], dtype=torch.from_numpy(np.zeros((), s.dtype)).dtype,
                       device=experiment.device)
        for k, s in specs.items()
    }
    dynamic = None
    if polymorphic_batch:
        b = torch.export.Dim("b", min=1)
        dynamic = ({k: {0: b} for k in specs},)
    # no stack trace per node: recording them takes about a third of the
    # trace's host time, and the unrolled sampler has ~1,000 nodes per
    # network forward
    stack_traces = getattr(torch.fx.config, "do_not_emit_stack_traces", False)
    torch.fx.config.do_not_emit_stack_traces = True
    t = time.perf_counter()
    try:
        with torch.no_grad():
            exported = torch.export.export(program, (example,), dynamic_shapes=dynamic)
    finally:
        torch.fx.config.do_not_emit_stack_traces = stack_traces
    _drop_no_op_nodes(exported)
    seconds = time.perf_counter() - t
    nodes = list(exported.graph.nodes)
    n_b1 = sum(str(n.target).startswith(_B1_OP) for n in nodes if n.op == "call_function")
    device = experiment.device
    if device.type == "cuda":
        device = torch.device("cuda", device.index if device.index is not None else torch.cuda.current_device())
    out = [n for n in nodes if n.op == "output"][0].args[0][0].meta["val"]
    manifest = {
        **info,
        "device": str(device),
        "devices": 1,
        "platforms": [device.type],
        "polymorphic_batch": bool(polymorphic_batch),
        "attention_kernel": None if not n_b1 else ("cuda" if device.type == "cuda" else "plain"),
        "inputs": {
            k: {"shape": ["b" if polymorphic_batch else s.shape[0], *s.shape[1:]], "dtype": str(np.dtype(s.dtype))}
            for k, s in specs.items()
        },
        "seed": {"shape": [], "dtype": "int64"},
        "output": {
            "shape": _dims(out.shape),
            "dtype": str(out.dtype).replace("torch.", ""),
            "axes": (["stat(mean,std)"] if reduce == "mean_std" else ["member"]) + ["batch", "time", "..."],
        },
        "graph": {"nodes": len(nodes), "b1_nodes": n_b1, "export_seconds": seconds},
        "torch": torch.__version__,
    }
    return exported, manifest


def export_run(
    registry_dir: str,
    run_id: str,
    out_dir: str,
    overrides: Optional[Sequence[str]] = None,
    slot: str = "best",
    split: str = "predict",
    platforms: Optional[Sequence[str]] = None,
    batch_size: Optional[int] = None,
    polymorphic_batch: bool = True,
    devices: int = 1,
    reduce: Optional[str] = None,
    device: torch.device | str = "cuda",
) -> str:
    """Export ``run_id``'s trained sampler to ``out_dir`` as one serialized
    ``torch.export`` program (``sampler.pt2``, the eval weights embedded) and
    a ``manifest.json``; returns the artifact's path.

    The run is reloaded as :func:`build_predict_fn` reloads it (after
    ``reduce`` is checked) and traced on ``device`` by
    :func:`export_experiment`: its B1 kernel is in the graph as the op
    ``dyffusion_tpu_torch::linear_attention_qkv`` (the manifest's
    ``attention_kernel``: ``"cuda"``, or ``"plain"`` on the CPU).
    ``platforms``, when given, names the one platform of ``device``.
    ``polymorphic_batch=True`` (default) gives a symbolic batch; ``False``
    pins it to ``batch_size`` (default: the run's eval batch size).
    ``reduce='mean_std'`` ships the on-device ensemble reduction instead of
    the raw members. Not ported: ``devices > 1`` (the data-parallel
    artifact, ROADMAP A) and a multi-platform artifact."""
    _check_reduce(reduce)  # before the reload
    if devices > 1:
        raise NotImplementedError(
            "devices > 1 (the data-parallel artifact) is not ported (ROADMAP A: the data-parallel artifact); "
            "export with devices=1"
        )
    device = torch.device(device)
    if platforms is not None:
        if len(set(platforms)) > 1:
            raise NotImplementedError(f"a multi-platform artifact is not ported: platforms={list(platforms)}")
        if set(platforms) != {device.type}:
            raise ValueError(f"platforms={list(platforms)} does not name the export device {device}")
    from dyffusion_tpu_torch.interface import reload_trainer

    trainer = reload_trainer(registry_dir, run_id, [*ONE_DEVICE, *(overrides or [])], slot=slot, device=device)
    exported, manifest = export_experiment(
        trainer.experiment, trainer.eval_fns, trainer.datamodule, trainer.state.eval_params(), split=split,
        batch_size=batch_size, polymorphic_batch=polymorphic_batch, reduce=reduce,
    )
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, _ARTIFACT)
    torch.export.save(exported, path)
    with open(os.path.join(out_dir, _MANIFEST), "w") as f:
        json.dump({"run_id": run_id, "slot": slot, **manifest}, f, indent=2)
    return path


def serve_exported(
    exported: torch.export.ExportedProgram, manifest: Mapping[str, Any], device: torch.device | str | None = None
) -> Callable:
    """``predict(batch, seed)`` over an exported sampler: converts the NHWC
    numpy or tensor ``batch`` to tensors of the manifest's dtypes on the
    artifact's device, seeds that device's default generator with ``seed``
    and runs the program, inside ``torch.random.fork_rng`` (the caller's RNG
    state is left as it was). Returns the (N, B, T, H, W, C) forecast, or
    (2, B, ...) when reduced; ``predict.exported`` is the program.
    ``device``: the artifact's own (default); a CUDA artifact needs a GPU,
    with no fallback to the CPU."""
    device = _artifact_device(manifest, device)
    module = exported.module()
    inputs = manifest["inputs"]
    dtypes = {k: torch.from_numpy(np.zeros((), spec["dtype"])).dtype for k, spec in inputs.items()}
    cuda = device.type == "cuda"

    def predict(batch: Mapping[str, Any], seed: int) -> torch.Tensor:
        args = {}
        for k, spec in inputs.items():
            x = torch.as_tensor(batch[k], dtype=dtypes[k], device=device)
            want = spec["shape"]
            if x.dim() != len(want) or any(w != "b" and w != n for w, n in zip(want, x.shape)) or x.shape[0] < 1:
                raise ValueError(f"input '{k}' has shape {tuple(x.shape)}; the artifact takes {want}")
            args[k] = x
        with torch.random.fork_rng(devices=[device.index] if cuda else []), torch.no_grad():
            (torch.cuda.default_generators[device.index] if cuda else torch.default_generator).manual_seed(int(seed))
            return module(args)

    predict.exported = exported
    return predict


def _artifact_device(manifest: Mapping[str, Any], device) -> torch.device:
    want = torch.device(manifest["device"])
    device = want if device is None else torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device() if torch.cuda.is_available() else 0)
    if device != want:
        raise ValueError(f"the artifact was exported on {want} and runs there, not on {device}")
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"the artifact was exported on {want}, but torch.cuda.is_available() is False: "
                           "a CUDA artifact has no CPU fallback")
    return device


@contextlib.contextmanager
def _cached_type_hints():
    """``typing.get_type_hints`` memoized per class for the duration: torch's
    deserializer asks it for the hints of its schema classes once per
    serialized object, ~20 per graph node, and resolving them again each
    time is a third of a large program's load. A class's hints do not change
    while it loads."""
    original = typing.get_type_hints
    cache: Dict[Any, Any] = {}

    def cached(obj, globalns=None, localns=None, include_extras=False):
        if not isinstance(obj, type):
            return original(obj, globalns, localns, include_extras)
        key = (obj, id(globalns), id(localns), include_extras)
        if key not in cache:
            cache[key] = original(obj, globalns, localns, include_extras)
        return cache[key]

    typing.get_type_hints = cached
    try:
        yield
    finally:
        typing.get_type_hints = original


def load_exported(out_dir: str, device: torch.device | str | None = None):
    """Load an :func:`export_run` artifact; returns ``(predict, manifest)``,
    ``predict(batch, seed)`` as :func:`serve_exported` gives it. Needs no
    model code or checkpoint: it imports ``torch`` and
    :mod:`dyffusion_tpu_torch.ops`, whose import registers the ops the
    program calls, and on CUDA builds their kernels (nvcc, cached under
    ``build/kernels/``) before the first request. The JAX package's
    ``compilation_cache`` option has no counterpart: an
    ``ExportedProgram`` runs eagerly, op by op, with nothing to compile."""
    import dyffusion_tpu_torch.ops  # noqa: F401 (registers the ops the program calls)

    with open(os.path.join(out_dir, _MANIFEST)) as f:
        manifest = json.load(f)
    device = _artifact_device(manifest, device)
    with _cached_type_hints():
        exported = torch.export.load(os.path.join(out_dir, _ARTIFACT))
    if device.type == "cuda":  # build the kernels before the first request
        from dyffusion_tpu_torch.ops._build import CSRC, load_libraries

        load_libraries(sorted(p.stem for p in CSRC.glob("*.cu")))
    return serve_exported(exported, manifest, device), manifest


def _main(argv: Optional[Sequence[str]] = None) -> str:
    """CLI: ``python -m dyffusion_tpu_torch.serving run_id=<id> out=<dir>
    [registry_dir=runs] [slot=best] [split=predict] [platforms=cuda]
    [batch_size=N] [polymorphic_batch=false] [devices=1] [reduce=mean_std]
    [device=cuda] [key.subkey=value ...]`` — export a trained run's sampler
    artifact."""
    import sys

    def usage(msg: str) -> "SystemExit":
        return SystemExit(f"error: {msg}\n\n{_main.__doc__}")

    args: Dict[str, Any] = dict(
        registry_dir="runs", slot="best", split="predict", platforms=None,
        batch_size=None, polymorphic_batch=True, devices=1, reduce=None, device="cuda",
    )
    overrides = []
    for arg in sys.argv[1:] if argv is None else argv:
        k, eq, v = arg.partition("=")
        if not eq or not k:
            raise usage(f"argument {arg!r} is not of the form key=value")
        if k in ("run_id", "out", "registry_dir", "slot", "split", "reduce", "device"):
            args[k] = v
        elif k == "platforms":
            args["platforms"] = v.split(",")
        elif k in ("batch_size", "devices"):
            try:
                args[k] = int(v)
            except ValueError:
                raise usage(f"{k} must be an integer, got {v!r}") from None
        elif k == "polymorphic_batch":
            if v.lower() not in ("true", "false"):
                raise usage(f"polymorphic_batch must be true or false, got {v!r}")
            args["polymorphic_batch"] = v.lower() == "true"
        else:
            overrides.append(arg)
    if "run_id" not in args or "out" not in args:
        raise usage("run_id=<id> and out=<dir> are required")
    path = export_run(
        args["registry_dir"], args["run_id"], args.pop("out"),
        overrides=overrides, slot=args["slot"], split=args["split"],
        platforms=args["platforms"], batch_size=args["batch_size"],
        polymorphic_batch=args["polymorphic_batch"], devices=args["devices"],
        reduce=args["reduce"], device=args["device"],
    )
    print(path)
    return path


if __name__ == "__main__":
    _main()
