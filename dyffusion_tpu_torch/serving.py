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
batch is symbolic, so one artifact serves any batch of at least 1. Each
sampler's loop over its steps is one loop op in the program
(``utils/loop.py``), so a 1000-step DDPM exports as its loop body. It may
be data-parallel (``devices=N``: N replicas of one program, each on its
rows of the batch) and serve several platforms (``platforms=("cuda",
"cpu")``). :func:`load_exported` serves it with no model code: it imports
``torch`` and :mod:`dyffusion_tpu_torch.ops` (the kernels' ops) and
nothing else of the package. :func:`export_experiment` and
:func:`save_exported` are the in-memory counterparts over an experiment.
``python -m dyffusion_tpu_torch.serving`` is the CLI.

The seed contract: the same seed gives the same answer. Eagerly, ``predict``
seeds one fresh ``torch.Generator`` on the device and draws from it in a
fixed order; the artifact draws the same sequence from the device's default
generator, which its ``predict`` seeds per request (restoring the caller's
RNG state afterwards). On one device, eager and artifact answers to one
seed are the same. Each replica of a data-parallel artifact seeds its
device's generator alike and keeps its rows of every draw made at the
whole batch, so N replicas answer as one device does.
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
    from dyffusion_tpu_torch.utils.profiling import span

    _check_reduce(reduce)
    input_specs, info = _serving_contract(experiment, datamodule, split, batch_size, reduce)
    body = _predict_body(eval_fns[split], reduce)

    def predict(batch: Dict[str, Any], seed: int) -> torch.Tensor:
        with span("serving.request"):
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

    def __init__(self, body: Callable, networks: Sequence[nn.Module], params, dtype: torch.dtype,
                 replicas: Optional[Tuple[int, int]] = None):
        super().__init__()
        self.replicas = replicas  # (request batch, replica batch) of a data-parallel program, else None
        copies = []
        for i, net in enumerate(networks):
            c = copy.deepcopy(net)
            if i == 0 and params is not None:
                c.load_state_dict(dict(params), strict=False)
            copies.append(c.to(dtype).requires_grad_(False))
        self.networks = nn.ModuleList(copies)
        self._runner = (_Runner(body, networks),)  # in a tuple: not a submodule, its weights are not our state

    def forward(self, batch: Dict[str, torch.Tensor], replica: Optional[torch.Tensor] = None) -> torch.Tensor:
        """``replica``: a data-parallel program's replica index (a 0-dim
        int64 tensor on the device), whose rows of the request it serves;
        every draw is the request's, cut to those rows."""
        weights = {**dict(self.networks.named_parameters("networks")), **dict(self.networks.named_buffers("networks"))}
        if self.replicas is None:
            return torch.func.functional_call(self._runner[0], weights, (batch,))
        from dyffusion_tpu_torch.utils.rng import replica_rows

        total, b = self.replicas
        rows = torch.arange(b, device=replica.device) + replica * b
        with replica_rows(total, rows):
            return torch.func.functional_call(self._runner[0], weights, (batch,))


def _dims(shape) -> list:
    """A shape for the manifest: the symbolic batch as ``"b"``."""
    return [int(d) if isinstance(d, int) else "b" for d in shape]


def _drop_no_op_nodes(exported: torch.export.ExportedProgram) -> None:
    """Drop what the trace records and the run does not need: the
    ``_assert_tensor_metadata`` checks, ``to`` casts to the dtype a tensor
    already has (eager ``Tensor.to`` returns the tensor itself) and unused
    ``promote_types`` calls, in the program's graph and in its loop
    bodies: a quarter to a third of a network forward's nodes, and saving
    and loading take time per node."""
    aten = torch.ops.aten
    for gm in _graph_modules(exported):
        for n in list(gm.graph.nodes):
            if n.op != "call_function":
                continue
            if n.target is aten._assert_tensor_metadata.default or (
                    n.target is aten.promote_types.default and not n.users):
                gm.graph.erase_node(n)
            elif (n.target is aten.to.dtype and len(n.args) == 2 and not n.kwargs
                  and getattr(n.args[0].meta.get("val"), "dtype", None) == n.args[1]):
                n.replace_all_uses_with(n.args[0])
                gm.graph.erase_node(n)
        gm.recompile()


def _graph_modules(exported: torch.export.ExportedProgram) -> List[torch.fx.GraphModule]:
    """The program's graph and the graphs of its loop ops' conditions and
    bodies."""
    return [m for m in exported.graph_module.modules() if isinstance(m, torch.fx.GraphModule)]


def _graph_stats(exported: torch.export.ExportedProgram) -> Dict[str, int]:
    """``nodes``: the nodes of every graph (a loop body counted once),
    ``loops``: the loop ops, ``b1_nodes``: the B1 nodes of every graph."""
    stats = {"nodes": 0, "loops": 0, "b1_nodes": 0}
    for gm in _graph_modules(exported):
        for n in gm.graph.nodes:
            stats["nodes"] += 1
            if n.op == "call_function":
                stats["b1_nodes"] += str(n.target).startswith(_B1_OP)
                stats["loops"] += n.target is torch.ops.higher_order.while_loop
    return stats


def export_experiment(
    experiment: Experiment,
    eval_fns: Dict[str, Callable],
    datamodule: DataModule,
    params: Optional[Mapping[str, torch.Tensor]],
    split: str = "predict",
    batch_size: Optional[int] = None,
    polymorphic_batch: bool = True,
    reduce: Optional[str] = None,
    devices: int = 1,
    platforms: Optional[Sequence[str]] = None,
) -> Tuple[torch.export.ExportedProgram, Dict[str, Any]]:
    """Export ``experiment``'s ``split`` sampler as a ``torch.export``
    program on the experiment's device; ``(program, manifest)``. The
    in-memory counterpart of :func:`export_run`, with the arguments of
    :func:`build_experiment_predict_fn`; serve the program with
    :func:`serve_exported`.

    ``polymorphic_batch=True`` traces a symbolic batch ``Dim("b", min=1)``
    at an example batch of ``max(batch_size, 2)``; ``False`` pins the batch
    to ``batch_size`` (default: the datamodule's eval batch size). Each
    sampler's loop over its steps is one loop op (``utils.loop``): the graph
    holds the loop body once, and the steps peeled out of it. ``devices=D``
    (pinned batch only) traces one replica at ``batch_size / D`` rows with
    its replica index as a second input (see :func:`export_run`).
    ``platforms``: the platforms the manifest lists (default: the
    experiment's device's)."""
    _check_reduce(reduce)
    specs, info = _serving_contract(experiment, datamodule, split, batch_size, reduce)
    _check_devices(devices, polymorphic_batch, info["batch_size"])
    # the eval function without its @torch.no_grad: the export runs under
    # no_grad, and the decorator's grad-mode switches would be traced as
    # regions that export then splits the whole graph at
    eval_fn = inspect.unwrap(eval_fns[split])
    B = info["batch_size"]
    replicas = (B, B // devices) if devices > 1 else None
    program = _SamplerProgram(_predict_body(eval_fn, reduce), _networks(experiment), params, experiment.eval_dtype(),
                              replicas)
    trace_batch = max(B, 2) if polymorphic_batch else B // devices
    example = {
        k: torch.zeros((trace_batch,) + s.shape[1:], dtype=torch.from_numpy(np.zeros((), s.dtype)).dtype,
                       device=experiment.device)
        for k, s in specs.items()
    }
    args = (example,) if replicas is None else (example, torch.zeros((), dtype=torch.int64, device=experiment.device))
    dynamic = None
    if polymorphic_batch:
        b = torch.export.Dim("b", min=1)
        dynamic = ({k: {0: b} for k in specs},)
    # no stack trace per node: recording them takes about a third of the
    # trace's host time
    stack_traces = getattr(torch.fx.config, "do_not_emit_stack_traces", False)
    torch.fx.config.do_not_emit_stack_traces = True
    t = time.perf_counter()
    try:
        with torch.no_grad():
            exported = torch.export.export(program, args, dynamic_shapes=dynamic)
    finally:
        torch.fx.config.do_not_emit_stack_traces = stack_traces
    _drop_no_op_nodes(exported)
    seconds = time.perf_counter() - t
    stats = _graph_stats(exported)
    device = experiment.device
    if device.type == "cuda":
        device = torch.device("cuda", device.index if device.index is not None else torch.cuda.current_device())
    out = [n for n in exported.graph.nodes if n.op == "output"][0].args[0][0].meta["val"]
    out_shape = _dims(out.shape)
    if replicas is not None:
        out_shape[1] = B  # the request's batch: the replicas' rows together
    manifest = {
        **info,
        "device": str(device),
        "devices": int(devices),
        "replica_batch_size": B // devices,
        "platforms": _platforms(platforms, device),
        "polymorphic_batch": bool(polymorphic_batch),
        "attention_kernel": None if not stats["b1_nodes"] else ("cuda" if device.type == "cuda" else "plain"),
        "inputs": {
            k: {"shape": ["b" if polymorphic_batch else s.shape[0], *s.shape[1:]], "dtype": str(np.dtype(s.dtype))}
            for k, s in specs.items()
        },
        "seed": {"shape": [], "dtype": "int64"},
        "output": {
            "shape": out_shape,
            "dtype": str(out.dtype).replace("torch.", ""),
            "axes": (["stat(mean,std)"] if reduce == "mean_std" else ["member"]) + ["batch", "time", "..."],
        },
        "graph": {**stats, "export_seconds": seconds},
        "torch": torch.__version__,
    }
    return exported, manifest


_PLATFORMS = ("cuda", "cpu")


def _platforms(platforms: Optional[Sequence[str]], device: torch.device) -> List[str]:
    """The manifest's platforms: ``platforms`` in order, once each (the
    export device's own by default), each one torch serves the program on."""
    out = list(dict.fromkeys(platforms or [device.type]))
    unknown = [p for p in out if p not in _PLATFORMS]
    if unknown:
        raise ValueError(f"unknown platform(s) {unknown}: an artifact serves on {list(_PLATFORMS)}")
    if device.type not in out:
        raise ValueError(f"platforms={out} does not name the export device {device}")
    return out


def _check_devices(devices: int, polymorphic_batch: bool, batch_size: Optional[int]) -> None:
    """The data-parallel artifact's rules (the JAX package's): a pinned
    batch, divisible by ``devices``."""
    if devices < 1:
        raise ValueError(f"devices must be >= 1, got {devices}")
    if devices == 1:
        return
    if polymorphic_batch:
        raise ValueError("devices>1 requires polymorphic_batch=False: the batch must be pinned to split it "
                         "over the replicas")
    if batch_size is not None and batch_size % devices:
        raise ValueError(f"batch_size={batch_size} is not divisible by devices={devices}")


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

    The run is reloaded as :func:`build_predict_fn` reloads it (after the
    arguments are checked) and traced on ``device`` by
    :func:`export_experiment`: its B1 kernel is in the graph as the op
    ``dyffusion_tpu_torch::linear_attention_qkv`` (the manifest's
    ``attention_kernel``: ``"cuda"``, or ``"plain"`` on the CPU), and each
    sampler's loop over its steps is one loop op, so the graph's size does
    not grow with the number of steps (the manifest's ``graph``).
    ``polymorphic_batch=True`` (default) gives a symbolic batch; ``False``
    pins it to ``batch_size`` (default: the run's eval batch size).
    ``reduce='mean_std'`` ships the on-device ensemble reduction instead of
    the raw members.

    ``platforms`` (e.g. ``("cuda", "cpu")``): the platforms the artifact
    serves on, the trace device's among them (default: that one alone).
    The program is traced once; :func:`load_exported` moves it to the
    device it is asked for, where the kernels' ops run their CUDA kernels
    or, on the CPU, their plain versions.

    ``devices=D`` exports a data-parallel artifact: a pinned batch
    (``polymorphic_batch=False``, or ``ValueError``) divisible by D
    (``ValueError``), served by D replicas of one program, each on B/D
    rows; :func:`load_exported` places replica i on ``cuda:i``. One
    replica is traced, at B/D rows, with its replica index as an input, so
    the weights are stored once, and each of its draws is the draw of the
    whole B-row batch cut to its rows: D replicas answer as one device
    does on the B rows. The export itself needs one device, not D (the
    JAX package checks for D at export, because it lowers onto a D-device
    mesh); the serving host's devices are checked when the artifact
    loads."""
    _check_reduce(reduce)  # the arguments, before the reload
    _check_devices(devices, polymorphic_batch, batch_size)
    device = torch.device(device)
    _platforms(platforms, device)
    from dyffusion_tpu_torch.interface import reload_trainer

    trainer = reload_trainer(registry_dir, run_id, [*ONE_DEVICE, *(overrides or [])], slot=slot, device=device)
    exported, manifest = export_experiment(
        trainer.experiment, trainer.eval_fns, trainer.datamodule, trainer.state.eval_params(), split=split,
        batch_size=batch_size, polymorphic_batch=polymorphic_batch, reduce=reduce, devices=devices,
        platforms=platforms,
    )
    return save_exported(exported, {"run_id": run_id, "slot": slot, **manifest}, out_dir)


def save_exported(exported: torch.export.ExportedProgram, manifest: Mapping[str, Any], out_dir: str) -> str:
    """Write ``exported`` and its manifest to ``out_dir`` as
    :func:`export_run` does (``sampler.pt2``, ``manifest.json``), for
    :func:`load_exported`; returns the artifact's path."""
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, _ARTIFACT)
    torch.export.save(exported, path)
    with open(os.path.join(out_dir, _MANIFEST), "w") as f:
        json.dump(dict(manifest), f, indent=2)
    return path


def _on_device(exported: torch.export.ExportedProgram, traced: torch.device, device: torch.device) -> nn.Module:
    """The program as a module on ``device``: its own where it was traced,
    else a copy moved there (weights, constants, and the devices written
    into its graphs, the loop bodies' included). Only what lies on the
    trace device moves: a CUDA program's per-step values and loop counter
    stay on the CPU, where the loop reads them without waiting for the
    card."""
    if device == traced:
        return exported.module()
    from torch.export.passes import move_to_device_pass

    moves = {str(traced): str(device), traced.type: str(device)}  # the trace may name "cuda" for "cuda:0"
    return move_to_device_pass(copy.deepcopy(exported), moves).module()


def serve_exported(
    exported: torch.export.ExportedProgram, manifest: Mapping[str, Any], device=None
) -> Callable:
    """``predict(batch, seed)`` over an exported sampler: converts the NHWC
    numpy or tensor ``batch`` to tensors of the manifest's dtypes, seeds
    the default generator of each device it runs on with ``seed`` and runs
    the program, inside ``torch.random.fork_rng`` (the caller's RNG state
    is left as it was). Returns the (N, B, T, H, W, C) forecast, or (2, B,
    ...) when reduced, on the (first) device; ``predict.exported`` is the
    program.

    ``device``: the artifact's own (default), or a device of one of the
    manifest's ``platforms`` (the program is moved there); a CUDA device
    needs a GPU, with no fallback to the CPU. A data-parallel artifact
    (``devices`` = D > 1) runs D replicas, replica i on rows [i B/D, (i+1)
    B/D) of the batch: by default on ``cuda:0 .. cuda:D-1`` (on the CPU
    for a CPU artifact), or on the list of D devices ``device`` gives,
    repeats allowed; one host thread per distinct device, each device's
    replicas one after another."""
    placements = _placements(manifest, device)
    traced = torch.device(manifest["device"])
    modules = {d: _on_device(exported, traced, d) for d in dict.fromkeys(placements)}
    inputs = manifest["inputs"]
    dtypes = {k: torch.from_numpy(np.zeros((), spec["dtype"])).dtype for k, spec in inputs.items()}
    n = len(placements)
    groups: Dict[torch.device, List[int]] = {}
    for i, d in enumerate(placements):
        groups.setdefault(d, []).append(i)
    cuda = sorted({d.index for d in placements if d.type == "cuda"})

    def run(d: torch.device, replicas: List[int], args: Dict[str, torch.Tensor], seed: int) -> Dict[int, torch.Tensor]:
        out = {}
        with torch.cuda.device(d) if d.type == "cuda" else contextlib.nullcontext():
            for i in replicas:
                (torch.cuda.default_generators[d.index] if d.type == "cuda" else torch.default_generator).manual_seed(
                    int(seed))
                if n == 1:
                    out[i] = modules[d](args)
                else:
                    b = next(iter(args.values())).shape[0] // n
                    rows = {k: v[i * b:(i + 1) * b].to(d) for k, v in args.items()}
                    out[i] = modules[d](rows, torch.full((), i, dtype=torch.int64, device=d))
        return out

    def predict(batch: Mapping[str, Any], seed: int) -> torch.Tensor:
        args = {}
        for k, spec in inputs.items():
            x = torch.as_tensor(batch[k], dtype=dtypes[k], device=placements[0])
            want = spec["shape"]
            if x.dim() != len(want) or any(w != "b" and w != m for w, m in zip(want, x.shape)) or x.shape[0] < 1:
                raise ValueError(f"input '{k}' has shape {tuple(x.shape)}; the artifact takes {want}")
            args[k] = x
        outs: Dict[int, torch.Tensor] = {}
        with torch.random.fork_rng(devices=cuda), torch.no_grad():
            if len(groups) == 1:
                outs.update(run(placements[0], list(range(n)), args, seed))
            else:
                from concurrent.futures import ThreadPoolExecutor

                with ThreadPoolExecutor(len(groups)) as pool:
                    for f in [pool.submit(run, d, r, args, seed) for d, r in groups.items()]:
                        outs.update(f.result())
        if n == 1:
            return outs[0]
        return torch.cat([outs[i].to(placements[0]) for i in range(n)], dim=1)

    predict.exported = exported
    return predict


def _placements(manifest: Mapping[str, Any], device) -> List[torch.device]:
    """The device of each replica (one for a one-device artifact), each of
    a platform the manifest lists; a CUDA one needs a GPU."""
    traced = torch.device(manifest["device"])
    platforms = manifest.get("platforms", [traced.type])
    n = int(manifest.get("devices", 1))
    if device is None:
        if n > 1 and traced.type == "cuda":
            have = torch.cuda.device_count()
            if have < n:
                raise RuntimeError(
                    f"the artifact was exported data-parallel over {n} devices but this host has {have} CUDA "
                    f"devices: re-export with devices={max(have, 1)} (or 1) for this host, or pass the "
                    f"{n} devices to place the replicas on"
                )
            devices = [torch.device("cuda", i) for i in range(n)]
        else:
            devices = [traced] * n
    elif isinstance(device, (list, tuple)):
        devices = [torch.device(d) for d in device]
        if len(devices) != n:
            raise ValueError(f"the artifact runs {n} replica(s): give {n} devices, not {len(devices)}")
    else:
        devices = [torch.device(device)] * n
    out = []
    for d in devices:
        if d.type == "cuda" and d.index is None:
            d = torch.device("cuda", torch.cuda.current_device() if torch.cuda.is_available() else 0)
        if d.type not in platforms:
            raise ValueError(f"the artifact was exported on {traced} for the platforms {platforms}, "
                             f"and runs there, not on {d}")
        if d.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(f"the artifact is asked to run on {d}, but torch.cuda.is_available() is False: "
                               "a CUDA request has no CPU fallback")
        out.append(d)
    return out


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


def load_exported(out_dir: str, device=None):
    """Load an :func:`export_run` artifact; returns ``(predict, manifest)``,
    ``predict(batch, seed)`` as :func:`serve_exported` gives it on
    ``device`` (see there: the artifact's own device by default, any device
    of a platform it lists, or, for a data-parallel artifact, ``cuda:0 ..
    cuda:D-1`` or a list of D devices; too few GPUs for the default
    placement raise a ``RuntimeError`` that says to re-export). Needs no
    model code or checkpoint: it imports ``torch`` and
    :mod:`dyffusion_tpu_torch.ops`, whose import registers the ops the
    program calls, and on CUDA builds their kernels (nvcc, cached under
    ``build/kernels/``) before the first request. The JAX package's
    ``compilation_cache`` option has no counterpart: an
    ``ExportedProgram`` runs eagerly, op by op, its loop ops a Python loop
    over their bodies, with nothing to compile."""
    import dyffusion_tpu_torch.ops  # noqa: F401 (registers the ops the program calls)

    with open(os.path.join(out_dir, _MANIFEST)) as f:
        manifest = json.load(f)
    placements = _placements(manifest, device)  # before the load: a wrong host fails fast
    with _cached_type_hints():
        exported = torch.export.load(os.path.join(out_dir, _ARTIFACT))
    if any(d.type == "cuda" for d in placements):  # build the kernels before the first request
        from dyffusion_tpu_torch.ops._build import CSRC, load_libraries

        load_libraries(sorted(p.stem for p in CSRC.glob("*.cu")))
    return serve_exported(exported, manifest, placements), manifest


def _main(argv: Optional[Sequence[str]] = None) -> str:
    """CLI: ``python -m dyffusion_tpu_torch.serving run_id=<id> out=<dir>
    [registry_dir=runs] [slot=best] [split=predict] [platforms=cuda,cpu]
    [batch_size=N] [polymorphic_batch=false] [devices=N] [reduce=mean_std]
    [device=cuda] [key.subkey=value ...]`` — export a trained run's sampler
    artifact (``devices=N`` needs ``polymorphic_batch=false`` and a batch
    divisible by N)."""
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
