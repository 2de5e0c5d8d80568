"""DYffusion engine over a forecaster and a frozen interpolator.

Counterpart of ``dyffusion_tpu/diffusion/dyffusion.py``: the step mapping,
the sampling-schedule DSL, the precomputed static schedule, the cold/naive
sampler and the two-term training loss (``p_losses``, ``loss``). The JAX
``lax.scan`` becomes :func:`utils.loop.loop` over the precomputed steps (a
Python loop when run, one loop op when exported); each cold step still
runs the two interpolator calls as ONE 2B-batch forward, and the last step
is peeled. Tensors are NCHW.

Randomness comes from one explicit ``torch.Generator``, drawn in a fixed
order, so the same seed gives the same samples; ``sample_ensemble`` runs the
sampler once per ensemble member, each on a generator of its own (the
unfolded layout). In sampling the forecaster
runs deterministic and the interpolator's dropout is live when
``enable_interpolator_dropout`` is set and a generator is given; in the
training loss both networks' dropout is live whenever a generator is given.
"""
from __future__ import annotations

import math

from dataclasses import dataclass
from typing import Callable, Dict, List, Mapping, Optional, Sequence, Tuple, Union

import numpy as np
import torch
from torch import nn

from dyffusion_tpu_torch.models.base import MODEL_STATE_UPDATES, apply_model, apply_model_train
from dyffusion_tpu_torch.utils import rng
from dyffusion_tpu_torch.utils.loop import loop
from dyffusion_tpu_torch.utils.loss import mse_loss

Params = Optional[Mapping[str, torch.Tensor]]


@dataclass(frozen=True)
class StepMapping:
    """Static diffusion-step <-> interpolation-step mapping. ``num_timesteps``
    is the TOTAL number of diffusion steps N (horizon plus auxiliary steps)."""

    schedule: str  # 'linear' | 'before_t1_only'
    horizon: int
    num_timesteps: int
    additional_steps: int
    di_to_ti_add: int
    factor: int

    @classmethod
    def create(
        cls,
        horizon: int,
        schedule: str = "before_t1_only",
        additional_interpolation_steps: int = 0,
        additional_interpolation_steps_factor: int = 0,
        interpolate_before_t1: bool = False,
    ) -> "StepMapping":
        assert horizon > 1, f"horizon must be > 1, got {horizon}"
        if schedule == "linear":
            assert additional_interpolation_steps == 0, (
                "additional_interpolation_steps must be 0 for the linear schedule"
            )
            if interpolate_before_t1:
                interpolated_steps, di_to_ti_add = horizon - 1, 0
            else:
                interpolated_steps, di_to_ti_add = horizon - 2, additional_interpolation_steps_factor
            additional = additional_interpolation_steps_factor * interpolated_steps
            return cls(schedule, horizon, horizon + additional, additional, di_to_ti_add,
                       additional_interpolation_steps_factor)
        if schedule == "before_t1_only":
            assert additional_interpolation_steps_factor == 0, (
                "additional_interpolation_steps_factor must be 0 for before_t1_only"
            )
            assert interpolate_before_t1, "interpolate_before_t1 must be True for before_t1_only"
            additional = additional_interpolation_steps
            return cls(schedule, horizon, horizon + additional, additional, 0, 0)
        raise ValueError(f"Invalid schedule: {schedule}")

    def to_interpolation_step(self, d):
        """d -> i for Python scalars and tensors (tensors in f32)."""
        if not isinstance(d, torch.Tensor):
            return self.i_of(d)
        d = d.float()
        if self.schedule == "linear":
            return (d + self.di_to_ti_add) / (self.factor + 1)
        J = self.additional_steps
        return torch.where(d >= J + 1, d - J, d / (J + 1))

    def i_of(self, d: Union[int, float]) -> float:
        if self.schedule == "linear":
            return (d + self.di_to_ti_add) / (self.factor + 1)
        J = self.additional_steps
        return float(d - J) if d >= J + 1 else d / (J + 1)

    @property
    def d_to_i(self) -> Dict[int, float]:
        return {d: self.i_of(d) for d in range(1, self.num_timesteps)}

    @property
    def dynamical_steps(self) -> Dict[int, float]:
        return {d: i for d, i in self.d_to_i.items() if float(i).is_integer()}

    @property
    def artificial_interpolation_steps(self) -> Dict[int, float]:
        return {d: i for d, i in self.d_to_i.items() if not float(i).is_integer()}

    def validate(self) -> None:
        """Check that the tensor mapping agrees with the scalar one at every
        diffusion step (to 4e-6: the tensor one computes in f32)."""
        for d, i in self.d_to_i.items():
            i2 = float(self.to_interpolation_step(torch.tensor(float(d))))
            if not math.isclose(i, i2, abs_tol=4e-6):
                raise ValueError(f"step mapping disagrees at d={d}: {i} != {i2}")


def parse_sampling_schedule(
    schedule: Union[None, str, Sequence[Union[int, float]]], mapping: StepMapping
) -> List[Union[int, float]]:
    """Resolve a sampling-schedule spec (``None``, ``only_dynamics``,
    ``only_dynamics_plusN[_discrete]``, ``everyN``, ``firstN``/``first0.F``,
    or an explicit sequence) into a sorted list of diffusion steps."""
    N = mapping.num_timesteps
    if schedule in (None, "None"):
        return list(range(N))
    if not isinstance(schedule, str):
        sched = list(schedule)
    else:
        name = schedule
        base = [0] + list(mapping.dynamical_steps.keys())
        artificial = list(mapping.artificial_interpolation_steps.keys())
        if "only_dynamics" in name:
            if "only_dynamics_plus" in name:
                plus_n = int(name.replace("only_dynamics_plus", "").replace("_discrete", ""))
                sched = list(np.linspace(0, base[1], plus_n + 1, endpoint=False))
                if "_discrete" in name:
                    sched = [int(np.floor(s)) for s in sched]
            else:
                assert name == "only_dynamics", f"Invalid sampling schedule: {name}"
                sched = []
        elif name.startswith("every"):
            n = int(name.replace("every", "").replace("th", "").replace("nd", "").replace("rd", ""))
            assert 1 <= n <= N, f"Invalid sampling schedule: {name}"
            sched = artificial[::n]
        elif name.startswith("first"):
            first_n = float(name.replace("first", "").replace("v2", ""))
            if first_n < 1:
                assert 0 < first_n < 1, f"Invalid sampling schedule: {name}"
                first_n = int(np.ceil(first_n * len(artificial)))
            else:
                assert float(first_n).is_integer(), f"firstN with N>=1 must be an integer: {first_n}"
                assert 1 <= first_n <= N, f"Invalid sampling schedule: {name}"
            sched = artificial[: int(first_n)]
        else:
            raise ValueError(f"Invalid sampling schedule: ``{name}``")
        sched = sorted(set(sched + base))

    assert 1 <= sched[-1] <= N, f"Invalid sampling schedule end: {sched}"
    if sched[0] != 0:
        sched = [0] + sched
    for a, b in zip(sched, sched[1:]):
        assert b > a, f"Sampling schedule not strictly increasing: {sched}"
    if all(float(s).is_integer() for s in sched):
        sched = [int(s) for s in sched]
    return sched


@dataclass(frozen=True)
class DyffusionConfig:
    """Hyperparameters of the DYffusion sampler."""

    timesteps: int  # == horizon of the data / interpolator
    forward_conditioning: str = "data"  # 'data' | 'none' | 'data+noise'
    schedule: str = "before_t1_only"
    additional_interpolation_steps: int = 0
    additional_interpolation_steps_factor: int = 0
    interpolate_before_t1: bool = True
    sampling_type: str = "cold"  # 'cold' | 'naive'
    sampling_schedule: Union[None, str, Tuple[float, ...]] = None
    time_encoding: str = "dynamics"  # 'discrete' | 'normalized' | 'dynamics'
    refine_intermediate_predictions: bool = False
    prediction_timesteps: Optional[Tuple[float, ...]] = None
    enable_interpolator_dropout: bool = True
    use_cold_sampling_for_last_step: bool = False
    num_input_channels: int = 1  # C of a single dynamics frame
    lambda_reconstruction: float = 1.0
    lambda_reconstruction2: float = 0.0
    # frozen-interpolator precision in the training loss: None | 'bfloat16'
    train_interpolator_dtype: Optional[str] = None

    def __post_init__(self):
        assert self.forward_conditioning in ("data", "none", "data+noise")
        assert self.sampling_type in ("cold", "naive")
        assert self.time_encoding in ("discrete", "normalized", "dynamics")


@dataclass(frozen=True)
class _SampleSteps:
    """Precomputed static per-step arrays of the sampling loop."""

    s: np.ndarray  # (K-1,) float32 — all schedule steps except the last
    i_next: np.ndarray  # (K-1,) float32 — interpolation time of s_next
    i_cur: np.ndarray  # (K-1,) float32 — interpolation time of s (clamped at s=0)
    s_pos: np.ndarray  # (K-1,) float32 — 1.0 where s > 0 (cold second q_sample)
    is_dyn: np.ndarray  # (K-1,) bool — records a dynamical output this step (the JAX scan's input)
    slot: np.ndarray  # (K-1,) int32 — output slot, or n_outputs (the spare slot) when not is_dyn
    last_s: float
    last_is_N_minus_1: bool
    n_outputs: int


class DyffusionEngine:
    """DYffusion sampler over a forecaster and a (frozen) interpolator.

    Both are backbones called as ``(x, time, condition, generator)``; the
    interpolator gets ``x = cat([initial_condition, x_last], dim=1)``. The
    methods take optional ``fc_params``/``ip_params`` state dicts that replace
    the modules' own weights for the call (``None`` = the module's own).
    ``criterion(preds, targets, mask=None)`` is the training loss (default
    MSE)."""

    def __init__(
        self,
        config: DyffusionConfig,
        forecaster: nn.Module,
        interpolator: nn.Module,
        interpolator_horizon: Optional[int] = None,
        criterion: Optional[Callable] = None,
    ):
        self.cfg = config
        self.forecaster = forecaster
        self.interpolator = interpolator
        self.criterion = criterion or mse_loss
        self.mapping = StepMapping.create(
            horizon=config.timesteps,
            schedule=config.schedule,
            additional_interpolation_steps=config.additional_interpolation_steps,
            additional_interpolation_steps_factor=config.additional_interpolation_steps_factor,
            interpolate_before_t1=config.interpolate_before_t1,
        )
        self.num_timesteps = self.mapping.num_timesteps
        last_i = self.mapping.i_of(self.num_timesteps - 1)
        if interpolator_horizon is not None and interpolator_horizon != last_i + 1:
            raise ValueError(
                f"interpolator horizon {interpolator_horizon} must equal the last interpolation step + 1 = {last_i + 1}"
            )
        self.sampling_schedule = parse_sampling_schedule(config.sampling_schedule, self.mapping)
        self._steps = self._precompute_steps(self.sampling_schedule)
        self._i_min = self.mapping.i_of(1) if self.mapping.i_of(1) > 0 else 1e-3
        self._i_max = float(last_i)

    def _precompute_steps(self, sched: List[Union[int, float]]) -> _SampleSteps:
        N = self.num_timesteps
        mp = self.mapping
        body, s_next = sched[:-1], sched[1:]
        i_next, i_cur, is_dyn, slot, s_pos = [], [], [], [], []
        n_outputs = mp.horizon
        for s, sn in zip(body, s_next):
            ti_n = mp.i_of(sn)
            dyn = float(ti_n).is_integer()
            i_next.append(ti_n)
            i_cur.append(np.clip(mp.i_of(s) if s > 0 else mp.i_of(max(s, 1)), 1e-6, None))
            s_pos.append(1.0 if s > 0 else 0.0)
            is_dyn.append(dyn)
            slot.append(int(ti_n) - 1 if dyn else n_outputs)
        return _SampleSteps(
            s=np.asarray(body, np.float32),
            i_next=np.asarray(i_next, np.float32),
            i_cur=np.asarray(i_cur, np.float32),
            s_pos=np.asarray(s_pos, np.float32),
            is_dyn=np.asarray(is_dyn, bool),
            slot=np.asarray(slot, np.int32),
            last_s=float(sched[-1]),
            last_is_N_minus_1=sched[-1] == N - 1,
            n_outputs=n_outputs,
        )

    # ---- building blocks ----
    def _encode_time(self, t: torch.Tensor) -> torch.Tensor:
        enc = self.cfg.time_encoding
        if enc == "discrete":
            return t
        if enc == "normalized":
            return t / self.num_timesteps
        return self.mapping.to_interpolation_step(t)

    def _forward_condition(
        self, condition: Optional[torch.Tensor], t: torch.Tensor, generator: Optional[torch.Generator]
    ) -> Optional[torch.Tensor]:
        mode = self.cfg.forward_conditioning
        if mode == "none" or condition is None:
            return None
        if mode == "data":
            return condition
        # data+noise: blend the condition with N(0, 1) noise by t/(N-1)
        tfac = (t / (self.num_timesteps - 1)).reshape((-1,) + (1,) * (condition.ndim - 1))
        noise = rng.row_randn(condition.shape, generator, condition.device, condition.dtype, grid=True)
        return tfac * condition + (1.0 - tfac) * noise

    def predict_x_last(
        self,
        fc_params: Params,
        condition: Optional[torch.Tensor],
        x_t: torch.Tensor,
        t: torch.Tensor,
        static_condition: Optional[torch.Tensor] = None,
        generator: Optional[torch.Generator] = None,
        noise_generator: Optional[torch.Generator] = None,
    ) -> torch.Tensor:
        """Forecaster forward F(x_t, t) with conditioning."""
        fcond = self._forecaster_condition(condition, t, static_condition, noise_generator)
        return apply_model(self.forecaster, fc_params, x_t, self._encode_time(t), fcond, generator)

    def _forecaster_condition(
        self,
        condition: Optional[torch.Tensor],
        t: torch.Tensor,
        static_condition: Optional[torch.Tensor],
        noise_generator: Optional[torch.Generator],
    ) -> Optional[torch.Tensor]:
        fcond = self._forward_condition(condition, t, noise_generator)
        if static_condition is not None:
            fcond = static_condition if fcond is None else torch.cat([fcond, static_condition], dim=1)
        return fcond

    def interpolate(
        self,
        ip_params: Params,
        initial_condition: torch.Tensor,
        x_last: torch.Tensor,
        interpolation_time: torch.Tensor,
        static_condition: Optional[torch.Tensor] = None,
        generator: Optional[torch.Generator] = None,
    ) -> torch.Tensor:
        """Stochastic interpolator I(x0, x_h, i), time in interpolation units."""
        inputs = torch.cat([initial_condition, x_last], dim=1)
        return apply_model(self.interpolator, ip_params, inputs, interpolation_time, static_condition, generator)

    def q_sample(
        self,
        ip_params: Params,
        x0: torch.Tensor,
        x_end: torch.Tensor,
        t: torch.Tensor,
        static_condition: Optional[torch.Tensor] = None,
        generator: Optional[torch.Generator] = None,
    ) -> torch.Tensor:
        """Forward process = the interpolator at i(t). ``x0`` is the LAST
        dynamical frame, ``x_end`` the initial condition."""
        i_t = torch.clamp(self.mapping.to_interpolation_step(t), self._i_min, self._i_max)
        return self.interpolate(ip_params, x_end, x0, i_t, static_condition, generator)

    # ---- training loss ----
    def p_losses(
        self,
        fc_params: Params,
        ip_params: Params,
        generator: Optional[torch.Generator],
        xt_last: torch.Tensor,
        condition: torch.Tensor,
        t: torch.Tensor,
        static_condition: Optional[torch.Tensor] = None,
    ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """Two-term DYffusion loss for a batch with per-row diffusion steps ``t``:
        l1 * |F(x_t, t) - x_h| + l2 * |F(D(F(x_t, t), t+1), t+1) - x_h|, D the
        frozen interpolator. Static shapes: rows with t == 0 take the raw
        condition as x_t, and the l2 term is masked over rows with t > N-2.

        The l2 term's gradient runs through D's input ``F(x_t, t)``: D's
        weights are frozen, but its second call is differentiated (as in
        the JAX package, which has no stop_gradient there). Dropout is live
        in both networks whenever ``generator`` is given; the draws come
        from it in a fixed order. A BatchNorm forecaster runs its first pass
        on the batch statistics, and the returned metrics carry its
        running-statistics updates under ``MODEL_STATE_UPDATES``; its l2
        pass and the interpolator read their running averages."""
        cfg = self.cfg
        lam1, lam2 = cfg.lambda_reconstruction, cfg.lambda_reconstruction2
        if condition.shape[1] != xt_last.shape[1]:
            raise ValueError(
                "DYffusion training requires a single-frame condition "
                f"(datamodule.window=1): condition has {condition.shape[1]} "
                f"channels but the target frame has {xt_last.shape[1]}."
            )
        # frozen-interpolator mixed precision (train_interpolator_dtype)
        ip_dt = torch.bfloat16 if cfg.train_interpolator_dtype in ("bfloat16", "bf16") else None
        if ip_dt is not None:
            source = ip_params if ip_params is not None else self.interpolator.state_dict()
            ip_params = {k: v.to(ip_dt) if v.is_floating_point() else v for k, v in source.items()}
            static_ip = None if static_condition is None else static_condition.to(ip_dt)
        else:
            static_ip = static_condition

        def run_q_sample(x0, x_end, t_q):
            """q_sample at the interpolator's training precision; f32 out
            under train_interpolator_dtype."""
            if ip_dt is None:
                return self.q_sample(ip_params, x0, x_end, t_q, static_ip, generator)
            return self.q_sample(ip_params, x0.to(ip_dt), x_end.to(ip_dt), t_q, static_ip, generator).float()

        t = t.float()
        row = (-1,) + (1,) * (condition.ndim - 1)
        # 1) forecaster input: the interpolated frame for t > 0, the condition for t == 0
        x_interpolated = run_q_sample(xt_last, condition, torch.clamp(t, min=1.0))
        x_t = torch.where((t > 0).reshape(row), x_interpolated.to(condition.dtype), condition)
        # 2) forward loss, the forecaster in train mode: a BatchNorm
        #    forecaster normalizes with the batch statistics and returns its
        #    running-statistics updates (the l2 pass reads the old averages)
        fcond = self._forecaster_condition(condition, t, static_condition, generator)
        xt_last_pred, updates = apply_model_train(
            self.forecaster, fc_params, x_t, self._encode_time(t), fcond, generator
        )
        loss_forward = self.criterion(xt_last_pred, xt_last)
        # 3) one-step diffusion-emulation loss (the l2 term)
        if lam2 > 0:
            mask2 = (t <= self.num_timesteps - 2).float()
            t2 = torch.clamp(t + 1.0, max=float(self.num_timesteps - 1))
            x_interpolated2 = run_q_sample(xt_last_pred, condition, t2)
            x_last_pred2 = self.predict_x_last(
                fc_params, condition, x_interpolated2, t2, static_condition,
                generator=generator, noise_generator=generator,
            )
            loss_forward2 = self.criterion(x_last_pred2, xt_last, mask=mask2)
        else:
            loss_forward2 = torch.zeros((), dtype=loss_forward.dtype, device=loss_forward.device)
        loss = lam1 * loss_forward + lam2 * loss_forward2
        aux = {"loss": loss, "loss_forward": loss_forward, "loss_forward2": loss_forward2}
        if updates:
            aux[MODEL_STATE_UPDATES] = updates
        return loss, aux

    def loss(
        self,
        fc_params: Params,
        ip_params: Params,
        generator: Optional[torch.Generator],
        xt_last: torch.Tensor,
        condition: torch.Tensor,
        static_condition: Optional[torch.Tensor] = None,
    ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """Draw t ~ U{0..N-1} per row from ``generator``, then :meth:`p_losses`."""
        t = rng.row_randint(0, self.num_timesteps, condition.shape[0], generator, condition.device)
        return self.p_losses(fc_params, ip_params, generator, xt_last, condition, t, static_condition)

    # ---- sampling ----
    def sample(
        self,
        fc_params: Params,
        ip_params: Params,
        generator: Optional[torch.Generator],
        initial_condition: torch.Tensor,
        static_condition: Optional[torch.Tensor] = None,
    ) -> torch.Tensor:
        """Run the sampler. ``initial_condition`` is (B, window*C, H, W);
        returns (B, h, C, H, W), the h dynamical predictions t1..th.

        The steps before the last run as one :func:`utils.loop.loop` over
        the precomputed steps (one loop op in an exported sampler), the
        JAX scan's body: the s = 0 step is a mask, and a step that records
        no dynamical output writes the spare slot ``n_outputs``. The final
        step is peeled, and the refinement is a loop of its own."""
        cfg, st, mp = self.cfg, self._steps, self.mapping
        B = initial_condition.shape[0]
        C = cfg.num_input_channels
        dev = initial_condition.device
        x_s = initial_condition[:, -C:]
        cold = cfg.sampling_type == "cold"
        ip_gen = generator if cfg.enable_interpolator_dropout else None
        # the outputs, and one spare slot for the steps that record none
        out = torch.zeros((st.n_outputs + 1,) + tuple(x_s.shape), dtype=x_s.dtype, device=dev)
        slots = torch.arange(st.n_outputs + 1, device=dev).reshape((-1,) + (1,) * x_s.ndim)
        ic2 = torch.cat([initial_condition, initial_condition], dim=0) if cold else None
        sc2 = None
        if cold and static_condition is not None:
            sc2 = torch.cat([static_condition, static_condition], dim=0)
        consts = (initial_condition, static_condition, ic2, sc2, fc_params, ip_params, slots)

        def full(v):  # (B,) f32 rows of the step value v (a float or a 0-dim CPU tensor)
            return torch.zeros((B,), dtype=torch.float32, device=dev) + v

        def write(out, slot, x, slots):
            return torch.where(slots == slot, x.unsqueeze(0), out)

        def step(carry, x, consts):
            x_s, out = carry
            ic, sc, ic2, sc2, fc_p, ip_p, slots = consts
            x0_hat = self.predict_x_last(fc_p, ic, x_s, full(x["s"]), sc, noise_generator=generator)
            if cold:
                # one 2B-batch interpolator call for i_next and i_cur
                t2 = torch.cat([full(x["i_next"]), full(x["i_cur"])])
                x_pair = self.interpolate(ip_p, ic2, torch.cat([x0_hat, x0_hat], dim=0), t2, sc2, ip_gen)
                x_ip_next, x_ip_cur = x_pair[:B], x_pair[B:]
                # at s = 0 (s_pos 0) the "current" interpolation is x_s itself;
                # the update in f32, as the JAX scan promotes it through the f32 mask
                s_pos = x["s_pos"]
                x_ip_cur = s_pos * x_ip_cur.float() + (1.0 - s_pos) * x_s.float()
                x_new = x_s.float() - x_ip_cur + x_ip_next.float()
            else:
                x_new = self.interpolate(ip_p, ic, x0_hat, full(x["i_next"]), sc, ip_gen)
            x_new = x_new.to(out.dtype)
            return x_new, write(out, x["slot"], x_new, slots)

        xs = {k: torch.from_numpy(getattr(st, k)) for k in ("s", "i_next", "i_cur", "s_pos")}
        xs["slot"] = torch.from_numpy(st.slot.astype(np.int64))
        nets = (self.forecaster, self.interpolator)  # the networks the loops call
        x_s, out = loop(step, (x_s, out), xs, consts, nets)

        # peeled final step
        x0_hat = self.predict_x_last(
            fc_params, initial_condition, x_s, full(st.last_s), static_condition, noise_generator=generator
        )
        if st.last_is_N_minus_1:
            if cold and cfg.use_cold_sampling_for_last_step:
                x_ip_cur = self.interpolate(
                    ip_params, initial_condition, x0_hat, full(mp.i_of(int(st.last_s))), static_condition, ip_gen
                )
                x_final = x_s - x_ip_cur + x0_hat
            else:
                x_final = x0_hat
            out[mp.horizon - 1] = x_final.to(out.dtype)
        # early-stopped schedules (last < N-1): later outputs stay zero

        if cfg.refine_intermediate_predictions:
            dyn_times = list(cfg.prediction_timesteps or mp.dynamical_steps.values())
            dyn_times = [i for i in dyn_times if i < self.num_timesteps and i < mp.horizon]
            if dyn_times:  # one batch-B interpolator forward per time; a fractional time writes the spare slot

                def refine(carry, x, consts):
                    ic, sc, x0_hat, ip_p, slots = consts
                    r = self.interpolate(ip_p, ic, x0_hat, full(x["t"]), sc, ip_gen)
                    return (write(carry[0], x["slot"], r.to(out.dtype), slots),)

                xs = {
                    "t": torch.tensor(dyn_times, dtype=torch.float32),
                    "slot": torch.tensor([int(i) - 1 if float(i).is_integer() else st.n_outputs for i in dyn_times]),
                }
                (out,) = loop(refine, (out,), xs, (initial_condition, static_condition, x0_hat, ip_params, slots),
                              nets)

        return out[: st.n_outputs].transpose(0, 1)  # (B, h, C, H, W)

    def sample_ensemble(
        self,
        fc_params: Params,
        ip_params: Params,
        generator: Union[rng.Generator, Sequence[rng.Generator]],
        initial_condition: torch.Tensor,
        static_condition: Optional[torch.Tensor] = None,
        num_predictions: int = 1,
        inputs_noise: float = 0.0,
    ) -> torch.Tensor:
        """The unfolded MC-dropout ensemble: :meth:`sample` once per member
        at batch B, each member on a generator of its own. Returns
        (N, B, h, C, H, W), the JAX package's (N, B, h, H, W, C) in NCHW.

        ``generator`` is the request's generator, split into
        ``num_predictions`` member generators (:func:`utils.rng.split`), or
        the list of the N member generators themselves (their streams run
        on: an autoregressive chain passes the same list to every window).
        ``initial_condition`` is (B, window*C, H, W), shared by the members,
        or (N, B, window*C, H, W), one per member. ``inputs_noise`` > 0 adds
        N(0, inputs_noise^2) to each member's condition, drawn from its
        generator before its sampler runs.

        A loop over members, where the JAX package vmaps over member keys:
        each member's dropout masks and noise come from its own generator,
        and peak activation memory is that of one B-row sampler (about 1/N
        of the folded layout's). ``torch.func.vmap`` is not used: it would
        need a vmap rule for the B1 op, and its random draws would not take
        the member generators."""
        if isinstance(generator, (list, tuple)):
            generators = list(generator)
        else:
            generators = rng.split(generator, num_predictions)
        per_member = initial_condition.ndim == 5
        preds = []
        for i, g in enumerate(generators):
            ic = initial_condition[i] if per_member else initial_condition
            if inputs_noise > 0:
                ic = ic + inputs_noise * rng.grid_randn(ic.shape, g, ic.device, ic.dtype)
            preds.append(self.sample(fc_params, ip_params, g, ic, static_condition))
        return torch.stack(preds)

    def sample_at_times(
        self,
        fc_params: Params,
        ip_params: Params,
        generator: Optional[torch.Generator],
        initial_condition: torch.Tensor,
        times: Sequence[float],
        static_condition: Optional[torch.Tensor] = None,
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Predictions at arbitrary (possibly fractional) dynamical times: the
        full sampler, then one batched interpolator forward from the final
        x-last estimate at each requested time. Returns
        ((B, h, C, H, W), (B, len(times), C, H, W))."""
        preds = self.sample(fc_params, ip_params, generator, initial_condition, static_condition)
        x_last = preds[:, -1]
        B, n_i = initial_condition.shape[0], len(times)
        rep = lambda x: x.repeat((n_i,) + (1,) * (x.ndim - 1))  # noqa: E731
        t_r = torch.tensor(list(times), dtype=torch.float32, device=x_last.device).repeat_interleave(B)
        sc_r = None if static_condition is None else rep(static_condition)
        refined = self.interpolate(
            ip_params, rep(initial_condition), rep(x_last), t_r, sc_r,
            generator if self.cfg.enable_interpolator_dropout else None,
        )
        refined = refined.reshape((n_i, B) + tuple(refined.shape[1:]))
        return preds, refined.transpose(0, 1)
