"""MCVD over NCSN++ in the port against the JAX package: the
``synthetic_mcvd model.name=ncsnpp`` experiment (loss and gradients, the
val eval, three AdamW + EMA steps with the Fourier features held), the
engine's DDPM, DDIM and F-PNDM samplers, and the six annealed-Langevin
functions.

Both packages build the experiment from the same preset and overrides
(8x8, C=1, horizon 2, an NCSN++ of dim 8 with mults (1, 2) and attention at
the 4x4 level); the JAX variables are perturbed with numpy draws (NCSN++'s
output conv starts at scale 1e-10) and converted. The JAX draws are
replayed through the port's ``draw``/``draw_steps`` and the Langevin
functions' ``draw`` argument. Tolerance: r x max|JAX| with r = 2e-5 (f32);
gradients 1e-4 of the larger of the tensor's own and 0.1 of the model's
largest (as the other engine tests); train-step weights 1e-2 of their
change (relative L2, as the other train-step tests).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dyffusion_tpu import config as jax_config
from dyffusion_tpu import interface as jax_interface
from dyffusion_tpu.diffusion import mcvd as jmcvd
from dyffusion_tpu.training import trainer as jax_trainer
from dyffusion_tpu_torch import config as port_config
from dyffusion_tpu_torch import interface as port_interface
from dyffusion_tpu_torch.diffusion import mcvd as pmcvd
from dyffusion_tpu_torch.models import ncsnpp_state_dict_from_jax
from dyffusion_tpu_torch.training import trainer as port_trainer
from tests._torch_port_helpers import nchw_to_nhwc, nhwc_to_nchw, to_numpy_tree
from tests._torch_port_helpers import torch_threads_share_of_cores  # noqa: F401 (autouse fixture)
from tests.test_torch_port_baselines import Replay
from tests.test_torch_port_ncsnpp import perturbed

R, GRAD_REL, GRAD_FLOOR, CHANGE_REL = 2e-5, 1e-4, 0.1, 1e-2
H, HW = 2, 8
TINY = [
    "datamodule.spatial=(8,8)", "datamodule.channels=1", f"datamodule.horizon={H}",
    "datamodule.conditional_channels=1", "datamodule.n_traj=5", "datamodule.n_time=10",
    "datamodule.batch_size=3", "datamodule.eval_batch_size=2", "model.name=ncsnpp", "model.dim=8",
    "model.dim_mults=(1,2)", "model.num_res_blocks=1", "model.attn_resolutions=(4,)", "model.n_head_channels=8",
    "module.num_predictions=2", "module.num_predictions_test=2", "diffusion.timesteps=10",
    "trainer.save_checkpoints=False",
]


def _close(got, want, r=R, what=""):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err, scale = float(np.abs(got - want).max()), float(np.abs(want).max())
    assert err <= r * scale, f"{what}: max abs err {err:.3e} > {r} x {scale:.3e}"


def _pair(extra=()):
    ov = TINY + list(extra)
    jcfg, pcfg = jax_config.get_config("synthetic_mcvd", ov), port_config.get_config("synthetic_mcvd", ov)
    jdm, pdm = jax_interface.get_datamodule(jcfg), port_interface.get_datamodule(pcfg)
    jdm.setup()
    pdm.setup()
    jexp, _, jvars, jloss, jeval, jeng = jax_interface.build_experiment(jcfg, jdm)
    jvars = perturbed(jvars, seed=2)
    pexp, pmodel, ploss, peval, peng = port_interface.build_experiment(pcfg, pdm, device="cpu")
    pmodel.load_state_dict(ncsnpp_state_dict_from_jax(jvars), strict=True)
    j = dict(exp=jexp, vars=jvars, loss=jloss, eval=jeval, eng=jeng, cfg=jcfg)
    p = dict(exp=pexp, model=pmodel, loss=ploss, eval=peval, eng=peng, cfg=pcfg)
    return j, p, pdm


@pytest.fixture(scope="module")
def pair():
    return _pair()


def _jbatch(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def test_config_and_backbone_match(pair):
    j, p, _ = pair
    assert p["cfg"] == j["cfg"] and p["cfg"]["model"]["name"] == "ncsnpp"
    assert type(p["model"]).__name__ == "NCSNpp" and p["model"].all_res == [8, 4]
    assert sum(v.numel() for v in p["model"].parameters()) == sum(
        np.asarray(a).size for a in jax.tree_util.tree_leaves(j["vars"]["params"]))


def test_mcvd_ncsnpp_loss_and_grads_match(pair):
    """The experiment's loss (t and noise replayed) and every gradient."""
    j, p, pdm = pair
    batch = next(pdm.split("train").batches(3))
    rng = jax.random.key(3)

    def f(params):
        loss, (aux, updates) = j["loss"]({**j["vars"], "params": params}, _jbatch(batch), rng)
        return loss, aux

    (loss, _), grads = jax.jit(jax.value_and_grad(f, has_aux=True))(j["vars"]["params"])
    k_t, k_loss = jax.random.split(rng)
    B = batch["dynamics"].shape[0]
    t = np.asarray(jax.random.randint(k_t, (B,), 0, p["eng"].num_timesteps))
    p["eng"].draw_steps = lambda n, generator, device: torch.from_numpy(t).to(device)
    p["eng"].draw = Replay([np.asarray(jax.random.normal(jax.random.split(k_loss, 3)[0], (B, HW, HW, H)))])
    p["model"].zero_grad()
    got, _ = p["loss"](None, batch, None)
    got.backward()
    _close(float(got.detach()), float(loss), what="loss")
    want = ncsnpp_state_dict_from_jax({"params": to_numpy_tree(grads)})
    top = max(float(w.abs().max()) for w in want.values())
    for k, prm in p["model"].named_parameters():
        limit = GRAD_REL * max(float(want[k].abs().max()), GRAD_FLOOR * top)
        assert float((prm.grad - want[k]).abs().max()) <= limit, k
    assert not p["eng"].draw.q


def test_val_eval_replays_jax(pair):
    """The val split's 2-member MCVD (DDPM) ensemble, members folded into
    the batch: each member's sampler draws replayed."""
    j, p, pdm = pair
    batch = next(pdm.split("val").batches(2))
    B = batch["dynamics"].shape[0]
    rng = jax.random.key(5)
    want = jax.jit(j["eval"]["val"])(j["vars"], _jbatch(batch), rng)
    steps = p["eng"].subsampled_schedule()[0]
    shape = (B, HW, HW, H)
    per_member = []
    for key in jax.random.split(rng, 2):
        k_init, k_loop, _ = jax.random.split(jax.random.split(key)[1], 3)
        per_member.append([jax.random.normal(k_init, shape)] +
                          [jax.random.normal(jax.random.fold_in(k_loop, i), shape) for i in range(len(steps) - 1)])
    p["eng"].draw = Replay([np.concatenate([np.asarray(a) for a in draws]) for draws in zip(*per_member)])
    got = p["eval"]["val"](batch, None, None)
    assert sorted(got) == sorted(want) and not p["eng"].draw.q
    for k in want:
        _close(got[k].numpy(), want[k], what=k)


@pytest.mark.parametrize("kw", [dict(sampling_timesteps=5), dict(version="DDIM", sampling_timesteps=5),
                                dict(version="FPNDM")], ids=["ddpm", "ddim", "fpndm"])
def test_mcvd_samplers_over_ncsnpp_match(pair, kw):
    j, p, _ = pair
    cond = np.random.default_rng(1).normal(size=(2, HW, HW, 2)).astype(np.float32)
    jeng = jmcvd.McvdEngine(jmcvd.McvdConfig(timesteps=10, **kw), j["eng"].scorenet_apply, (HW, HW, H))
    peng = pmcvd.McvdEngine(pmcvd.McvdConfig(timesteps=10, **kw), p["model"], (H, HW, HW))
    rng = jax.random.key(9)
    want = np.asarray(jax.jit(lambda v, c: jeng.sample(v, rng, c))(j["vars"], cond))
    shape = (2, HW, HW, H)
    if kw.get("version", "DDPM") == "DDPM":
        k_init, k_loop, _ = jax.random.split(rng, 3)
        n = len(peng.subsampled_schedule()[0])
        draws = [jax.random.normal(k_init, shape)] + [jax.random.normal(jax.random.fold_in(k_loop, i), shape)
                                                      for i in range(n - 1)]
    else:
        draws = [jax.random.normal(jax.random.split(rng)[0], shape)]
    peng.draw = Replay([np.asarray(d) for d in draws])
    with torch.no_grad():
        got = nchw_to_nhwc(peng.sample(None, None, nhwc_to_nchw(cond)))
    _close(got, want)
    assert not peng.draw.q


def test_three_adamw_ema_steps_hold_the_fourier_features():
    """Fourier time embedding: three AdamW (weight decay 0.1) + clip + EMA
    steps at fixed t with replayed noise. The weights and the EMA follow
    JAX; the Fourier features ``fourier_emb.W`` stay bit for bit as they
    were, in the weights and the EMA, on both sides (the JAX package cuts
    their gradient and masks them out of the decay)."""
    extra = ["model.embedding_type=fourier", "diffusion.loss_function=mse", "module.use_ema=true",
             "module.ema_decay=0.9", "module.optimizer.weight_decay=0.1", "module.optimizer.lr=1e-3"]
    j, p, pdm = _pair(extra)
    W0 = p["model"].fourier_emb.W.detach().clone()
    np.testing.assert_array_equal(W0.numpy(), j["vars"]["params"]["fourier_emb"]["W"])
    init = {k: v.detach().clone() for k, v in p["model"].named_parameters()}
    batches = [next(pdm.split("train").batches(3)) for _ in range(3)]
    t_rows = np.asarray([0, 4, 9], np.int32)

    def key(i):
        return jax.random.fold_in(jax.random.key(0), i)

    def j_loss(variables, batch, rng):
        dyn = batch["dynamics"]
        targets = jnp.moveaxis(dyn[:, 1:1 + H], 1, -2).reshape(dyn.shape[:1] + dyn.shape[2:4] + (H,))
        cond = jnp.concatenate([dyn[:, 0], batch["condition"]], axis=-1)
        loss, aux = j["eng"].p_losses(variables, key(batch["i"]), targets, cond, t_rows)
        return loss, (aux, {})

    def p_loss(params, batch, generator):
        p["eng"].draw_steps = lambda n, g, d: torch.from_numpy(t_rows).long()
        return p["loss"](params, {k: v for k, v in batch.items() if k != "i"}, generator)

    j_state = jax_interface.create_train_state(j["cfg"], j["vars"])
    p_state = port_interface.create_train_state(p["cfg"], p["model"])
    j_step = jax.jit(jax_trainer.make_train_step(j_loss))
    p_step = port_trainer.make_train_step(p_loss)
    for i, batch in enumerate(batches):
        j_state, jm = j_step(j_state, {**_jbatch(batch), "i": jnp.int32(i)})
        p["eng"].draw = Replay([np.asarray(jax.random.normal(jax.random.split(key(i))[0], (3, HW, HW, H)))])
        pm = p_step(p_state, {**batch, "i": i})
        _close(float(pm["loss"]), float(jm["loss"]), 1e-5, f"loss {i}")
    want = ncsnpp_state_dict_from_jax({"params": to_numpy_tree(j_state.params)})
    want_ema = ncsnpp_state_dict_from_jax({"params": to_numpy_tree(j_state.ema_params)})
    got = {k: v.detach() for k, v in p["model"].named_parameters()}
    for name, g, w in (("params", got, want), ("ema", p_state.ema, want_ema)):
        assert torch.equal(g["fourier_emb.W"], W0) and torch.equal(w["fourier_emb.W"], W0), name
        num = sum(float(((g[k] - w[k]) ** 2).sum()) for k in w)
        den = sum(float(((w[k] - init[k]) ** 2).sum()) for k in w)
        assert den > 0 and (num / den) ** 0.5 <= CHANGE_REL, f"{name}: relative L2 {(num / den) ** 0.5:.3e}"


# ---------------------------------------------------------------------------
# annealed Langevin dynamics, the JAX draws replayed
# ---------------------------------------------------------------------------
SIGMAS = jmcvd.get_sigmas("geometric", 1.0, 0.01, 3)
N_STEPS = 2


@pytest.fixture(scope="module")
def langevin(pair):
    j, p, _ = pair
    g = np.random.default_rng(7)
    x0 = g.normal(size=(2, HW, HW, H)).astype(np.float32)
    cond = g.normal(size=(2, HW, HW, 2)).astype(np.float32)
    return j["eng"].scorenet_apply, j["vars"], p["model"], x0, cond


def _level_step_keys(rng, L):
    """The JAX per-step keys: one key per level, split into n_steps_each."""
    return [k for lk in jax.random.split(rng, L) for k in jax.random.split(lk, N_STEPS)]


def _normal(key, shape):
    return np.asarray(jax.random.normal(key, shape))


def _t(a):
    return nhwc_to_nchw(a) if a.ndim == 4 else torch.from_numpy(a)


LANGEVIN = ["plain", "sparse", "consistent", "sparse_consistent", "inpainting", "interpolation"]


@pytest.mark.parametrize("name", LANGEVIN)
@torch.no_grad()
def test_langevin_matches_jax(langevin, name):
    apply, v, tm, x0, cond = langevin
    rng = jax.random.key(11)
    shape = x0.shape
    sparsity = np.random.default_rng(8).uniform(0.5, 1.5, size=shape).astype(np.float32)
    L = len(SIGMAS)
    if name == "plain":
        want = jmcvd.anneal_langevin_dynamics(apply, v, rng, x0, cond, SIGMAS, N_STEPS, step_lr=2e-5)
        draws = [_normal(k, shape) for k in _level_step_keys(rng, L)]
        got = pmcvd.anneal_langevin_dynamics(tm, None, None, _t(x0), _t(cond), SIGMAS, N_STEPS, step_lr=2e-5,
                                             draw=Replay(draws))
    elif name == "sparse":
        want = jmcvd.sparse_anneal_langevin_dynamics(apply, v, rng, x0, sparsity, cond, SIGMAS, N_STEPS,
                                                     step_lr=2e-5, frac_steps=0.5)
        draws = [_normal(k, shape) for k in _level_step_keys(rng, 2)]  # frac_steps keeps the last 2 levels
        got = pmcvd.sparse_anneal_langevin_dynamics(tm, None, None, _t(x0), _t(sparsity), _t(cond), SIGMAS, N_STEPS,
                                                    step_lr=2e-5, frac_steps=0.5, draw=Replay(draws))
    elif name in ("consistent", "sparse_consistent"):
        n = (L - 1) * N_STEPS + 1
        draws = [_normal(jax.random.fold_in(rng, i), shape) for i in range(n - 1)]
        if name == "consistent":
            want = jmcvd.anneal_langevin_dynamics_consistent(apply, v, rng, x0, cond, SIGMAS, N_STEPS, step_lr=1e-4)
            got = pmcvd.anneal_langevin_dynamics_consistent(tm, None, None, _t(x0), _t(cond), SIGMAS, N_STEPS,
                                                            step_lr=1e-4, draw=Replay(draws))
        else:
            want = jmcvd.sparse_anneal_langevin_dynamics_consistent(apply, v, rng, x0, sparsity, cond, SIGMAS,
                                                                    N_STEPS, step_lr=1e-4)
            got = pmcvd.sparse_anneal_langevin_dynamics_consistent(tm, None, None, _t(x0), _t(sparsity), _t(cond),
                                                                   SIGMAS, N_STEPS, step_lr=1e-4, draw=Replay(draws))
    elif name == "inpainting":
        refer = np.random.default_rng(9).normal(size=shape).astype(np.float32)
        mask = np.zeros(shape, np.float32)
        mask[:, :, : HW // 2] = 1.0
        want = jmcvd.anneal_langevin_dynamics_inpainting(apply, v, rng, x0, refer, mask, cond, SIGMAS, N_STEPS,
                                                         step_lr=2e-5)
        draws = []
        for k in _level_step_keys(rng, L):
            k_c, k_n = jax.random.split(k)
            draws += [_normal(k_c, shape), _normal(k_n, shape)]
        got = pmcvd.anneal_langevin_dynamics_inpainting(tm, None, None, _t(x0), _t(refer), _t(mask), _t(cond),
                                                        SIGMAS, N_STEPS, step_lr=2e-5, draw=Replay(draws))
    else:
        n_i = 3
        cond_rep = np.repeat(cond, n_i, axis=0)
        want = jmcvd.anneal_langevin_dynamics_interpolation(apply, v, rng, x0, n_i, cond_rep, SIGMAS, N_STEPS,
                                                            step_lr=2e-5)
        draws = []
        for k in _level_step_keys(rng, L):
            k_p, k_q = jax.random.split(k)
            draws += [_normal(k_p, shape), _normal(k_q, shape)]
        got = pmcvd.anneal_langevin_dynamics_interpolation(tm, None, None, _t(x0), n_i, _t(cond_rep), SIGMAS,
                                                           N_STEPS, step_lr=2e-5, draw=Replay(draws))
    _close(nchw_to_nhwc(got), np.asarray(want), what=name)
