"""The port's OISST path on the CPU: the OISSTv2 datamodule against the JAX
package's on the same written boxes, the native batch gather and the
prefetching train loader, the OISST stage-1 loss, stage-2 loss with every
forecaster gradient and folded val eval against the JAX package's on
converted weights, and the OISST presets through the port's CLI.

Sizes: boxes written by ``write_fake_oisst_dir`` (60x60, the archive's
grid), a few days a year; networks are ``Unet`` dim 8 with mults (1, 2) and
one attention head of 8 channels (the full-width attention at 60x60 would
cost seconds a forward on the CPU)."""
import json
import os
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dyffusion_tpu import config as jax_config
from dyffusion_tpu import interface as jax_interface
from dyffusion_tpu.data import base as jax_base
from dyffusion_tpu.data import oisstv2 as jax_oisst
from dyffusion_tpu.models import make_apply_fn
from dyffusion_tpu.utils import naming as jax_naming
from dyffusion_tpu_torch import config as port_config
from dyffusion_tpu_torch import interface as port_interface
from dyffusion_tpu_torch import train
from dyffusion_tpu_torch.data import base as port_base
from dyffusion_tpu_torch.data import native_loader
from dyffusion_tpu_torch.data import oisstv2 as port_oisst
from dyffusion_tpu_torch.data.native_loader import DeviceStager, PrefetchIterator, gather_batch, native_available
from dyffusion_tpu_torch.models import unet_state_dict_from_jax
from dyffusion_tpu_torch.serving import build_predict_fn
from dyffusion_tpu_torch.utils import registry_api
from dyffusion_tpu_torch.utils import rng as port_rng
from dyffusion_tpu_torch.utils.naming import get_run_id
from tests._torch_port_helpers import nhwc_to_nchw, to_numpy_tree
from tests._torch_port_helpers import torch_threads_share_of_cores  # noqa: F401 (autouse fixture)
from tests.test_torch_port_train import assert_grads_match

BOXES = (84, 85, 86)


@pytest.fixture(scope="module")
def oisst_root(tmp_path_factory):
    """Boxes written by the JAX package's writer; the port's writer must
    write the same files (checked below)."""
    root = str(tmp_path_factory.mktemp("oisst"))
    return jax_oisst.write_fake_oisst_dir(root, boxes=BOXES, n_days_per_year=20)


def _pair(root, **kw):
    """(JAX datamodule, port datamodule) with the same arguments."""
    return jax_oisst.OISSTv2DataModule(data_dir=root, **kw), port_oisst.OISSTv2DataModule(data_dir=root, **kw)


# ---------------------------------------------------------------------------
# the datamodule, against the JAX package's
# ---------------------------------------------------------------------------
def test_writer_writes_the_jax_packages_boxes(oisst_root, tmp_path):
    port_dir = port_oisst.write_fake_oisst_dir(str(tmp_path), boxes=BOXES, n_days_per_year=20)
    for b in BOXES:
        name = f"subregion-60x60boxes-pixelwise_stats/sst.day.mean.box{b}.npz"
        want, got = np.load(f"{oisst_root}/{name}"), np.load(f"{port_dir}/{name}")
        assert sorted(got.files) == sorted(want.files) == ["sst", "time"]
        for k in want.files:
            assert got[k].dtype == want[k].dtype
            np.testing.assert_array_equal(got[k], want[k])


SPLIT_CASES = {
    "boxes": dict(boxes=[84, 85], horizon=5),
    "all_boxes": dict(boxes="all", horizon=3, window=2),
    "validation_boxes": dict(boxes=[84, 85, 86], validation_boxes=[86], horizon=4),
    "train_start_year": dict(boxes=[85], train_start_date=2018, horizon=3),
    "train_start_date": dict(boxes=[85], train_start_date="2018-01-05", horizon=3),
    "prediction_horizon": dict(boxes=[84], horizon=3, prediction_horizon=6),
    "predict_slice": dict(boxes=[84], predict_boxes=[85, 86], predict_slice=("2020-01-03", "2020-01-17"),
                          horizon=3),
    "predict_all": dict(boxes=[84], predict_boxes="all", predict_slice=("2019-01-01", "2019-01-12"), horizon=2),
}


@pytest.mark.parametrize("case", sorted(SPLIT_CASES))
def test_splits_equal_jax(oisst_root, case):
    """Every split's arrays, exactly, and the datamodule's descriptors (the
    predict split where the case sets a slice inside the written days)."""
    jdm, pdm = _pair(oisst_root, **SPLIT_CASES[case])
    jdm.setup()
    pdm.setup()
    splits = ("train", "val", "test") + (("predict",) if "predict_slice" in SPLIT_CASES[case] else ())
    for split in splits:
        want, got = jdm.split(split).tensors, pdm.split(split).tensors
        assert sorted(got) == sorted(want) == ["dynamics"]
        assert got["dynamics"].dtype == want["dynamics"].dtype == np.float32
        np.testing.assert_array_equal(got["dynamics"], want["dynamics"], err_msg=split)
        assert len(pdm.split(split)) > 0
    assert pdm.dims == jdm.dims
    assert pdm.dataset_identifier == jdm.dataset_identifier
    assert pdm._resolve_boxes(pdm.boxes) == jdm._resolve_boxes(jdm.boxes)
    for split in ("train", "val", "test", "predict"):
        assert pdm._boxes_for(split) == jdm._boxes_for(split)
        assert pdm.get_horizon(split) == jdm.get_horizon(split)
    for split in splits[1:]:
        which = f"{split}_batches"
        for want, got in zip(getattr(jdm, which)(), getattr(pdm, which)(), strict=True):
            np.testing.assert_array_equal(got["dynamics"], want["dynamics"])


def test_pacific_names_and_missing_boxes(oisst_root, tmp_path):
    assert port_oisst.PACIFIC_BOXES == jax_oisst.PACIFIC_BOXES
    for boxes in (port_oisst.PACIFIC_BOXES, [84, 86]):
        assert port_oisst.get_name_for_boxes(boxes) == jax_oisst.get_name_for_boxes(boxes)
    pdm = port_oisst.OISSTv2DataModule(data_dir=str(tmp_path), boxes="all")
    with pytest.raises(FileNotFoundError):
        pdm.setup("train")
    with pytest.raises(ValueError, match="Invalid train_start_date"):
        port_oisst.OISSTv2DataModule(data_dir=oisst_root, train_start_date=1970)
    short = port_oisst.OISSTv2DataModule(data_dir=oisst_root, boxes=[84], horizon=25)
    with pytest.raises(ValueError, match="days < window"):
        short.setup("train")


def test_numpy_cache_round_trip_equals_jax(oisst_root):
    """The npz cache is written, read back equal, and named as the JAX
    package names it (the same file serves both)."""
    kw = dict(boxes=[84], horizon=3, save_and_load_as_numpy=True)
    jdm, pdm = _pair(oisst_root, **kw)
    pdm.setup()
    first = pdm.split("train").tensors["dynamics"].copy()
    cache = pdm._numpy_cache_file("train")
    assert cache.exists() and cache == jdm._numpy_cache_file("train")
    _, again = _pair(oisst_root, **kw)
    again.setup()
    np.testing.assert_array_equal(again.split("train").tensors["dynamics"], first)
    assert pdm._numpy_cache_file("predict") is None


def test_numpy_cache_name_changes_with_every_build_input(oisst_root):
    base = dict(boxes=[84, 85], horizon=3, save_and_load_as_numpy=True)
    _, dm = _pair(oisst_root, **base)
    variants = [
        ("test", dict(base, prediction_horizon=5)),
        ("train", dict(base, window=2)),
        ("train", dict(base, train_start_date=2018)),
        ("val", dict(base, validation_boxes=[84])),
        ("train", dict(base, boxes=[84])),
    ]
    for split, kw in variants:
        jother, other = _pair(oisst_root, **kw)
        assert dm._numpy_cache_file(split) != other._numpy_cache_file(split), (split, kw)
        assert other._numpy_cache_file(split) == jother._numpy_cache_file(split)
    _, same = _pair(oisst_root, **base)
    for split in ("train", "val", "test"):
        assert dm._numpy_cache_file(split) == same._numpy_cache_file(split)


@pytest.mark.parametrize("name", ["oisstv2", "navier-stokes", "spring-mesh"])
def test_dims_of_dataset_equal_jax(name):
    for cfg in (None, {"spatial_shape": (30, 30)}):
        assert port_base.get_dims_of_dataset(name, cfg) == jax_base.get_dims_of_dataset(name, cfg)
    with pytest.raises(ValueError, match="Unknown dataset"):
        port_base.get_dims_of_dataset("oisst")


def test_get_datamodule_builds_oisst(oisst_root):
    cfg = port_config.get_config("oisst_pacific_dyffusion", [f"datamodule.data_dir={oisst_root}",
                                                             "datamodule.boxes=[84,85]"])
    pdm = port_interface.get_datamodule(cfg)
    jdm = jax_interface.get_datamodule(jax_config.get_config(
        "oisst_pacific_dyffusion", [f"datamodule.data_dir={oisst_root}", "datamodule.boxes=[84,85]"]))
    assert isinstance(pdm, port_oisst.OISSTv2DataModule)
    assert (pdm.batch_size, pdm.eval_batch_size, pdm.horizon, pdm.dims) == (64, 6, 7, jdm.dims)
    pdm.setup("val")
    jdm.setup("val")
    np.testing.assert_array_equal(pdm.split("val").tensors["dynamics"], jdm.split("val").tensors["dynamics"])


# ---------------------------------------------------------------------------
# the native batch gather and the prefetching loader
# ---------------------------------------------------------------------------
def test_native_gather_builds_and_matches_numpy():
    """This host has g++: the C++ gather is built (into build/native/, named
    by a hash) and runs."""
    assert native_available()
    assert "build/native/batch_gather-" in native_loader.build_log["path"]
    rng = np.random.default_rng(0)
    src = rng.normal(size=(50, 3, 4, 4)).astype(np.float32)
    idx = rng.integers(0, 50, size=17)
    np.testing.assert_array_equal(gather_batch(src, idx), src[idx])
    np.testing.assert_array_equal(gather_batch(src, idx, n_threads=1), src[idx])
    srcb = src > 0
    np.testing.assert_array_equal(gather_batch(srcb, idx), srcb[idx])


def test_gather_non_contiguous_takes_numpy():
    src = np.arange(120, dtype=np.float32).reshape(10, 12)[:, ::2]
    idx = np.array([1, 3, 5])
    np.testing.assert_array_equal(gather_batch(src, idx), src[idx])


def test_gather_negative_and_out_of_bounds_indices():
    src = np.random.default_rng(1).normal(size=(20, 5)).astype(np.float32)
    idx = np.array([-1, 0, -20, 19])
    np.testing.assert_array_equal(gather_batch(src, idx), src[idx])
    for bad in ([20], [-21]):
        with pytest.raises(IndexError):
            gather_batch(src, np.array(bad))


def test_gather_empty_indices():
    src = np.ones((4, 3), np.float32)
    out = gather_batch(src, np.array([], np.int64))
    assert out.shape == (0, 3) and out.dtype == np.float32
    assert gather_batch(src.astype(np.float64), np.array([], np.int64), out_dtype=np.float32).dtype == np.float32


def test_gather_fused_f64_to_f32():
    src = np.random.default_rng(2).normal(size=(30, 4, 4))
    idx = np.random.default_rng(3).integers(-30, 30, size=11)
    got = gather_batch(src, idx, out_dtype=np.float32)
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, src[idx].astype(np.float32))
    np.testing.assert_array_equal(gather_batch(src.astype(np.float32), idx, out_dtype=np.float32),
                                  src[idx].astype(np.float32))


def test_failed_build_raises(monkeypatch, tmp_path):
    """g++ present but failing: the load raises, it does not fall back."""
    bad = tmp_path / "bad.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(native_loader, "SOURCE", bad)
    monkeypatch.setattr(native_loader, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(native_loader, "_state", {"checked": False, "lib": None})
    monkeypatch.setattr(native_loader, "build_log", {})
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        native_available()
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):  # and again: no quiet fallback later
        gather_batch(np.ones((3, 2), np.float32), np.array([0]))


def test_without_gxx_the_numpy_path_runs_and_says_so(monkeypatch, capsys):
    monkeypatch.setattr(native_loader.shutil, "which", lambda name: None)
    monkeypatch.setattr(native_loader, "_state", {"checked": False, "lib": None})
    src = np.arange(24, dtype=np.float32).reshape(6, 4)
    assert not native_available()
    np.testing.assert_array_equal(gather_batch(src, np.array([5, 0])), src[[5, 0]])
    assert not native_available()
    assert capsys.readouterr().err.count("no g++") == 1


def test_prefetch_yields_every_batch():
    rng = np.random.default_rng(1)
    tensors = {"dynamics": rng.normal(size=(37, 2, 4, 4, 1)).astype(np.float32),
               "condition": rng.normal(size=(37, 4, 4, 1)).astype(np.float32)}
    batches = list(PrefetchIterator(tensors, batch_size=8, rng=np.random.default_rng(2)))
    assert len(batches) == 4 and all(b["dynamics"].shape == (8, 2, 4, 4, 1) for b in batches)
    seen = np.concatenate([b["dynamics"][:, 0, 0, 0, 0] for b in batches])
    assert len(np.unique(seen)) == 32
    kept = list(PrefetchIterator(tensors, batch_size=8, shuffle=False, drop_last=False))
    assert [len(b["condition"]) for b in kept] == [8, 8, 8, 8, 5]
    np.testing.assert_array_equal(np.concatenate([b["condition"] for b in kept]), tensors["condition"])


def test_prefetch_raises_a_worker_error():
    calls = {"n": 0}

    def bad_put(batch):
        calls["n"] += 1
        if calls["n"] == 2:
            raise RuntimeError("device OOM staging batch")
        return batch

    it = PrefetchIterator({"x": np.arange(40, dtype=np.float32).reshape(10, 4)}, batch_size=2, shuffle=False,
                          device_put=bad_put)
    with pytest.raises(RuntimeError, match="device OOM"):
        list(it)


def _loader_threads():
    return [t for t in threading.enumerate() if t.name == "PrefetchIterator"]


def test_prefetch_reaps_its_worker_on_an_early_break():
    tensors = {"x": np.arange(400, dtype=np.float32).reshape(100, 4)}
    for _ in range(5):
        for i, _batch in enumerate(PrefetchIterator(tensors, batch_size=2, shuffle=False)):
            if i == 1:
                break
    deadline = time.time() + 10.0
    while _loader_threads() and time.time() < deadline:
        time.sleep(0.05)
    assert not _loader_threads()


def test_fit_stops_the_loader_when_a_step_raises():
    """A train step that raises ends ``fit`` with its error, and the loader's
    worker is stopped and joined, not left waiting on its queue while the
    traceback keeps the loop's frame alive (it would be, were the iterator
    held in a local of ``fit``)."""
    overrides = ["datamodule.spatial=(8,8)", "datamodule.channels=1", "datamodule.horizon=2", "datamodule.n_traj=6",
                 "datamodule.n_time=8", "datamodule.batch_size=2", "model.dim=8", "model.dim_mults=(1,)"]
    trainer = port_interface.build_trainer(port_config.get_config("synthetic_interpolation", overrides), device="cpu")
    step, calls = trainer.train_step, []

    def failing_step(state, batch):
        calls.append(None)
        if len(calls) == 2:
            raise RuntimeError("step failed")
        return step(state, batch)

    trainer.train_step = failing_step
    with pytest.raises(RuntimeError, match="step failed") as err:
        trainer.fit()
    assert err.value.__traceback__ is not None  # the failing frame is still referenced here
    assert not _loader_threads()


def test_train_loader_gives_train_batches_bit_for_bit(oisst_root):
    """The same generator gives the same batches, in the same order, over
    consecutive epochs, through the loader (native gather, CPU staging) and
    through ``train_batches``."""
    _, dm = _pair(oisst_root, boxes=[84, 85, 86], horizon=3, batch_size=5)
    stager = DeviceStager("cpu")
    r_loader, r_host = np.random.default_rng(7), np.random.default_rng(7)
    for _epoch in range(3):
        got = list(dm.train_loader(rng=r_loader, device_put=stager))
        want = list(dm.train_batches(rng=r_host))
        assert len(got) == len(want) == len(dm.split("train")) // 5
        for g, w in zip(got, want):
            assert isinstance(g["dynamics"], torch.Tensor)
            np.testing.assert_array_equal(g["dynamics"].numpy(), w["dynamics"])


# ---------------------------------------------------------------------------
# the slice against the JAX package: losses, gradients, the folded val eval
# ---------------------------------------------------------------------------
def _tiny(root):
    return [
        f"datamodule.data_dir={root}", "datamodule.boxes=[84,85]", "datamodule.horizon=3",
        "datamodule.prediction_horizon=3", "datamodule.batch_size=2", "datamodule.eval_batch_size=2",
        "datamodule.validation_boxes=[86]", "model.dim=8", "model.dim_mults=(1,2)", "model.attn_heads=1",
        "model.attn_dim_head=8", "model.block_dropout=0.0", "model.block_dropout1=0.0", "model.attn_dropout=0.0",
        "module.num_predictions=2", "diffusion.additional_interpolation_steps=1",
    ]


def _shared_normal(shape, channels_first=False):
    """The same N(0, 1) draw for every call of one logical shape (B, H, W,
    C): what both packages' data+noise conditioning receives below."""
    shape = tuple(shape)
    nhwc = (shape[0], shape[2], shape[3], shape[1]) if channels_first else shape
    x = np.random.default_rng(abs(hash(nhwc)) % 2**32).standard_normal(nhwc).astype(np.float32)
    return np.ascontiguousarray(np.transpose(x, (0, 3, 1, 2))) if channels_first else x


@pytest.fixture
def shared_noise(monkeypatch):
    """Both packages' ``forward_conditioning=data+noise`` draws replaced by
    :func:`_shared_normal` (the JAX sampler's scan draws once per trace; a
    draw that depends on the shape alone makes that the same as a draw per
    step). Nothing else on these paths draws normals: dropout is off."""
    monkeypatch.setattr(jax.random, "normal",
                        lambda key, shape, dtype=jnp.float32: jnp.asarray(_shared_normal(shape), dtype))
    monkeypatch.setattr(port_rng, "randn", lambda shape, generator, device, dtype=None: torch.from_numpy(
        _shared_normal(shape, channels_first=True)).to(device=device, dtype=dtype or torch.float32))


@pytest.fixture(scope="module")
def oisst_slice(oisst_root):
    """Both stages of the OISST presets, tiny, on both packages from the
    same configs, the port's weights converted from the JAX ones."""
    out = {}
    j_ip = p_ip = None
    for stage, preset in ((1, "oisst_pacific_interpolation"), (2, "oisst_pacific_dyffusion")):
        jc, pc = jax_config.get_config(preset, _tiny(oisst_root)), port_config.get_config(preset, _tiny(oisst_root))
        assert pc == jc
        jdm, pdm = jax_interface.get_datamodule(jc), port_interface.get_datamodule(pc)
        jdm.setup()
        pdm.setup()
        jexp, jmodel, jvars, _, jeval, jeng = jax_interface.build_experiment(jc, jdm, interpolator=j_ip)
        jvars = to_numpy_tree(jvars)
        pexp, pmodel, ploss, peval, peng = port_interface.build_experiment(pc, pdm, interpolator=p_ip, device="cpu")
        pmodel.load_state_dict(unet_state_dict_from_jax(jvars))
        out[stage] = dict(jexp=jexp, jmodel=jmodel, jvars=jvars, jeval=jeval, jeng=jeng, pexp=pexp,
                          pmodel=pmodel, ploss=ploss, peval=peval, peng=peng,
                          batch=next(pdm.val_batches()), train=next(pdm.train_batches(np.random.default_rng(0))))
        j_ip, p_ip = (make_apply_fn(jmodel), jvars), pmodel
    s = out[2]
    dyn = s["train"]["dynamics"]

    @jax.jit
    def value_and_grad(fv, t):  # one compile for every t of the stage-2 case
        def f(v):
            return s["jeng"].p_losses(v, out[1]["jvars"], jax.random.key(0), dyn[:, -1], dyn[:, 0], t)
        return jax.value_and_grad(f, has_aux=True)(fv)

    s["jax_value_and_grad"] = value_and_grad
    return out


def test_oisst_stage1_loss_matches_jax(oisst_slice):
    """The port's stage-1 loss at the i it draws, against the JAX apply +
    criterion at that i, on an OISST train batch."""
    s = oisst_slice[1]
    dyn = s["train"]["dynamics"]
    i = torch.randint(1, 3, (dyn.shape[0],), generator=torch.Generator().manual_seed(5)).numpy()
    jexp, apply = s["jexp"], make_apply_fn(s["jmodel"])

    def f(v):
        targets = jnp.asarray(dyn)[jnp.arange(dyn.shape[0]), i]
        return jexp.criterion(apply(v, jexp.get_inputs(jnp.asarray(dyn)), jnp.asarray(i, jnp.float32), None, None),
                              targets)

    want = float(jax.jit(f)(s["jvars"]))
    with torch.no_grad():
        loss, _ = s["ploss"](None, s["train"], torch.Generator().manual_seed(5))
    np.testing.assert_allclose(float(loss), want, rtol=1e-5)


@pytest.mark.parametrize("t", [0, 2], ids=["t0", "tmid"])
def test_oisst_stage2_loss_and_forecaster_grads_match_jax(oisst_slice, shared_noise, t):
    """``p_losses`` of the OISST stage 2 (data+noise conditioning, k=1) at a
    fixed t on a train batch: the loss terms within 1e-5 and every
    forecaster gradient within 1e-4 of the larger of its own and a tenth of
    the model's largest (``assert_grads_match``)."""
    s = oisst_slice[2]
    dyn = s["train"]["dynamics"]
    x_last, cond = dyn[:, -1], dyn[:, 0]
    t_arr = np.full((dyn.shape[0],), t, np.int32)
    (want_loss, want_aux), want_grads = s["jax_value_and_grad"](s["jvars"], t_arr)
    s["pmodel"].zero_grad()
    loss, aux = s["peng"].p_losses(None, None, None, nhwc_to_nchw(x_last), nhwc_to_nchw(cond), torch.from_numpy(t_arr))
    loss.backward()
    for k in ("loss", "loss_forward", "loss_forward2"):
        np.testing.assert_allclose(float(aux[k].detach()), float(want_aux[k]), rtol=1e-5, atol=1e-7, err_msg=k)
    assert float(aux["loss_forward2"].detach()) > 0
    assert_grads_match({k: v.grad for k, v in s["pmodel"].named_parameters()},
                       unet_state_dict_from_jax(to_numpy_tree(want_grads)))


def test_oisst_folded_val_eval_matches_jax(oisst_slice, shared_noise):
    """The folded f32 val eval of one OISST batch (the cold sampler over 2
    members, data+noise conditioning): every horizon's ensemble and targets
    within 1e-4 of max|JAX|."""
    s = oisst_slice[2]
    want = jax.jit(s["jeval"]["val"])(s["jvars"], s["batch"], jax.random.key(0))
    got = s["peval"]["val"](s["batch"], torch.Generator().manual_seed(0))
    assert sorted(got) == sorted(want) == sorted(f"t{i}_{k}" for i in (1, 2, 3) for k in ("preds", "targets"))
    for k in want:
        w = np.asarray(want[k])
        assert tuple(got[k].shape) == w.shape, k
        np.testing.assert_allclose(got[k].numpy(), w, atol=1e-4 * float(np.abs(w).max()), rtol=0, err_msg=k)


# ---------------------------------------------------------------------------
# the CLI: both stages by run id, perf=measured, mode=test, serving by run id
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def oisst_cli(tmp_path_factory):
    """Stage 1 and stage 2 (by run id) of the OISST presets with
    ``perf=measured`` through ``train.main``, then ``mode=test``."""
    root = str(tmp_path_factory.mktemp("cli_oisst"))
    data = port_oisst.write_fake_oisst_dir(root, boxes=(84, 85), n_days_per_year=6)
    reg = f"{root}/registry"
    common = [
        f"datamodule.data_dir={data}", "datamodule.boxes=[84,85]", "datamodule.horizon=3",
        "datamodule.prediction_horizon=3", "datamodule.batch_size=1", "datamodule.eval_batch_size=2",
        "datamodule.validation_boxes=[84]", "datamodule.predict_slice=('2020-01-01','2020-01-06')", "model.dim=8",
        "model.dim_mults=(1,2)", "model.attn_heads=1", "model.attn_dim_head=8", "module.num_predictions=2",
        "module.num_predictions_test=3", "trainer.max_epochs=1", "trainer.log_every_n_steps=1", f"registry_dir={reg}",
    ]
    c1 = ["experiment=oisst_pacific_interpolation", *common]
    id1 = get_run_id(port_config.get_config("oisst_pacific_interpolation", c1[1:]))
    c2 = ["experiment=oisst_pacific_dyffusion", *common, f"diffusion.interpolator_run_id={id1}",
          "diffusion.additional_interpolation_steps=1"]
    id2 = get_run_id(port_config.get_config("oisst_pacific_dyffusion", c2[1:]))
    # perf=measured keeps the effective batch: stage 1 folds its 4 micro-batches
    # of 1; stage 2 halves the accumulation, so its batch doubles (as 64 -> 128)
    m1, m2 = c1 + ["perf=measured"], c2 + ["perf=measured", "datamodule.batch_size=2"]
    best1 = train.main(m1, device="cpu")
    best2 = train.main(m2, device="cpu")
    test_crps = train.main(["mode=test", f"run_id={id2}", f"registry_dir={reg}"], device="cpu")
    return dict(reg=reg, c1=c1, c2=c2, m1=m1, m2=m2, id1=id1, id2=id2, best1=best1, best2=best2, test_crps=test_crps)


def test_oisst_cli_run_ids_equal_jax_and_parity(oisst_cli):
    """The measured runs' configs and run ids are the JAX package's, and
    their run ids are the parity layout's."""
    c = oisst_cli
    for parity, measured, run_id in ((c["c1"], c["m1"], c["id1"]), (c["c2"], c["m2"], c["id2"])):
        preset = parity[0].split("=")[1]
        want = jax_config.get_config(preset, measured[1:])
        got = port_config.get_config(preset, measured[1:])
        assert got == want and want["perf"] == "measured"
        assert get_run_id(got) == jax_naming.get_run_id(want) == run_id
        assert run_id == jax_naming.get_run_id(jax_config.get_config(preset, parity[1:]))
        assert registry_api.get_run_config(c["reg"], run_id) == json.loads(json.dumps(got))  # tuples as lists


def test_oisst_cli_trains_the_measured_layouts(oisst_cli):
    """Stage 1 folded (B1 x 4 as one batch of 4: steps logged in fours, one
    optimizer step each), stage 2 as B2 x accumulate 2 with remat (steps
    logged one by one); finite scores."""
    c = oisst_cli
    assert all(np.isfinite(c[k]) for k in ("best1", "best2", "test_crps"))
    steps1 = [r["step"] for r in registry_api.get_run_metrics(c["reg"], c["id1"]) if "train/loss" in r]
    steps2 = [r["step"] for r in registry_api.get_run_metrics(c["reg"], c["id2"]) if "train/loss" in r]
    # 2 boxes x (6 - 4 + 1) = 6 train rows: one folded batch of 4; three batches of 2
    assert steps1 == [4] and steps2 == [1, 2, 3]
    assert all("grads/" not in k for r in registry_api.get_run_metrics(c["reg"], c["id2"]) for k in r)
    t1 = port_interface.reload_trainer(c["reg"], c["id1"], device="cpu")
    t2 = port_interface.reload_trainer(c["reg"], c["id2"], device="cpu")
    assert (t1.datamodule.batch_size, t1.state.fold_factor, t1.state.optimizer.accumulate_grad_batches) == (4, 4, 1)
    assert (t2.datamodule.batch_size, t2.state.fold_factor, t2.state.optimizer.accumulate_grad_batches) == (2, 1, 2)
    assert t2.experiment.model.remat and not t1.experiment.model.remat
    assert t2.state.step == 3 and t1.state.step == 4


def test_oisst_cli_test_mode_and_serving_by_run_id(oisst_cli):
    c = oisst_cli
    assert {"test_crps.npz", "test_crps.json"} <= set(os.listdir(os.path.join(c["reg"], c["id2"], "curves")))
    predict, specs, info = build_predict_fn(c["reg"], c["id2"], device="cpu")
    trainer = port_interface.reload_trainer(c["reg"], c["id2"], device="cpu")
    batch = next(trainer.datamodule.predict_batches())
    a, b, other = predict(batch, 0), predict(batch, 0), predict(batch, 1)
    assert tuple(a.shape) == (2, 2, 3, 60, 60, 1) and info["ensemble_members"] == 2
    assert bool(torch.isfinite(a).all()) and torch.equal(a, b) and not torch.equal(a, other)
    assert float(a.std(dim=0).mean()) > 0  # the members differ
