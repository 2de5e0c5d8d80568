"""The work counters against hand counts at tiny shapes."""
import copy

from benchmark.reference import model as ref_model
from benchmark.tests.tiny import tiny_config


def test_b1_bytes_of_a_request_by_hand():
    ref = tiny_config()["reference"]  # 16x16 grid, mults (1, 2): attention at 256 and 64 tokens, twice each
    rows, members = 2, 3
    R = rows * members
    steps = ref["horizon"] + ref["k"] - 1  # the loop's steps; one more forecaster call after it
    w = ref_model.flops_and_bytes(ref, "serve", rows, members, (16, 16))
    per_row = (256 + 64 + 64 + 256) * 512 * 4  # float32 in this configuration
    assert w["b1_bytes"] == (steps + 1) * R * per_row + steps * 2 * R * per_row
    assert w["resize_bytes"] == 0


def test_b1_bytes_of_a_train_step_by_hand():
    ref = tiny_config()["reference"]
    w = ref_model.flops_and_bytes(ref, "train", 4, 1, (16, 16), accumulate=2)
    per_row = (256 + 64 + 64 + 256) * 512 * 4
    # per micro-batch: the interpolator twice, the forecaster twice (forward only)
    assert w["b1_bytes"] == 2 * 4 * 4 * per_row


def test_resize_bytes_by_hand():
    ref = {"backbone": "unet_simple", "channels": 3, "window": 1, "static_channels": 2, "horizon": 2, "k": 0,
           "conditioning": "none", "refine": True, "boundary": "navier_stokes",
           "model": {n: {"dim": 4, "upsample_dims": [64, 64], "dropout": 0.0} for n in ("forecaster", "interpolator")},
           "low_eps": {"serve": [True, True], "train": [True, False]}}
    H, W = 20, 10
    w = ref_model.flops_and_bytes(ref, "serve", 1, 1, (H, W))
    # a forward: in (c, H, W) -> (c, 64, 64); decoders 1->2, ..., 32->64 at their widths; readout (3, 128, 128) -> (3, H, W)
    dec_in = [(32, 1), (64, 2), (64, 4), (32, 8), (16, 16), (16, 32)]  # (channels, side) at dim 4

    def forward(c_in):
        n = c_in * (H * W + 64 * 64) + 3 * (128 * 128 + H * W)
        return n + sum(c * s * s * 5 for c, s in dec_in)  # out = 4 x in, read once and written once

    # horizon 2, k 0: one loop step (forecaster + interpolator at 2 rows), the final forecaster, one refinement
    elems = 2 * forward(3 + 2) + 2 * forward(6 + 2) + forward(6 + 2)
    assert w["resize_bytes"] == elems * 2


def test_flops_count_every_forward_of_the_sampler():
    ref = copy.deepcopy(tiny_config()["reference"])
    one = ref_model.flops_and_bytes(ref, "serve", 2, 3, (16, 16))["flops"]
    ref["k"] += 1  # one more loop step: one more forecaster (6 rows) and interpolator (12 rows) forward
    two = ref_model.flops_and_bytes(ref, "serve", 2, 3, (16, 16))["flops"]
    ref_t = copy.deepcopy(tiny_config()["reference"])
    per_row = ref_model.flops_and_bytes(ref_t, "serve", 1, 1, (16, 16))
    assert two > one > 0 and per_row["flops"] > 0
    # linear in the rows
    assert ref_model.flops_and_bytes(ref_t, "serve", 2, 3, (16, 16))["flops"] == one
    assert abs(one - 6 * per_row["flops"]) <= 1e-9 * one
