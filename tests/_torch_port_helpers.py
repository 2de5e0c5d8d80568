"""Shared helpers of the tests that hold dyffusion_tpu_torch against dyffusion_tpu.

Inputs are made with numpy from a seed and handed to both packages; the port
works in NCHW, the JAX package in NHWC.
"""
import os

import jax
import numpy as np
import pytest
import torch


def nhwc_to_nchw(x: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(np.transpose(x, (0, 3, 1, 2))))


def nchw_to_nhwc(x: torch.Tensor) -> np.ndarray:
    return x.detach().float().permute(0, 2, 3, 1).numpy()


def to_numpy_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def holder(module: torch.nn.Module) -> torch.nn.Module:
    """Wrap ``module`` as attribute ``m`` so converter prefixes apply."""
    h = torch.nn.Module()
    h.m = module
    return h


@pytest.fixture(autouse=True, scope="module")
def torch_threads_share_of_cores():
    """Give torch this pytest-xdist worker's share of the cores for a test
    module (import it into the module to apply it). N workers each running
    torch's default pool of one thread per core oversubscribe the machine,
    and torch's CPU kernels then slow down many-fold (one port test took
    421 s under 6 workers on 8 cores, 8 s alone)."""
    workers = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))
    before = torch.get_num_threads()
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // workers))
    yield
    torch.set_num_threads(before)
