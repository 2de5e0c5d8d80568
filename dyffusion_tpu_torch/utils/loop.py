"""A sampler's loop: a Python loop when run, one loop op when exported.

Counterpart of the JAX package's ``lax.scan`` over a sampler's precomputed
steps. :func:`loop` runs ``carry = step(carry, x_j, consts)`` for each
step j. Run eagerly it is a Python loop. While ``torch.export`` traces
(``torch.compiler.is_exporting()``), it is one ``while_loop`` op whose
body is ``step`` traced once, so an exported sampler holds one loop body
whatever its number of steps (an unrolled 1000-step DDPM would hold a
thousand network forwards). Both paths call the same ``step`` on the same
values, in the same order, so they draw the same random numbers and give
the same answer bit for bit.

The per-step values ``xs`` are f32 or int64 vectors on the CPU, one entry
per step, built on the host from the values eager evaluation used to turn
into Python floats. The step gets ``x_j`` as 0-dim CPU tensors. In an
elementwise op with a device tensor such a tensor is a scalar, as a Python
float is: the kernel takes its value as an argument, with no copy to the
device and no wait for it. The loop's counter stays on the CPU for the
same reason: the loop's test reads it with no wait for the device.

``while_loop`` and not ``scan``: torch 2.11's ``scan`` calls its body one
extra time to learn the output shapes, which would draw an extra set of
random numbers and launch every kernel once more per loop.
"""
from __future__ import annotations

import contextlib
from typing import Any, Callable, Dict, Mapping, Sequence, Tuple

import torch
from torch import nn
from torch.utils import _pytree as pytree

from dyffusion_tpu_torch.utils import rng

Carry = Tuple[torch.Tensor, ...]


def loop(
    step: Callable[[Carry, Dict[str, torch.Tensor], Any], Sequence[torch.Tensor]],
    carry: Sequence[torch.Tensor],
    xs: Mapping[str, torch.Tensor],
    consts: Any = None,
    modules: Sequence[nn.Module] = (),
) -> Carry:
    """``carry = step(carry, x_j, consts)`` for j = 0 .. n-1; returns the
    last carry (a tuple of tensors, whose shapes and dtypes ``step`` keeps).

    ``xs``: name -> (n,) CPU tensor; ``x_j`` maps each name to entry j, a
    0-dim tensor. ``consts``: a pytree (tuples, lists, dicts, None) of the
    tensors ``step`` reads besides the carry, handed to it as they are.
    ``modules``: the networks ``step`` calls; exported, their parameters
    and buffers are inputs of the loop op, as are the rows of a
    data-parallel replica (``utils.rng.replica_rows``). A tensor ``step``
    reads that is in none of these would be baked into the loop body as a
    constant, and the artifact would not save."""
    n = {int(v.shape[0]) for v in xs.values()}
    if len(n) != 1:
        raise ValueError(f"every per-step vector needs the same length, got {sorted(n)}")
    n = n.pop()
    if not torch.compiler.is_exporting():
        carry = tuple(carry)
        for j in range(n):
            carry = tuple(step(carry, {k: v[j] for k, v in xs.items()}, consts))
        return carry
    return _while_loop(step, tuple(carry), dict(xs), n, consts, modules)


def _while_loop(step, carry: Carry, xs: Dict[str, torch.Tensor], n: int, consts, modules) -> Carry:
    from torch._higher_order_ops.while_loop import while_loop_op
    from torch.nn.utils.stateless import _reparametrize_module

    names = list(xs)
    leaves, spec = pytree.tree_flatten(consts)
    const_at = [i for i, v in enumerate(leaves) if isinstance(v, torch.Tensor)]
    weights = [list(dict(m.named_parameters(remove_duplicate=False)).items())
               + list(dict(m.named_buffers(remove_duplicate=False)).items()) for m in modules]
    # each tensor once: the tracer merges the inputs it is given twice
    extra: list = []
    slot: Dict[int, int] = {}

    def place(t: torch.Tensor) -> int:
        if id(t) not in slot:
            slot[id(t)] = len(extra)
            extra.append(t)
        return slot[id(t)]

    xs_at = [place(xs[k]) for k in names]
    const_slots = [place(leaves[i]) for i in const_at]
    weight_slots = [[(name, place(t)) for name, t in w] for w in weights]
    # a data-parallel replica's rows, which every draw of the body reads
    replica = rng.replica_state()
    replica_slot = None if replica is None else place(replica[1])
    nc = len(carry)

    def cond(j, *rest):
        return j < n

    def body(j, *rest):
        state, inputs = rest[:nc], rest[nc:]
        x_j = {k: inputs[s].index_select(0, j.reshape(1)).reshape(()) for k, s in zip(names, xs_at)}
        vals = list(leaves)
        for i, s in zip(const_at, const_slots):
            vals[i] = inputs[s]
        with contextlib.ExitStack() as stack:
            if replica is not None:
                stack.enter_context(rng.replica_rows(replica[0], inputs[replica_slot]))
            for m, ws in zip(modules, weight_slots):
                stack.enter_context(_reparametrize_module(m, {name: inputs[s] for name, s in ws}))
            out = tuple(step(tuple(state), x_j, pytree.tree_unflatten(vals, spec)))
        # the loop op's outputs may not be its inputs
        seen = {id(t) for t in (*state, *inputs)}
        return (j + 1, *(o.clone() if id(o) in seen else o for o in out))

    # the carry's own copies, contiguous: the loop's carry keeps one layout
    init = [c.clone(memory_format=torch.contiguous_format) for c in carry]
    out = while_loop_op(cond, body, (torch.zeros((), dtype=torch.int64), *init), tuple(extra))
    return tuple(out[1:])
