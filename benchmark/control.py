#!/usr/bin/env python3
"""Readings that set a cell's limits, at the cell's own size (on the chip):

    python3 benchmark/control.py --workload sst-serve --seeds 1,2,3 [--port-seeds 4,5,...]

For each seed of ``--port-seeds``: the system's answer (a served request,
or the checked training steps) against the reference, as a run reads it
(the lower reading); with ``--look``, a training cell's leaves of the
largest gaps as well. For each seed of ``--seeds``: the control, the
reference computed with fp8 (e4m3) conv and matmul operands, the nearest
precision below the configuration's bfloat16, against the reference (the
upper reading). One JSON line per reading. Serving cells build the system
once and read every port seed in that process.
"""
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from benchmark import harness, inputs, system  # noqa: E402
from benchmark.reference import compare  # noqa: E402
from benchmark.reference import model as ref_model  # noqa: E402


def _seeds(s):
    return [int(x) for x in s.split(",") if x]


def serve(cell, seeds, port_seeds, device):
    conf, tr = cell.config, cell.traffic
    ref = conf["reference"]
    members = int(tr.get("members", 20))
    mode = cell.mode()
    if port_seeds:
        run = harness.Run(cell, port_seeds[0], device)
        sess = mode.Session(cell, run)
        members = sess.members
        for s in port_seeds:
            run.seed = s
            batch = inputs.make_batches(conf["data"], inputs.generator(s, device, "batches"), 1, int(tr["rows"]),
                                        ref.get("window", 1), tuple(conf["grid"]), ref["channels"], device)[0]
            w = {net: inputs.make_weights(spec, s, device, net) for net, spec in ref_model.param_specs(ref).items()}
            sess.exp.model.load_state_dict(w["forecaster"])
            sess.exp.engine.interpolator.load_state_dict(w["interpolator"])
            out = sess.predict(batch, system.request_seed(s, 0))
            system.reference_numerics()
            numbers = mode.judge(ref, w, batch, system.request_seed(s, 0), members, out)
            print(json.dumps({"reading": "port", "seed": s, **numbers}), flush=True)
            del out
    for s in seeds:
        system.reference_numerics()
        batch = inputs.make_batches(conf["data"], inputs.generator(s, device, "batches"), 1, int(tr["rows"]),
                                    ref.get("window", 1), tuple(conf["grid"]), ref["channels"], device)[0]
        w = {net: inputs.make_weights(spec, s, device, net) for net, spec in ref_model.param_specs(ref).items()}
        numbers = mode.judge(ref, w, batch, system.request_seed(s, 0), members, None, fp8=True)
        print(json.dumps({"reading": "control", "seed": s, **numbers}), flush=True)


def train(cell, seeds, port_seeds, device, look=False):
    conf, tr = cell.config, cell.traffic
    ref = conf["reference"]
    for s in port_seeds:
        run = harness.Run(cell, s, device)
        sess = cell.mode().Session(cell, run)
        grads, change = sess.grads, sess.change
        numbers, _ = sess.check()
        print(json.dumps({"reading": "port", "seed": s, **numbers}), flush=True)
        if look:
            want = ref_model.train(ref, {net: inputs.make_weights(spec, s, device, net) for net, spec in
                                         ref_model.param_specs(ref).items()},
                                   sess.pool[: int(tr["checked_steps"]) * sess.acc], sess.step_seed,
                                   int(tr["checked_steps"]), sess.acc)
            print(json.dumps({"look": "worst leaves", "seed": s,
                              "grad": compare.worst_leaves(grads, want["grads"], list(want["grads"])),
                              "update": compare.worst_leaves(change, want["change"], list(want["change"]))}),
                  flush=True)
        del sess
        system.free_device_memory()
    for s in seeds:
        system.reference_numerics()
        g = inputs.generator(s, device, "batches")
        acc = int(ref.get("accumulate", 1))
        batches = inputs.make_batches(conf["data"], g, int(tr["pool"]), int(tr["rows"]),
                                      ref.get("window", 1) + ref["horizon"], tuple(conf["grid"]), ref["channels"],
                                      device)[: int(tr["checked_steps"]) * acc]
        w = {net: inputs.make_weights(spec, s, device, net) for net, spec in ref_model.param_specs(ref).items()}
        step_seed = inputs.sub_seed(s, "steps")
        want = ref_model.train(ref, w, batches, step_seed, int(tr["checked_steps"]), acc)
        got = ref_model.train(ref, w, batches, step_seed, int(tr["checked_steps"]), acc, fp8=True)
        numbers = compare.train_numbers(got["losses"], want["losses"], got["grads"], want["grads"], got["change"],
                                        want["change"])
        print(json.dumps({"reading": "control", "seed": s, **numbers}), flush=True)


def main(argv):
    import argparse

    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", default="")
    p.add_argument("--port-seeds", default="")
    p.add_argument("--device", default="cuda")
    p.add_argument("--look", action="store_true", help="training: also print the leaves with the largest gaps")
    a = p.parse_args(argv)
    cell = harness.Cell(a.workload)
    if cell.traffic["mode"] == "serve":
        serve(cell, _seeds(a.seeds), _seeds(a.port_seeds), a.device)
    else:
        train(cell, _seeds(a.seeds), _seeds(a.port_seeds), a.device, a.look)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
