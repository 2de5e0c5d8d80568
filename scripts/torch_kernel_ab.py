#!/usr/bin/env python3
"""Time the port's kernel phases of two checkouts on one GPU, in turns.

    python3 scripts/torch_kernel_ab.py PARENT_TREE [CHANGE_TREE] [--log-dir DIR]

Runs the device, build, B1 and B3 phases of ``chip_smoke.py`` in two
checkouts (PARENT_TREE, e.g. the parent commit unpacked with ``git archive``
into a directory that ``.gitignore`` lists, and CHANGE_TREE, by default this
checkout), one process each, in the order parent, change, change, parent,
then times the checkout's B2 (``ops.fused_act``) with CHANGE_TREE's
``chip_smoke.time_act`` (inputs rotated past L2, NCHW and channels-last).
Every process times with CHANGE_TREE's ``chip_smoke._time_ms``, so both trees
are timed the same way. Prints each B1, B3 and B2 time per shape, B1 per
request and per train step, for the four runs and the change's mean over the
parent's. ``--log-dir`` keeps each run's whole output there.
"""
from __future__ import annotations

import argparse
import os
import re
import subprocess
import sys
from pathlib import Path

RUN = """
import importlib.util, sys
spec = importlib.util.spec_from_file_location("ab_timer", {timer!r})
timer = importlib.util.module_from_spec(spec)
spec.loader.exec_module(timer)
import chip_smoke as c
c._time_ms = timer._time_ms
c.phase_device(); c.phase_build(); c.phase_kernel(); c.phase_kernel_core()
import torch
from dyffusion_tpu_torch.ops import fused_act
timer.time_act(fused_act, torch.Generator(device="cuda").manual_seed(c.SEED + 2))
"""
# what a [kernel-time] line times, and its kernel ms
LINE = re.compile(r"^\[kernel-time\] (.*?):? kernel ([0-9.]+) ms")


def run(tree: Path, timer: Path, log: Path | None) -> dict:
    env = dict(os.environ, PYTHONPATH=str(tree))
    proc = subprocess.run([sys.executable, "-c", RUN.format(timer=str(timer))], cwd=tree, env=env,
                          capture_output=True, text=True)
    out = proc.stdout + proc.stderr
    if log is not None:
        log.write_text(out)
    if proc.returncode != 0:
        raise SystemExit(f"{tree}: the kernel phases failed (exit {proc.returncode}):\n{out[-4000:]}")
    times = {}
    for line in proc.stdout.splitlines():
        m = LINE.match(line)
        if m:
            key = re.sub(r" \([0-9]+ calls.*", "", m.group(1)).replace(" nchw-view", "")
            times[key] = float(m.group(2))
    return times


def main(argv) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("parent", type=Path)
    ap.add_argument("change", type=Path, nargs="?", default=Path(__file__).resolve().parent.parent)
    ap.add_argument("--log-dir", type=Path)
    args = ap.parse_args(argv)
    parent, change = args.parent.resolve(), args.change.resolve()
    timer = change / "chip_smoke.py"
    runs = []
    for label, tree in (("parent1", parent), ("change1", change), ("change2", change), ("parent2", parent)):
        log = args.log_dir / f"ab_{label}.log" if args.log_dir else None
        runs.append(run(tree, timer, log))
        print(f"[ab] {label} done: {tree}", flush=True)
    print("[ab] what | parent 1 | change 1 | change 2 | parent 2 | change / parent (ms, mean of two runs each)")
    for key in runs[0]:
        if all(key in r for r in runs):
            t = [r[key] for r in runs]
            print(f"[ab] {key} | {t[0]:.4f} | {t[1]:.4f} | {t[2]:.4f} | {t[3]:.4f} | {(t[1] + t[2]) / (t[0] + t[3]):.3f}")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
