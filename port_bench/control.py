"""Readings that the limits of ``correct`` are set from (not run by the
benchmark's own runs).

    python -m port_bench.control --workload <cell> --seconds <s> --seeds <n> ...

For each seed, one run of the cell as the benchmark makes it (the sound
reading), then its control and the faults the cell can have, each
judged by the same judge against the same reference and the cell's
limits (``judge.verdict``):

- ``reduced``, the control: the reference put in the program's place
  over the frames that the sound run took, one precision below the
  configuration's fp32 with TF32 off: its network's products in TF32,
  and MANO, the camera, the translation and the render's screen
  positions in bf16;
- ``altered``: every answer's mesh moved by 0.1 mm where it is produced;
- ``frozen``: a step that leaves the OneEuro state as it found it;
- ``halved`` (cells whose steps take a batch): the second half of each
  chunk repeats the first.

One JSON line per seed: {"seed", "workload", "sound", "metrics",
"controls"}, with ``sound`` and each control as {"correct", "numbers"}.

The architecture's steps come from the cell's architecture module
(``harness.manifest.load_arch``): the control's reference, its outputs
in the program's shape (``as_outputs``) and the judge. The faults are
the harness's: they touch only the app's stream and chunk steps and the
mesh (``verts``) that every MANO-based architecture's outputs carry.
"""

import argparse
import json
import os
import sys

import numpy as np

from port_bench.harness import manifest

SHIFT_M = 1e-4


class Altered:
    """The pipeline with every answer's mesh moved where it is produced."""

    def __init__(self, inner, shift: float = SHIFT_M):
        self.inner, self.shift = inner, shift

    def __call__(self, *a, **k):
        out = self.inner(*a, **k)
        out["verts"] = out["verts"] + self.shift
        return out

    def refine(self, *a, **k):              # the mesh of ``-t``
        out = self.inner.refine(*a, **k)
        out["verts"] = out["verts"] + self.shift
        return out

    def __getattr__(self, name):
        return getattr(self.inner, name)


def altered(app):
    app.pipeline = Altered(app.pipeline)


def frozen(app):
    """Each step (one frame, or one chunk) leaves the OneEuro state as it
    found it."""
    for name in ("stream_step", "chunk_step"):
        step = getattr(app, name)

        def keep_state(*a, _step=step, **k):
            state = app.filter_state
            out = _step(*a, **k)
            app.filter_state = state
            return out
        setattr(app, name, keep_state)


def halved(app):
    """A chunk step whose second half of the chunk repeats the first."""
    step = app.chunk_step

    def half(image, offsets):
        n = len(image) // 2
        image = np.concatenate([image[:n], image[:n]])
        offsets = np.concatenate([offsets[:n], offsets[:n]])
        return step(image, offsets)
    app.chunk_step = half


def faults(cell):
    """The faults that a cell's timed path can have, by name."""
    out = {"altered": altered, "frozen": frozen}
    if cell["traffic"]["app"].get("val_batch_size", 1) > 1:
        out["halved"] = halved
    return out


def reduced_control(stash) -> dict:
    """The reference one precision down in the program's place: the
    numbers the judge gives it."""
    run, ref = stash["run"], stash["ref"]
    f, arch = run.fields, run.arch
    ctrl = arch.Reference(run.weights, f, os.path.join(manifest.ROOT, "model_data", "mano"),
                          run.device, tf32=True, tail_bf16=True)
    numbers = arch.new_numbers()
    for seq in stash["seen"]["sequences"]:
        out = ctrl.sequence(seq["frames"])
        outputs = [arch.as_outputs(out, t, f) for t in range(len(seq["frames"]))]
        drawn = {t: ctrl.composite(out, t, outputs[t], seq["frames"][t])
                 for t in seq["composites"]}
        arch.judge_sequence(ref, seq["frames"], outputs, seq["judged"], drawn,
                            numbers, f)
    return numbers


def judged(result) -> dict:
    return {"correct": result["correct"],
            "numbers": {k: v["number"] for k, v in result["checks"].items()}}


def readings(cell, seed, seconds, device="cuda") -> dict:
    """The sound run and every control of one seed, each judged."""
    from port_bench.harness.judge import verdict
    from port_bench.run import run_cell
    stash = {}
    sound = run_cell(cell, seed, seconds, False, device, stash=stash)
    numbers = reduced_control(stash)
    n_judged = sum(len(s["judged"]) for s in stash["seen"]["sequences"])
    stash.clear()
    correct, _ = verdict(numbers, cell["config"]["limits"], n_judged)
    controls = {"reduced": {"correct": correct, "numbers": {
        k: v for k, v in numbers.items() if k in cell["config"]["limits"]}}}
    for name, hook in faults(cell).items():
        controls[name] = judged(run_cell(cell, seed, seconds, False, device,
                                         app_hook=hook))
    return {"seed": seed, "workload": cell["workload"]["name"],
            "sound": judged(sound), "metrics": sound["metrics"],
            "controls": controls}


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    args = p.parse_args(argv)
    cell = manifest.cell(manifest.load_manifest(), args.workload)
    for seed in args.seeds:
        print(json.dumps(readings(cell, seed, args.seconds)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
