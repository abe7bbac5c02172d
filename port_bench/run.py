"""One run of one cell of ``BENCHMARK.json`` on the card.

    python -m port_bench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Set-up (from process start): the seeded weights on the card, the app of
the cell's configuration, the traffic's inputs, a warm-up over the
cell's own shapes. Then the measured window, then the judge: the frozen
reference recomputes what the program produced. The last line on
standard output is the result, with the numbers judged and their limits
under ``checks``; the same numbers are the last lines on standard error.
Exits 3 without a result where no card is visible, 4 where JAX or the
JAX package was loaded.

The architecture's steps come from the module that the configuration's
``architecture`` names (``cell["arch"]``, ``harness.manifest.load_arch``):
the weights, the output keys kept, the reference, the judge's numbers
and the FLOPs per frame. The harness's: the app, the driver and its
window, the trace, the rasterizer's and MANO kernel's work
(``_raster_work``, ``harness.work``), the verdict and the result line.
"""

import time

CLOCK0 = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

from port_bench.harness import manifest  # noqa: E402

# every build and kernel cache inside the checkout, at fixed paths
_CACHE = os.path.join(manifest.ROOT, "build", "port_bench")
os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(_CACHE, "torch_extensions")
os.environ["TRITON_CACHE_DIR"] = os.path.join(_CACHE, "triton")
os.environ["USE_FLAX"] = "0"

FORBIDDEN = ("jax", "jaxlib", "flax", "acr_tpu")


def loaded_forbidden():
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


class Run:
    """What a driver needs: the cell's traffic, the seed, the window, the
    app factory and the observations."""

    def __init__(self, cell, seed, seconds, trace, device, clock0,
                 overrides=None, app_hook=None):
        import torch
        from port_bench.harness.drivers import Obs
        self.cell, self.traffic, self.arch = cell, cell["traffic"], cell["arch"]
        self.seed, self.seconds, self.trace = seed, seconds, trace
        self.device, self.clock0 = torch.device(device), clock0
        self.obs = Obs()
        cfg = cell["config"]
        self.fields = dict(cfg["model"])
        self.fields.update(self.traffic["app"])
        self.fields.update(overrides or {})
        self.obs.precision = self.fields["model_precision"]
        dtype = torch.bfloat16 if self.obs.precision == "bf16" else torch.float32
        self.weights = self.arch.make_weights(seed, self.device, dtype,
                                              self.fields)
        self.app_hook = app_hook
        self.marks = []
        self.mark("weights")

    def mark(self, what: str) -> None:
        """A set-up step done: its time since process start, on stderr."""
        self.sync()
        t = time.perf_counter() - self.clock0
        self.marks.append((what, t))
        print(f"port_bench: set-up {what} done at {t:.2f} s", file=sys.stderr)

    def make_app(self):
        from acr_tpu_torch.config import Config
        from acr_tpu_torch.pipeline.app import ACRApp
        cfg = Config(configs_yml="", mano_model_path=os.path.join(
            manifest.ROOT, "model_data", "mano"), **self.fields)
        params = self.weights
        if cfg.quantize != "none":
            # the int8 path quantizes host copies of the float weights
            params = {k: v.float().cpu() for k, v in params.items()}
        app = ACRApp(cfg, params=params, device=str(self.device))
        if self.app_hook is not None:
            self.app_hook(app)
        return app

    def sync(self):
        import torch
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)


def run_cell(cell, seed, seconds, trace, device="cuda", clock0=None,
             overrides=None, app_hook=None, stash=None):
    """One run; returns the result dict (the last key ``checks``).
    ``overrides`` change fields of the app's config, ``app_hook(app)``
    runs on the app once it is built, and ``stash`` (a dict) receives the
    run, what it observed and the reference: the control's and the
    tests' ways in."""
    import torch
    from port_bench.harness import work
    from port_bench.harness.drivers import DRIVERS, say
    from port_bench.harness.judge import verdict
    run = Run(cell, seed, seconds, trace, device,
              time.perf_counter() if clock0 is None else clock0,
              overrides, app_hook)
    if run.device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(run.device)
    seen = DRIVERS[cell["traffic"]["driver"]](run)
    obs = run.obs
    dev = {"platform": "gpu" if run.device.type == "cuda" else "cpu",
           "kind": (torch.cuda.get_device_name(run.device)
                    if run.device.type == "cuda" else "cpu"),
           "count": 1,
           "memory_peak_bytes": (torch.cuda.max_memory_allocated(run.device)
                                 if run.device.type == "cuda" else 0)}
    forbidden = loaded_forbidden()
    if forbidden:
        return {"forbidden": forbidden}
    gc.collect()
    if run.device.type == "cuda":
        torch.cuda.empty_cache()

    f, arch = run.fields, run.arch
    ref = arch.Reference(run.weights, f, os.path.join(manifest.ROOT, "model_data", "mano"),
                         run.device)
    numbers = arch.new_numbers()
    pairs = []
    t_judge = time.perf_counter()
    for seq in seen["sequences"]:
        out = arch.judge_sequence(ref, seq["frames"], seq["outputs"], seq["judged"],
                                  seq["composites"], numbers, f)
        for t in seq["judged"][-4:]:
            pairs.append(_raster_work(out, t, ref.faces, f))
    n_judged = sum(len(s["judged"]) for s in seen["sequences"])
    say(f"judged {n_judged} frames in {time.perf_counter() - t_judge:.1f} s")
    limits = cell["config"]["limits"]
    correct, checks = verdict(numbers, limits, n_judged)
    peaks = work.PEAKS.get(dev["kind"])
    obs.peaks = peaks
    obs.work = {"flops_per_frame": arch.flops_per_frame(f)}
    if peaks is not None and pairs:
        obs.work["raster_bound_s"] = sum(
            work.bound_s(b, o, peaks) for b, o in pairs) / len(pairs)
        obs.work["mano_bound_s"] = work.bound_s(
            *work.mano_work(f.get("val_batch_size", 1)), peaks)
    result = {"correct": bool(correct), "attempted": int(seen["attempted"]),
              "failed": int(numbers["hands_wrong"]),
              "metrics": manifest.read_metrics(
                  cell["per_layer"] if trace else cell["end_to_end"], obs),
              "device": dev}
    if trace and obs.trace is not None:
        dev["busy_s"] = obs.trace["busy_s"]
        dev["window_s"] = obs.trace["window_s"]
        result["breakdown"] = {"device_ops": obs.trace["device_ops"],
                               "idle_gaps": obs.trace["idle_gaps"]}
    result["checks"] = {name: {"number": v, "limit": lim} for name, v, lim in checks}
    if stash is not None:
        stash.update(run=run, seen=seen, ref=ref)
    return result


def _raster_work(ref_out, t, faces, f):
    """B1's work on the reference's geometry of frame ``t``: it needs the
    reference's outputs ``verts`` and ``cam_trans`` and its ``.faces``,
    which every MANO-based architecture provides."""
    import numpy as np
    import torch
    from port_bench.harness import work
    size, focal = f["render_size"], float(f["focal_length"])
    tris = []
    for h in range(2):
        world = ref_out["verts"][t][h] + ref_out["cam_trans"][t][h]
        z = np.maximum(world[:, 2], 1e-4)
        uv = np.stack([focal * world[:, 0] / z, focal * world[:, 1] / z], -1) + size / 2
        tris.append(uv[faces[h]])
    n_faces = faces.shape[0] * faces.shape[1]
    return work.raster_work(torch.as_tensor(np.concatenate(tris)),
                            -(-n_faces // 128) * 128, size)


def host_state() -> str:
    """The host's load and the card's clocks, for the stderr record."""
    import subprocess
    try:
        load = open("/proc/loadavg").read().split()[:3]
    except OSError:
        load = ["?"]
    try:
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=clocks.sm,power.draw,power.limit,temperature.gpu",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        smi = "?"
    return f"load {' '.join(load)}; card {smi}"


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    import torch
    print(f"port_bench: torch imported at {time.perf_counter() - CLOCK0:.2f} s",
          file=sys.stderr)
    # the card's context before the architecture's module and what it
    # imports (cv2, the reference): the order the cells were measured in
    if torch.cuda.is_available():
        torch.zeros(1, device="cuda")
    cell = manifest.cell(manifest.load_manifest(), args.workload)
    need = cell["workload"]["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < need:
        print(f"port_bench: the cell needs {need} CUDA card(s); "
              f"torch.cuda.is_available() is {torch.cuda.is_available()}, "
              f"device_count {torch.cuda.device_count()}", file=sys.stderr)
        return 3
    print(f"port_bench: CUDA ready at {time.perf_counter() - CLOCK0:.2f} s; "
          f"{host_state()}", file=sys.stderr)
    result = run_cell(cell, args.seed, args.seconds, bool(args.trace),
                      "cuda", CLOCK0)
    if "forbidden" in result:
        print("port_bench: loaded after the window: "
              + ", ".join(result["forbidden"]), file=sys.stderr)
        return 4
    print(f"port_bench: after the run: {host_state()}", file=sys.stderr)
    for name, c in result["checks"].items():
        print(f"check {name} {c['number']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
