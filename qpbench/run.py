"""The benchmark of ``qpalette_tpu_torch`` on NVIDIA H100 cards.

  python -m qpbench.run --workload <cell> --seed <n> --seconds <s> \
      --trace <0|1>

run from the root of a checkout.  The cell is an entry of
``BENCHMARK.json``'s ``workloads``; it names a configuration (its file
under ``qpbench/configs/``) and a traffic mix
(``qpbench/traffic/<mix>.json``, whose ``kind`` names the window,
``qpbench/kinds/<kind>.py``).  Every metric is read by its own reader,
``qpbench/metrics/<name>.py`` (``read(rec, config) -> number or None``):
with ``--trace 0`` the cell's end-to-end metrics, with ``--trace 1`` its
per-layer metrics, after a traced slice of the run.  ``files.py`` says
what else is found by name.

Set-up (timed from the process's start: imports, the program's build of
its CUDA libraries where they are missing, the model from the seed's
draws, captures and warm-up) is ``setup_s``.  Then the window runs for
``--seconds``; then, with the program's state freed, the plain reference
judges what the window produced (``check.py``, limits in
``qpbench/limits/<cell>.json``).  The last line of standard output is one
JSON object; the numbers compared, each with its limit, are the last
lines of standard error and the last key of that object.

``--control 1`` (never in a benchmark's own runs) also reads, on the same
sample, each number with the control in the program's place: the
reference one precision step below the configuration's (``control`` in
its file); it is printed beside the program's, for the limits.

It exits non-zero without a result when no CUDA card is visible (or
fewer than the cell asks for), and when a JAX module (``jax``,
``jaxlib``, ``flax``, ``qpalette_tpu``) is loaded once the window has
closed.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "qpalette_tpu")


def cache_env(root: Path = ROOT) -> None:
    """Kernel and build caches at fixed paths inside the checkout."""
    cache = root / ".qpbench_cache"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ.setdefault("USE_FLAX", "0")


def cell_of(bench: dict, name: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise SystemExit(f"no workload {name!r} in BENCHMARK.json")


def load_config(bench: dict, name: str, root: Path = ROOT) -> dict:
    """A configuration file: the published config's keys (the sizes, as
    run) beside ``quantization``; -> {"model", "quantization", "root"
    (the checkout's ``qpbench`` folder, where files are found by
    name)}."""
    entry = next(c for c in bench["configs"] if c["name"] == name)
    data = json.loads((root / entry["file"]).read_text())
    return {"model": data, "quantization": data["quantization"],
            "root": root / "qpbench"}


def metrics_of(bench: dict, cell: dict, traced: bool) -> list:
    """The metric entries a run of cell reports."""
    e2e = [m for m in bench["end_to_end"]
           if cell["name"] in m.get("workloads", [cell["name"]])]
    if not traced:
        return e2e
    moved = {m["name"] for m in e2e}
    return [m for m in bench["per_layer"]
            if cell["name"] in m.get("workloads", [])
            or ("workloads" not in m and m["moves"] in moved)]


def jax_loaded() -> list:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def card_label() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True).stdout.strip()
    except (OSError, subprocess.CalledProcessError) as exc:
        return f"nvidia-smi failed: {exc}"


def measure(bench, cell, seed, seconds, traced, device, root=ROOT,
            control=False):
    """Set up, run the window, judge it: (result dict, checks dict, the
    control's numbers or None).  ``device`` "cpu" rehearses on the
    program's plain versions."""
    import torch

    from qpbench import check, drive, files, generate, system
    from qpbench.weights import Draws

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    config = load_config(bench, cell["config"], root)
    qroot = config["root"]
    mix = generate.load(cell["traffic"], qroot)
    kind = files.load("kinds", mix["kind"], qroot)
    draws = Draws(seed, config["model"], device)
    spec, params = system.build(config, draws, device)
    traffic = kind.Window(spec, params, config, mix, seed)
    drive.sync()
    setup_s = time.perf_counter() - T_START
    rec = traffic.window(seconds)
    rec.setup_s = setup_s
    t_trace = time.perf_counter()
    if traced:
        traffic.traced(rec)
    cuda = device != "cpu"
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    sample = traffic.check_sample(rec, seed)
    system.release(params)
    del spec, params, traffic
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    limits = check.limits(cell["name"], qroot)
    t_check = time.perf_counter()
    values = kind.numbers(config, draws, mix, sample, None, seed)
    checks = {n: {"value": values.get(n), "limit": lim}
              for n, lim in limits.items()}
    t_control = time.perf_counter()
    low = (kind.numbers(config, draws, mix, sample,
                        config["quantization"]["control"], seed)
           if control else None)
    print(f"[time] set-up {setup_s:.1f} s, window {rec.seconds:.1f} s, "
          f"traced slice {t_check - t_trace:.1f} s with the release, "
          f"check {t_control - t_check:.1f} s"
          + (f", control {time.perf_counter() - t_control:.1f} s"
             if control else ""), file=sys.stderr)
    correct = bool(checks) and all(
        c["value"] is not None and c["value"] <= c["limit"]
        for c in checks.values())
    metrics = {}
    for m in metrics_of(bench, cell, traced):
        value = files.load("metrics", m["name"], qroot).read(rec, config)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
           "count": cell["chips"], "memory_peak_bytes": peak}
    result = {"correct": correct, "attempted": rec.attempted,
              "failed": rec.failed, "metrics": metrics, "device": dev}
    if traced and rec.slice is not None:
        dev["busy_s"] = rec.slice.busy_s
        dev["window_s"] = rec.slice.window_s
        result["breakdown"] = {"device_ops": rec.slice.device_ops,
                               "idle_gaps": rec.slice.idle_gaps}
    return result, checks, low


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cache_env()
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    cell = cell_of(bench, args.workload)

    import torch
    torch.set_num_threads(4)
    if not torch.cuda.is_available() or (torch.cuda.device_count()
                                         < cell["chips"]):
        print(f"no result: {cell['chips']} CUDA card(s) wanted, "
              f"{torch.cuda.device_count()} visible", file=sys.stderr)
        return 2
    label = card_label()
    print(f"[card] {label}", file=sys.stderr, flush=True)
    result, checks, low = measure(bench, cell, args.seed, args.seconds,
                                  bool(args.trace), "cuda",
                                  control=bool(args.control))
    bad = jax_loaded()
    if bad:
        print(f"no result: {bad} loaded in the process", file=sys.stderr)
        return 3
    if low is not None:
        result["control"] = low
    result["check"] = checks
    for name, value in (low or {}).items():
        print(f"control {name} {value!r}", file=sys.stderr)
    for name, c in checks.items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
