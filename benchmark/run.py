"""Run one cell of the port's benchmark once and print its result line.

    python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout that holds ``witw_tpu_torch``. Set-up (imports,
the CUDA context, the kernels' libraries, which the first run in a checkout
builds with nvcc, the weights, the warm-up of the cell's shapes) is
``setup_s``; then the traffic driver's window runs for ``--seconds``; then,
with the program's state freed, the reference checks one sample of the
window's outputs. ``--trace 1`` runs the window under torch.profiler and
reports the per-layer metrics instead of the end-to-end ones.

The last line of standard output is one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics``, ``device`` (and ``breakdown`` with
``--trace 1``), then ``checks``: each number compared with its limit. The
checks are also the last lines of standard error. Exits non-zero, printing
no result, without enough CUDA devices, when a module of JAX, flax or the
JAX package ``witw_tpu`` is loaded, or when the port is missing.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = {"jax", "jaxlib", "flax", "witw_tpu"}


def fail(msg: str, code: int = 2) -> None:
    print(f"benchmark: {msg}", file=sys.stderr, flush=True)
    sys.exit(code)


def forbidden_modules() -> list:
    """Loaded modules whose top-level name (before the first dot) is JAX's,
    flax's or the JAX package's, compared whole."""
    return sorted(name for name in list(sys.modules) if name.split(".")[0] in FORBIDDEN)


def set_cache_dirs() -> None:
    """Keep every build and kernel cache at fixed paths in the checkout."""
    cache = ROOT / ".bench_cache"
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"), ("TRITON_CACHE_DIR", "triton"),
                     ("CUDA_CACHE_PATH", "cuda")):
        os.environ[var] = str(cache / sub)


def card_name_and_limit() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=60, check=True)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "nvidia-smi unavailable"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    set_cache_dirs()

    from benchmark import cells

    if not (ROOT / "BENCHMARK.json").exists():
        fail("no BENCHMARK.json at the checkout's root")
    bench = cells.manifest()
    entry = next((w for w in bench["workloads"] if w["name"] == args.workload), None)
    if entry is None:
        fail(f"no cell named {args.workload!r} in BENCHMARK.json")
    cell = cells.workload(args.workload)
    conf = cells.config(cell["config"])
    chips = int(entry["chips"])

    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        fail(f"the cell needs {chips} CUDA device(s); "
             f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} available")
    try:
        import witw_tpu_torch  # noqa: F401
    except ImportError as e:
        fail(f"the port witw_tpu_torch is not importable here: {e}")
    from benchmark import trace as tracing

    device = torch.device("cuda", 0)
    cfg = cells.experiment(conf)
    driver = cells.traffic(cell["traffic"]).Driver(cfg, conf, cell, args.seed, device)
    driver.setup()
    torch.cuda.synchronize(device)
    setup_s = time.perf_counter() - T_START

    with tracing.Tracer(bool(args.trace)) as tracer:
        result = driver.window(args.seconds)
        torch.cuda.synchronize(device)
        t_trace = time.perf_counter()
    memory_peak = torch.cuda.max_memory_allocated(device)
    summary = tracer.summary(result["window_ns"])
    t_trace = time.perf_counter() - t_trace  # the profiler's stop and the reading

    metrics = {}
    breakdown = None
    work = driver.work() if args.trace else None
    for m in cells.metrics_of(bench, args.workload, bool(args.trace)):
        if args.trace:
            value = cells.reader(m["name"])(summary, work)
            if value is None:
                continue
        elif m["name"] == "setup_s":
            value = setup_s
        else:
            value = next(result[n] for n in cells.split_bases(m["name"]) if n in result)
        metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = {"platform": "gpu", "kind": torch.cuda.get_device_name(device), "count": chips,
           "memory_peak_bytes": int(memory_peak)}
    if summary is not None:
        dev["busy_s"] = summary["busy_s"]
        dev["window_s"] = summary["window_s"]
        breakdown = summary["breakdown"]

    driver.release()
    t_check = time.perf_counter()
    checks = driver.check()
    t_check = time.perf_counter() - t_check
    limits = cell["limits"]
    missing = sorted(set(limits) ^ set(checks))
    if missing:
        fail(f"checks and limits differ: {missing}")
    correct = all(checks[k] <= limits[k] for k in limits)

    loaded = forbidden_modules()
    if loaded:
        fail(f"modules of JAX or the JAX package are loaded: {loaded[:10]}", 3)

    line = {"correct": correct, "attempted": result["attempted"],
            "failed": result["failed"], "metrics": metrics, "device": dev}
    if breakdown is not None:
        line["breakdown"] = breakdown
    line["checks"] = {k: {"value": checks[k], "limit": limits[k]} for k in sorted(limits)}
    print(f"card: {card_name_and_limit()}; set-up {setup_s:.3f} s, window "
          f"{result['window_s']:.3f} s ({result['attempted']} requests), trace reading "
          f"{t_trace:.3f} s, check {t_check:.3f} s", file=sys.stderr)
    if result.get("request_s"):
        print("request seconds: " + " ".join(f"{t:.4f}" for t in result["request_s"]),
              file=sys.stderr)
    for k in sorted(limits):
        print(f"check {k}: {checks[k]!r} limit {limits[k]!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
