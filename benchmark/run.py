"""Run one benchmark cell once and print its result as the last line.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The cell (`BENCHMARK.json`'s `workloads`) names a configuration
(`benchmark/configs/<config>.yaml`) and a traffic mix
(`benchmark/traffic/<traffic>.yaml`); each metric is read by
`benchmark/metrics/<name>.py`. With `--trace 0` the line holds the cell's
end-to-end metrics, with `--trace 1` its per-layer metrics, read from a
CUDA-only profiler trace of a few of the window's steps, and the line's
`span_join` says whether the program's spans joined that trace (`spans.py`)
and on what clock figures, or which check broke the join. Either way the run
ends with the check of `check.py`, whose numbers and limits are printed last
on standard error and last in the line.

Needs the card: without CUDA, or with fewer devices than the cell asks for,
it exits 2 and prints no result. It exits 3 if a module of JAX or of the JAX
package is loaded at the end.
"""

from __future__ import annotations

import time

T_BEGIN = time.perf_counter()

import argparse  # noqa: E402
import importlib  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import shutil  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BENCH = os.path.join(ROOT, "benchmark")
FORBIDDEN = ("jax", "jaxlib", "flax", "multiply_tpu")


def forbidden_modules(modules=None) -> list[str]:
    """Loaded modules whose top-level name (before the first dot) is one of
    FORBIDDEN, compared whole: `multiply_tpu_torch` is not `multiply_tpu`."""
    names = sys.modules if modules is None else modules
    return sorted({m for m in names if m.split(".", 1)[0] in FORBIDDEN})


def load_bench(root: str = ROOT) -> dict:
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        return json.load(f)


def cell_parts(bench: dict, name: str) -> tuple[dict, dict, dict, dict]:
    """(workload, config entry, config file, traffic file) of a cell."""
    from benchmark.harness import load_yaml

    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json (have {sorted(cells)})")
    cell = cells[name]
    entry = {c["name"]: c for c in bench["configs"]}[cell["config"]]
    config = load_yaml(os.path.join(ROOT, entry["file"]))
    traffic = load_yaml(os.path.join(BENCH, "traffic", f"{cell['traffic']}.yaml"))
    return cell, entry, config, traffic


def metrics_of(bench: dict, cell: str, trace: bool) -> list[dict]:
    """The metric entries that the cell reports in this kind of run."""
    group = bench["per_layer"] if trace else bench["end_to_end"]
    return [m for m in group if "workloads" not in m or cell in m["workloads"]]


def read_metrics(entries: list[dict], run: dict) -> dict:
    out = {}
    for m in entries:
        value = importlib.import_module(f"benchmark.metrics.{m['name']}").read(run)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def cell_limits(cell: str) -> dict:
    path = os.path.join(BENCH, "limits", f"{cell}.json")
    if not os.path.exists(path):
        return {}
    with open(path) as f:
        return json.load(f)


def measure(bench: dict, name: str, seed: int, seconds: float, trace: bool, device="cuda",
            t_begin: float = T_BEGIN) -> dict:
    """One run of cell `name`: the result line's object (without the
    forbidden-module check, which `main` makes at the very end)."""
    import torch

    from benchmark import harness, kernels, spans, traces

    cell, entry, config, traffic = cell_parts(bench, name)
    records = harness.run_cell(cell, config, traffic, seed, seconds, trace, device, t_begin)
    try:
        on_card = torch.device(device).type == "cuda"
        kind = torch.cuda.get_device_name(0) if on_card else None
        run = dict(records, peak=kernels.peaks(kind) if kind else None)
        run["flops"] = kernels.step_flops(records["conf"]["model"], int(config["dataset"]["train"]["num_person"]),
                                          int(config["dataset"]["train"]["num_sample"]),
                                          int(config["scene"]["body_verts"]))
        run["trace"] = None
        if records["trace_path"]:
            run["trace"] = traces.reduce_trace(traces.load_events(records["trace_path"]))
        metrics = read_metrics(metrics_of(bench, name, trace), run)
        if not on_card:  # a time, a rate or a device share is never reported from a CPU run
            metrics = {k: {"value": "not measured", "unit": v["unit"]} for k, v in metrics.items()}
        t_check = time.perf_counter()
        correct, checks, read = harness.run_check(records, cell_limits(name), device)
        records["setup_phases"]["check (after the window)"] = time.perf_counter() - t_check
        device_info = {"platform": "gpu" if on_card else "cpu", "kind": kind or "cpu",
                       "count": int(cell["chips"]), "memory_peak_bytes": records["peak_bytes"]}
        result = {"correct": bool(correct), "attempted": records["steps"],
                  "failed": sum(m != records["expected_mode"] for m in records["modes"]) + records["skipped"],
                  "metrics": metrics, "device": device_info}
        if trace and run["trace"]:
            t = run["trace"]
            device_info.update(busy_s=t["busy_s"], window_s=t["window_s"])
            top = sorted(t["by_name_s"].items(), key=lambda kv: -kv[1])[:10]
            gaps = sorted(t["gaps_s"].items(), key=lambda kv: -kv[1])[:10]
            result["breakdown"] = {"device_ops": [[k, v] for k, v in top], "idle_gaps": [[k, v] for k, v in gaps]}
        result["setup_phases"] = records["setup_phases"]
        result["diagnostics"] = read["parts"]
        if trace:
            result["span_join"] = spans.summary(run)
        result["checks"] = checks
        return result
    finally:
        shutil.rmtree(records["workdir"], ignore_errors=True)


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    if sys.path and os.path.abspath(sys.path[0]) == BENCH:  # the script's folder shadows nothing
        sys.path.pop(0)
    sys.path.insert(0, ROOT)
    cache = os.path.join(BENCH, ".cache")
    os.environ.setdefault("TRITON_CACHE_DIR", os.path.join(cache, "triton"))
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", os.path.join(cache, "torch_extensions"))
    bench = load_bench()
    cell = {w["name"]: w for w in bench["workloads"]}.get(args.workload)
    if cell is None:
        print(f"no workload {args.workload!r} in BENCHMARK.json", file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < int(cell["chips"]):
        print(f"{args.workload} needs {cell['chips']} CUDA device(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} available", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False  # the configurations state float32
    torch.backends.cudnn.allow_tf32 = False
    result = measure(bench, args.workload, args.seed, args.seconds, bool(args.trace))
    bad = forbidden_modules()
    if bad:
        print(f"modules of JAX or the JAX package are loaded: {bad}", file=sys.stderr)
        return 3
    for k, c in result["checks"].items():
        print(f"check {k}: {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    print(json.dumps(result))
    sys.stdout.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())
