"""Run one cell of ``BENCHMARK.json`` once and print one JSON line.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

From the root of a checkout.  The cell names a configuration
(``perfbench/configs/<config>.json``) and a traffic mix
(``perfbench/workloads/<traffic>.json``, whose ``kind`` names the module
that runs it: ``serve`` or ``train``); its limits are
``perfbench/limits/<cell>.json`` and each per-layer metric is read by
``perfbench/metrics/<metric>.py``.
With ``--trace 0`` the line carries the cell's end-to-end metrics, with
``--trace 1`` its per-layer ones, read from a ``torch.profiler`` window.
The checks that decide ``correct`` come last in the line and as the last
lines on standard error.

Exits non-zero, printing no result, without enough CUDA devices, or if
JAX or the JAX package was loaded.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HERE = os.path.join(ROOT, "perfbench")
FORBIDDEN = ("jax", "jaxlib", "flax", "dcfp_tpu")


def load_json(*parts):
    with open(os.path.join(ROOT, *parts)) as f:
        return json.load(f)


def cell_spec(bench: dict, name: str) -> dict:
    """The cell, its configuration, traffic, limits, and the metrics it
    reports, all found by name."""
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise SystemExit(f"unknown workload {name!r}; have {sorted(cells)}")
    cell = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    desc = load_json(configs[cell["config"]]["file"])
    traffic = load_json("perfbench", "workloads", f"{cell['traffic']}.json")
    limits = load_json("perfbench", "limits", f"{name}.json")

    def mine(metrics):
        return [m for m in metrics if name in m.get("workloads", [name])]

    return {"cell": cell, "desc": desc, "traffic": traffic,
            "limits": limits, "end_to_end": mine(bench["end_to_end"]),
            "per_layer": mine(bench["per_layer"])}


def reader(metric: str):
    """``perfbench/metrics/<metric>.py``'s ``read(window, ctx)``."""
    path = os.path.join(HERE, "metrics", f"{metric}.py")
    spec = importlib.util.spec_from_file_location(
        f"perfbench_metric_{metric.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def loaded_forbidden():
    return sorted({m.split(".")[0] for m in sys.modules}
                  & set(FORBIDDEN))


def line(spec: dict, out: dict, trace: bool, device) -> dict:
    import torch
    from perfbench import checks
    metrics = {}
    if trace:
        win = out["window"]
        for m in spec["per_layer"]:
            value = reader(m["name"])(win, out["ctx"])
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        for m in spec["end_to_end"]:
            metrics[m["name"]] = {"value": out["e2e"][m["name"]],
                                  "unit": m["unit"]}
    chips = spec["cell"]["chips"]
    dev = {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
           "count": chips, "memory_peak_bytes": int(out["peak"])}
    result = {"correct": checks.held(out["found"], out["limits"]),
              "attempted": out["attempted"], "failed": out["failed"],
              "metrics": metrics, "device": dev}
    if trace:
        win = out["window"]
        dev["busy_s"] = win.busy_s
        dev["window_s"] = win.window_s
        result["breakdown"] = {"device_ops": win.device_ops,
                               "idle_gaps": win.idle_gaps}
    result["checks"] = {k: {"value": out["found"][k], "limit": v}
                        for k, v in out["limits"].items()}
    return result


def main(argv=None) -> int:
    p = argparse.ArgumentParser("perfbench")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    spec = cell_spec(load_json("BENCHMARK.json"), args.workload)

    # one load-generating process with one host thread: the program's
    # work is on the card, and idle host threads spinning beside the
    # client's add jitter to its timings (a serving run's rate spread by
    # 1.0-2.2% across processes with PyTorch's default threads, 0.8-1.0%
    # with one)
    os.environ.setdefault("OMP_NUM_THREADS", "1")
    import torch
    torch.set_num_threads(1)
    chips = spec["cell"]["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"perfbench: the cell needs {chips} CUDA device(s); "
              f"torch.cuda.is_available() is {torch.cuda.is_available()}",
              file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import importlib
    kind = spec["traffic"]["kind"]
    runner = importlib.import_module(f"perfbench.{kind}")
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    out = runner.run(args.workload, spec["desc"], spec["traffic"],
                     spec["limits"], args.seed, args.seconds,
                     bool(args.trace), device, T_START)
    bad = loaded_forbidden()
    if bad:
        print(f"perfbench: the process loaded {bad}", file=sys.stderr)
        return 3
    result = line(spec, out, bool(args.trace), device)
    for k, v in out["found"].items():
        if k not in result["checks"]:
            print(f"observed {k} {v!r} (not held)", file=sys.stderr)
    for k, v in result["checks"].items():
        print(f"check {k} {v['value']!r} limit {v['limit']!r}",
              file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.path.insert(0, ROOT)
    sys.exit(main())
