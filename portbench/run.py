"""Run one cell of ``BENCHMARK.json`` once and print its result line.

    python3 -m portbench.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

Exits non-zero, printing no result, without a CUDA card (or with fewer than
the cell asks for), and if the process holds any module of JAX or of the
JAX package once the window has closed.  With ``--trace 0`` the metrics are
the cell's end-to-end metrics, with ``--trace 1`` its per-layer metrics.
"""

from __future__ import annotations

import time

T_PROCESS = time.perf_counter()  # set-up counts from here, the imports included

import argparse  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
CHECKOUT = HERE.parent
# build and kernel caches at fixed paths inside the checkout
CACHE = CHECKOUT / ".portbench_cache"
os.environ["TORCH_EXTENSIONS_DIR"] = str(CACHE / "torch_extensions")
os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")


def cell_spec(workload: str) -> dict:
    """The cell's entry, configuration, traffic, limits and metric names."""
    from .harness import load_json

    bench = load_json(CHECKOUT / "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise SystemExit(f"unknown workload {workload!r}; known: {sorted(cells)}")
    cell = cells[workload]

    def mine(metrics):
        return [m for m in metrics if workload in m.get("workloads", [workload])]

    return dict(
        cell=cell,
        config=load_json(HERE / "configs" / f"{cell['config']}.json"),
        traffic=load_json(HERE / "traffic" / f"{cell['traffic']}.json"),
        limits=load_json(HERE / "limits" / f"{workload}.json"),
        end_to_end=mine(bench["end_to_end"]),
        per_layer=mine(bench["per_layer"]),
    )


def reader(name: str):
    """The ``read(run)`` of ``metrics/<name>.py``."""
    spec = importlib.util.spec_from_file_location(
        "portbench_metric_" + name.replace(".", "_").replace("-", "_"),
        HERE / "metrics" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def generator(traffic: dict):
    return importlib.import_module(f"portbench.traffic.{traffic['generator']}")


def run_cell(workload: str, seed: int, seconds: float, trace: bool, device="cuda",
             traffic_overrides: dict | None = None, t_start: float | None = None) -> dict:
    """Set up, measure, check → the result line (a dict).  ``traffic_overrides``
    replaces keys of the cell's traffic mix (the tests' tiny sizes)."""
    import torch  # noqa: F401  (its import is part of set-up)

    from .harness import Run, check, result_line

    spec = cell_spec(workload)
    traffic = {**spec["traffic"], **(traffic_overrides or {})}
    run = Run(spec["cell"], spec["config"], traffic, seed, seconds, trace, device)
    if t_start is not None:
        run.t_start = run._t_mark = t_start
    run.mark("import_torch")
    generator(traffic).run(run)
    if trace:
        metrics = {}
        for m in spec["per_layer"]:
            value = reader(m["name"])(run)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        metrics = {m["name"]: {"value": run.end_to_end[m["name"]], "unit": m["unit"]}
                   for m in spec["end_to_end"] if m["name"] in run.end_to_end}
        metrics["setup_s"] = {"value": run.setup_s, "unit": "s"}
    if run.device.type == "cuda":
        torch.cuda.empty_cache()
    t_check = time.perf_counter()
    correct, table = check(run, spec["limits"])
    run.counters["check_s"] = time.perf_counter() - t_check
    line = result_line(run, correct, table, metrics)
    line["_setup_split"] = run.setup_split
    line["_counters"] = dict(run.counters)
    return line


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    chips = int(cell_spec(args.workload)["cell"].get("chips", 1))
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"portbench: needs {chips} CUDA card(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    line = run_cell(args.workload, args.seed, args.seconds, bool(args.trace), "cuda",
                    t_start=T_PROCESS)
    from .harness import offending_modules

    bad = offending_modules()
    if bad:
        print(f"portbench: the process holds {bad}; no result", file=sys.stderr)
        return 3
    extra = {k: line.pop(k) for k in ("_setup_split", "_counters")}
    print(json.dumps(extra), file=sys.stderr)
    for name, c in line["check"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(line))
    return 0


if __name__ == "__main__":
    sys.exit(main())
