"""Readings for the limits of ``correct``: one cell's numbers over many
seeds in one process, from the program or from the control in its place.

    python3 -m portbench.control --workload <name> --seeds 1,2,3 --seconds 3 [--control]

Prints one JSON line per seed (``correct``, each number compared, the
end-to-end metrics) and a last line with the largest reading of each
number.  ``--control`` puts the bfloat16 control of the reference that the
cell's configuration names in the program's place (``reference/control.py``).
"""

from __future__ import annotations

import argparse
import functools
import json
import sys
import time


def use_control(spec: dict) -> None:
    """Put the control of ``spec``'s reference in ``render_batch``'s place,
    with no pipelined warm-up in the cell's generator (the control's timing
    is not read)."""
    from audio_raytracing_studio_tpu_torch.parallel import sharding

    from . import run as bench
    from .harness import reference
    from .reference import control

    sharding.render_batch = functools.partial(control.render_batch,
                                              reference=reference(spec["config"]))
    bench.generator(spec["traffic"]).WARM_ROUNDS = 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--control", action="store_true")
    args = ap.parse_args(argv)

    from . import run as bench

    if args.control:
        use_control(bench.cell_spec(args.workload))
    worst = {}
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        line = bench.run_cell(args.workload, seed, args.seconds, False, "cuda")
        numbers = {k: v["value"] for k, v in line["check"].items()}
        for k, v in numbers.items():
            worst[k] = max(worst.get(k, 0.0), v)
        print(json.dumps({"seed": seed, "correct": line["correct"], "numbers": numbers,
                          "metrics": {k: v["value"] for k, v in line["metrics"].items()},
                          "counters": line["_counters"], "wall_s": time.perf_counter() - t0}),
              flush=True)
    print(json.dumps({"workload": args.workload, "control": args.control, "worst": worst}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
