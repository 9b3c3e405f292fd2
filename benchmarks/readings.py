"""The readings that the limits of ``correct`` are set from: a cell's
compared numbers for the program on each of many seeds, and for the two
controls one step below the configuration's float32 on some: the program
with PyTorch's TF32 matmuls switched on, and the reference in bfloat16 put
in the program's place (for the elementwise stages, which TF32 does not
touch); and, for the numbers no control moves, the program with a fault
planted (``FAULTS``); all in one process.

    python benchmarks/readings.py --workload <cell> --seeds 1 2 3 ... \
        [--control-seeds 1 2 3] [--tf32-seeds 4 5 6] \
        [--fault gate_inverted --fault-seeds 7 8 9] [--out readings.jsonl]

Each seed renders its own scenes, runs as many requests as a run checks,
at the cell's own sizes and load, and prints one JSON line of the numbers
the run would compare; the benchmark's own runs never run this.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from harness import runtime  # noqa: E402
from harness.trace import Spans  # noqa: E402


def _gate_inverted(monkeypatch):
    """The SfM loop's epipolar gate answers with its inlier labels
    inverted: only the RANSAC outliers among the matches chain tracks."""
    from photogrammetry_tpu_torch.sfm import incremental

    orig = incremental._gate

    def gate(generator, m, config):
        return m.mask & ~orig(generator, m, config)

    monkeypatch(incremental, "_gate", gate)


def _gate_open(monkeypatch):
    """The SfM loop's epipolar gate passes every match."""
    from photogrammetry_tpu_torch.sfm import incremental

    orig = incremental._gate

    def gate(generator, m, config):
        orig(generator, m, config)          # the same draws as a sound run
        return m.mask

    monkeypatch(incremental, "_gate", gate)


def _pnp_turned(monkeypatch):
    """The SfM loop's RANSAC PnP answers with its rotation turned 3
    degrees about the optical axis."""
    import math

    import torch

    from photogrammetry_tpu_torch.sfm import incremental

    orig = incremental.ransac_pnp
    c, s = math.cos(math.radians(3.0)), math.sin(math.radians(3.0))

    def pnp(*args, **kwargs):
        out = orig(*args, **kwargs)
        turn = torch.tensor([[c, -s, 0.0], [s, c, 0.0], [0.0, 0.0, 1.0]],
                            dtype=out.r.dtype, device=out.r.device)
        return out._replace(r=turn @ out.r)

    monkeypatch(incremental, "ransac_pnp", pnp)


# faults planted in the port, each as ``plant(setattr_like)``
FAULTS = {"gate_inverted": _gate_inverted, "gate_open": _gate_open,
          "pnp_turned": _pnp_turned}


def readings(cell, seed: int, device, root, control: bool = False,
             tf32: bool = False) -> dict:
    """The compared numbers of one seed: the program's, and the bfloat16
    control's where asked (None otherwise).  ``tf32``: the program runs
    with PyTorch's TF32 matmuls switched on, its own path one step below
    the configuration's float32 (the port switches them off when it is
    imported, so it is imported first); the check runs with them off."""
    import torch

    import photogrammetry_tpu_torch  # noqa: F401

    n = int(cell.traffic.get("check_requests", 3))
    cell.traffic.update(check_every=1, pool=n)
    ctx = runtime.Context(cell, seed, device, Spans(False, device), root)
    driver = cell.driver.make(ctx)
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    try:
        driver.setup()
        records = []
        for i in range(n):
            rec = driver.request(i)
            rec["index"] = i
            records.append(rec)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    prog = {k: v for k, v, _ in driver.check(records)}
    ctrl = ({k: v for k, v, _ in driver.check(records, control=True)}
            if control else None)
    return {"failed": sum(not r["ok"] for r in records), "program": prog,
            "control": ctrl, "info": getattr(driver, "info", None)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="*", default=[])
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--tf32-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--fault", choices=sorted(FAULTS), default=None)
    ap.add_argument("--fault-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    root = runtime.BENCH_DIR.parent
    os.environ.update(runtime.cache_env(root))
    sys.path.insert(0, str(root))
    import torch

    if not torch.cuda.is_available():
        print("readings are taken on a CUDA card", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    runs = ([(s, None) for s in dict.fromkeys(args.seeds
                                              + args.control_seeds)]
            + [(s, "tf32") for s in args.tf32_seeds]
            + [(s, args.fault) for s in args.fault_seeds])
    undo = []

    def plant(obj, name, value):
        undo.append((obj, name, getattr(obj, name)))
        setattr(obj, name, value)

    for seed, kind in runs:
        t0 = time.perf_counter()
        cell = runtime.load_cell(args.workload)
        if kind in FAULTS:
            FAULTS[kind](plant)
        try:
            got = readings(cell, seed, device, root,
                           control=kind is None
                           and seed in args.control_seeds,
                           tf32=kind == "tf32")
        finally:
            while undo:
                setattr(*undo.pop())
        line = json.dumps({"workload": args.workload, "seed": seed,
                           "tf32": kind == "tf32", "fault": kind
                           if kind in FAULTS else None, **got,
                           "seconds": time.perf_counter() - t0})
        print(line, flush=True)
        if args.out:
            with open(args.out, "a") as fh:
                fh.write(line + "\n")
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
