#!/usr/bin/env python3
"""How far apart two float32 runs of loop closure may honestly land, on
one CUDA card, from the repository root:

    python3 experiments/loop_closure_f32/run.py [--iterations 20 100]

The state is ``chip_smoke.py``'s loop-closure phase: the 12-frame 1080p pan
traversed out and back (23 frames), one ``run_incremental_sfm`` at its
``LOOP_SEED``, ``run_sfm``'s configuration.  For 'revisit' and 'rotation'
mode it prints one JSON line each:

- the edge measurements (``measure_loop_edges``) taken on the card and on
  CPU copies of the same features and poses: their largest difference;
- ``optimize_pose_graph`` on one graph (built from the card's
  measurements) at each number of iterations: on the card in float32, on
  the CPU in float32 and on the CPU in float64, the largest pose
  difference between each two, their costs, and the correction that the
  float64 run applies to the SfM poses (its largest entry);
- the CPU float32 run again on poses moved by one part in 1e7 (a seeded
  draw): how far an input rounding moves the result.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--iterations", type=int, nargs="+", default=[20, 100])
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    import chip_smoke
    from photogrammetry_tpu_torch.sfm.frontend import (
        DescribedFrame, frame_features, make_pairs, precompute_frontend,
    )
    from photogrammetry_tpu_torch.sfm.incremental import (
        SfmConfig, run_incremental_sfm,
    )
    from photogrammetry_tpu_torch.sfm.loop_closure import (
        build_pose_graph, close_loops, measure_loop_edges,
    )
    from photogrammetry_tpu_torch.sfm.pose_graph import (
        PoseGraph, optimize_pose_graph,
    )

    dev = torch.device("cuda", 0)
    cpu = torch.device("cpu")
    seq, k, _, centers = chip_smoke.render_sequence()
    frames, _ = chip_smoke.out_and_back(seq, centers)
    cfg = SfmConfig(collect_diagnostics=False)
    res = run_incremental_sfm(frames, k, cfg, seed=chip_smoke.LOOP_SEED,
                              device=dev)
    stacked = precompute_frontend(
        torch.as_tensor(frames, dtype=torch.float32, device=dev),
        make_pairs(cfg.frontend, device=dev), cfg.frontend,
        chunk=cfg.frontend_chunk)
    on_cpu = DescribedFrame(
        points=type(stacked.points)(*(x.cpu() for x in stacked.points)),
        bits=stacked.bits.cpu(), xy=stacked.xy.cpu())
    n = len(frames)
    feats = {dev: [frame_features(stacked, t) for t in range(n)],
             cpu: [frame_features(on_cpu, t) for t in range(n)]}
    rs0 = torch.as_tensor(res.rs, dtype=torch.float32)
    ts0 = torch.as_tensor(res.ts, dtype=torch.float32)
    kmat = torch.as_tensor(k, dtype=torch.float32)

    def diff(a, b):
        return float((a.cpu().double() - b.cpu().double()).abs().max())

    def optimize(graph, rs, ts, on, dtype, iters):
        g = PoseGraph(*(x.to(on) if x.dtype == torch.int32
                        else x.to(on, dtype) for x in graph))
        out = optimize_pose_graph(rs.to(on, dtype), ts.to(on, dtype), g,
                                  num_iterations=iters)
        return out.rs, out.ts, float(out.cost)

    for mode in ("revisit", "rotation"):
        _, _, info = close_loops(feats[dev], rs0.to(dev), ts0.to(dev),
                                 kmat.to(dev), cfg.frontend, min_gap=5,
                                 mode=mode)
        pairs = [tuple(e) for e in info["loop_edges"]]
        meas = {on: measure_loop_edges(feats[on], rs0.to(on), ts0.to(on),
                                       kmat.to(on), pairs, cfg.frontend,
                                       mode=mode)[0] for on in (dev, cpu)}
        row = {"mode": mode, "edges": [list(p) for p in pairs],
               "measurement_diff_card_vs_cpu": max(
                   max(diff(a[0], b[0]), diff(a[1], b[1]))
                   for a, b in zip(meas[dev], meas[cpu]))}
        graph = build_pose_graph(rs0, ts0, pairs,
                                 [(z.cpu(), t.cpu()) for z, t in meas[dev]],
                                 loop_weight=4.0, device="cpu")
        for iters in args.iterations:
            runs = {"card_f32": optimize(graph, rs0, ts0, dev,
                                         torch.float32, iters),
                    "cpu_f32": optimize(graph, rs0, ts0, cpu,
                                        torch.float32, iters),
                    "cpu_f64": optimize(graph, rs0, ts0, cpu,
                                        torch.float64, iters)}
            gen = torch.Generator().manual_seed(0)
            nudged = [x * (1 + 1e-7 * torch.randn(x.shape, generator=gen))
                      for x in (rs0, ts0)]
            runs["cpu_f32_nudged"] = optimize(graph, *nudged, cpu,
                                              torch.float32, iters)
            names = list(runs)
            row[f"iterations_{iters}"] = {
                "cost": {m: runs[m][2] for m in names},
                "pose_diff": {
                    f"{a}_vs_{b}": max(diff(runs[a][0], runs[b][0]),
                                       diff(runs[a][1], runs[b][1]))
                    for i, a in enumerate(names) for b in names[i + 1:]},
                "correction_f64": max(diff(runs["cpu_f64"][0], rs0),
                                      diff(runs["cpu_f64"][1], ts0))}
        print(json.dumps(row), flush=True)
    print(json.dumps({"device": torch.cuda.get_device_name(0),
                      "translation_scale": float(np.abs(res.ts).max())}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
