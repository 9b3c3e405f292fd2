"""Driver of the port's two-view pose path, as ``cli/estimate_pose`` runs
it without the PNG I/O: ``cli.estimate_pose.frontend(g1, g2, pairs,
config)`` then ``sfm.two_view.two_view_pipeline(gen, xy1, xy2, mask, k,
threshold, num_samples, model="fundamental")``.

A request is one photo pair, handed over as float32 grey levels on the
host and uploaded as the CLI does; it ends when R, t, the inlier mask and
the points are on the host.  The pool of pairs is rendered on the card in
set-up: frames 0 and 2 of the pan at the configuration's photo size, each
pair a new scene drawn from (seed, index).  The BRIEF pair table is made
once in set-up.

The check compares both frames' features and the matches with the
reference's on the same frames, and the pose with the scene's true
relative pose.  The control puts the reference's frontend in bfloat16 and
its two-view solver with bfloat16 rounding in the program's place.
"""
from __future__ import annotations

import math
import statistics
import sys
import time
import traceback

import numpy as np
import torch

from harness import compare, draws, scene
from reference import frontend as rf
from reference import geometry as rg


def make(ctx):
    return PoseDriver(ctx)


class PoseDriver:
    def __init__(self, ctx):
        self.ctx = ctx
        self.dev = ctx.device
        cfg, tr = ctx.config, ctx.traffic
        self.h, self.w = cfg["image_size"]
        self.frame_ids = tuple(tr["frames"])
        self.limits = cfg["limits"]
        self.order = draws.pool_order(ctx.seed, int(tr["pool"]))
        self.every = int(tr.get("check_every", 1))

    def _spec(self, index: int) -> scene.SceneSpec:
        dot_seed, texture_seed = scene.scene_seeds(self.ctx.seed, index)
        return scene.SceneSpec(image_size=(self.h, self.w),
                               focal=self.ctx.config["focal"],
                               num_frames=int(self.ctx.traffic["pan_frames"]),
                               pan_radius=self.ctx.traffic["pan_radius"],
                               dot_seed=dot_seed, texture_seed=texture_seed)

    def setup(self):
        from photogrammetry_tpu_torch.cli.estimate_pose import frontend
        from photogrammetry_tpu_torch.sfm.frontend import (
            FrontendConfig, make_pairs,
        )
        from photogrammetry_tpu_torch.sfm.two_view import two_view_pipeline

        fc = self.ctx.config["frontend"]
        self.fcfg = FrontendConfig(
            detection_threshold=fc["detection_threshold"],
            hamming_threshold=fc["hamming_threshold"],
            reduction=fc["reduction"],
            suppression_radius=fc["suppression_radius"],
            max_keypoints=fc["max_keypoints"], num_pairs=fc["num_pairs"],
            brief_sigma=fc["brief_sigma"], pair_seed=fc["pair_seed"])
        self.frontend, self.two_view = frontend, two_view_pipeline
        self.pairs = make_pairs(self.fcfg, device=self.dev)
        spec0 = self._spec(0)
        self.k_np = scene.intrinsics(spec0)
        self.k = torch.as_tensor(self.k_np, device=self.dev)
        rs, ts, _ = scene.pan_trajectory(spec0)
        a, b = self.frame_ids
        self.r_true, self.t_true = rg.relative_pose(rs[a], ts[a], rs[b],
                                                    ts[b])
        self.pool = []
        for j in range(int(self.ctx.traffic["pool"])):
            frames = scene.render_frames(self._spec(j), self.frame_ids,
                                         self.dev)
            self.pool.append([f.cpu().numpy().astype(np.float32)
                              for f in frames])
        for i in range(int(self.ctx.traffic.get("warmup_requests", 1))):
            rec = self.request(-1 - i)
            if not rec["ok"]:
                raise RuntimeError(f"warm-up request failed: {rec}")

    def request(self, i: int) -> dict:
        scene_i = int(self.order[i % len(self.order)])
        rec = {"scene": scene_i, "units": 1, "ok": False}
        spans = self.ctx.spans
        g1, g2 = self.pool[scene_i]
        t0 = time.perf_counter()
        try:
            with spans.span("frontend", i):
                f1, f2, m = self.frontend(torch.from_numpy(g1).to(self.dev),
                                          torch.from_numpy(g2).to(self.dev),
                                          self.pairs, self.fcfg)
            with spans.span("geometry", i):
                gen = torch.Generator(device=self.dev).manual_seed(
                    draws.request_seed(self.ctx.seed, i))
                out = self.two_view(
                    gen, m.xy1, m.xy2, m.mask, self.k,
                    threshold=self.ctx.config["ransac_threshold"],
                    num_samples=self.ctx.config["ransac_samples"],
                    model="fundamental")
                r, t, inliers, points = (x.cpu().numpy() for x in
                                         (out.r, out.t, out.inliers,
                                          out.points))
            rec["latency_s"] = time.perf_counter() - t0
            rec["ok"] = bool(np.isfinite(r).all() and np.isfinite(t).all())
            if i >= 0 and draws.kept(self.ctx.seed, i, self.every):
                rec["out"] = dict(f1=f1, f2=f2, m=m, r=r, t=t,
                                  inliers=inliers, f=out.f)
        except Exception as err:    # a request that raises is failed
            rec["latency_s"] = time.perf_counter() - t0
            rec["error"] = repr(err)
            traceback.print_exc(file=sys.stderr)
        return rec

    def end_to_end(self, records, window_start) -> dict:
        lat = [1e3 * r["latency_s"] for r in records]
        if not lat:
            return {}
        p95 = (statistics.quantiles(lat, n=100, method="inclusive")[94]
               if len(lat) > 1 else lat[0])
        return {"pose_p50_ms": statistics.median(lat), "pose_p95_ms": p95}

    def check(self, records, control: bool = False):
        fc = self.ctx.config["frontend"]
        thr = self.ctx.config["ransac_threshold"]
        samples = self.ctx.config["ransac_samples"]
        table = rf.pair_table(fc["pair_seed"], fc["brief_sigma"],
                              fc["num_pairs"])
        args = (table, fc["detection_threshold"], fc["max_keypoints"],
                fc["suppression_radius"])
        cands = [r for r in records if r.get("out") and r["ok"]]
        chosen = draws.pick(self.ctx.seed, cands,
                            int(self.ctx.traffic.get("check_requests", 16)))
        ids = {id(r) for r in chosen}
        for r in records:
            if id(r) not in ids:
                r.pop("out", None)
        worst, truth = {}, {"rotation_deg": [], "direction_deg": []}
        ref_cache = {}

        def note(name, value):
            value = math.inf if math.isnan(value) else value   # NaN fails
            worst[name] = max(worst.get(name, 0.0), value)

        for rec in chosen:
            out = rec["out"]
            rng = np.random.default_rng(draws.request_seed(self.ctx.seed,
                                                           rec["index"]))
            frames = [torch.as_tensor(g, device=self.dev)
                      for g in self.pool[rec["scene"]]]
            if rec["scene"] not in ref_cache:
                feats = [rf.frame_features(g, *args) for g in frames]
                ref_cache[rec["scene"]] = (feats, rf.mutual_matches(
                    feats[0], feats[1], fc["hamming_threshold"], self.dev))
            ref, ref_m = ref_cache[rec["scene"]]
            if control:
                got = [rf.frame_features(g, *args, dtype=torch.bfloat16)
                       for g in frames]
                idx2, dist, valid = rf.mutual_matches(
                    got[0], got[1], fc["hamming_threshold"], self.dev)
                xy1, xy2 = self._pairs_xy(got, idx2, valid)
                use = np.nonzero(valid)[0]
                r, t, f, inl = rg.two_view_pose(
                    xy1[use], xy2[use], self.k_np, rng, samples, thr,
                    quantize=rg.to_bf16, dtype=torch.float32)
                inliers = np.zeros(len(valid), bool)
                inliers[use] = inl
            else:
                got = [compare.described_to_numpy(
                    f.points.coords, f.points.score, f.points.mask, f.bits,
                    f.xy) for f in (out["f1"], out["f2"])]
                m = out["m"]
                idx2, dist, valid = (x.cpu().numpy() for x in
                                     (m.idx2, m.dist, m.mask))
                xy1, xy2 = m.xy1, m.xy2
                r, t, f = out["r"], out["t"], out["f"]
                inliers = out["inliers"] & valid
            for g, rr in zip(got, ref):
                gaps = compare.feature_gaps(g, rr)
                note("keypoints", gaps["keypoints"])
                note("bits", gaps["bits"])
                note("xy_px", gaps["xy_px"])
            note("matches", compare.match_gaps(idx2, dist, valid, ref_m))
            # the geometry judged by what it says: its inliers are the
            # matches within the threshold under its own F, its pose is
            # the one its F implies, and its consensus is as large as the
            # reference's RANSAC finds on the reference's matches
            f64 = torch.as_tensor(f, device=self.dev).double()
            x1h, x2h = (torch.cat([x.double(), torch.ones_like(
                x[:, :1], dtype=torch.float64)], -1) for x in (xy1, xy2))
            d = rg.sampson(f64, x1h, x2h, lambda x: x).cpu().numpy()
            clear = np.abs(d - thr) > 1e-3
            note("inlier_flips", int(((d <= thr) != inliers)[
                valid & clear].sum()))
            r_f, t_f = rg.pose_from_f(f64, xy1, xy2,
                                      torch.as_tensor(inliers,
                                                      device=self.dev),
                                      self.k_np)
            note("pose_gap_deg", max(rg.rotation_deg(r, r_f),
                                     rg.direction_deg(t, t_f)))
            ref_xy1, ref_xy2 = self._pairs_xy(ref, *ref_m[::2])
            use = np.nonzero(ref_m[2])[0]
            best = int(rg.two_view_pose(ref_xy1[use], ref_xy2[use],
                                        self.k_np, rng, samples,
                                        thr)[3].sum())
            note("consensus_shortfall",
                 max(0.0, (best - int(inliers.sum())) / max(best, 1)))
            truth["rotation_deg"].append(rg.rotation_deg(r, self.r_true))
            truth["direction_deg"].append(rg.direction_deg(t, self.t_true))
        self.info = {"against the true pose (not compared), max over the "
                     "sample": {k: max(v) for k, v in truth.items() if v}}
        if not chosen:
            return []
        return [(name, value, self.limits[name])
                for name, value in worst.items()]

    def _pairs_xy(self, feats, idx2, valid):
        """The matched (x, y) of both frames' features, as tensors."""
        xy1 = torch.as_tensor(feats[0].xy, device=self.dev)
        xy2 = torch.as_tensor(feats[1].xy[np.maximum(idx2, 0)],
                              device=self.dev)
        return xy1, xy2
