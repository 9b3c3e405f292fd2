"""Driver of the port's incremental SfM entry, with the lens dewarp stage in
front where the traffic delivers raw frames.

A request is one sequence: its frames handed over as float32 grey levels
on the host (as ``cli/common.load_gray`` gives them), through
``cli.run_sfm.dewarp_frames`` when the traffic names a lens, then
``sfm.incremental.run_incremental_sfm(frames, k, cfg, seed=...)``; it ends
when the ``SfmResult`` is on the host.  The pool of sequences is rendered
on the card in set-up, each a new scene drawn from (seed, index).

The check reads only what the two public calls return: the dewarped
frames and the ``SfmResult`` (its track table, poses and costs).  The
reference recomputes the features of every frame and judges the table by
them: each observation has to lie on a reference keypoint (FAST, NMS and
the subpixel refine), and the links between a track's consecutive
observations in two frames have to be held by one fundamental matrix
within the epipolar gate's threshold, as the gate's inliers are (the
matching, the gates and the chaining).  The final state is judged by the robust cost the program
reports and by how far one Gauss-Newton step would still lower it (the
windowed and final BA).  The dewarp is recomputed from the raw frames.
"""
from __future__ import annotations

import math
import statistics
import sys
import traceback

import numpy as np
import torch

from harness import compare, draws, scene
from reference import dewarp as rdw
from reference import frontend as rf
from reference import geometry as rg


# the epipolar gate's Sampson threshold in px and hypotheses
# (``SfmConfig.ransac_threshold`` and ``ransac_samples // 2``, which the
# configuration keeps at their defaults), and the fewest links between two
# frames that the check fits an F to
GATE_PX = 1.5
GATE_SAMPLES = 500
MIN_LINKS = 16


def make(ctx):
    return SfmDriver(ctx)


class SfmDriver:
    def __init__(self, ctx):
        self.ctx = ctx
        self.dev = ctx.device
        cfg, tr = ctx.config, ctx.traffic
        self.h, self.w = cfg["image_size"]
        self.num_frames = int(tr["frames"])
        self.coeffs = tr.get("distortion_coeffs")
        self.limits = cfg["limits"]
        self.cache_dir = str(ctx.root / tr.get(
            "dewarp_cache", "build/bench_cache/distortion_maps"))
        self.order = draws.pool_order(ctx.seed, int(tr["pool"]))
        self.every = int(tr.get("check_every", 1))
        self.last_kept = None

    def _sfm_config(self):
        from photogrammetry_tpu_torch.sfm.frontend import FrontendConfig
        from photogrammetry_tpu_torch.sfm.incremental import SfmConfig

        c, fc = self.ctx.config, self.ctx.config["frontend"]
        return SfmConfig(frontend=FrontendConfig(
            detection_threshold=fc["detection_threshold"],
            max_keypoints=fc["max_keypoints"], reduction=fc["reduction"],
            suppression_radius=fc["suppression_radius"],
            hamming_threshold=fc["hamming_threshold"],
            num_pairs=fc["num_pairs"], brief_sigma=fc["brief_sigma"],
            pair_seed=fc["pair_seed"]), **c["sfm"])

    def _spec(self, index: int) -> scene.SceneSpec:
        dot_seed, texture_seed = scene.scene_seeds(self.ctx.seed, index)
        return scene.SceneSpec(image_size=(self.h, self.w),
                               focal=self.ctx.config["focal"],
                               num_frames=self.num_frames,
                               pan_radius=self.ctx.traffic["pan_radius"],
                               dot_seed=dot_seed, texture_seed=texture_seed)

    def setup(self):
        from photogrammetry_tpu_torch.cli.run_sfm import dewarp_frames
        from photogrammetry_tpu_torch.sfm.incremental import (
            run_incremental_sfm,
        )

        self.run_sfm = run_incremental_sfm
        self.dewarp = dewarp_frames
        self.cfg = self._sfm_config()
        spec0 = self._spec(0)
        self.k = scene.intrinsics(spec0)
        _, _, self.centers = scene.pan_trajectory(spec0)
        self.pool = []
        for j in range(int(self.ctx.traffic["pool"])):
            frames = scene.render_frames(self._spec(j),
                                         range(self.num_frames), self.dev)
            if self.coeffs is not None:
                frames = rdw.capture(frames, self.coeffs)
            self.pool.append(frames.cpu().numpy().astype(np.float32))
        for i in range(int(self.ctx.traffic.get("warmup_requests", 1))):
            rec = self.request(-1 - i)
            if not rec["ok"]:
                raise RuntimeError(f"warm-up request failed: {rec}")
        self.last_kept = None

    def request(self, i: int) -> dict:
        scene_i = int(self.order[i % len(self.order)])
        rec = {"scene": scene_i, "units": self.num_frames, "ok": False}
        keep = i >= 0 and draws.kept(self.ctx.seed, i, self.every)
        spans = self.ctx.spans
        frames = self.pool[scene_i]
        dewarped = res = None
        try:
            if self.coeffs is not None:
                with spans.span("dewarp", i):
                    dewarped = self.dewarp(frames, self.coeffs,
                                           self.cache_dir, device=self.dev)
            with spans.span("sfm", i):
                res = self.run_sfm(frames if dewarped is None else dewarped,
                                   self.k, self.cfg,
                                   seed=draws.request_seed(self.ctx.seed, i),
                                   device=self.dev)
            rec["ok"] = bool(np.isfinite(res.rs).all()
                             and np.isfinite(res.ts).all())
            deferred = sum(f.get("pose_init") == "deferred"
                           for f in res.frame_info)
            rec["note"] = f"scene {scene_i}, {deferred} frames deferred"
        except Exception as err:    # a request that raises is failed
            rec["error"] = repr(err)
            traceback.print_exc(file=sys.stderr)
        if i < 0:
            return rec
        # the outputs of sampled requests, and of the latest until the
        # next request replaces it
        if self.last_kept is not None and not self.last_kept["keep"]:
            self.last_kept.pop("out", None)
        rec["keep"] = keep
        rec["out"] = {"result": res, "dewarped": dewarped}
        self.last_kept = rec
        return rec

    def end_to_end(self, records, window_start) -> dict:
        done = [r for r in records if r["ok"]]
        if not records:
            return {}
        span = max(r["t1"] for r in records) - window_start
        return {"sfm_frames_per_s": sum(r["units"] for r in done) / span}

    # -- the check ------------------------------------------------------

    def _sampled(self, records):
        cands = [r for r in records if r.get("out") and r["ok"]]
        chosen = draws.pick(self.ctx.seed, cands,
                            int(self.ctx.traffic.get("check_requests", 3)))
        ids = {id(r) for r in chosen}
        for r in records:
            if id(r) not in ids:
                r.pop("out", None)
        if self.dev.type == "cuda":
            torch.cuda.empty_cache()
        return chosen

    def _gate_escapes(self, obs, seen, index: int) -> float:
        """The share of the table's links (frames at most two apart, with
        MIN_LINKS or more between them) outside the float64 RANSAC
        consensus that the reference fits to each frame pair's links at the
        gate's threshold; 1 where the table holds no such pair."""
        escapes = total = 0
        for (e, f), t in compare.links(seen).items():
            if len(t) < MIN_LINKS:
                continue
            rng = np.random.default_rng((self.ctx.seed, index, e, f))
            _, inl = rg.epipolar_consensus(
                torch.as_tensor(obs[e, t], device=self.dev),
                torch.as_tensor(obs[f, t], device=self.dev), rng,
                GATE_SAMPLES, GATE_PX, keep_best=True)
            escapes += int((~inl).sum())
            total += len(t)
        return escapes / total if total else 1.0

    def check(self, records, control: bool = False):
        fc = self.ctx.config["frontend"]
        pairs = rf.pair_table(fc["pair_seed"], fc["brief_sigma"],
                              fc["num_pairs"])
        args = (pairs, fc["detection_threshold"], fc["max_keypoints"],
                fc["suppression_radius"])
        kmat = torch.as_tensor(self.k, dtype=torch.float64, device=self.dev)
        worst, ates, per_seq = {}, [], []

        def note(name, value):
            value = math.inf if math.isnan(value) else value   # NaN fails
            worst[name] = max(worst.get(name, 0.0), value)

        chosen = self._sampled(records)
        for rec in chosen:
            out = rec["out"]
            res = out["result"]
            raw = torch.as_tensor(self.pool[rec["scene"]], device=self.dev)
            frames_in = src = raw
            if self.coeffs is not None:
                ref_dw = rdw.remap(raw, rdw.dewarp_map(
                    self.h, self.w, self.coeffs, self.dev))
                src = dewarped = out["dewarped"]
                if control:
                    src = dewarped = rdw.remap(raw, rdw.dewarp_map(
                        self.h, self.w, self.coeffs, self.dev,
                        dtype=torch.bfloat16))
                note("dewarp_grey", float((dewarped.double() - ref_dw)
                                          .abs().max()))
                frames_in = out["dewarped"]
            # the reference's features of the frames the program's
            # frontend was given
            ref_f = [rf.frame_features(frames_in[f].float(), *args)
                     for f in range(self.num_frames)]
            tb = res.table
            obs = tb.obs.double().cpu().numpy()
            seen = tb.obs_mask.cpu().numpy()
            if control:
                # the bfloat16 frontend's refined positions in the
                # program's place
                obs = compare.snap(obs, seen, [
                    rf.frame_features(src[f].float(), *args,
                                      dtype=torch.bfloat16)
                    for f in range(self.num_frames)])
            # the frontend: every observation on a reference keypoint
            note("obs_px", compare.observation_gap(obs, seen, ref_f))
            # the epipolar gates and the chaining: the links between a
            # track's consecutive observations in two frames are the gate's
            # inliers there, so one F holds them all within its threshold
            # (but for the map-guided re-association's links, which no gate
            # sees)
            note("gate_escapes", self._gate_escapes(obs, seen, rec["index"]))
            # the final state: the robust cost the program reported against
            # the reference's at the same state (a gap per observation, in
            # px^2), and how far one Gauss-Newton step would still lower it
            rs = torch.as_tensor(res.rs, device=self.dev)
            ts = torch.as_tensor(res.ts, device=self.dev)
            pts, cost = tb.points, res.costs[-1]
            mask = tb.obs_mask & tb.has_point[None, :]
            if control:
                rs, ts, pts = (rg.to_bf16(x) for x in (rs, ts, pts))
                cost = float(rg.ba_residuals(
                    *(x.to(torch.bfloat16) for x in (rs, ts, pts, tb.obs)),
                    mask, kmat.to(torch.bfloat16))[-1])
            ref_cost, decrement, nobs = rg.ba_decrement(rs, ts, pts, tb.obs,
                                                        mask, kmat)
            per_seq.append((abs(cost - ref_cost) / max(nobs, 1),
                            decrement / max(ref_cost, 1e-300)))
            centers = -np.einsum("fji,fj->fi", rs.double().cpu().numpy(),
                                 ts.double().cpu().numpy())
            ates.append(rg.ate(centers, self.centers))
        self.info = {"ATE against the true centres (not compared)": ates,
                     "cost_gap_px2 and ba_decrement a sequence": per_seq}
        if not chosen:
            return []
        # the final state's numbers are medians over the sequences: one
        # sound sequence in ~20 stops its final BA short of the minimum
        # (fixed iteration count) and reads like the TF32 control does
        for j, name in enumerate(("cost_gap_px2", "ba_decrement")):
            note(name, statistics.median(x[j] for x in per_seq))
        return [(name, value, self.limits[name])
                for name, value in worst.items()]
