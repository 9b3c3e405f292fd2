"""Driver of loop-closed SfM: the port's incremental SfM entry on an
out-and-back walk, then the CLI's loop-closure stage.

A request is one sequence of ``2 * pan_frames - 1`` frames: the pan's poses
walked out, then its poses ``pan_frames - 2`` down to 0 walked back with
the camera centre moved by ``return_offset`` (world units) and the
orientation unchanged, handed over as float32 grey levels on the host;
``sfm.incremental.run_incremental_sfm`` on them, then
``cli.run_sfm.close_loops_stage`` with the configuration's ``loop``
settings (what ``run_sfm --loop-closure`` runs); it ends when the
loop-closed ``SfmResult`` is on the host.  The pool of sequences is
rendered on the card in set-up, each a new scene drawn from (seed,
index), the return leg from its own poses (``harness/scene.render_frame``).

The check judges the SfM part as ``drivers/sfm.py`` does, on the state
before the stage, and the stage against ``reference/loop.py`` (float64):
the pair grid's counts against the counts of the reference's own features
of the same frames (exact), the candidates and the support gate, each
edge's measured rotation against the float64 Procrustes on the same
matches, the pose graph's reported costs and how far one Gauss-Newton step
would still lower its cost at the corrected poses, and the re-triangulated
landmarks against the n-view DLT under the corrected poses.
"""
from __future__ import annotations

import inspect
import math
import statistics
import sys
import traceback
from types import SimpleNamespace

import numpy as np
import torch

from drivers import sfm as base
from harness import draws, scene
from reference import frontend as rf
from reference import geometry as rg
from reference import loop as rl

LOOP_WEIGHT = 4.0       # close_loops' loop_weight, which the stage keeps
# an edge whose float64 support lies this close to the gate may fall on
# either side of it in float32 (the trim's 3 x mean cut moves a match)
SUPPORT_MARGIN = 2
# an edge some match of which lies this close to a round's trim cut
# (relative to the cut) in the float64 fit: float32's residuals (~2e-7 on
# cuts of ~1e-2) may put it on the other side, and one match in or out
# turns the rotation by ~resid / N, up to 0.01 degrees
TRIM_MARGIN = 1e-4
# retri_px reads the re-triangulated observations of the tracks whose
# point float32 can place: a two-view track of little parallax, or one
# under a poorly estimated pose, leaves the 4x4 Gram matrix's two smallest
# eigenvalues nearly equal, and a float32 solve then turns its point by
# 1.2e-7 x the condition (reference/loop.py dlt_nview), to hundreds of px
# in views where it lies far along its rays
WELL_POSED = 1e5        # conditions above: float32 turns the point 1e-2


def make(ctx):
    return LoopDriver(ctx)


def outback_trajectory(spec: scene.SceneSpec, offset):
    """World-to-camera (rs, ts) and centres of the pan walked out (its
    frames 0..F-1) and back (F-2..0), the way back with its centres moved
    by ``offset`` and the orientation unchanged."""
    rs, _, centers = scene.pan_trajectory(spec)
    back = np.arange(len(rs) - 2, -1, -1)
    rs = np.concatenate([rs, rs[back]])
    centers = np.concatenate([centers, centers[back]
                              + np.asarray(offset, np.float64)])
    ts = -np.einsum("fij,fj->fi", rs, centers)
    return rs, ts, centers


def _bf16(x: np.ndarray) -> np.ndarray:
    """``x`` rounded to bfloat16 (the control's precision) and back."""
    return torch.as_tensor(x).to(torch.bfloat16).to(torch.float64).numpy()


class LoopDriver(base.SfmDriver):
    def __init__(self, ctx):
        super().__init__(ctx)
        tr = ctx.traffic
        self.pan_frames = int(tr["pan_frames"])
        self.num_frames = 2 * self.pan_frames - 1
        if int(tr["frames"]) != self.num_frames:
            raise ValueError(f"an out-and-back of {self.pan_frames} pan "
                             f"frames has {self.num_frames} frames, not "
                             f"{tr['frames']}")
        self.offset = tr["return_offset"]
        loop = ctx.config["loop"]
        self.loop = {key: loop[key] for key in
                     ("mode", "min_gap", "min_matches", "max_edges")}

    def _spec(self, index: int) -> scene.SceneSpec:
        dot_seed, texture_seed = scene.scene_seeds(self.ctx.seed, index)
        return scene.SceneSpec(image_size=(self.h, self.w),
                               focal=self.ctx.config["focal"],
                               num_frames=self.pan_frames,
                               pan_radius=self.ctx.traffic["pan_radius"],
                               dot_seed=dot_seed, texture_seed=texture_seed)

    def setup(self):
        from photogrammetry_tpu_torch.cli import run_sfm
        from photogrammetry_tpu_torch.sfm.incremental import (
            run_incremental_sfm,
        )

        if "mode" not in inspect.signature(
                run_sfm.close_loops_stage).parameters:
            raise SystemExit("cli.run_sfm.close_loops_stage takes no "
                             "keyword settings in this version of the port")
        self.run_sfm = run_incremental_sfm
        self.stage = run_sfm.close_loops_stage
        self.cfg = self._sfm_config()
        spec0 = self._spec(0)
        self.k = scene.intrinsics(spec0)
        rs, ts, self.centers = outback_trajectory(spec0, self.offset)
        self.pool = []
        for j in range(int(self.ctx.traffic["pool"])):
            spec = self._spec(j)
            frames = torch.stack([scene.render_frame(spec, r, t, self.k,
                                                     self.dev)
                                  for r, t in zip(rs, ts)])
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
        res = pre = info = None
        try:
            with spans.span("sfm", i):
                res = self.run_sfm(frames, self.k, self.cfg,
                                   seed=draws.request_seed(self.ctx.seed, i),
                                   device=self.dev)
            # the state before the stage, which replaces these attributes
            pre = SimpleNamespace(rs=res.rs, ts=res.ts, table=res.table,
                                  costs=res.costs)
            with spans.span("loop", i):
                _, info = self.stage(frames, res, self.k, self.cfg,
                                     self.dev, **self.loop)
            rec["ok"] = bool(np.isfinite(res.rs).all()
                             and np.isfinite(res.ts).all())
            rec["note"] = (f"scene {scene_i}, {len(info['loop_edges'])} loop "
                           f"edges, {len(info['rejected_edges'])} rejected")
        except Exception as err:    # a request that raises is failed
            rec["error"] = repr(err)
            traceback.print_exc(file=sys.stderr)
        if i < 0:
            return rec
        if self.last_kept is not None and not self.last_kept["keep"]:
            self.last_kept.pop("out", None)
        rec["keep"] = keep
        rec["out"] = {"result": res, "pre": pre, "loop": info,
                      "dewarped": None}
        self.last_kept = rec
        return rec

    # -- the check ------------------------------------------------------

    def check(self, records, control: bool = False):
        chosen = self._sampled(records)
        # the SfM part, on the state before the stage
        checks = super().check(
            [dict(r, out={"result": r["out"]["pre"], "dewarped": None})
             for r in chosen], control)
        sfm_info = self.info
        worst, per_seq = {}, []
        for rec in chosen:
            got = self._loop_numbers(rec, control)
            per_seq.append(got)
            for name in ("loop_counts", "loop_edges", "edge_rot_deg",
                         "pg_cost_gap"):
                value = math.inf if math.isnan(got[name]) else got[name]
                worst[name] = max(worst.get(name, 0.0), value)
        self.info = dict(sfm_info, **{
            "ATE after the stage (not compared)":
                [g["ate_after"] for g in per_seq],
            "loop edges, rejected, support gaps a sequence":
                [(g["edges"], g["rejected"], g["support_gap"])
                 for g in per_seq],
            "largest edge angle (degrees) and its trim margin, edges "
            "of undecided trim a sequence":
                [(max(g["angles"], default=None),
                  sum(m < TRIM_MARGIN for _, m in g["angles"]))
                 for g in per_seq],
            "pg_decrement a sequence": [g["pg_decrement"] for g in per_seq],
            "re-triangulation gap median a sequence (px), well-posed "
            "tracks, tracks with a point":
                [(float(np.median(g["retri_gaps"]))
                  if g["retri_gaps"].size else None,) + g["well_posed"]
                 for g in per_seq]})
        if not chosen:
            return []
        # medians over the sequences: one sound sequence in ~15 stops its
        # 20 LM iterations short of the graph's minimum (as the final BA
        # does, drivers/sfm.py), and one in ~20 has its few well-posed
        # tracks under poses that SfM estimated poorly
        worst["pg_decrement"] = statistics.median(
            math.inf if math.isnan(g["pg_decrement"]) else g["pg_decrement"]
            for g in per_seq)
        gaps = np.concatenate([g["retri_gaps"] for g in per_seq])
        worst["retri_px"] = float(np.median(gaps)) if gaps.size else 0.0
        return checks + [(name, value, self.limits[name])
                         for name, value in worst.items()]

    def _features(self, frames, dtype=torch.float32):
        fc = self.ctx.config["frontend"]
        pairs = rf.pair_table(fc["pair_seed"], fc["brief_sigma"],
                              fc["num_pairs"])
        return [rf.frame_features(frames[f].float(), pairs,
                                  fc["detection_threshold"],
                                  fc["max_keypoints"],
                                  fc["suppression_radius"], dtype=dtype)
                for f in range(len(frames))]

    def _loop_numbers(self, rec, control: bool) -> dict:
        """The stage's numbers for one sequence, the re-triangulation's
        gaps (px) and what the run prints."""
        out = rec["out"]
        res, pre, info = out["result"], out["pre"], out["loop"]
        dev = self.dev
        thr = int(self.ctx.config["frontend"]["hamming_threshold"])
        kmat = np.asarray(self.k, np.float64)
        frames = torch.as_tensor(self.pool[rec["scene"]], device=dev)
        ref_f = self._features(frames)

        def stacked(feats):
            return (torch.as_tensor(np.stack([f.bits for f in feats]),
                                    device=dev),
                    torch.as_tensor(np.stack([f.mask for f in feats]),
                                    device=dev))

        bits, masks = stacked(ref_f)
        ref_counts = rl.match_counts(bits, masks, thr)
        # the pair grid: the program's counts, or the bfloat16 reference
        # frontend's in their place
        counts = (rl.match_counts(*stacked(self._features(
            frames, torch.bfloat16)), thr) if control
            else np.asarray(info["counts"]))
        got = {"loop_counts": int((counts != ref_counts).sum())}

        # candidates and the support gate
        lp = self.loop
        ref_cands = rl.select_candidates(ref_counts, lp["min_gap"],
                                         lp["min_matches"], lp["max_edges"])
        edges = [tuple(e) for e in info["loop_edges"]]
        prog_cands = set(edges) | {tuple(p) for p, _ in
                                   info["rejected_edges"]}

        def procrustes(i, j, **quantize):
            # rows: frame j's keypoints, columns frame i's; the rotation
            # takes frame j's bearings to frame i's
            rows, cols = rl.matches(bits[j], masks[j], bits[i], masks[i],
                                    thr)
            return rl.trimmed_procrustes(
                ref_f[j].xy[rows], ref_f[i].xy[cols], np.ones(len(rows)),
                kmat, **quantize)

        ref_fit = {p: procrustes(*p) for p in set(ref_cands) | prog_cands}
        gate = lp["min_matches"]
        ref_acc = {p for p in ref_cands if ref_fit[p][1] >= gate}
        near = {p for p in ref_fit
                if abs(ref_fit[p][1] - gate) <= SUPPORT_MARGIN}
        got["loop_edges"] = (len(prog_cands ^ set(ref_cands))
                             + len((set(edges) ^ ref_acc) - near))
        support = info.get("inliers", [])
        gaps = [abs(int(s) - ref_fit[e][1]) for e, s in zip(edges, support)]

        # each accepted edge's measured rotation (z_r = R_ji^T), where
        # float32 trims the matches as float64 does
        got["edge_rot_deg"] = 0.0
        meas = info.get("measurements", [])
        angles = []
        for e, (zr, _) in zip(edges, meas):
            z = (procrustes(*e, quantize=_bf16)[0].T if control
                 else zr.double().cpu().numpy())
            angles.append((rl.rotation_deg(z, ref_fit[e][0].T),
                           ref_fit[e][2]))
            if angles[-1][1] >= TRIM_MARGIN:
                got["edge_rot_deg"] = max(got["edge_rot_deg"],
                                          angles[-1][0])

        # the pose graph, at the program's measurements
        got["pg_cost_gap"] = got["pg_decrement"] = 0.0
        rs_pre = np.asarray(pre.rs, np.float64)
        ts_pre = np.asarray(pre.ts, np.float64)
        rs_post = np.asarray(res.rs, np.float64)
        ts_post = np.asarray(res.ts, np.float64)
        if edges and "cost" in info:
            graph = rl.chain_graph(
                rs_pre, ts_pre, edges,
                [zr.double().cpu().numpy() for zr, _ in meas],
                [zt.double().cpu().numpy() for _, zt in meas],
                loop_weight=LOOP_WEIGHT)
            c_pre = rl.cost(rs_pre, ts_pre, graph)
            c_post = rl.cost(rs_post, ts_post, graph)
            final = (info["cost"], info["initial_cost"])
            rs_at, ts_at = rs_post, ts_post
            if control:
                rs_at, ts_at = _bf16(rs_post), _bf16(ts_post)
                final = (rl.cost(rs_at, ts_at, graph), c_pre)
            scale = max(c_pre, 1e-300)
            got["pg_cost_gap"] = max(abs(final[0] - c_post),
                                     abs(final[1] - c_pre)) / scale
            got["pg_decrement"] = rl.gn_decrement(rs_at, ts_at, graph) / scale

        # the landmarks, re-triangulated under the corrected poses
        tb0, tb1 = pre.table, res.table
        obs = tb0.obs.double().cpu().numpy()
        seen = tb0.obs_mask.cpu().numpy()
        ref_pts, depths, cond = rl.dlt_nview(obs, seen, rs_post, ts_post,
                                             kmat)
        cfg = self.cfg
        inside = (depths > cfg.min_depth) & (depths < cfg.max_depth)
        held = tb0.has_point.cpu().numpy() & np.where(seen, inside,
                                                      True).all(0)
        pts = tb1.points.double().cpu().numpy()
        has = tb1.has_point.cpu().numpy()
        if control:
            pts = rl.dlt_nview(obs, seen, rs_post, ts_post, kmat,
                               quantize=_bf16)[0]
            has = held
        posed = cond < WELL_POSED
        held, has = held & posed, has & posed
        with np.errstate(divide="ignore", invalid="ignore"):
            gap = np.linalg.norm(
                rl.project(pts, rs_post, ts_post, kmat)
                - rl.project(ref_pts, rs_post, ts_post, kmat), axis=-1)
        # an observation of a track that one side holds and the other
        # dropped counts as an infinite gap
        gap = np.where(held & has, np.nan_to_num(gap, nan=np.inf),
                       np.inf)[seen & (held | has)]
        got.update(retri_gaps=gap,
                   well_posed=(int(held.sum()),
                               int(tb0.has_point.cpu().numpy().sum())),
                   ate_after=rg.ate(rl.centers(rs_post, ts_post),
                                    self.centers),
                   edges=len(edges), rejected=len(info["rejected_edges"]),
                   support_gap=max(gaps, default=0),
                   angles=angles)
        return got

