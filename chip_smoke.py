#!/usr/bin/env python3
"""Drive photogrammetry_tpu_torch's main path on one CUDA card.

    python3 chip_smoke.py

Phases, each printing one JSON line:
  1. device: the card's name, and ``nvidia-smi``'s name and power limit
     (also printed raw on a line of its own);
  2. build: every kernel in photogrammetry_tpu_torch/csrc, one nvcc each,
     all at once, with the build time and ptxas's register report;
  3. parity: each kernel against its plain PyTorch version on the card, at
     the main path's shapes (a rendered 1080x1920 frame, its 2048 keypoints
     and 256 BRIEF pairs, the 2048x2048 Hamming matrix) and at ragged ones;
     all outputs are integers and must be bit-exact;
  4. slice: frames 0 and 2 of a 1080x1920 star-scene pan through
     ``entry.forward`` with the kernels, launch counts set to 0 just before
     and read just after; then the same with the plain versions on the card
     under the same generator seed: keypoints, bits and matches identical,
     poses equal; >= 30 matches and rotation error < 5 deg against ground
     truth;
  5. timing: each kernel, its plain version and (for Hamming)
     ``torch.cdist(p=0)`` as device busy time per call (torch.profiler) and
     as CUDA-event time per call in a loop (host dispatch included), each
     beside its bound from the bytes moved and the operations done; the
     1080p frontend's frames/s and the two-view pair latency (host clock),
     with device busy time, idle share and top device ops.
Then the ``{"kernels": [...]}`` line and, last, the ok line.  Any failure
raises and exits non-zero before the ok line.  Needs one CUDA card; exits
2 without one.
"""
from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time

import numpy as np

# H100 SXM peaks (NVIDIA data sheet, at the 700 W limit)
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
# bench.py's 1080p frontend configuration and the two-view settings
FRAME_SHAPE = (1080, 1920)
FOCAL = 1560.0   # the 640-px scene's 520 scaled with the width
MAX_KEYPOINTS = 2048
TWO_VIEW = dict(threshold=1.5, num_samples=2000, h_samples=500,
                model="auto")


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def cuda_ms(fn, iters: int = 20, reps: int = 5) -> float:
    """Median over ``reps`` CUDA-event windows of ``iters`` calls, ms/call,
    after a warm-up."""
    import torch

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / iters)
    return statistics.median(times)


def host_ms(fn, reps: int = 5) -> float:
    """Median host-clock ms of ``fn`` ending in a device synchronize."""
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def device_profile(fn, iters: int = 10, top: int = 0):
    """Device busy time per call of ``fn`` (ms): the sum of the durations
    of every kernel and copy it puts on the card, from torch.profiler's
    CUDA activity over ``iters`` calls after a warm-up, and the ``top``
    device ops by time.  Host dispatch gaps are not in it."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    evts = [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA
            and e.self_device_time_total > 0]
    if not evts:
        raise RuntimeError("torch.profiler recorded no device activity")
    busy = sum(e.self_device_time_total for e in evts) / iters / 1e3
    evts.sort(key=lambda e: -e.self_device_time_total)
    ops = [dict(name=e.key[:90], ms=e.self_device_time_total / iters / 1e3,
                calls=e.count / iters) for e in evts[:top]]
    return busy, ops


def bound_ms(nbytes: float, ops: float) -> tuple[float, str]:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / FP32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def render_pair(i: int = 0, j: int = 2):
    from photogrammetry_tpu_torch.synth.star_scene import (
        StarSceneConfig, intrinsics, pan_trajectory, render_frame,
    )

    cfg = StarSceneConfig(image_size=FRAME_SHAPE, focal=FOCAL)
    rs, ts, _ = pan_trajectory(cfg)
    k = intrinsics(cfg)
    frames = [render_frame(cfg, rs[n], ts[n], k).astype(np.float32)
              for n in (i, j)]
    return frames, k, rs[j] @ rs[i].T


def max_err(a, b) -> float:
    """max |a - b| in float64 (int32 INT_INF entries must not wrap)."""
    if a.numel() == 0:
        return 0.0
    return float((a.double() - b.double()).abs().max().item())


def check_kernels(dev, frames, pairs, cfg):
    """Phase 3: each kernel against its plain version on ``dev``; returns
    the worst |kernel - plain| per kernel (0 for bit-exact)."""
    import torch

    from photogrammetry_tpu_torch.kernels import (
        brief_pack, fast_stencil, hamming,
    )
    from photogrammetry_tpu_torch.ops.fast import extract_keypoints

    gen = torch.Generator(device=dev).manual_seed(1)
    im = torch.as_tensor(frames[0], device=dev)
    errs = {}
    cases = []

    # FAST: the frame, a batch of both frames, a ragged noise frame
    noise = torch.randint(0, 256, (2, 333, 517), generator=gen, device=dev)
    for imgs, thr in ((im[None], cfg.detection_threshold),
                      (torch.stack([torch.as_tensor(f, device=dev)
                                    for f in frames]),
                       cfg.detection_threshold),
                      (noise.float().contiguous(), 37.5)):
        got = fast_stencil.fast_score_map_batch(imgs, thr)
        ref = fast_stencil.fast_score_map_plain(imgs, thr)
        e = max_err(got, ref)
        errs["fast_score"] = max(errs.get("fast_score", 0.0), e)
        cases.append(dict(kernel="fast_score", shape=list(imgs.shape),
                          corners=int((ref > 0).sum()), max_abs_err=e))

    # BRIEF: the frame's 2048 strongest keypoints, and ragged coords that
    # reach past every border
    score = fast_stencil.fast_score_map_plain(im, cfg.detection_threshold)
    pts = extract_keypoints(score, cfg.max_keypoints)
    coords = pts.coords
    h, w = im.shape
    ragged = torch.stack([
        torch.randint(-20, h + 20, (1999,), generator=gen, device=dev),
        torch.randint(-20, w + 20, (1999,), generator=gen, device=dev)],
        -1).to(torch.int32)
    for c in (coords, ragged):
        got = brief_pack.brief_bits(im, c, pairs)
        ref = brief_pack.brief_bits_plain(im, c, pairs)
        e = max_err(got, ref)
        errs["brief_bits"] = max(errs.get("brief_bits", 0.0), e)
        cases.append(dict(kernel="brief_bits", shape=[c.shape[0],
                                                      pairs.shape[0]],
                          ones=int(ref.sum()), max_abs_err=e))

    # Hamming: the frame's bits against themselves reversed, masked as the
    # frontend masks them, and ragged random bits
    bits = brief_pack.brief_bits_plain(im, coords, pairs)
    rb1 = torch.randint(0, 2, (2000, 256), generator=gen, device=dev)
    rb2 = torch.randint(0, 2, (1500, 256), generator=gen, device=dev)
    m1 = torch.rand(2000, generator=gen, device=dev) > 0.1
    m2 = torch.rand(1500, generator=gen, device=dev) > 0.1
    for a, b, ma, mb in ((bits, bits.flip(0).contiguous(), pts.mask,
                          pts.mask.flip(0)),
                         (rb1.to(torch.uint8), rb2.to(torch.uint8), m1, m2)):
        got = hamming.hamming_distance_matrix(a, b, ma, mb)
        ref = hamming.hamming_distance_matrix_plain(a, b, ma, mb)
        e = max_err(got, ref)
        errs["hamming"] = max(errs.get("hamming", 0.0), e)
        cases.append(dict(kernel="hamming", shape=[a.shape[0], b.shape[0]],
                          max_abs_err=e))
    if dev.type == "cuda":
        torch.cuda.synchronize()
    emit({"phase": "parity", "cases": cases,
          "exact": all(c["max_abs_err"] == 0 for c in cases)})
    bad = [c for c in cases if c["max_abs_err"] != 0]
    if bad:
        raise AssertionError(f"kernel disagrees with its plain version: {bad}")
    return errs


def drive_main_path(dev, frames, k, r_gt, pairs, cfg, counters):
    """Phase 4: the forward step with the kernels (launches counted) and
    with the plain versions, under the same generator seed."""
    import torch

    from photogrammetry_tpu_torch.entry import forward

    def run(plain):
        gen = torch.Generator(device=dev).manual_seed(0)
        return forward(frames[0], frames[1], pairs, k, cfg, generator=gen,
                       device=dev, plain=plain, **TWO_VIEW)

    for c in counters.values():
        c.launches = 0
    out = run(plain=False)
    launches = {name: c.launches for name, c in counters.items()}
    ref = run(plain=True)
    if dev.type == "cuda":
        torch.cuda.synchronize()

    for f_got, f_ref in ((out.frame1, ref.frame1), (out.frame2, ref.frame2)):
        for a, b in zip(f_got.points, f_ref.points):
            if not torch.equal(a, b):
                raise AssertionError("keypoints differ kernel vs plain")
        if not torch.equal(f_got.bits, f_ref.bits):
            raise AssertionError("BRIEF bits differ kernel vs plain")
        if not torch.equal(f_got.xy, f_ref.xy):
            raise AssertionError("refined xy differ kernel vs plain")
    for a, b in zip(out.match, ref.match):
        if not torch.equal(a, b):
            raise AssertionError("matches differ kernel vs plain")
    tv, tv_ref = out.two_view, ref.two_view
    pose_diff = max(max_err(tv.r, tv_ref.r), max_err(tv.t, tv_ref.t))
    if pose_diff > 1e-6:
        raise AssertionError(f"poses differ kernel vs plain by {pose_diff}")

    r = tv.r.double().cpu().numpy()
    cos = (np.trace(r @ r_gt.T) - 1) / 2
    rot_err = float(np.degrees(np.arccos(np.clip(cos, -1, 1))))
    num = int(out.match.num)
    result = {"phase": "slice", "frame_shape": list(FRAME_SHAPE),
              "keypoints": [int(out.frame1.points.count),
                            int(out.frame2.points.count)],
              "matches": num, "num_inliers": int(tv.num_inliers),
              "used_homography": bool(tv.used_homography),
              "rotation_error_deg": rot_err,
              "pose_max_abs_diff_kernel_vs_plain": pose_diff,
              "finite_points": bool(torch.isfinite(tv.points).all()),
              "launches": launches}
    emit(result)
    if num < 30 or rot_err >= 5.0 or not result["finite_points"]:
        raise AssertionError(f"slice out of bounds: {result}")
    missing = [n for n, v in launches.items() if v < 1]
    if missing:
        raise AssertionError(f"kernels not launched on the main path: "
                             f"{missing}")
    return out, launches


def time_all(dev, frames, k, pairs, cfg, out):
    """Phase 5: kernel, plain and library times with their bounds; the
    frontend's frames/s and the pair latency."""
    import torch

    from photogrammetry_tpu_torch.entry import forward
    from photogrammetry_tpu_torch.kernels import (
        brief_pack, fast_stencil, hamming,
    )
    from photogrammetry_tpu_torch.sfm.frontend import detect_and_describe

    im = torch.as_tensor(frames[0], device=dev)
    batch = im[None]
    h, w = im.shape
    f1, f2 = out.frame1, out.frame2
    coords = f1.points.coords
    n, p = coords.shape[0], pairs.shape[0]
    b1, b2 = f1.bits, f2.bits
    m1, m2 = f1.points.mask, f2.points.mask
    thr = cfg.detection_threshold

    # distinct pixels the BRIEF pairs of this run touch (in-bounds ends)
    ends = coords[:, None, None, :].long() + pairs[None].long()
    inb = ((ends >= 0) & (ends < torch.tensor([h, w], device=dev))).all(-1)
    touched = int(torch.unique((ends[..., 0] * w + ends[..., 1])[inb])
                  .numel())
    n1, n2 = b1.shape[0], b2.shape[0]
    words = p // 32
    rows = {
        "fast_score": dict(
            run=lambda: fast_stencil.fast_score_map_batch(batch, thr),
            plain=lambda: fast_stencil.fast_score_map_plain(batch, thr),
            library=None,
            # one f32 read + one int32 write per pixel; 130 ops per pixel
            # (2 band edges, 16 x 2 compares, 32 x 3 run-recurrence steps)
            bytes=h * w * 8, ops=h * w * 130),
        "brief_bits": dict(
            run=lambda: brief_pack.brief_bits(im, coords, pairs),
            plain=lambda: brief_pack.brief_bits_plain(im, coords, pairs),
            library=None,
            bytes=4 * touched + coords.numel() * 4 + pairs.numel() * 4
            + n * p, ops=n * p * 12),
        "hamming": dict(
            run=lambda: hamming.hamming_distance_matrix(b1, b2, m1, m2),
            plain=lambda: hamming.hamming_distance_matrix_plain(b1, b2, m1,
                                                                m2),
            library=lambda: torch.cdist(b1.float(), b2.float(), p=0),
            bytes=(n1 + n2) * p + n1 + n2 + n1 * n2 * 4,
            ops=n1 * n2 * words * 3),
    }
    # ms / plain_ms / library_ms: device busy time per call (profiler);
    # *_call_ms: CUDA-event time per call in a back-to-back loop, which
    # includes the host's dispatch gaps when they outlast the device work
    timings = {}
    for name, row in rows.items():
        b_ms, b_by = bound_ms(row["bytes"], row["ops"])
        t = dict(bound_ms=b_ms, bound_by=b_by, bytes=row["bytes"],
                 ops=row["ops"], library_ms=None, library_call_ms=None)
        for key in ("run", "plain", "library"):
            if row[key] is None:
                continue
            pre = {"run": "", "plain": "plain_", "library": "library_"}[key]
            t[pre + "ms"] = device_profile(row[key])[0]
            t[pre + "call_ms"] = cuda_ms(row[key])
        timings[name] = t
    emit({"phase": "timing", "kernels": timings,
          "brief_distinct_pixels": touched})

    ims = [torch.as_tensor(f, device=dev) for f in frames]
    k_dev = torch.as_tensor(k, device=dev)

    def frontend(plain):
        return lambda: detect_and_describe(ims[0], pairs, cfg, plain=plain)

    def pair():
        gen = torch.Generator(device=dev).manual_seed(0)
        return forward(ims[0], ims[1], pairs, k_dev, cfg, generator=gen,
                       device=dev, **TWO_VIEW)

    result = {"phase": "end_to_end"}
    for label, fn, reps in (("frontend", frontend(False), 10),
                            ("frontend_plain", frontend(True), 10),
                            ("two_view_pair", pair, 5)):
        wall = host_ms(fn, reps=reps)
        busy, top = device_profile(fn, iters=3, top=8)
        result[label] = dict(wall_ms=wall, device_busy_ms=busy,
                             device_idle_share=max(0.0, 1 - busy / wall),
                             top_device_ops=top)
    result["frontend_frames_per_s"] = 1e3 / result["frontend"]["wall_ms"]
    emit(result)
    return timings


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 2
    from photogrammetry_tpu_torch.kernels import (
        _build, brief_pack, fast_stencil, hamming,
    )
    from photogrammetry_tpu_torch.sfm.frontend import (
        FrontendConfig, make_pairs,
    )

    dev = torch.device("cuda", 0)
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    emit({"phase": "device", "name": name, "nvidia_smi": smi,
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda})

    t0 = time.perf_counter()
    logs = _build.build_all()
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "ptxas": {n: [ln.strip() for ln in log.splitlines()
                        if "registers" in ln or "spill" in ln]
                    for n, log in logs.items()}})

    t0 = time.perf_counter()
    frames, k, r_gt = render_pair()
    emit({"phase": "render", "seconds": time.perf_counter() - t0,
          "shape": list(frames[0].shape)})

    cfg = FrontendConfig(detection_threshold=50.0,
                         max_keypoints=MAX_KEYPOINTS, reduction="nms",
                         suppression_radius=4.0)
    pairs = make_pairs(cfg, device=dev)
    errs = check_kernels(dev, frames, pairs, cfg)

    modules = {"fast_score": fast_stencil, "brief_bits": brief_pack,
               "hamming": hamming}
    counters = {"fast_score": fast_stencil.fast_score_map_batch,
                "brief_bits": brief_pack.brief_bits,
                "hamming": hamming.hamming_distance_matrix}
    out, launches = drive_main_path(dev, frames, k, r_gt, pairs, cfg,
                                    counters)
    timings = time_all(dev, frames, k, pairs, cfg, out)

    emit({"kernels": [
        dict(name=n, route="cuda", source=modules[n].SOURCE,
             replaces=modules[n].REPLACES, launches=launches[n],
             max_abs_err=errs[n], ms=timings[n]["ms"],
             plain_ms=timings[n]["plain_ms"],
             bound_ms=timings[n]["bound_ms"],
             bound_by=timings[n]["bound_by"],
             library_ms=timings[n]["library_ms"], parity_ok=errs[n] == 0,
             call_ms=timings[n]["call_ms"],
             plain_call_ms=timings[n]["plain_call_ms"],
             library_call_ms=timings[n]["library_call_ms"])
        for n in counters]})
    emit({"ok": True, "device": {"platform": "gpu", "kind": name,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
