#!/usr/bin/env python3
"""Drive photogrammetry_tpu_torch's main path on one CUDA card.

    python3 chip_smoke.py

Phases, each printing one JSON line with its seconds:
  1. device: the card's name, and ``nvidia-smi``'s name and power limit
     (also printed raw on a line of its own);
  2. build: every kernel in photogrammetry_tpu_torch/csrc, one nvcc each,
     all at once, with the build time and ptxas's register report;
  3. render: the 12-frame star-scene pan at 1080x1920, focal 1560,
     rendered once in a process pool (the two-view slice takes its frames
     0 and 2, the SfM phase all 12);
  4. parity: FAST, BRIEF and Hamming against their plain PyTorch versions
     on the card, at the two-view slice's shapes (a rendered frame, its
     2048 keypoints and 256 BRIEF pairs, the 2048x2048 Hamming matrix),
     at the pyramid's (FAST and BRIEF on the 12 frames' 540x960 and
     270x480 octaves, Hamming at 1024 x 1024 between two frames' merged
     octaves) and at ragged ones; all outputs are integers and must be
     bit-exact.
     FAST also on the 12 frames, 13 noise frames, images smaller than the
     7-px stencil, widths that are not a multiple of 4, a constant image,
     an isolated peak (a ring wholly outside: score 16) and a quantised
     image whose ring values sit on the band edges; BRIEF also on keypoints
     past and on every border, at 48 and 1024 pairs, on the 12 frames in
     one call (512 keypoints a frame, masks ragged), steered by the
     keypoints' own angles and by (cos, sin) that put rotated offsets on
     rint ties, at 1, 8, 16 and 64 keypoints a block; Hamming at every N
     of 1, 17, 129, 512 and 2049 and P of 32, 48, 96, 256, 512, 544 and
     1024, with all rows masked, with operands at an odd byte offset, and
     on a side stream;
  5. schur_parity: the Schur kernel against its plain einsums at the
     SfM path's F=12/T=1024, bench_all.py's F=16/T=4096, a ragged
     F=5/T=700, the submap path's global BA at F=23/T=4096 and one shape
     for each branch of the kernel (one camera, a
     ragged camera tile, one landmark, none, odd T, a ragged last tile;
     operands at an odd offset into a larger allocation; a side stream):
     every element within 3T * 2^-23 * (|A| |B|^T), the worst-case f32
     bound of a 3T-term sum, and the same bits twice;
     remap_parity: the remap kernel against its plain version, bit-exact,
     on a 1080x1920 float32 frame through the reference-coefficient
     distortion map, on that frame as (1080, 1920, 3) uint8, on the 12
     stacked frames, and on ragged batches of 1 to 5 channels in both
     types through maps larger and smaller than the source that fold and
     have entries far outside and non-finite, whole and in frame chunks
     that do not divide the batch; and ``make_distortion_applier`` on
     int16, int32 and float64 frames (through the f32 kernel and back)
     equal to the plain applier;
  6. slice: the two frames through ``entry.forward`` with the kernels,
     launch counts set to 0 just before and read just after (BRIEF: two,
     one a frame); then the
     same with the plain versions on the card under the same generator
     seed: keypoints, bits and matches identical, poses equal; >= 30
     matches and rotation error < 5 deg against ground truth;
  7. sfm: ``run_incremental_sfm_robust(restarts=3)`` (``run_sfm
     --restarts 3``'s configuration) on the 12 frames at SFM_SEED with
     the kernels,
     launch counts set to 0 just before and read just after (every one of
     the four kernels must have launched; BRIEF three times, once a restart
     for all 12 frames), then with ``plain=True`` under
     the same seed; the batched frontend's features identical kernel vs
     plain; ATE < 0.2 scene units and > 80 landmarks in both runs (the
     bounds of tests/test_incremental.py); the largest camera-center
     difference between the two runs is printed, not gated;
     precompute: the same robust run with ``precompute_matching`` (every
     (t, t-1) and (t, t-2) pair matched a chunk of 16 pairs a launch of
     the batched Hamming entry: two launches a restart, the single-pair
     entry none), launches counted, then with ``plain=True``: 12 poses,
     > 80 landmarks, ATE < PRECOMPUTE_ATE_MAX (what the JAX package meets
     with the flag at SFM_SEED, printed beside); ``precompute_matching``
     kernel vs plain bit-identical at K = 512 and, on the two-octave
     pyramid's features, K = 1024; the batched entry at Q = 16 and the
     tail's Q = 5 (graph replay, call, plain, batched ``cdist(p=0)``,
     bound on the bits and masks of the frames the chunk reads);
     fused: single ``run_incremental_sfm`` runs at SFM_SEED, diagnostics
     off: the staged loop twice and once more in a spawned process,
     ``fused_steady_steps=True`` (its first steady frame the warm-up, the
     capture, then CUDA-graph replays), ``run_incremental_sfm_fused``
     (the same capture) and ``read_free`` with ``export=False`` and
     ``export_sfm_result``: all five bit-identical to the first staged
     run (rs, ts, landmarks, costs), the read-free run a
     ``DeviceSfmResult`` on the card bootstrapping at
     min(bootstrap_max_defer, F-1) with ATE < 0.2 and > 80 landmarks; the
     capture's graph segments and cuts a steady frame, the
     synchronisations of one replayed frame, warm-up and capture ms;
  8. dewarp_sfm: the lens-dewarp path at full width.  The 12 frames are
     barrel-distorted once with the synthetic map at the reference
     coefficients (what that camera would have captured), then go through
     ``run_sfm``'s ``dewarp_frames`` (the map from ``DistortionMapCache``
     in a temporary directory, one stacked launch of the remap kernel) and
     ``run_incremental_sfm_robust(restarts=3)`` at DEWARP_SEED, launch
     counts set to 0 just before and read just after (all five kernels
     must have launched, BRIEF three times); then the same with
     ``plain=True``: the dewarped
     frames bit-equal, the frontend's features identical, the dewarped
     interior within DEWARP_MEAN_TOL / DEWARP_P99_TOL grey levels of the
     clean frames, 12 camera centers, ATE < 0.2 and > 80 landmarks in both
     runs;
  9. pipeline_demo: ``cli.pipeline_demo.build_pipeline``'s dewarp ->
     grayscale -> detect -> nms -> draw stages over the content store on a
     uint8 RGB rendering of one frame (the read and write stages need an
     image library and are left out), launches counted, kernel vs
     ``plain=True`` keypoints identical;
     steered: a 1080x1920 texture of smoothed noise and the same rotated
     by 30 degrees through the frontend with ``oriented_brief`` (kernel
     bits equal plain bits, BRIEF launched once a frame); its correct
     mutual-nearest matches at least twice plain BRIEF's and at least 20;
     one ``run_sfm --oriented-brief --restarts 3`` on its 12-frame
     synthetic pan (BRIEF three launches), ATE and landmarks reported, not
     gated;
     loop_parity: the Hamming kernel's batched entry (a frame pair a
     ``blockIdx.z``) against its plain version, bit for bit, at every Q of
     1, 7, 529 pairs, K of 1, 17, 512, 513 keypoints and P of 48, 256,
     1024 bits, masks ragged, pairs repeating a frame; the chunked
     ``pairwise_match_counts`` against its plain path at F = 23 and 64,
     one launch a chunk;
     loop_closure: the pan traversed out and back (23 frames, frame j the
     same as frame 22 - j) through one ``run_incremental_sfm`` and
     ``close_loops`` in 'revisit' and 'rotation' mode (min gap 5), launches
     counted over the whole path (FAST, BRIEF, Hamming, Schur, the batched
     Hamming once a chunk a pass), then both modes with the plain versions
     on the same features and trajectory, and both modes on CPU copies of
     them (the CPU path the tests hold to the JAX package): the count
     matrices and edges equal, every fold pair's count equal to its
     diagonal, every accepted edge a fold pair, the pose-graph cost not
     risen, the card's poses within 1e-4 of the plain run's, its final
     cost within LOOP_CPU_COST_SHARE of the initial cost of the CPU run's
     and its poses within LOOP_CPU_POSE_SHARE of the CPU run's
     correction; ATE before and
     after, after < 0.2 (LOOP_SEED, from a seed sweep); one ``run_sfm
     --loop-closure --loop-mode revisit`` on a frames directory of the 23;
     checkpoint: ``run_incremental_sfm(checkpoint_path, checkpoint_every=4)``
     on the 12 frames, the snapshot reloaded equal to the run's state, and
     a run resumed from a snapshot cut at frame 7 within the SfM gate that
     runs frames 8-11 and no other;
     frontend_clis: the reference's two-image tools at its photo size:
     frames 0 and 2 of the pan at 3000x4000 (rendered in a spawn pool of
     two from the start of the script) as PNG files through the ``main``
     of ``detect_features``, ``cluster_features`` (grid and ``--exact``),
     ``match_keypoints`` (cluster reduction), ``estimate_pose`` (``nms
     --motion-filter``, ``anms``, ``--pyramid-octaves 2``) and
     ``image_editing``, each timed by the host clock, launches counted
     per CLI (FAST, BRIEF, Hamming as each path needs them); estimate_pose
     within POSE_MAX_DEG of the true rotation, >= POSE_MIN_MATCHES
     matches, > POSE_MIN_POINTS cloud points; each CLI's device work again
     with the kernels and ``plain=True`` (score maps, keypoints, grid
     clusters, bits, matches, motion mask equal); the grid cluster step
     alone, and FAST, BRIEF and Hamming at this path's shapes;
     timing_shapes: FAST on the 540x960 octave (B = 12), BRIEF there at
     the keypoints the pyramid path detects on it (beside its gather
     floor), Hamming at the pyramid's 1024 x 1024, Schur at the global
     BA's F = 23, T = 4096 beside the cuBLAS pair, by CUDA-graph replay
     and CUDA events (no profiler session), with their bounds;
 10. timing: each kernel, its plain version and, where one exists, one
     PyTorch call computing the same function (Hamming: ``cdist(p=0)``,
     at the forward path's 2048x2048 and the SfM path's 512x512;
     Schur: two matmuls on operands already flattened to (6F, 3T); remap:
     ``grid_sample`` on a grid normalised beforehand and, for uint8, an
     image converted to float beforehand), as
     device busy time per call (torch.profiler) and as CUDA-event time per
     call in a loop (host dispatch included), each beside its bound from
     the bytes moved and the operations done (inputs hot in the L2 where
     they fit; every kernel also by CUDA-graph replay (``graph_ms``),
     which stands in for the profiler's time where the profiler has run
     dry; the remap rows also single calls after the L2 was
     overwritten; the Schur rows also device time per call by CUDA-graph
     replay at several numbers of landmark slabs, beside a launch of an
     empty kernel; FAST also batched at B=12; BRIEF at the forward path's
     2048 x 256 and the SfM path's 12 x 512 x 256, each beside its gather
     floor, ``gather_probe``'s graph_ms), with the device ops of one kernel
     call (Hamming, BRIEF and the SfM path's describe stage must each be a
     single launch); the 1080p frontend's
     frames/s and the two-view pair latency; ``bundle_adjust`` at F=16,
     T=4096, 10 iterations (bench_all.py's problem) in iterations/s with
     the kernel and plain; one 12-frame ``run_incremental_sfm`` after a
     warm-up (whose launches are counted: BRIEF once): frames/s from its
     wall time, device busy time, idle share and top device ops; the remap kernel at its three 1080p shapes, map
     generation, ``dewarp_frames`` on the 12 frames, and one dewarp + SfM
     run's frames/s, busy time and idle share; timing_loop: the batched
     Hamming kernel over the pair grid of F = 23 and 64 frames of 512
     keypoints (device ms by graph replay, call ms, bound, plain and
     batched ``cdist(p=0)`` CUDA-event ms), and the wall, busy and idle
     share of ``close_loops`` at F = 23 and of ``optimize_pose_graph``
     alone;
     distributed: the distributed layer in spawned processes (the main
     process's profiler and CUDA state stay clean).  A world of one NCCL
     rank: ``distributed_bundle_adjust`` on the timing_ba problem (F=16,
     T=4096, 10 iterations) with the kernel and ``plain=True`` beside
     ``bundle_adjust`` (Schur once an iteration, iterations/s median of 5
     in turns), ``distributed_optimize_pose_graph`` dense on the loop
     phase's graph beside ``optimize_pose_graph``, CG at DIST_CG_NODES
     nodes on the card and on the CPU, the robust SfM with
     ``SfmConfig.mesh`` at SFM_SEED (ATE beside the sfm phase's) and one
     ``run_sfm --mesh 1 --restarts 3`` on the frames as files (launches
     counted: ``launches_distributed``); a world of DIST_WORLD gloo ranks
     on the one card: the same BA (Schur at F16/T2048 a shard), the ranks
     bit-identical, within DIST_COST_RTOL / DIST_POSE_ATOL of
     ``bundle_adjust``, the kernel within its f32 bound of its plain
     version on a shard's operands, iterations/s, and Schur at the shard
     shape timed (graph replay, call, plain, the cuBLAS pair, bound);
 11. keyframes: ``run_keyframed_sfm(restarts=3)`` on the 12 frames at
     KF_DISP_PX (4-8 keyframes) and KF_SEED, launches counted; keyframe
     selection kernel vs plain (the same list and features), localization
     kernel vs plain on the run's map (the same path a frame, poses within
     1e-4); every frame posed, ATE of the trajectory and of the keyframe
     map and fallbacks, reported (no seed of the sweep behind KF_SEED
     meets ATE < 0.2); one ``run_sfm --keyframe-disp`` on the
     frames as files; one keyframed run's frames/s (an unprofiled call),
     busy time and idle share (a profiled one);
     pyramid: ``run_incremental_sfm_robust(restarts=3)`` with
     ``pyramid_octaves=2`` (track capacity 2048) on the 12 frames,
     launches counted (FAST and BRIEF once an octave a restart), its
     features kernel vs plain bit for bit, ATE < 0.2 and > 80 landmarks
     (reported beside the single-scale sfm phase's); one run's frames/s
     (an unprofiled call), busy time and idle share (a profiled one);
     submaps: ``run_sfm --submap-frames 12 --submap-overlap 4
     --loop-closure --loop-mode revisit --loop-min-gap 5`` on the 23
     out-and-back frames as files (spans (0, 12), (8, 20), (16, 23)),
     launches counted, its frames/s from that (unprofiled) call; spans,
     tracks, drops, the restarts each window took, each window's ATE and
     the stitched one, loop edges (all fold pairs), 23 poses, ATE before
     and after the cross-seam refine; then that refine on the run's
     merged tracks and loop links under the ground-truth trajectory, with
     the kernels (profiled: its busy time and idle share) and with the
     plain versions (more than SUBMAP_REFINE_MIN_LANDMARKS landmarks,
     poses within SUBMAP_REFINE_POSE_SHARE of its correction);
     timing_modes: one ``run_incremental_sfm`` at SFM_SEED staged
     (``precompute_matching`` off), with it on, with
     ``fused_steady_steps`` and through ``run_incremental_sfm_fused``
     (scan): wall and wrapper launches (unprofiled; on: the batched entry
     2, the single-pair entry 0; off: 0 and 21), busy, idle share and
     each kernel's launches by name from one profiler session over the
     four in turn (timing_precompute and timing_fused lines; the fused
     and scan runs' Hamming and Schur launches, inside the graphs, equal
     the staged run's).  These four come last: nothing reads the
     profiler after them.
Then the ``{"kernels": [...]}`` line (each kernel's launches on every
path, ``launches_loop`` on the loop-closure phase, ``launches_keyframes``,
``launches_submaps`` and ``launches_pyramid`` on the new ones, each of
FAST, BRIEF, Hamming and Schur > 0 there; ``launches_frontend_clis``,
FAST, BRIEF and Hamming > 0 there; ``launches_distributed``, each of
FAST, BRIEF, Hamming and Schur > 0 on ``run_sfm --mesh 1``, and Schur's
row at the shard shape as ``distributed_shape``; the row at the new shape as
``new_shape``, at the CLIs' as ``cli_shape``; Hamming's batched entry
as its ``batched`` row and, with its precompute-path launches and its
times at Q = 16, K = 512, as a row of its own, ``hamming_pairs``;
``launches_precompute`` on every row; ``launches_fused``, the fused
run's launches from the trace, on every row) and, last, the ok line.  Any failure
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
INT8_OPS_PER_S = 1979e12     # dense, tensor cores
# bench.py's 1080p frontend configuration and the two-view settings
FRAME_SHAPE = (1080, 1920)
FOCAL = 1560.0   # the 640-px scene's 520 scaled with the width
MAX_KEYPOINTS = 2048
TWO_VIEW = dict(threshold=1.5, num_samples=2000, h_samples=500,
                model="auto")
SFM_FRAMES = 12     # the pan; the two-view slice takes its frames 0 and 2
# The RANSAC seed of the SfM phase.  At 1080p this pan bootstraps from ~12
# landmarks and can land in a bad basin.  Under the BRIEF pair table JAX
# draws (the port's own table since it draws JAX's; the seeds were first
# chosen under a table drawn from a torch generator), best of 3, seeds 0-5
# (cli/sweep_sfm_seeds.py --frames 12 --size 1080 1920 --focal 1560
# --seeds 6 --restarts 3, NVIDIA H100 80GB HBM3 at 700 W): ATE 0.154,
# 0.0104, 0.076, 0.044, 0.096, 0.028 with 146-175 landmarks, all six in
# bounds; seed 1 with the most margin.
SFM_SEED = 1
# The lens of the dewarp phases: the reference's coefficients k1..k5
DEWARP_COEFFS = [3e-4, 1e-7, 0.0, 0.0, 0.0]
# The RANSAC seed of the dewarp_sfm phase, chosen as SFM_SEED was.  Seeds
# 0-5 under JAX's pair table (cli/sweep_sfm_seeds.py --frames 12 --size
# 1080 1920 --focal 1560 --seeds 6 --restarts 3 --distortion-coeffs 3e-4
# 1e-7 0 0 0, NVIDIA H100 80GB HBM3 at 700 W): all six met both bounds
# (ATE 0.0108-0.078, 120-143 landmarks; seed 1: 0.059), so the phase
# keeps the SfM phase's seed.
DEWARP_SEED = 1
# Grey-level bounds on |dewarped - clean| over the interior (40 px in from
# every border): the frame is resampled twice (the synthetic capture shrinks
# it by up to 1.45x toward the corners, the dewarp expands it again), so the
# star's edges blur (hundreds of pixels are off by up to half the grey
# range) while the mean and the 99th percentile stay small: 0.36 and 0.79
# on a frame of this pan, against 16.5 for the captured frame.
DEWARP_MEAN_TOL = 1.0
DEWARP_P99_TOL = 4.0
# (F cameras, T landmarks): the SfM path's window and track capacity,
# bench_all.py's BA problem, and a ragged shape
SCHUR_SHAPES = ((12, 1024), (16, 4096), (5, 700))
# parity shapes beyond those, one for each branch of the kernel: one
# camera, a ragged camera tile, one landmark (fewer than any split), no
# landmark, an odd T (camera rows that start 8-byte aligned only), a
# slab with a ragged last tile; and the submap path's cross-seam global
# BA (23 frames, refine_submaps_global's 4096 merged tracks)
SCHUR_PARITY_SHAPES = SCHUR_SHAPES + ((1, 1024), (17, 701), (12, 1), (3, 0),
                                      (16, 701), (6, 2000), (23, 4096))
# where the operands are also taken at an odd offset into a larger
# allocation (4-byte aligned rows) and on a side stream
SCHUR_OFFSET_SHAPES = ((12, 1024), (17, 701))
# Hamming parity: (N1, N2) at every N of 1, 17, 129, 512 and 2049 (one
# row, ragged tiles, the SfM shape, a ragged last tile of the largest
# tile; odd and even N2), each at every P
HAMMING_PARITY_SHAPES = ((1, 1), (17, 129), (129, 17), (512, 512),
                         (2049, 2049), (1, 2049))
# every P: one 512-column pass, a zero-filled tail (P % 32 != 0), byte
# staging (P % 16 != 0), more than one pass
HAMMING_PARITY_BITS = (32, 48, 96, 256, 512, 544, 1024)
# BRIEF parity: pair counts beside the frontend's 256 (P % 32 != 0; four
# times the default)
BRIEF_PARITY_PAIRS = (48, 1024)
# the steered-BRIEF phase: a 1080x1920 texture of noise smoothed at 3 and
# 12 px and the same rotated by STEER_DEGREES about its centre; FAST at
# threshold 8 (the texture's corners are shallow); a match is correct
# within STEER_PX of where the rotation puts the keypoint
STEER_DEGREES = 30.0
STEER_THRESHOLD = 8.0
STEER_PX = 2.0
# the SfM path's matrix: SfmConfig.max_keypoints rows a frame
SFM_KEYPOINTS = 512
# loop_parity: the batched Hamming kernel at every Q pairs (one, ragged,
# F = 23's grid), K keypoints (one, ragged tiles, the SfM shape, a ragged
# last tile) and P bits (byte staging with a zero-filled tail, one pass,
# two passes), then the chunked pair grid at F = 23 and 64
LOOP_PARITY_PAIRS = (1, 7, 529)
LOOP_PARITY_KEYPOINTS = (1, 17, 512, 513)
LOOP_PARITY_BITS = (48, 256, 1024)
LOOP_GRID_FRAMES = (23, 64)
# the loop-closure phase: the 12-frame pan traversed out and back (23
# frames, frame j the same as frame 22 - j), candidates at least
# LOOP_MIN_GAP frames apart (run_sfm's default max(5, F // 4) at F = 23)
LOOP_MIN_GAP = 5
# The RANSAC seed of the loop phase's SfM run, whose ATE after loop
# closure is gated (< 0.2).  Seeds 0-5 under JAX's pair table
# (cli/sweep_sfm_seeds.py --frames 12 --size 1080 1920 --focal 1560
# --seeds 6 --out-and-back --loop-mode revisit, NVIDIA H100 80GB HBM3 at
# 700 W): ATE before / after revisit closure 0.148 / 0.148, 0.604 /
# 0.314, 0.487 / 0.207, 0.132 / 0.136, 0.129 / 0.129, 0.506 / 0.210;
# seeds 0, 3 and 4 hold the gate, seed 4 with the most margin (the seed
# chosen under the earlier table, where it read 0.0126 / 0.0122).
LOOP_SEED = 4
# The card's close_loops against the CPU's on copies of the same inputs.
# Poses are not held to an absolute tolerance: the revisit graph's minimum
# is flat, and float32 alone moves it by 1e-4-4e-4 (experiments/
# loop_closure_f32/run.py, NVIDIA H100 80GB HBM3 at 700 W: a 1e-7 nudge of
# the CPU's input poses moves its result by 1.5e-4, CPU float32 lies
# 9.1e-5 from float64 and the card 3.5e-4, the correction being 0.065;
# on one graph the costs agree to 6e-5 of themselves).  Nor is the final
# cost held to itself: the edge measurements differ by float32 rounding
# too (1.7e-5 in rotation mode), which moved a final cost of 9.0e-6 by
# 0.13%.  So the final costs must agree to LOOP_CPU_COST_SHARE of the
# initial cost, and the poses to LOOP_CPU_POSE_SHARE of the correction
# the CPU run applied: a fault in the card's optimiser moves them by the
# order of the reduction and of the correction themselves.
LOOP_CPU_COST_SHARE = 1e-3
LOOP_CPU_POSE_SHARE = 0.05
# the pyramid phase: run_sfm --pyramid-octaves 2 (its track capacity 1024 x
# octaves) on the 12-frame pan; the kernels' parity at each octave below
# the frame down to PARITY_OCTAVES (540x960, 270x480)
PYRAMID_OCTAVES = 2
PARITY_OCTAVES = 2
# The keyframes phase: the median-displacement gate (px) of run_sfm
# --keyframe-disp and the RANSAC seed of its best-of-3 SfM.  Gates of 40,
# 60 and 80 px keep 4-5 of the 12 frames, 30 px five ([0, 3, 6, 9, 11])
# and 20 px six ([0, 2, 5, 7, 9, 11]), with the fewest fallbacks (none)
# and the lowest mean ATE: 0.446 over seeds 0-5 (cli/sweep_sfm_seeds.py
# --frames 12 --size 1080 1920 --focal 1560 --seeds 6 --restarts 3
# --keyframe-disp 20, NVIDIA H100 80GB HBM3 at 700 W; 30 px 0.486, 40 px
# 0.503), under the earlier torch-generator pair table.  Only seed 3 of
# six met ATE < 0.2 then (0.115); under JAX's table at 20 px none does
# (0.565-0.736, mean 0.666, keyframes [0, 3, 5, 7, 10, 11] at every
# seed, 0-2 fallbacks, 60-76 landmarks): keyframing a pan whose frames are already
# well spaced leaves a thin map (against the full run's ~155), as the
# JAX package's sfm/keyframes.py says of such sequences.  So the phase
# reports the ATE and does not gate it, and keeps the SfM phase's seed.
# The precompute phase's SfM gate.  With precompute_matching every pair's
# RANSAC gate draws from its own generator, so the run at SFM_SEED takes
# other draws than the sfm phase's, and the flag costs accuracy in both
# packages.  run_incremental_sfm_robust(restarts=3, precompute_matching=
# True) on these frames, seeds 0-5: the JAX package on the CPU
# (experiments/precompute_seeds/run.py) ATE 0.090, 0.266, 0.065, 0.101,
# 0.074, 0.228 (without the flag at most 0.144); the port on an NVIDIA
# H100 80GB HBM3 at 700 W (cli/sweep_sfm_seeds.py --frames 12 --size 1080
# 1920 --focal 1560 --seeds 6 --restarts 3 --precompute-matching) 0.017,
# 0.332, 0.011, 0.408, 0.120, 0.024 with the kernels and 0.018, 0.172,
# 0.083, 0.242, 0.025, 0.024 with --plain, 101-158 landmarks.  SFM_SEED
# is JAX's worst seed under the flag: the phase holds the port to JAX's
# reading there with a margin of half, 12 poses, > 80 landmarks and an
# ATE under 1.5 x 0.266, and prints JAX's reading beside.
PRECOMPUTE_JAX_ATE = 0.266
PRECOMPUTE_ATE_MAX = 1.5 * PRECOMPUTE_JAX_ATE
KF_DISP_PX = 20.0
KF_SEED = SFM_SEED
# the submaps phase: run_sfm --submap-frames 12 --submap-overlap 4 on the
# 23-frame out-and-back pan (spans (0, 12), (8, 20), (16, 23))
SUBMAP_FRAMES = 12
SUBMAP_OVERLAP = 4
# refine_submaps_global with the kernels against its plain run on the
# same inputs (the run's merged tracks and loop links under the
# ground-truth trajectory): poses within this share of the correction the
# plain refine applied to its input poses.  Not an absolute tolerance: the
# Schur kernel's f32 sums differ from the plain einsums' in the last bits,
# and 2 x 30 LM iterations carry that into the poses (measured 2.0e-4
# against a correction of 1.4e-2, 1.4% of it, on NVIDIA H100 80GB HBM3 at
# 700 W); a fault in the kernel would move them by the order of the
# correction itself, as LOOP_CPU_POSE_SHARE argues.  The refine must keep
# more than SUBMAP_REFINE_MIN_LANDMARKS landmarks (the SfM runs' gate,
# tests/test_incremental.py), so that the check covers a real BA.
SUBMAP_REFINE_POSE_SHARE = 0.05
SUBMAP_REFINE_MIN_LANDMARKS = 80
# the frontend_clis phase: the reference's photo size (its lego pair is
# 3000x4000), frames 0 and 2 of the 12-frame pan at focal 3250 (the 640-px
# scene's 520 scaled with the width), rendered in the background while the
# earlier phases run; estimate_pose held to the slice's gates
CLI_SHAPE = (3000, 4000)
CLI_FOCAL = 3250.0
CLI_FRAMES = (0, 2)
POSE_MAX_DEG = 5.0
POSE_MIN_MATCHES = 30
POSE_MIN_POINTS = 10


# The distributed phase: bench_all.py's BA problem (timing_ba's: 16
# cameras, 4096 landmarks, 10 LM iterations) sharded over a world of one
# rank (NCCL) and of DIST_WORLD ranks (gloo, both on the one card: NCCL
# refuses two ranks on one GPU), so Schur runs at F16/T2048 a shard; the
# sharded BA held to bundle_adjust within tests/test_distributed.py's
# tolerances (cost 1e-4 relative, poses 1e-3); the CG pose graph at
# DIST_CG_NODES nodes (tests/test_dist_pose_graph.py's); each world's
# processes limited to DIST_TIMEOUT seconds.
DIST_BA = (16, 4096, 10)
DIST_WORLD = 2
DIST_COST_RTOL = 1e-4
DIST_POSE_ATOL = 1e-3
DIST_CG_NODES = 256
DIST_TIMEOUT = 600.0


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def timed(label, fn, *args):
    """``fn(*args)``, and a line with the seconds it took."""
    t0 = time.perf_counter()
    out = fn(*args)
    emit({"phase_seconds": label, "seconds": time.perf_counter() - t0})
    return out


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


def graph_ms(fn, iters: int = 20, reps: int = 5) -> float:
    """Device-side ms per call of ``fn``: ``iters`` calls captured into one
    CUDA graph and replayed, median over ``reps`` replays.  The host's
    dispatch is not in it (the gaps between the graph's kernels are), so it
    needs no profiler run."""
    import torch

    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / iters)
    return statistics.median(times)


def cold_ms(fn, dev, reps: int = 7) -> float:
    """Median CUDA-event ms of single calls of ``fn``, each after a 256 MB
    buffer (five times the 50 MB L2) has been overwritten, so that the
    call finds none of its inputs in the cache."""
    import torch

    flush = torch.empty(256 << 20, dtype=torch.uint8, device=dev)
    fn()
    times = []
    for i in range(reps):
        flush.fill_(i)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def host_ms(fn, reps: int = 5, warm: bool = True) -> float:
    """Median host-clock ms of ``fn`` ending in a device synchronize, after
    a warm-up call unless the caller has just run the same code."""
    import torch

    if warm:
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def device_profile(fn, iters: int = 10, top: int = 0, warm: bool = True):
    """Device busy time per call of ``fn`` (ms): the sum of the durations
    of every kernel and copy it puts on the card, from torch.profiler's
    CUDA activity over ``iters`` calls after a warm-up (unless the caller
    has just run the same code), and the ``top`` device ops by time.  Host
    dispatch gaps are not in it."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    if warm:
        fn()
    torch.cuda.synchronize()
    # device activity only: a host-side trace of a whole SfM run fills the
    # profiler's buffers, and the sessions after it then record nothing
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
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


def bound_ms(nbytes: float, ops: float,
             ops_per_s: float = FP32_OPS_PER_S) -> tuple[float, str]:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / ops_per_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _render_one(i: int):
    """Frame ``i`` of the 12-frame 1080p pan (a pool worker)."""
    from photogrammetry_tpu_torch.synth.star_scene import (
        StarSceneConfig, intrinsics, pan_trajectory, render_frame,
    )

    cfg = StarSceneConfig(num_frames=SFM_FRAMES, image_size=FRAME_SHAPE,
                          focal=FOCAL)
    rs, ts, _ = pan_trajectory(cfg)
    return render_frame(cfg, rs[i], ts[i], intrinsics(cfg))


def render_sequence():
    """The 12-frame 1080p pan, rendered in a spawn pool: uint8 frames
    (F, H, W), K, ground-truth rotations and camera centers."""
    import multiprocessing
    import os

    from photogrammetry_tpu_torch.synth.star_scene import (
        StarSceneConfig, intrinsics, pan_trajectory,
    )

    ctx = multiprocessing.get_context("spawn")
    with ctx.Pool(min(SFM_FRAMES, os.cpu_count() or 1)) as pool:
        frames = np.stack(pool.map(_render_one, range(SFM_FRAMES)))
    cfg = StarSceneConfig(num_frames=SFM_FRAMES, image_size=FRAME_SHAPE,
                          focal=FOCAL)
    rs, _, centers = pan_trajectory(cfg)
    return frames, intrinsics(cfg), rs, centers


def _cli_scene():
    from photogrammetry_tpu_torch.synth.star_scene import (
        StarSceneConfig, pan_trajectory,
    )

    cfg = StarSceneConfig(num_frames=SFM_FRAMES, image_size=CLI_SHAPE,
                          focal=CLI_FOCAL)
    return cfg, pan_trajectory(cfg)


def _render_cli_one(i: int):
    """Frame ``i`` of the pan at CLI_SHAPE (a pool worker)."""
    from photogrammetry_tpu_torch.synth.star_scene import (
        intrinsics, render_frame,
    )

    cfg, (rs, ts, _) = _cli_scene()
    return render_frame(cfg, rs[i], ts[i], intrinsics(cfg))


def start_cli_render():
    """Start rendering the frontend_clis phase's two frames in a spawn pool
    of two: (pool, pending result); ``drive_frontend_clis`` collects them
    and closes the pool."""
    import multiprocessing

    pool = multiprocessing.get_context("spawn").Pool(len(CLI_FRAMES))
    return pool, pool.map_async(_render_cli_one, CLI_FRAMES)


def sync(dev) -> None:
    """Wait for the card (nothing to wait for on the CPU, where the phases
    can be rehearsed)."""
    import torch

    if dev.type == "cuda":
        torch.cuda.synchronize()


def max_err(a, b) -> float:
    """max |a - b| in float64 (int32 INT_INF entries must not wrap)."""
    if a.numel() == 0:
        return 0.0
    return float((a.double() - b.double()).abs().max().item())


def check_kernels(dev, frames, seq, pairs, cfg):
    """Phase 4: each kernel against its plain version on ``dev``; returns
    the worst |kernel - plain| per kernel (0 for bit-exact)."""
    import torch

    from photogrammetry_tpu_torch.kernels import (
        brief_pack, fast_stencil, hamming,
    )
    from photogrammetry_tpu_torch.ops.brief import (
        angles_cos_sin, gaussian_pairs, keypoint_orientations,
    )
    from photogrammetry_tpu_torch.ops.fast import extract_keypoints
    from photogrammetry_tpu_torch.sfm.frontend import (
        _downsample2, make_pairs, precompute_frontend,
    )
    from photogrammetry_tpu_torch.sfm.incremental import SfmConfig

    gen = torch.Generator(device=dev).manual_seed(1)
    im = torch.as_tensor(frames[0], device=dev)
    errs = {}
    cases = []

    # FAST: the frame, a batch of both frames, the 12 frames, ragged noise
    # frames (13 of them: more than the SfM batch), images smaller than the
    # stencil, widths that are no multiple of 4 (the kernel's scalar
    # stores), a constant image, an isolated peak (its ring wholly
    # outside: 16) and ring values on the band edges (multiples of 12.5,
    # threshold 25)
    noise = torch.randint(0, 256, (13, 333, 517), generator=gen, device=dev)
    edges = (torch.randint(0, 8, (2, 64, 94), generator=gen, device=dev)
             * 12.5)
    peak = torch.zeros((1, 31, 45), device=dev)
    peak[0, 15, 20] = 255.0
    fast_cases = [
        ("frame", im[None], cfg.detection_threshold),
        ("two_frames", torch.stack([torch.as_tensor(f, device=dev)
                                    for f in frames]),
         cfg.detection_threshold),
        ("pan_12", torch.as_tensor(seq, device=dev).to(torch.float32),
         cfg.detection_threshold),
        ("noise_13", noise.float().contiguous(), 37.5),
        ("tiny_1x1", noise[:1, :1, :1].float().contiguous(), 37.5),
        ("tiny_5x6", noise[:2, :5, :6].float().contiguous(), 37.5),
        ("tiny_6x7", noise[:1, :6, :7].float().contiguous(), 37.5),
        ("tiny_7x7", noise[:1, :7, :7].float().contiguous(), 37.5),
        ("w_odd", noise[:3, :37, :33].float().contiguous(), 37.5),
        ("constant", torch.full((2, 40, 64), 77.0, device=dev), 10.0),
        ("isolated_peak", peak, 50.0),
        ("band_edges", edges.contiguous(), 25.0),
    ]
    for label, imgs, thr in fast_cases:
        got = fast_stencil.fast_score_map_batch(imgs, thr)
        ref = fast_stencil.fast_score_map_plain(imgs, thr)
        e = max_err(got, ref)
        errs["fast_score"] = max(errs.get("fast_score", 0.0), e)
        cases.append(dict(kernel="fast_score", case=label,
                          shape=list(imgs.shape),
                          corners=int((ref > 0).sum()), max_abs_err=e))
    if int(fast_stencil.fast_score_map_plain(peak, 50.0)[0, 15, 20]) != 16:
        raise AssertionError("the isolated peak does not score 16")

    # BRIEF: the frame's 2048 strongest keypoints, and 1999 ragged coords
    # (the last block has warps without a keypoint) that reach past every
    # border and lie on it; the 12 frames in one call with the SfM path's
    # 512 keypoints a frame, their masks ragged; P of 48, 256 and 1024;
    # steered by the keypoints' own angles and by (cos, sin) that put
    # rotated offsets on rint ties
    score = fast_stencil.fast_score_map_plain(im, cfg.detection_threshold)
    pts = extract_keypoints(score, cfg.max_keypoints, order="score")
    coords = pts.coords
    h, w = im.shape
    ragged = torch.stack([
        torch.randint(-20, h + 20, (1999,), generator=gen, device=dev),
        torch.randint(-20, w + 20, (1999,), generator=gen, device=dev)],
        -1).to(torch.int32)
    ragged[:4] = torch.tensor([[0, 0], [h - 1, w - 1], [0, w - 1],
                               [h - 1, 0]], device=dev)
    pan = torch.as_tensor(seq, device=dev).to(torch.float32)
    sfm_cfg = SfmConfig().frontend
    pan_pts = [extract_keypoints(s, sfm_cfg.max_keypoints, order="score")
               for s in
               fast_stencil.fast_score_map_plain(
                   pan, sfm_cfg.detection_threshold)]
    pan_coords = torch.stack([x.coords for x in pan_pts])
    pan_mask = torch.stack([x.mask for x in pan_pts])
    cut = torch.randint(0, SFM_KEYPOINTS + 1, (len(seq), 1), generator=gen,
                        device=dev)
    pan_ragged = pan_mask & (torch.arange(SFM_KEYPOINTS, device=dev) < cut)
    pan_angles = angles_cos_sin(keypoint_orientations(pan, pan_coords))
    ties = torch.tensor([[0.5, 0.5], [1.5, 0.0], [-0.5, 0.5], [0.5, -1.5]],
                        device=dev).repeat(SFM_KEYPOINTS // 4, 1)
    ties = ties[None].expand(len(seq), -1, -1).contiguous()
    sfm_pairs = make_pairs(sfm_cfg, device=dev)
    more = {p: gaussian_pairs(p, num_pairs=p, device=dev)
            for p in BRIEF_PARITY_PAIRS}

    def check_brief(label, imgs, c, prs, mask=None, cos_sin=None):
        ref = brief_pack.brief_bits_plain(imgs, c, prs, mask, cos_sin)
        got = brief_pack.brief_bits(imgs, c, prs, mask, cos_sin)
        e = max_err(got, ref)
        errs["brief_bits"] = max(errs.get("brief_bits", 0.0), e)
        cases.append(dict(kernel="brief_bits", case=label,
                          shape=list(ref.shape), ones=int(ref.sum()),
                          max_abs_err=e, exact=torch.equal(got, ref)))

    check_brief("frame", im, coords, pairs)
    check_brief("ragged", im, ragged, pairs)
    for p, prs in more.items():
        check_brief(f"frame_P{p}", im, coords, prs)
        check_brief(f"ragged_P{p}_steered", im, ragged, prs,
                    cos_sin=angles_cos_sin(torch.rand(
                        ragged.shape[0], generator=gen, device=dev) * 6.3))
    check_brief("pan12", pan, pan_coords, sfm_pairs, pan_mask)
    check_brief("pan12_ragged_masks", pan, pan_coords, sfm_pairs, pan_ragged)
    check_brief("pan12_steered", pan, pan_coords, sfm_pairs, pan_ragged,
                pan_angles)
    check_brief("pan12_rint_ties", pan, pan_coords, sfm_pairs, pan_mask,
                ties)
    check_brief("pan12_P1024_steered", pan, pan_coords, more[1024],
                pan_ragged, pan_angles)

    # the pyramid's octaves of the pan (540x960, 270x480): FAST at the SfM
    # threshold, BRIEF at each octave's SFM_KEYPOINTS strongest keypoints
    octave = pan
    for o in range(1, PARITY_OCTAVES + 1):
        octave = _downsample2(octave)
        got = fast_stencil.fast_score_map_batch(
            octave, sfm_cfg.detection_threshold)
        ref = fast_stencil.fast_score_map_plain(
            octave, sfm_cfg.detection_threshold)
        e = max_err(got, ref)
        errs["fast_score"] = max(errs["fast_score"], e)
        cases.append(dict(kernel="fast_score", case=f"pan12_octave{o}",
                          shape=list(octave.shape),
                          corners=int((ref > 0).sum()), max_abs_err=e))
        opts = [extract_keypoints(x, sfm_cfg.max_keypoints, order="score")
                for x in ref]
        check_brief(f"pan12_octave{o}", octave,
                    torch.stack([x.coords for x in opts]), sfm_pairs,
                    torch.stack([x.mask for x in opts]))

    def check_hamming(label, a, b, ma, mb, stream=None):
        if stream is not None:
            stream.wait_stream(torch.cuda.current_stream(dev))
            with torch.cuda.stream(stream):
                got = hamming.hamming_distance_matrix(a, b, ma, mb)
            torch.cuda.current_stream(dev).wait_stream(stream)
        else:
            got = hamming.hamming_distance_matrix(a, b, ma, mb)
        ref = hamming.hamming_distance_matrix_plain(a, b, ma, mb)
        e = max_err(got, ref)
        errs["hamming"] = max(errs.get("hamming", 0.0), e)
        cases.append(dict(kernel="hamming", case=label,
                          shape=[a.shape[0], b.shape[0], a.shape[1]],
                          tile=list(hamming.tile_plan(a.shape[0],
                                                      b.shape[0])[:4]),
                          max_abs_err=e))

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
        check_hamming("frame_bits" if a is bits else "random_bits", a, b,
                      ma, mb)
    # every N and P of the parity table, masked as the frontend masks
    for n1, n2 in HAMMING_PARITY_SHAPES:
        for p in HAMMING_PARITY_BITS:
            a, b = (torch.randint(0, 2, (n, p), generator=gen, device=dev)
                    .to(torch.uint8) for n in (n1, n2))
            ma, mb = (torch.rand(n, generator=gen, device=dev) > 0.2
                      for n in (n1, n2))
            check_hamming("shape", a, b, ma, mb)
    # all rows masked; operands one byte into a larger allocation (the
    # kernel's byte loads in place of its 16-byte copies); a side stream
    none = torch.zeros(rb1.shape[0], dtype=torch.bool, device=dev)
    check_hamming("all_rows_masked", rb1.to(torch.uint8),
                  rb2.to(torch.uint8), none, m2)

    def offset_copy(x):
        buf = torch.empty(x.numel() + 1, dtype=x.dtype, device=x.device)
        view = buf[1:].view(x.shape)
        view.copy_(x)
        return view

    check_hamming("odd_byte_offset", offset_copy(bits),
                  offset_copy(bits.flip(0)), pts.mask, pts.mask.flip(0))
    side = torch.cuda.Stream(dev) if dev.type == "cuda" else None
    check_hamming("side_stream", bits, bits.flip(0).contiguous(), pts.mask,
                  pts.mask.flip(0), stream=side)
    # the pyramid's match: frames 0 and 1 of the pan, two octaves of
    # SFM_KEYPOINTS merged (1024 x 1024, P = 256)
    pyr = precompute_frontend(pan[:2], sfm_pairs, sfm_cfg,
                              octaves=PYRAMID_OCTAVES, plain=True)
    check_hamming("pyramid_1024", pyr.bits[0], pyr.bits[1],
                  pyr.points.mask[0], pyr.points.mask[1])
    if dev.type == "cuda":
        torch.cuda.synchronize()
    emit({"phase": "parity", "cases": cases,
          "exact": all(c["max_abs_err"] == 0 for c in cases)})
    bad = [c for c in cases
           if c["max_abs_err"] != 0 or not c.get("exact", True)]
    if bad:
        raise AssertionError(f"kernel disagrees with its plain version: {bad}")
    return errs


def drive_main_path(dev, frames, k, r_gt, pairs, cfg, counters):
    """Phase 6: the forward step with the kernels (launches counted) and
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
    if launches["brief_bits"] != 2:          # one describe a frame
        raise AssertionError(f"BRIEF launches on the forward step: "
                             f"{launches}")
    return out, launches


def time_row(row) -> dict:
    """Times of one kernel row: ms / plain_ms / library_ms are device busy
    time per call (profiler); graph_ms the kernel's device time per call by
    CUDA-graph replay (the plain versions make host tensors and cannot be
    captured); *_call_ms the CUDA-event time per call in a back-to-back
    loop, which includes the host's dispatch gaps when they outlast the
    device work.  Once the profiler records nothing any more, ms falls to
    graph_ms and plain_ms / library_ms to their call_ms (``*_ms_from``
    says which).  ``kernel_ops``: the device ops of one kernel call, by
    name.  The bound comes from the row's bytes and operations (at the
    row's rate, f32 unless named)."""
    b_ms, b_by = bound_ms(row["bytes"], row["ops"],
                          row.get("ops_per_s", FP32_OPS_PER_S))
    t = dict(bound_ms=b_ms, bound_by=b_by, bytes=row["bytes"],
             ops=row["ops"], library_ms=None, library_call_ms=None,
             graph_ms=graph_ms(row["run"]))
    for key in ("run", "plain", "library"):
        if row[key] is None:
            continue
        pre = {"run": "", "plain": "plain_", "library": "library_"}[key]
        t[pre + "call_ms"] = cuda_ms(row[key])
        try:
            busy, ops = device_profile(row[key], top=4)
            t[pre + "ms"], t[pre + "ms_from"] = busy, "profiler"
            if key == "run":
                t["kernel_ops"] = ops
        except RuntimeError:
            fallback = "graph_ms" if key == "run" else pre + "call_ms"
            t[pre + "ms"], t[pre + "ms_from"] = t[fallback], fallback
    return t


def brief_row(imgs, pts, prs) -> dict:
    """The BRIEF kernel's timing row on (B, H, W) frames at a path's
    keypoints, mask folded in.  Bytes: the distinct pixels the live
    keypoints' in-bounds pairs touch, the live keypoints' coords, the mask
    and pairs, the output (masked rows too: written as zeros); 12
    operations a bit of a live keypoint (four sums, four bounds tests, a
    compare, the index arithmetic).  A masked keypoint's coords are not
    read and its bits not computed."""
    import torch

    from photogrammetry_tpu_torch.kernels import brief_pack

    h, w = imgs.shape[-2:]
    c, m = pts.coords, pts.mask
    ends = c[..., None, None, :].long() + prs.long()
    inb = (((ends >= 0) & (ends < torch.tensor([h, w], device=imgs.device)))
           .all(-1).all(-1) & m[..., None])[..., None].expand(
               *ends.shape[:-1])
    frame = torch.arange(imgs.shape[0], device=imgs.device).view(-1, 1, 1, 1)
    flat = (frame * h + ends[..., 0]) * w + ends[..., 1]
    touched = int(torch.unique(flat[inb]).numel())
    n, p = c.shape[0] * c.shape[1], prs.shape[0]
    live = int(m.sum())
    return dict(
        run=lambda: brief_pack.brief_bits(imgs, c, prs, m),
        plain=lambda: brief_pack.brief_bits_plain(imgs, c, prs, m),
        library=None, floor=lambda: brief_pack.gather_probe(imgs, c, prs, m),
        bytes=4 * touched + live * 8 + m.numel() + prs.numel() * 4 + n * p,
        ops=live * p * 12, distinct_pixels=touched, live_keypoints=live)


def time_all(dev, frames, seq, k, pairs, cfg, out):
    """Phase 8, two-view part: kernel, plain and library times with their
    bounds; the frontend's frames/s and the pair latency."""
    import torch

    from photogrammetry_tpu_torch.entry import forward
    from photogrammetry_tpu_torch.kernels import fast_stencil, hamming
    from photogrammetry_tpu_torch.sfm.frontend import (
        describe_bits, detect_and_describe, make_pairs, precompute_frontend,
    )
    from photogrammetry_tpu_torch.sfm.incremental import SfmConfig
    from photogrammetry_tpu_torch.utils.padding import PaddedPoints

    im = torch.as_tensor(frames[0], device=dev)
    batch = im[None]
    h, w = im.shape
    f1, f2 = out.frame1, out.frame2
    p = pairs.shape[0]
    b1, b2 = f1.bits, f2.bits
    m1, m2 = f1.points.mask, f2.points.mask
    thr = cfg.detection_threshold

    # the batched entry as the SfM path launches it: all 12 frames at once
    batch12 = torch.as_tensor(seq, device=dev).to(torch.float32)
    sfm_cfg = SfmConfig().frontend
    sfm_pairs = make_pairs(sfm_cfg, device=dev)
    sfm_pts = precompute_frontend(batch12, sfm_pairs, sfm_cfg).points

    def hamming_row(a, b, ma, mb):
        n1, n2 = a.shape[0], b.shape[0]
        return dict(
            run=lambda: hamming.hamming_distance_matrix(a, b, ma, mb),
            plain=lambda: hamming.hamming_distance_matrix_plain(a, b, ma, mb),
            library=lambda: torch.cdist(a.float(), b.float(), p=0),
            # the bits and masks read once, the distances written once; the
            # products |a|.|b| of the identity, 2 N1 N2 P operations on
            # uint8 (the int8 tensor-core rate)
            bytes=(n1 + n2) * p + n1 + n2 + n1 * n2 * 4,
            ops=2 * n1 * n2 * p, ops_per_s=INT8_OPS_PER_S)

    # the SfM path's shape: its frames' SFM_KEYPOINTS strongest keypoints
    sfm_bits = [x[:SFM_KEYPOINTS].contiguous() for x in (b1, b2, m1, m2)]
    rows = {
        "fast_score": dict(
            run=lambda: fast_stencil.fast_score_map_batch(batch, thr),
            plain=lambda: fast_stencil.fast_score_map_plain(batch, thr),
            library=None,
            # one f32 read + one int32 write per pixel; 49 operations per
            # pixel: 2 band edges and 16 x 2 compares in f32 and ~15 logic
            # operations for the longest run (no pre-test taken off)
            bytes=h * w * 8, ops=h * w * 49),
        "fast_score_b12": dict(
            run=lambda: fast_stencil.fast_score_map_batch(batch12, thr),
            plain=lambda: fast_stencil.fast_score_map_plain(batch12, thr),
            library=None,
            bytes=len(seq) * h * w * 8, ops=len(seq) * h * w * 49),
        "brief_bits": brief_row(batch, PaddedPoints(
            *(x[None] for x in f1.points)), pairs),
        "brief_bits_b12": brief_row(batch12, sfm_pts, sfm_pairs),
        "hamming": hamming_row(b1, b2, m1, m2),
        f"hamming_{SFM_KEYPOINTS}": hamming_row(*sfm_bits),
    }
    def describe():
        return describe_bits(batch12, sfm_pts, sfm_pairs, sfm_cfg)

    # the describe stage of the SfM path: one device op, the kernel (no
    # mask multiply, no stacking)
    _, describe_ops = device_profile(describe, top=4)
    timings = {name: time_row(row) for name, row in rows.items()}
    for name in ("brief_bits", "brief_bits_b12"):
        timings[name].update(gather_floor_ms=graph_ms(rows[name]["floor"]),
                             distinct_pixels=rows[name]["distinct_pixels"],
                             live_keypoints=rows[name]["live_keypoints"])
    timings["brief_bits_b12"]["describe_stage_ops"] = describe_ops
    for name in ("hamming", f"hamming_{SFM_KEYPOINTS}", "brief_bits",
                 "brief_bits_b12"):
        calls = sum(op["calls"] for op in timings[name].get("kernel_ops",
                                                             [{"calls": 1}]))
        if calls != 1:
            raise AssertionError(f"{name}: {calls} device ops per call, "
                                 f"expected the one kernel launch: "
                                 f"{timings[name]['kernel_ops']}")
    if sum(op["calls"] for op in describe_ops) != 1:
        raise AssertionError(f"the describe stage is not one launch: "
                             f"{describe_ops}")
    emit({"phase": "timing", "kernels": timings})

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


def schur_inputs(dev, f: int, t: int, seed: int):
    """Random (w_hinv, w_cp, b_p) of the Schur products at F, T."""
    import torch

    gen = torch.Generator(device=dev).manual_seed(seed)
    return [torch.randn(shape, generator=gen, device=dev)
            for shape in ((f, t, 6, 3), (f, t, 6, 3), (t, 3))]


def check_schur(dev) -> float:
    """Phase 5: the Schur kernel against its plain einsums at
    SCHUR_PARITY_SHAPES, within the worst-case f32 bound, and bitwise
    repeatable; once with operands that start at an odd offset into a
    larger allocation and once on a side stream; returns the largest
    |kernel - plain| over the cases."""
    import torch

    from photogrammetry_tpu_torch.kernels import schur

    def offset_copy(x):
        # the same values, 4-byte aligned only: a view one float into a
        # larger buffer
        buf = torch.empty(x.numel() + 1, dtype=x.dtype, device=x.device)
        view = buf[1:].view(x.shape)
        view.copy_(x)
        return view

    side = torch.cuda.Stream(dev) if dev.type == "cuda" else None
    cases = []
    for f, t in SCHUR_PARITY_SHAPES:
        args = schur_inputs(dev, f, t, seed=f * t + 1)
        variants = [("plain_layout", args, None)]
        if (f, t) in SCHUR_OFFSET_SHAPES:
            variants.append(("offset_operands",
                             [offset_copy(x) for x in args], None))
            variants.append(("side_stream", args, side))
        ref = schur.schur_products_plain(*args)
        bounds = schur.error_bound(*args)
        for label, ops, stream in variants:
            if stream is not None:
                stream.wait_stream(torch.cuda.current_stream(dev))
                with torch.cuda.stream(stream):
                    got = schur.schur_products(*ops)
                    again = schur.schur_products(*ops)
                torch.cuda.current_stream(dev).wait_stream(stream)
            else:
                got = schur.schur_products(*ops)
                again = schur.schur_products(*ops)
            if dev.type == "cuda":
                torch.cuda.synchronize()
            ratio = max((float(((g.double() - r.double()).abs()
                                / b.clamp(min=1e-30)).max())
                         for g, r, b in zip(got, ref, bounds)
                         if g.numel()), default=0.0)
            cases.append(dict(
                shape=[f, t], case=label,
                slabs=schur.split_plan(f, t).slabs,
                max_abs_err=max(max_err(g, r) for g, r in zip(got, ref)),
                max_err_over_bound=ratio,
                finite=all(bool(torch.isfinite(g).all()) for g in got),
                repeatable=all(torch.equal(a, b)
                               for a, b in zip(got, again))))
    emit({"phase": "schur_parity", "cases": cases})
    bad = [c for c in cases if not c["max_err_over_bound"] <= 1.0
           or not c["repeatable"] or not c["finite"]]
    if bad:
        raise AssertionError(f"Schur kernel outside its bound: {bad}")
    return max(c["max_abs_err"] for c in cases)


def drive_sfm(dev, frames, k, centers, counters, phase="sfm", seed=SFM_SEED,
              stage=None):
    """Phases 7 and 8: the robust incremental SfM through the kernels
    (launches counted) and with the plain versions, under the same seed.
    ``stage(plain)``, when given, makes the run's frames inside the counted
    window (the dewarp stage) and must give the same bits both times."""
    import torch

    from photogrammetry_tpu_torch.sfm.frontend import (
        make_pairs, precompute_frontend,
    )
    from photogrammetry_tpu_torch.sfm.incremental import (
        SfmConfig, run_incremental_sfm_robust,
    )
    from photogrammetry_tpu_torch.sfm.metrics import (
        absolute_trajectory_error,
    )

    cfg = SfmConfig(collect_diagnostics=False)    # run_sfm's configuration

    def run(plain):
        t0 = time.perf_counter()
        run_frames = frames if stage is None else stage(plain)
        res = run_incremental_sfm_robust(run_frames, k, cfg, seed=seed,
                                         restarts=3, device=dev,
                                         plain=plain)
        if dev.type == "cuda":
            torch.cuda.synchronize()
        ate = float(absolute_trajectory_error(
            torch.tensor(res.camera_centers, dtype=torch.float64),
            torch.tensor(centers, dtype=torch.float64)))
        return run_frames, res, dict(
            seconds=time.perf_counter() - t0, ate=ate,
            centers=len(res.camera_centers), landmarks=len(res.points),
            quality=res.quality, final_cost=res.costs[-1])

    for c in counters.values():
        c.launches = 0
    out_frames, out, stats = run(plain=False)
    launches = {name: c.launches for name, c in counters.items()}
    ref_frames, ref, ref_stats = run(plain=True)

    # the batched frontend of both runs, each on its own frames
    pairs = make_pairs(cfg.frontend, device=dev)
    fa, fb = (precompute_frontend(
        torch.as_tensor(fr, dtype=torch.float32, device=dev), pairs,
        cfg.frontend, chunk=cfg.frontend_chunk, plain=plain)
        for fr, plain in ((out_frames, False), (ref_frames, True)))
    same = features_equal(fa, fb)
    result = {"phase": phase, "frames": list(frames.shape), "seed": seed,
              "kernels": stats, "plain": ref_stats,
              "features_identical": same,
              "keypoints_per_frame": fa.points.count.tolist(),
              "max_center_diff_kernel_vs_plain": float(np.abs(
                  out.camera_centers - ref.camera_centers).max()),
              "launches": launches}
    if stage is not None:
        result["staged_frames_identical"] = bool(torch.equal(out_frames,
                                                             ref_frames))
    emit(result)
    if not same:
        raise AssertionError("batched frontend differs kernel vs plain")
    if not result.get("staged_frames_identical", True):
        raise AssertionError("staged frames differ kernel vs plain")
    for st in (stats, ref_stats):
        if (st["centers"] != len(frames) or not st["ate"] < 0.2
                or st["landmarks"] <= 80):
            raise AssertionError(f"SfM out of bounds: {st}")
    missing = [n for n, v in launches.items() if v < 1]
    if missing:
        raise AssertionError(f"kernels not launched on the {phase} path: "
                             f"{missing}")
    if launches["brief_bits"] != 3:   # one describe of all 12 frames a restart
        raise AssertionError(f"BRIEF launches on the {phase} path: "
                             f"{launches}")
    return launches, out_frames, stats


def tinted_rgb(frame):
    """A uint8 RGB rendering (H, W, 3) of a grayscale frame: three
    different channels, so a channel mix-up shows."""
    return np.stack([frame, frame * 0.8, frame * 0.6], -1).astype(np.uint8)


def check_remap(dev, seq) -> float:
    """The remap kernel against its plain version on ``dev``, bit-exact, at
    the dewarp paths' shapes and a ragged one; returns the worst
    |kernel - plain| (0 when exact)."""
    import torch

    from photogrammetry_tpu_torch.kernels import remap
    from photogrammetry_tpu_torch.ops.dewarp import (
        generate_distortion_map, make_distortion_applier,
    )

    gen = torch.Generator(device=dev).manual_seed(2)
    h, w = seq.shape[1:]
    dmap = generate_distortion_map(h, w, DEWARP_COEFFS, device=dev)
    stack = torch.as_tensor(seq, device=dev).to(torch.float32)[..., None]
    rgb = torch.as_tensor(tinted_rgb(seq[0]), device=dev)[None]
    # ragged: maps larger and smaller than the source that fold in the
    # columns, with entries far outside and non-finite ones
    hs, ws = 333, 517

    def wild_map(ho, wo):
        rows = torch.rand((ho, wo), generator=gen, device=dev) * (hs + 6) - 3
        cols = (torch.arange(wo, device=dev) - wo / 2.0).abs() * 1.9 + 0.3
        m = torch.stack([rows, cols[None, :].expand(ho, wo)], -1).contiguous()
        m[::7, ::5] = 1e9
        m[1::7, ::5] = -1e9
        m[2::7, ::5, 0] = float("nan")
        m[3::7, ::5, 1] = float("inf")
        return m

    larger, smaller = wild_map(350, 540), wild_map(211, 301)
    cases = []

    def check(label, imgs, m, frame_chunk=None):
        got = remap.remap_bilinear(imgs, m, frame_chunk=frame_chunk)
        ref = remap.remap_bilinear_plain(imgs, m)
        cases.append(dict(case=label, images=list(imgs.shape),
                          map=list(m.shape), dtype=str(imgs.dtype),
                          frame_chunk=frame_chunk,
                          nonzero=int((ref != 0).sum()),
                          max_abs_err=max_err(got, ref),
                          exact=bool(torch.equal(got, ref))))

    check("frame_f32", stack[:1], dmap)
    check("frame_rgb_u8", rgb, dmap)
    check("stack_f32", stack, dmap)
    # every channel count the kernel specialises (1-4) and one it does not,
    # in both types; 5 frames in chunks of 2 (a last chunk of one frame);
    # 211 x 301 output pixels are odd, so the frames of the uint8 outputs
    # start at every byte alignment
    for ch in (1, 2, 3, 4, 5):
        noise = torch.randint(0, 256, (5, hs, ws, ch), generator=gen,
                              device=dev)
        for imgs in (noise.to(torch.uint8), noise.to(torch.float32) * 0.37):
            tag = f"c{ch}_{str(imgs.dtype).split('.')[-1]}"
            check(f"larger_{tag}", imgs[:2], larger)
            check(f"smaller_chunk2_{tag}", imgs, smaller, frame_chunk=2)
    # the applier at dtypes the kernel does not take: through the f32 kernel
    # and back, equal to the plain applier (three frames, signed values)
    apply = make_distortion_applier(dmap, (h, w), device=dev)
    apply_plain = make_distortion_applier(dmap, (h, w), device=dev,
                                          plain=True)
    signed = stack[:3, ..., 0] * 7.3 - 900.0
    for dtype in (torch.int16, torch.int32, torch.float64):
        imgs = signed.to(dtype)
        before = remap.remap_bilinear.launches
        got = apply(imgs)
        launched = remap.remap_bilinear.launches - before
        ref = apply_plain(imgs)
        cases.append(dict(case=f"applier_{str(dtype).split('.')[-1]}",
                          images=list(imgs.shape), map=list(dmap.shape),
                          dtype=str(got.dtype), launches=launched,
                          nonzero=int((ref != 0).sum()),
                          max_abs_err=max_err(got, ref),
                          exact=bool(torch.equal(got, ref)
                                     and got.dtype == dtype
                                     and launched == int(dev.type == "cuda"))))
    if dev.type == "cuda":
        torch.cuda.synchronize()
    emit({"phase": "remap_parity", "cases": cases})
    bad = [c for c in cases if not c["exact"] or c["nonzero"] == 0]
    if bad:
        raise AssertionError(f"remap kernel disagrees with its plain "
                             f"version: {bad}")
    return max(c["max_abs_err"] for c in cases)


def capture_frames(dev, seq):
    """The frames as a camera with the DEWARP_COEFFS lens would have
    captured them: uint8 (F, H, W) numpy, barrel-distorted with the
    synthetic map (a fixture, made with the plain remap)."""
    import torch

    from photogrammetry_tpu_torch.ops.dewarp import (
        generate_synthetic_distortion_map, remap_plain,
    )

    synth = generate_synthetic_distortion_map(*seq.shape[1:], DEWARP_COEFFS,
                                              device=dev)
    clean = torch.as_tensor(seq, device=dev)[..., None]
    return remap_plain(clean, synth)[..., 0].cpu().numpy()


def drive_dewarp_sfm(dev, seq, captured, k, centers, counters, cache_dir):
    """Phase 8: dewarp_frames + the robust SfM on the captured frames."""
    import torch

    from photogrammetry_tpu_torch.cli.run_sfm import dewarp_frames

    def stage(plain):
        return dewarp_frames(captured, DEWARP_COEFFS, cache_dir, dev,
                             plain=plain)

    launches, dewarped, _ = drive_sfm(dev, seq, k, centers, counters,
                                      phase="dewarp_sfm", seed=DEWARP_SEED,
                                      stage=stage)
    clean = torch.as_tensor(seq, device=dev).to(torch.float32)
    err = (dewarped - clean).abs()[:, 40:-40, 40:-40]
    stats = dict(mean=float(err.mean()),
                 p99=float(torch.quantile(err.flatten()[::7], 0.99)),
                 max=float(err.max()),
                 captured_mean=float((torch.as_tensor(captured, device=dev)
                                      .to(torch.float32) - clean).abs()
                                     [:, 40:-40, 40:-40].mean()))
    emit({"phase": "dewarp_interior", "grey_levels": stats,
          "finite": bool(torch.isfinite(dewarped).all()),
          "shape": list(dewarped.shape)})
    if (not stats["mean"] < DEWARP_MEAN_TOL
            or not stats["p99"] < DEWARP_P99_TOL
            or not stats["mean"] < 0.5 * stats["captured_mean"]):
        raise AssertionError(f"dewarped frames far from the clean ones: "
                             f"{stats}")
    return launches


def steered_pair():
    """A 1080x1920 texture (noise smoothed at 3 and 12 px, weighted by
    scale, over 0..255) and the same rotated by STEER_DEGREES about its
    centre (bilinear, zero outside), float32 numpy; and the map of a (row,
    col) of the first to its place in the second."""
    from scipy import ndimage

    h, w = FRAME_SHAPE
    rng = np.random.default_rng(SFM_SEED)
    t = sum(ndimage.gaussian_filter(rng.normal(size=(h, w)), s) * s
            for s in (3.0, 12.0))
    img = ((t - t.min()) / (t.max() - t.min()) * 255.0).astype(np.float32)
    a = np.radians(STEER_DEGREES)
    rot = np.array([[np.cos(a), -np.sin(a)], [np.sin(a), np.cos(a)]])
    c = np.array([(h - 1) / 2.0, (w - 1) / 2.0])
    turned = ndimage.affine_transform(img, rot, offset=c - rot @ c, order=1)
    return img, turned.astype(np.float32), lambda rc: (rc - c) @ rot + c


def drive_steered(dev, counters, out_dir):
    """The steered-BRIEF phase: the textured pair through the frontend with
    ``oriented_brief`` (kernel bits equal to plain bits, launches counted),
    the correct mutual-nearest matches steered and not (the gate of
    tests/test_pyramid_sfm.py's roll test: steered >= 2x plain and >= 20),
    and one ``run_sfm --oriented-brief --restarts 3`` on its 12-frame
    synthetic pan, whose ATE and landmarks are reported, not gated (the
    scene's round dots have no defined orientation)."""
    import dataclasses

    import torch

    from photogrammetry_tpu_torch.sfm.frontend import (
        FrontendConfig, detect_and_describe, make_pairs, match_pair,
    )

    img, turned, where = steered_pair()
    ims = [torch.as_tensor(x, device=dev) for x in (img, turned)]
    steer = FrontendConfig(detection_threshold=STEER_THRESHOLD,
                           max_keypoints=MAX_KEYPOINTS,
                           suppression_radius=4.0, hamming_threshold=75,
                           subpixel=False, oriented_brief=True)
    pairs = make_pairs(steer, device=dev)
    result = {"phase": "steered", "frame_shape": list(FRAME_SHAPE),
              "degrees": STEER_DEGREES}
    for label, cfg in (("steered", steer),
                       ("plain_brief",
                        dataclasses.replace(steer, oriented_brief=False))):
        for c in counters.values():
            c.launches = 0
        f1, f2 = (detect_and_describe(x, pairs, cfg) for x in ims)
        launches = {n: c.launches for n, c in counters.items()}
        r1, r2 = (detect_and_describe(x, pairs, cfg, plain=True)
                  for x in ims)
        m = match_pair(f1, f2, cfg)
        ok = m.mask.cpu().numpy()
        p1 = f1.points.coords.cpu().numpy()[ok].astype(np.float64)
        p2 = (f2.points.coords.cpu().numpy()[m.idx2.cpu().numpy()[ok]]
              .astype(np.float64))
        result[label] = dict(
            keypoints=[int(f1.points.count), int(f2.points.count)],
            bits_equal_plain=bool(torch.equal(f1.bits, r1.bits)
                                  and torch.equal(f2.bits, r2.bits)),
            matches=int(ok.sum()),
            correct=int((np.linalg.norm(where(p1) - p2, axis=1)
                         < STEER_PX).sum()),
            launches=launches)
    for c in counters.values():
        c.launches = 0
    t0 = time.perf_counter()
    cli = run_cli(["--synthetic-frames", str(SFM_FRAMES), "--restarts", "3",
                   "--oriented-brief", "--device", str(dev),
                   "--cloud", f"{out_dir}/cloud.ply",
                   "--trajectory", f"{out_dir}/trajectory.json"])
    result["run_sfm_oriented_brief"] = dict(
        seconds=time.perf_counter() - t0, ate=cli.get("ate"),
        landmarks=cli["landmarks"], frames=cli["frames"],
        quality=cli["quality"],
        launches={n: c.launches for n, c in counters.items()})
    emit(result)
    st, pl = result["steered"], result["plain_brief"]
    if not (st["bits_equal_plain"] and pl["bits_equal_plain"]):
        raise AssertionError("steered BRIEF bits differ kernel vs plain")
    if st["correct"] < 2 * max(pl["correct"], 1) or st["correct"] < 20:
        raise AssertionError(f"steered BRIEF below its match gate: {result}")
    if st["launches"]["brief_bits"] != 2 or \
            result["run_sfm_oriented_brief"]["launches"]["brief_bits"] != 3:
        raise AssertionError(f"steered BRIEF launches: {result}")
    return result


def drive_pipeline(dev, frame, counters, cache_dir):
    """Phase 9: build_pipeline's stages between read and write on one uint8
    RGB frame, with the kernels (launches counted) and plain."""
    import torch

    from photogrammetry_tpu_torch.cli.pipeline_demo import build_pipeline
    from photogrammetry_tpu_torch.store.content_store import Variant
    from photogrammetry_tpu_torch.store.pipeline import Pipeline

    rgb = tinted_rgb(frame)

    def run(plain):
        full = build_pipeline(DEWARP_COEFFS, 50.0, 50.0, 4096, cache_dir,
                              cache_dir, device=dev, plain=plain)
        pipe = Pipeline(full.stages[1:-1])
        rid = pipe.run([rgb])[0]
        if dev.type == "cuda":
            torch.cuda.synchronize()
        return (pipe.store.fetch(rid, Variant.KEYPOINTS),
                pipe.store.fetch(rid, Variant.DENOISED_KEYPOINTS),
                pipe.store.fetch(rid, Variant.OVERLAY), pipe.timer.summary())

    for c in counters.values():
        c.launches = 0
    t0 = time.perf_counter()
    pts, kept, overlay, stages = run(plain=False)
    seconds = time.perf_counter() - t0
    launches = {name: c.launches for name, c in counters.items()}
    ref_pts, ref_kept, ref_overlay, _ = run(plain=True)
    same = all(torch.equal(a, b) for a, b in zip([*pts, *kept],
                                                 [*ref_pts, *ref_kept]))
    result = {"phase": "pipeline_demo", "image": list(rgb.shape),
              "keypoints": int(pts.count), "after_nms": int(kept.count),
              "keypoints_identical": same,
              "overlay_identical": bool(np.array_equal(overlay,
                                                       ref_overlay)),
              "overlay": [list(overlay.shape), str(overlay.dtype)],
              "seconds": seconds, "stages": stages, "launches": launches}
    emit(result)
    if not same or not result["overlay_identical"]:
        raise AssertionError("pipeline differs kernel vs plain")
    if (int(kept.count) <= 10 or int(kept.count) >= int(pts.count)
            or overlay.shape != rgb.shape or overlay.dtype != np.uint8):
        raise AssertionError(f"pipeline out of bounds: {result}")
    missing = [n for n, v in launches.items() if v < 1]
    if missing:
        raise AssertionError(f"kernels not launched by the pipeline: "
                             f"{missing}")
    return launches


def time_remap(dev, seq, captured, cache_dir):
    """Phase 10, dewarp part: the remap kernel, its plain version and
    grid_sample at the three 1080p shapes; map generation; dewarp_frames."""
    import torch
    import torch.nn.functional as F

    from photogrammetry_tpu_torch.cli.run_sfm import dewarp_frames
    from photogrammetry_tpu_torch.kernels import remap
    from photogrammetry_tpu_torch.ops.dewarp import generate_distortion_map

    h, w = seq.shape[1:]
    dmap = generate_distortion_map(h, w, DEWARP_COEFFS, device=dev)
    # the library call's grid: (x, y) in [-1, 1] with align_corners=True,
    # made beforehand (not in its time), one copy per frame as it demands
    grid = torch.stack([dmap[..., 1] * (2.0 / (w - 1)) - 1.0,
                        dmap[..., 0] * (2.0 / (h - 1)) - 1.0], -1)
    stack = torch.as_tensor(captured, device=dev).to(torch.float32)[..., None]
    rgb = torch.as_tensor(tinted_rgb(captured[0]), device=dev)[None]
    rows = {}
    for label, imgs in (("frame_f32", stack[:1].contiguous()),
                        ("frame_rgb_u8", rgb), ("stack_f32", stack)):
        b, _, _, c = imgs.shape
        nchw = imgs.permute(0, 3, 1, 2).to(torch.float32).contiguous()
        grids = grid[None].expand(b, h, w, 2).contiguous()
        rows[label] = time_row(dict(
            run=lambda imgs=imgs: remap.remap_bilinear(imgs, dmap),
            plain=lambda imgs=imgs: remap.remap_bilinear_plain(imgs, dmap),
            library=lambda nchw=nchw, grids=grids: F.grid_sample(
                nchw, grids, mode="bilinear", padding_mode="zeros",
                align_corners=True),
            # the map once, the images once, the output once; per pixel 8
            # operations for the weights and 11 per frame and channel
            bytes=dmap.numel() * 4 + 2 * imgs.numel() * imgs.element_size(),
            ops=h * w * (8 + 11 * b * c)))
        rows[label]["images"] = list(imgs.shape)
        rows[label]["cold_call_ms"] = cold_ms(
            lambda imgs=imgs: remap.remap_bilinear(imgs, dmap), dev)
        rows[label]["library_cold_call_ms"] = cold_ms(
            lambda nchw=nchw, grids=grids: F.grid_sample(
                nchw, grids, mode="bilinear", padding_mode="zeros",
                align_corners=True), dev)
        del nchw, grids
    result = {"phase": "timing_remap", "rows": rows,
              "inputs": "ms, call_ms: back-to-back calls on the same "
                        "inputs, hot in the 50 MB L2 where they fit (33 MB "
                        "and 29 MB do, the stack's 216 MB do not); "
                        "cold_call_ms: single calls, each after 256 MB "
                        "were written"}
    result["generate_map_ms"] = host_ms(
        lambda: generate_distortion_map(h, w, DEWARP_COEFFS, device=dev))

    def dewarp():
        return dewarp_frames(captured, DEWARP_COEFFS, cache_dir, dev)

    ms = host_ms(dewarp)
    busy, top = device_profile(dewarp, iters=3, top=4)
    result["dewarp_frames"] = dict(
        frames=len(captured), wall_ms=ms,
        frames_per_s=len(captured) * 1e3 / ms, device_busy_ms=busy,
        top_device_ops=top)
    emit(result)
    return rows


def time_dewarp_sfm(dev, captured, k, cache_dir):
    """Phase 10, last part: one dewarp + SfM run's frames/s, device busy
    time, idle share and top device ops."""
    from photogrammetry_tpu_torch.cli.run_sfm import dewarp_frames
    from photogrammetry_tpu_torch.sfm.incremental import (
        SfmConfig, run_incremental_sfm,
    )

    cfg = SfmConfig(collect_diagnostics=False)

    def run():
        frames = dewarp_frames(captured, DEWARP_COEFFS, cache_dir, dev)
        return run_incremental_sfm(frames, k, cfg, seed=DEWARP_SEED,
                                   device=dev)

    # warm already: the SfM timing and dewarp_frames ran just before
    wall = host_ms(run, reps=1, warm=False)
    busy, top = device_profile(run, iters=1, top=10, warm=False)
    emit({"phase": "timing_dewarp_sfm", "frames": list(captured.shape),
          "wall_ms": wall, "frames_per_s": len(captured) * 1e3 / wall,
          "device_busy_ms": busy,
          "device_idle_share": max(0.0, 1 - busy / wall),
          "top_device_ops": top})


def drive_precompute(dev, seq, k, centers, counters, single_scale):
    """The precompute phase: ``run_incremental_sfm_robust(restarts=3)``
    with ``precompute_matching`` on the 12 frames at SFM_SEED, launches
    counted (the batched Hamming entry once a chunk of pairs: two a
    restart), then with ``plain=True``: 12 poses, > 80 landmarks and ATE
    < PRECOMPUTE_ATE_MAX in both; ``precompute_matching`` on the kernel
    run's features with the kernels and with the plain versions under one
    generator seed, every field bit-identical, at one octave (K = 512)
    and two (K = 1024); the batched entry at the first chunk's shape
    (Q = 16, K = 512) and the tail's (Q = 5) timed with its bound (the
    bits and masks of the frames the chunk reads).  Returns the robust
    run's launches and the batched entry's rows."""
    import torch

    from photogrammetry_tpu_torch.kernels import hamming
    from photogrammetry_tpu_torch.sfm.frontend import (
        make_pairs, precompute_frontend, precompute_matching, sequence_pairs,
    )
    from photogrammetry_tpu_torch.sfm.incremental import (
        SfmConfig, run_incremental_sfm_robust,
    )
    from photogrammetry_tpu_torch.sfm.metrics import trajectory_ate

    cfg = SfmConfig(collect_diagnostics=False, precompute_matching=True)
    fc = cfg.frontend
    counters = {**counters,
                "hamming_pairs": hamming.hamming_distance_matrix_pairs}
    runs = {}
    for plain in (False, True):
        for c in counters.values():
            c.launches = 0
        t0 = time.perf_counter()
        res = run_incremental_sfm_robust(seq, k, cfg, seed=SFM_SEED,
                                         restarts=3, device=dev, plain=plain)
        sync(dev)
        runs["plain" if plain else "kernels"] = dict(
            seconds=time.perf_counter() - t0,
            ate=trajectory_ate(res.rs, res.ts, centers),
            landmarks=len(res.points), quality=res.quality,
            centers=len(res.camera_centers),
            launches={n: c.launches for n, c in counters.items()})
    launches = runs["kernels"]["launches"]

    # PrecompMatches kernel vs plain on the same features and draws
    frames = torch.as_tensor(seq, dtype=torch.float32, device=dev)
    identical = {}
    for octaves in (1, PYRAMID_OCTAVES):
        ocfg = SfmConfig(pyramid_octaves=octaves)
        feats = precompute_frontend(frames, make_pairs(fc, device=dev), fc,
                                    chunk=ocfg.frontend_chunk,
                                    octaves=octaves)
        pm = [precompute_matching(
            feats, fc, torch.Generator(device=dev).manual_seed(SFM_SEED),
            len(seq), ocfg.ransac_threshold, ocfg.ransac_samples // 2,
            chunk=ocfg.frontend_chunk, plain=plain)
            for plain in (False, True)]
        identical[f"K{feats.bits.shape[1]}"] = dict(
            identical=all(torch.equal(a, b) for a, b in zip(*pm)),
            gated_matches=int(pm[0].good1.sum() + pm[0].good2.sum()))
        if octaves == 1:
            sfm_feats = feats

    # the batched entry at the chunks' shapes, beside its bound
    pair_list = sequence_pairs(len(seq))
    bits = sfm_feats.bits.contiguous()
    masks = sfm_feats.points.mask.contiguous()
    _, kk, p = bits.shape
    rows = {}
    for lo, hi in ((0, cfg.frontend_chunk), (cfg.frontend_chunk,
                                             len(pair_list))):
        ii = torch.tensor([t for t, _ in pair_list[lo:hi]],
                          dtype=torch.int32, device=dev)
        jj = torch.tensor([t - dt for t, dt in pair_list[lo:hi]],
                          dtype=torch.int32, device=dev)
        q = hi - lo
        # the bits and masks of the frames this chunk's pairs read, once
        nf = len(set(ii.tolist()) | set(jj.tolist()))
        b_ms, b_by = bound_ms(q * kk * kk * 4 + nf * kk * p + nf * kk + 8 * q,
                              2 * q * kk * kk * p, INT8_OPS_PER_S)
        fa, fb = bits[ii.long()].float(), bits[jj.long()].float()
        rows[f"Q{q}_K{kk}"] = dict(
            pairs=q, frames_read=nf, keypoints=kk, bits=p, bound_ms=b_ms,
            bound_by=b_by,
            graph_ms=graph_ms(lambda ii=ii, jj=jj:
                              hamming.hamming_distance_matrix_pairs(
                                  bits, masks, ii, jj)),
            call_ms=cuda_ms(lambda ii=ii, jj=jj:
                            hamming.hamming_distance_matrix_pairs(
                                bits, masks, ii, jj)),
            plain_call_ms=cuda_ms(
                lambda ii=ii, jj=jj: hamming.hamming_distance_matrix_pairs_plain(
                    bits, masks, ii, jj)),
            library_call_ms=cuda_ms(lambda fa=fa, fb=fb:
                                    torch.cdist(fa, fb, p=0)))

    result = {"phase": "precompute", "frames": list(seq.shape),
              "seed": SFM_SEED, "runs": runs,
              "single_scale": {key: single_scale[key] for key in
                               ("ate", "landmarks", "quality")},
              "jax_cpu_ate": PRECOMPUTE_JAX_ATE,
              "precomp_matches": identical, "rows": rows}
    emit(result)
    bad = []
    for label, run in runs.items():
        if (run["centers"] != len(seq)
                or not run["ate"] < PRECOMPUTE_ATE_MAX
                or run["landmarks"] <= 80):
            bad.append(f"{label} SfM out of bounds")
    if launches["hamming_pairs"] != 2 * 3:
        bad.append(f"batched Hamming: {launches['hamming_pairs']} launches,"
                   f" expected two a restart")
    for name in ("fast_score", "brief_bits", "schur"):
        if launches[name] < 1:
            bad.append(f"{name} not launched")
    bad += [f"PrecompMatches differ kernel vs plain at {key}"
            for key, v in identical.items() if not v["identical"]]
    if bad:
        raise AssertionError(f"precompute out of bounds: {bad}")
    return launches, rows


KERNEL_NAMES = {"fast_score": "fast_score_kernel",
                "brief_bits": "brief_kernel",
                "hamming": "hamming_mma_kernel",
                "schur": "schur_partial_kernel", "remap": "remap_kernel"}


def time_modes(dev, seq, k, counters):
    """timing_precompute and timing_fused, the script's last profiler
    session: one ``run_incremental_sfm`` at SFM_SEED each way: staged
    (``precompute_matching`` off), flag on, ``fused_steady_steps`` and
    ``run_incremental_sfm_fused`` (scan; both replay the fused phase's
    capture).  Wall and wrapper launches from unprofiled calls in that
    order (a replay adds the launches its capture recorded, so the fused
    and scan runs' Hamming and Schur counts equal the staged run's); busy,
    idle share and each kernel's launches by name from the trace (those
    inside graph replays too) from one profiler session over the four in
    turn (on, staged, fused, scan).  The flag on launches the batched
    Hamming entry twice and the single-pair entry never; off, the reverse
    (21 single launches).  Placed before the timing phases, a profiler session over
    whole SfM runs left the first of their sessions empty, so it comes
    after them.  Returns (the precompute timing, the fused timing)."""
    from photogrammetry_tpu_torch.kernels import hamming
    from photogrammetry_tpu_torch.sfm.incremental import (
        SfmConfig, run_incremental_sfm, run_incremental_sfm_fused,
    )

    counters = {**counters,
                "hamming_pairs": hamming.hamming_distance_matrix_pairs}
    cfg = SfmConfig(collect_diagnostics=False)
    runs = {
        "off": lambda: run_incremental_sfm(seq, k, cfg, seed=SFM_SEED,
                                           device=dev),
        "on": lambda: run_incremental_sfm(seq, k, SfmConfig(
            collect_diagnostics=False, precompute_matching=True),
            seed=SFM_SEED, device=dev),
        "fused": lambda: run_incremental_sfm(seq, k, SfmConfig(
            collect_diagnostics=False, fused_steady_steps=True),
            seed=SFM_SEED, device=dev),
        "scan": lambda: run_incremental_sfm_fused(seq, k, cfg,
                                                  seed=SFM_SEED, device=dev)}
    timing = {}
    for label, fn in runs.items():
        for c in counters.values():
            c.launches = 0
        wall = wall_ms(fn, dev)
        timing[label] = dict(
            launches={n: c.launches for n, c in counters.items()},
            wall_ms=wall)
    order = ("on", "off", "fused", "scan")
    _, profiled = profiled_runs(
        [runs[label] for label in order], dev, len(seq),
        walls=[timing[label]["wall_ms"] for label in order], top=False,
        names=tuple(KERNEL_NAMES.values()))
    for label, prof in zip(order, profiled):
        timing[label]["profiled"] = prof
    emit({"phase": "timing_precompute", "seed": SFM_SEED,
          **{label: timing[label] for label in ("off", "on")}})
    emit({"phase": "timing_fused", "seed": SFM_SEED,
          "staged": timing["off"],
          **{label: timing[label] for label in ("fused", "scan")}})
    on, off = timing["on"]["launches"], timing["off"]["launches"]
    if (on["hamming_pairs"], on["hamming"]) != (2, 0) \
            or (off["hamming_pairs"], off["hamming"]) != (0, 21):
        raise AssertionError(f"launches with the flag on / off: {timing}")
    for label in ("fused", "scan"):
        got, staged = timing[label]["launches"], timing["off"]["launches"]
        if any(got[n] != staged[n] for n in ("hamming", "schur")):
            raise AssertionError(f"{label} run's wrapper launches {got} "
                                 f"against the staged run's {staged}")
    if dev.type == "cuda":
        for label in ("fused", "scan"):
            got = timing[label]["profiled"]["trace_launches"]
            staged = timing["off"]["profiled"]["trace_launches"]
            # the eager prefix alone launches fewer: the rest ran in graphs
            missing = [n for n in ("hamming", "schur")
                       if not 1 <= got[KERNEL_NAMES[n]]
                       == staged[KERNEL_NAMES[n]]]
            if missing:
                raise AssertionError(f"{label} run's trace launches {got} "
                                     f"against the staged run's {staged}")
    return ({label: timing[label] for label in ("off", "on")},
            {"staged": timing["off"], "fused": timing["fused"],
             "scan": timing["scan"]})


def _staged_in_child(seq, k, seed, device_type):
    """One staged ``run_incremental_sfm`` in a spawned process (the fused
    phase's second process, on the card): ``run_bits`` of it."""
    from photogrammetry_tpu_torch.sfm.incremental import (
        SfmConfig, run_incremental_sfm,
    )

    return run_bits(run_incremental_sfm(
        seq, k, SfmConfig(collect_diagnostics=False), seed=seed,
        device=device_type))


def run_bits(res):
    """(rs, ts, landmarks, costs) of an SfmResult, as numpy."""
    return (res.rs, res.ts, res.table.points.cpu().numpy(),
            np.asarray(res.costs))


def bits_equal(a, b) -> bool:
    return all(np.array_equal(x, y) for x, y in zip(a, b))


def drive_fused(dev, seq, k, centers, counters):
    """The fused phase on the 12 frames at SFM_SEED, diagnostics off: the
    staged ``run_incremental_sfm`` twice, once more in a spawned process;
    ``fused_steady_steps=True`` (its first steady frame the warm-up, then
    the capture, then replays); ``run_incremental_sfm_fused`` (the same
    capture replayed); ``read_free`` with ``export=False`` and
    ``export_sfm_result``.  Gates: the staged runs bit-identical (rs, ts,
    landmarks, costs) in both processes; the fused and scan runs
    bit-identical to them; the capture's segments one more than its cuts;
    the read-free run a ``DeviceSfmResult`` on the card that bootstraps at
    min(bootstrap_max_defer, F-1), ATE < 0.2 and > 80 landmarks after the
    export.  Prints each run's wall and wrapper launches (the warm-up's
    and the replays'; a capture, which runs nothing, counts none), the
    capture's segments and cuts, the synchronisations of one replayed
    frame (``set_sync_debug_mode("warn")``) and the warm-up and capture
    ms."""
    import multiprocessing
    import warnings
    from dataclasses import replace

    import torch

    from photogrammetry_tpu_torch.sfm.incremental import (
        DeviceSfmResult, SfmConfig, export_sfm_result, run_incremental_sfm,
        run_incremental_sfm_fused, steady_step,
    )
    from photogrammetry_tpu_torch.sfm.metrics import trajectory_ate

    cfg = SfmConfig(collect_diagnostics=False)
    runs, bits = {}, {}

    def run(label, fn):
        for c in counters.values():
            c.launches = 0
        t0 = time.perf_counter()
        res = fn()
        sync(dev)
        wall = (time.perf_counter() - t0) * 1e3
        if isinstance(res, DeviceSfmResult):
            res = export_sfm_result(res)
        runs[label] = dict(
            wall_ms=wall, ate=trajectory_ate(res.rs, res.ts, centers),
            landmarks=len(res.points),
            pose_init=[i["pose_init"] for i in res.frame_info],
            launches={n: c.launches for n, c in counters.items()})
        bits[label] = run_bits(res)
        return res

    for label in ("staged", "staged_again"):
        run(label, lambda: run_incremental_sfm(seq, k, cfg, seed=SFM_SEED,
                                               device=dev))
    t0 = time.perf_counter()
    with multiprocessing.get_context("spawn").Pool(1) as pool:
        bits["second_process"] = pool.apply(_staged_in_child,
                                            (seq, k, SFM_SEED, dev.type))
    child_s = time.perf_counter() - t0
    run("fused", lambda: run_incremental_sfm(
        seq, k, replace(cfg, fused_steady_steps=True), seed=SFM_SEED,
        device=dev))
    step = steady_step(cfg, len(seq), dev)
    run("scan", lambda: run_incremental_sfm_fused(seq, k, cfg,
                                                  seed=SFM_SEED, device=dev))
    graph = step.graph      # None on a CPU rehearsal: the step is eager
    syncs = None
    if graph is not None:
        # the synchronisations of one replayed frame (the last frame's
        # inputs are still in the capture's buffers)
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                graph.replay()
            finally:
                torch.cuda.set_sync_debug_mode(0)
            sync(dev)
        syncs = sum("synchroniz" in str(w.message) for w in caught)
    handle = {}

    def read_free():
        res = run_incremental_sfm(seq, k, replace(cfg, read_free=True),
                                  seed=SFM_SEED, device=dev, export=False)
        handle.update(type=type(res).__name__, device=str(res.rs.device))
        return res

    read_free_res = run("read_free", read_free)
    boot = [i["frame"] for i in read_free_res.frame_info
            if i["pose_init"] == "bootstrap"]
    expect = min(cfg.bootstrap_max_defer, len(seq) - 1)
    same = {label: bits_equal(bits["staged"], bits[label])
            for label in ("staged_again", "second_process", "fused", "scan")}
    result = {"phase": "fused", "frames": list(seq.shape), "seed": SFM_SEED,
              "bit_identical_to_staged": same,
              "segments_per_steady_frame": graph and graph.segments,
              "cuts_per_steady_frame": graph and len(graph.cuts),
              "syncs_per_replayed_frame": syncs,
              "warm_up_ms": step.warm_up_ms, "capture_ms": step.capture_ms,
              "second_process_s": child_s, "runs": runs,
              "read_free": dict(handle, bootstrap_frames=boot,
                                expected=expect,
                                bootstrap_support=read_free_res.frame_info[
                                    boot[0] - 1].get("bootstrap_support")
                                if boot else None)}
    emit(result)
    bad = [f"{label} differs from the staged run"
           for label, ok in same.items() if not ok]
    if graph is not None and graph.segments != len(graph.cuts) + 1:
        bad.append("segments and cuts do not pair")
    if runs["fused"]["pose_init"].count("fused_step") < 1 \
            or runs["scan"]["pose_init"].count("scan") < 1:
        bad.append("no frame went through the step")
    rf = runs["read_free"]
    if handle.get("type") != "DeviceSfmResult" or boot != [expect] \
            or not rf["ate"] < 0.2 or rf["landmarks"] <= 80:
        bad.append(f"read_free run out of bounds: {result['read_free']}, "
                   f"{rf}")
    if bad:
        raise AssertionError(f"fused phase: {bad}")
    return result


def time_sfm(dev, frames, k, counters):
    """Phase 8, SfM part: the Schur kernel at the SfM path's and
    bench_all.py's shapes; bundle_adjust iterations/s; one
    run_incremental_sfm's frames/s, busy time and idle share, and its
    launches (BRIEF: one, for all 12 frames)."""
    import torch

    from photogrammetry_tpu_torch.kernels import schur
    from photogrammetry_tpu_torch.sfm.ba import (
        BAProblem, BAState, bundle_adjust, project,
    )
    from photogrammetry_tpu_torch.sfm.incremental import (
        SfmConfig, run_incremental_sfm,
    )

    rows = {}
    for f, t in SCHUR_SHAPES[:2]:
        args = schur_inputs(dev, f, t, seed=f * t)
        # the library yardstick runs on operands flattened to (6F, 3T)
        # beforehand: the flattening is not in its time
        a, b = (x.permute(0, 2, 1, 3).reshape(6 * f, 3 * t).contiguous()
                for x in args[:2])
        bp = args[2].reshape(-1)
        rows[f"F{f}_T{t}"] = time_row(dict(
            run=lambda args=args: schur.schur_products(*args),
            plain=lambda args=args: schur.schur_products_plain(*args),
            library=lambda a=a, b=b, bp=bp: (torch.matmul(a, b.T), a @ bp),
            bytes=2 * (6 * f * 3 * t) * 4 + 3 * t * 4 + (6 * f) ** 2 * 4
            + 6 * f * 4,
            ops=2 * (6 * f) ** 2 * 3 * t + 2 * 6 * f * 3 * t))
        # device time per call (graph replay, both kernels and the gap
        # between them; at the plan's own number of landmark slabs S in
        # graph_ms) at each S
        tiles_t = -(-t // schur.TILE_T)
        rows[f"F{f}_T{t}"].update(
            slabs=schur.split_plan(f, t).slabs,
            graph_ms_by_slabs={
                str(schur.split_plan(f, t, s).slabs): graph_ms(
                    lambda args=args, s=s: schur.schur_products(*args,
                                                                slabs=s))
                for s in (1, 4, 8, 16, 32, 64, 128) if s <= tiles_t})
    # what one launch of a kernel that does nothing costs: per call from
    # the host (CUDA events around a loop) and on the device (graph replay)
    empty = dict(call_ms=cuda_ms(lambda: schur.launch_empty(dev)),
                 graph_ms=graph_ms(lambda: schur.launch_empty(dev)))
    emit({"phase": "timing_schur", "rows": rows, "empty_launch": empty,
          "inputs": "hot in L2: back-to-back calls on the same operands "
                    "(1.8 MB and 9.5 MB)"})

    # bench_all.py:92-109's BA problem: 16 cameras x 4096 landmarks
    f, t, iters = 16, 4096, 10
    rng = np.random.default_rng(0)
    kb = torch.tensor([[520.0, 0, 320], [0, 520.0, 240], [0, 0, 1]],
                      device=dev)
    pts = torch.tensor(rng.uniform(-2, 2, (t, 3)) + [0, 0, 6],
                       dtype=torch.float32, device=dev)
    rs = torch.eye(3, device=dev).repeat(f, 1, 1)
    ts = torch.tensor(rng.normal(0, 0.1, (f, 3)), dtype=torch.float32,
                      device=dev)
    obs = project(rs, ts, pts, kb)[0] + torch.tensor(
        rng.normal(0, 0.5, (f, t, 2)), dtype=torch.float32, device=dev)
    state = BAState(rs=rs, ts=ts, points=pts + torch.tensor(
        rng.normal(0, 0.05, (t, 3)), dtype=torch.float32, device=dev))
    prob = BAProblem(obs=obs, mask=torch.ones((f, t), dtype=torch.bool,
                                              device=dev), k=kb)
    ba = {}
    for plain in (False, True, True, False):    # in turns
        label = "plain" if plain else "kernel"

        def call(plain=plain):
            return bundle_adjust(state, prob, num_iterations=iters,
                                 plain=plain)

        ms = host_ms(call, reps=5)
        ba.setdefault(label, []).append(ms)
    result = {"phase": "timing_ba", "cameras": f, "landmarks": t,
              "iterations": iters}
    for label, ms in ba.items():
        busy, top = device_profile(
            lambda plain=(label == "plain"): bundle_adjust(
                state, prob, num_iterations=iters, plain=plain),
            iters=2, top=6)
        result[label] = dict(wall_ms=ms, iters_per_s=[iters * 1e3 / m
                                                      for m in ms],
                             device_busy_ms=busy, top_device_ops=top)
    emit(result)

    cfg = SfmConfig(collect_diagnostics=False)
    sfm = {"phase": "timing_sfm", "frames": list(frames.shape)}
    for label, plain in (("kernel", False), ("plain", True)):
        def run(plain=plain):
            return run_incremental_sfm(frames, k, cfg, seed=SFM_SEED,
                                       device=dev, plain=plain)

        for c in counters.values():
            c.launches = 0
        run()                                           # the warm-up
        launches = {n: c.launches for n, c in counters.items()}
        wall = host_ms(run, reps=1, warm=False)
        entry = dict(wall_ms=wall, frames_per_s=len(frames) * 1e3 / wall,
                     launches=launches)
        if not plain:
            busy, top = device_profile(run, iters=1, top=10, warm=False)
            entry.update(device_busy_ms=busy,
                         device_idle_share=max(0.0, 1 - busy / wall),
                         top_device_ops=top)
        sfm[label] = entry
    emit(sfm)
    if sfm["kernel"]["launches"]["brief_bits"] != 1:
        raise AssertionError(f"BRIEF launches on run_incremental_sfm: "
                             f"{sfm['kernel']['launches']}")
    return rows


def check_loop_kernels(dev, counters) -> float:
    """loop_parity: the batched Hamming kernel against its plain version,
    bit for bit, at every Q, K and P of LOOP_PARITY_*, with ragged masks
    (one frame all masked) and pairs that repeat a frame (ii == jj); then
    the chunked ``pairwise_match_counts`` against its plain path at
    LOOP_GRID_FRAMES frames of SFM_KEYPOINTS x 256 bits, launches counted
    (one a chunk).  Returns the worst |kernel - plain| (0 when exact)."""
    import torch

    from photogrammetry_tpu_torch.kernels import hamming
    from photogrammetry_tpu_torch.sfm.loop_closure import (
        pair_chunk, pairwise_match_counts,
    )

    gen = torch.Generator(device=dev).manual_seed(7)

    def inputs(f, k, p, q):
        bits = torch.randint(0, 2, (f, k, p), generator=gen,
                             device=dev).to(torch.uint8)
        masks = torch.rand((f, k), generator=gen, device=dev) > 0.2
        masks[f - 1] = False
        ii = torch.randint(0, f, (q,), generator=gen, device=dev)
        jj = torch.randint(0, f, (q,), generator=gen, device=dev)
        jj[: q // 3] = ii[: q // 3]
        return bits, masks, ii.to(torch.int32), jj.to(torch.int32)

    cases = []
    for q in LOOP_PARITY_PAIRS:
        for k in LOOP_PARITY_KEYPOINTS:
            for p in LOOP_PARITY_BITS:
                args = inputs(23, k, p, q)
                counters["hamming_pairs"].launches = 0
                got = hamming.hamming_distance_matrix_pairs(*args)
                launched = counters["hamming_pairs"].launches
                ref = hamming.hamming_distance_matrix_pairs_plain(*args)
                cases.append(dict(case="pairs", pairs=q, keypoints=k,
                                  bits=p, launches=launched,
                                  tile=list(hamming.tile_plan(k, k, q)[:4]),
                                  max_abs_err=max_err(got, ref),
                                  exact=bool(torch.equal(got, ref))
                                  and launched == 1))
                del got, ref, args
    for f in LOOP_GRID_FRAMES:
        bits, masks, _, _ = inputs(f, SFM_KEYPOINTS, 256, 1)
        chunks = -(-f * f // pair_chunk(SFM_KEYPOINTS))
        counters["hamming_pairs"].launches = 0
        got = pairwise_match_counts(bits, masks, 80)
        launched = counters["hamming_pairs"].launches
        ref = pairwise_match_counts(bits, masks, 80, plain=True)
        cases.append(dict(case="pair_grid", frames=f, pairs=f * f,
                          chunks=chunks, launches=launched,
                          max_abs_err=max_err(got, ref),
                          exact=bool(torch.equal(got, ref))
                          and launched == chunks))
    sync(dev)
    emit({"phase": "loop_parity", "cases": cases,
          "exact": all(c["exact"] for c in cases)})
    bad = [c for c in cases if not c["exact"]]
    if bad:
        raise AssertionError(f"batched Hamming disagrees with its plain "
                             f"version or launched more than once a "
                             f"chunk: {bad}")
    return max(c["max_abs_err"] for c in cases)


def out_and_back(seq, centers):
    """The pan traversed out and back: 2F - 1 frames, frame j the same as
    frame 2F - 2 - j, and their ground-truth camera centres."""
    return (np.concatenate([seq, seq[-2::-1]]),
            np.concatenate([centers, centers[-2::-1]]))


def drive_loop_closure(dev, seq, k, centers, counters, out_dir):
    """The loop-closure phase: one ``run_incremental_sfm`` over the 23-frame
    out-and-back pan, then ``close_loops`` in 'revisit' and 'rotation' mode
    on its trajectory (launches counted from just before the SfM run to
    just after the second close_loops), then both modes again with the
    plain versions on the same features and trajectory, and on CPU copies
    of them (the CPU path that the tests hold to the JAX package, so a
    fault that the card's kernel and plain paths share shows as well);
    and one ``run_sfm --loop-closure --loop-mode revisit`` on a frames
    directory of the 23 frames.  Returns the launches and what the timing
    phase needs."""
    import torch

    from photogrammetry_tpu_torch.cli import run_sfm
    from photogrammetry_tpu_torch.sfm.frontend import (
        DescribedFrame, frame_features, make_pairs, precompute_frontend,
    )
    from photogrammetry_tpu_torch.sfm.incremental import (
        SfmConfig, run_incremental_sfm,
    )
    from photogrammetry_tpu_torch.sfm.loop_closure import (
        close_loops, pair_chunk,
    )
    from photogrammetry_tpu_torch.sfm.metrics import trajectory_ate

    frames, gt = out_and_back(seq, centers)
    n = len(frames)
    cfg = SfmConfig(collect_diagnostics=False)     # run_sfm's configuration
    kmat = torch.as_tensor(k, device=dev)

    def close(feats, rs, ts, mode, plain):
        on = rs.device
        gen = torch.Generator(device=on).manual_seed(run_sfm.LOOP_SEED)
        return close_loops(feats, rs, ts, kmat.to(on), cfg.frontend,
                           generator=gen, min_gap=LOOP_MIN_GAP, mode=mode,
                           plain=plain)

    for c in counters.values():
        c.launches = 0
    t0 = time.perf_counter()
    res = run_incremental_sfm(frames, k, cfg, seed=LOOP_SEED, device=dev)
    sync(dev)
    sfm_s = time.perf_counter() - t0
    stacked = precompute_frontend(
        torch.as_tensor(frames, dtype=torch.float32, device=dev),
        make_pairs(cfg.frontend, device=dev), cfg.frontend,
        chunk=cfg.frontend_chunk)
    feats = [frame_features(stacked, t) for t in range(n)]
    stacked_cpu = DescribedFrame(
        points=type(stacked.points)(*(x.cpu() for x in stacked.points)),
        bits=stacked.bits.cpu(), xy=stacked.xy.cpu())
    feats_cpu = [frame_features(stacked_cpu, t) for t in range(n)]
    rs0 = torch.as_tensor(res.rs, device=dev)
    ts0 = torch.as_tensor(res.ts, device=dev)
    runs = {}
    for mode in ("revisit", "rotation"):
        t0 = time.perf_counter()
        runs[mode] = close(feats, rs0, ts0, mode, plain=False)
        sync(dev)
        runs[mode] += (time.perf_counter() - t0,)
    launches = {name: c.launches for name, c in counters.items()}
    chunks = -(-n * n // pair_chunk(SFM_KEYPOINTS))

    result = {"phase": "loop_closure", "frames": list(frames.shape),
              "seed": LOOP_SEED, "min_gap": LOOP_MIN_GAP,
              "sfm": dict(seconds=sfm_s,
                          ate=trajectory_ate(res.rs, res.ts, gt),
                          landmarks=len(res.points)),
              "chunks_per_pass": chunks, "launches": launches}
    bad = []
    def pose_diff(a, b):
        return max(max_err(torch.as_tensor(a[0]).cpu(),
                           torch.as_tensor(b[0]).cpu()),
                   max_err(torch.as_tensor(a[1]).cpu(),
                           torch.as_tensor(b[1]).cpu()))

    for mode, (rs_o, ts_o, info, seconds) in runs.items():
        rs_p, ts_p, info_p = close(feats, rs0, ts0, mode, plain=True)
        rs_c, ts_c, info_c = close(feats_cpu, rs0.cpu(), ts0.cpu(), mode,
                                   plain=True)
        correction = pose_diff((rs_c, ts_c), (rs0, ts0))
        counts = info["counts"]
        fold = np.arange(n)
        edges = [tuple(e) for e in info["loop_edges"]]
        entry = dict(
            seconds=seconds, loop_edges=[list(e) for e in edges],
            rejected_edges=len(info["rejected_edges"]),
            support=info.get("inliers"),
            fold_counts=counts[fold, n - 1 - fold].tolist(),
            self_counts=counts[fold, fold].tolist(),
            cost=info.get("cost"), initial_cost=info.get("initial_cost"),
            ate_before=result["sfm"]["ate"],
            ate_after=trajectory_ate(rs_o, ts_o, gt),
            counts_equal_plain=bool(np.array_equal(counts,
                                                   info_p["counts"])),
            edges_equal_plain=edges == [tuple(e) for e in
                                        info_p["loop_edges"]],
            pose_max_abs_diff_kernel_vs_plain=pose_diff((rs_o, ts_o),
                                                        (rs_p, ts_p)),
            counts_equal_cpu=bool(np.array_equal(counts, info_c["counts"])),
            edges_equal_cpu=edges == [tuple(e) for e in
                                      info_c["loop_edges"]],
            cost_cpu=info_c.get("cost"),
            initial_cost_cpu=info_c.get("initial_cost"),
            pose_max_abs_diff_card_vs_cpu=pose_diff((rs_o, ts_o),
                                                    (rs_c, ts_c)),
            correction_cpu=correction)
        result[mode] = entry
        if not (entry["counts_equal_plain"] and entry["edges_equal_plain"]):
            bad.append(f"{mode}: kernel and plain paths differ")
        if not (entry["counts_equal_cpu"] and entry["edges_equal_cpu"]):
            bad.append(f"{mode}: card and CPU paths differ")
        if entry["fold_counts"] != entry["self_counts"]:
            bad.append(f"{mode}: a fold pair's count is not its diagonal")
        if not edges or any(i + j != n - 1 for i, j in edges):
            bad.append(f"{mode}: an accepted edge is not a fold pair")
        if not entry["cost"] <= entry["initial_cost"]:
            bad.append(f"{mode}: the pose-graph cost rose")
        if not entry["pose_max_abs_diff_kernel_vs_plain"] < 1e-4:
            bad.append(f"{mode}: poses differ kernel vs plain")
        if not (abs(entry["cost"] - entry["cost_cpu"])
                <= LOOP_CPU_COST_SHARE * entry["initial_cost_cpu"]):
            bad.append(f"{mode}: final cost differs card vs CPU")
        if not (entry["pose_max_abs_diff_card_vs_cpu"]
                <= LOOP_CPU_POSE_SHARE * correction):
            bad.append(f"{mode}: poses differ card vs CPU")
        if not entry["ate_after"] < 0.2:
            bad.append(f"{mode}: ATE after loop closure")

    # the CLI on a frames directory of the 23 frames
    frames_dir = f"{out_dir}/loop_frames"
    write_frames(frames, frames_dir)
    t0 = time.perf_counter()
    cli = run_cli([frames_dir, "--fx", str(k[0, 0]), "--cx", str(k[0, 2]),
                   "--cy", str(k[1, 2]), "--loop-closure", "--loop-mode",
                   "revisit", "--device", str(dev),
                   "--cloud", f"{out_dir}/loop_cloud.ply",
                   "--trajectory", f"{out_dir}/loop_trajectory.json"])
    with open(f"{out_dir}/loop_trajectory.json") as fh:
        traj = json.load(fh)
    cli_edges = [tuple(e) for e in cli["loop_closure"]["loop_edges"]]
    result["run_sfm_loop_closure"] = dict(
        seconds=time.perf_counter() - t0, loop_closure=cli["loop_closure"],
        landmarks=cli["landmarks"], quality=cli.get("quality"),
        ate=trajectory_ate(traj["rotations"], traj["translations"], gt))
    if not cli_edges or any(i + j != n - 1 for i, j in cli_edges) \
            or len(traj["centers"]) != n:
        bad.append("run_sfm --loop-closure: no edge, or not fold pairs")
    missing = [name for name, v in launches.items() if v < 1
               and name != "remap"]
    if missing:
        bad.append(f"kernels not launched on the loop path: {missing}")
    if launches["hamming_pairs"] != 2 * chunks:
        bad.append(f"batched Hamming launches {launches['hamming_pairs']}, "
                   f"expected one a chunk: {2 * chunks}")
    emit(result)
    if bad:
        raise AssertionError(f"loop closure out of bounds: {bad}")
    return launches, dict(stacked=stacked, feats=feats, rs=rs0, ts=ts0,
                          cfg=cfg, kmat=kmat,
                          revisit_edges=result["revisit"]["loop_edges"])


def drive_checkpoint(dev, seq, k, centers, counters, out_dir):
    """The checkpoint phase: ``run_incremental_sfm(checkpoint_path=...,
    checkpoint_every=4)`` on the 12-frame pan, its snapshot reloaded equal
    to the run's state (the run without final BA rounds, so that its result
    is the state at the last frame); then the first 8 frames run alone
    (snapshot at frame 7) and the run resumed from it over the 12 frames,
    held to the SfM gate (ATE < 0.2, > 80 landmarks) and to running frames
    8-11 and no other (its frame_info: a resume that restarted from frame
    1 would list them all)."""
    import dataclasses

    import torch

    from photogrammetry_tpu_torch.sfm.incremental import (
        SfmConfig, run_incremental_sfm,
    )
    from photogrammetry_tpu_torch.sfm.metrics import trajectory_ate
    from photogrammetry_tpu_torch.store.checkpoint import load_checkpoint

    cfg = SfmConfig(collect_diagnostics=False)
    path, cut = f"{out_dir}/sfm.npz", f"{out_dir}/cut.npz"
    for c in counters.values():
        c.launches = 0
    t0 = time.perf_counter()
    res = run_incremental_sfm(seq, k, dataclasses.replace(
        cfg, final_ba_iterations=0), seed=SFM_SEED, checkpoint_path=path,
        checkpoint_every=4, device=dev)
    launches = {name: c.launches for name, c in counters.items()}
    rs, ts, table, done, meta = load_checkpoint(path, device=dev)
    same = (done == len(seq) - 1
            and np.array_equal(rs.cpu().numpy(), res.rs)
            and np.array_equal(ts.cpu().numpy(), res.ts)
            and all(torch.equal(a, b) for a, b in zip(table, res.table)))
    run_incremental_sfm(seq[:8], k, cfg, seed=SFM_SEED, checkpoint_path=cut,
                        checkpoint_every=4, device=dev)
    cut_at = load_checkpoint(cut, device=dev)[3]
    resumed = run_incremental_sfm(seq, k, cfg, seed=SFM_SEED,
                                  checkpoint_path=cut, device=dev)
    sync(dev)
    result = {"phase": "checkpoint", "frames": list(seq.shape),
              "seed": SFM_SEED, "snapshot_frame": done, "meta": meta,
              "snapshot_equals_run": bool(same), "cut_at": cut_at,
              "resumed": dict(ate=trajectory_ate(resumed.rs, resumed.ts,
                                                 centers),
                              frames_run=[i["frame"]
                                          for i in resumed.frame_info],
                              landmarks=len(resumed.points),
                              centers=len(resumed.camera_centers),
                              costs=len(resumed.costs)),
              "seconds": time.perf_counter() - t0, "launches": launches}
    emit(result)
    r = result["resumed"]
    if not same or cut_at != 7 or r["centers"] != len(seq) \
            or r["frames_run"] != list(range(cut_at + 1, len(seq))) \
            or not r["ate"] < 0.2 or r["landmarks"] <= 80:
        raise AssertionError(f"checkpoint/resume out of bounds: {result}")


def profiled_run(fn, dev, frames: int, wall=None, top: bool = True):
    """(fn's result, its timing) for ONE call of ``fn`` over ``frames``
    frames under torch.profiler's device activity: ``profiled_runs`` of
    one function."""
    outs, timings = profiled_runs([fn], dev, frames, [wall], top)
    return outs[0], timings[0]


# The device kernel that separates the calls of one profiler session
# (torch.cuda._sleep's)
MARKER_KERNEL = "spin_kernel"


def profiled_runs(fns, dev, frames: int, walls=None, top: bool = True,
                  names=()):
    """(results, timings): one call of each of ``fns`` over ``frames``
    frames, in turn, under ONE torch.profiler session of device activity,
    the calls parted on the device by a marker kernel.  Each timing: the
    wall ms (the caller's unprofiled one from ``walls`` where given, else
    the host clock inside the session, the profiler's CUPTI tracing
    included), frames/s, device busy ms (the raw device events'
    durations summed: the profiler's own event list, ``key_averages``,
    takes far longer to build for a whole SfM run), idle share, with
    ``top`` the top device ops by name, the count of device events whose
    name holds each of ``names`` (a kernel's launches, those inside
    CUDA-graph replays among them), and the ms spent after the calls
    reading the trace.  Busy time and ops are None where the profiler
    recorded nothing (and on a CPU rehearsal)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    walls = walls or [None] * len(fns)

    def timing(wall_ms, busy=None, ops=None, post=None, launches=None):
        return dict(frames=frames, wall_ms=wall_ms,
                    frames_per_s=frames * 1e3 / wall_ms,
                    device_busy_ms=busy,
                    device_idle_share=(None if busy is None
                                       else max(0.0, 1 - busy / wall_ms)),
                    top_device_ops=ops, profiler_post_ms=post,
                    **({"trace_launches": launches} if names else {}))

    outs, host = [], []
    if dev.type != "cuda":          # a rehearsal on the CPU: no device
        for fn, wall in zip(fns, walls):
            t0 = time.perf_counter()
            outs.append(fn())
            host.append((time.perf_counter() - t0) * 1e3)
        return outs, [timing(wall if wall is not None else ms)
                      for ms, wall in zip(host, walls)]
    sync(dev)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for i, fn in enumerate(fns):
            if i:
                torch.cuda._sleep(1)
                sync(dev)
            t0 = time.perf_counter()
            outs.append(fn())
            sync(dev)
            host.append((time.perf_counter() - t0) * 1e3)
        t1 = time.perf_counter()
    events = sorted(((e.start_ns(), e.duration_ns() / 1e6, e.name())
                     for e in prof.profiler.kineto_results.events()
                     if e.device_type() == DeviceType.CUDA),
                    key=lambda e: e[0])
    calls = [[]]
    for start, ms, name in events:
        if MARKER_KERNEL in name:
            calls.append([])
        else:
            calls[-1].append((ms, name))
    if len(calls) != len(fns):
        raise RuntimeError(f"profiled_runs: {len(calls) - 1} markers "
                           f"recorded between {len(fns)} calls")
    post = (time.perf_counter() - t1) * 1e3
    timings = []
    for got, ms, wall in zip(calls, host, walls):
        busy, by_name = 0.0, {}
        for dur, name in got:
            busy += dur
            total, n = by_name.get(name, (0.0, 0))
            by_name[name] = (total + dur, n + 1)
        ops = None
        if top:
            ops = [dict(name=name[:90], ms=t, calls=n)
                   for name, (t, n) in sorted(
                       by_name.items(), key=lambda kv: -kv[1][0])[:6]]
        launches = {n: sum(c for key, (_, c) in by_name.items() if n in key)
                    for n in names}
        timings.append(timing(wall if wall is not None else ms,
                              busy or None, ops, post, launches))
    return outs, timings


def wall_ms(fn, dev) -> float:
    """Host-clock ms of one call of ``fn`` ending in a device synchronize
    (the caller has just run the same code: no warm-up)."""
    sync(dev)
    t0 = time.perf_counter()
    fn()
    sync(dev)
    return (time.perf_counter() - t0) * 1e3


def features_equal(a, b) -> bool:
    """Two DescribedFrames (or lists of them) identical leaf by leaf."""
    import torch

    if isinstance(a, list):
        return all(features_equal(x, y) for x, y in zip(a, b))
    return all(torch.equal(x, y) for x, y in
               zip([*a.points, a.bits, a.xy], [*b.points, b.bits, b.xy]))


def write_frames(frames, frames_dir) -> None:
    """The frames as numbered BMP files (run_sfm's frames directory)."""
    import os

    from photogrammetry_tpu_torch.io.image import write_image

    os.makedirs(frames_dir, exist_ok=True)
    for i, frame in enumerate(frames):
        write_image(f"{frames_dir}/{i:02d}.bmp", frame)


def run_cli(args) -> dict:
    """``run_sfm.main(args)``, its JSON report parsed."""
    import contextlib
    import io

    from photogrammetry_tpu_torch.cli import run_sfm

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        if run_sfm.main(args) != 0:
            raise AssertionError(f"run_sfm {args} failed")
    return json.loads(out.getvalue().splitlines()[0])


def drive_keyframes(dev, seq, k, centers, counters, out_dir):
    """The keyframes phase: ``run_keyframed_sfm(restarts=3)`` on the
    12-frame pan at KF_DISP_PX and KF_SEED, launches counted; keyframe
    selection and localization each again with the plain versions (the
    same keyframes and features; on the run's own map the same path per
    frame and poses within 1e-4); every frame posed; ATE of the full
    trajectory and of the keyframe map and fallbacks, reported; one
    ``run_sfm --keyframe-disp`` on the frames as files; then one keyframed
    run (restarts 1) timed: wall from one call, busy time from a second
    under the profiler."""
    from photogrammetry_tpu_torch.sfm.incremental import SfmConfig
    from photogrammetry_tpu_torch.sfm.keyframes import (
        localize_nonkeyframes, run_keyframed_sfm, select_keyframes,
    )
    from photogrammetry_tpu_torch.sfm.metrics import trajectory_ate

    cfg = SfmConfig(collect_diagnostics=False)    # run_sfm's configuration
    for c in counters.values():
        c.launches = 0
    t0 = time.perf_counter()
    rs, ts, kfs, res, info = run_keyframed_sfm(
        seq, k, cfg, min_disp_px=KF_DISP_PX, seed=KF_SEED, restarts=3,
        device=dev)
    sync(dev)
    seconds = time.perf_counter() - t0
    launches = {name: c.launches for name, c in counters.items()}

    kfs_k, feats_k = select_keyframes(seq, cfg, KF_DISP_PX, device=dev)
    kfs_p, feats_p = select_keyframes(seq, cfg, KF_DISP_PX, device=dev,
                                      plain=True)
    loc = {plain: localize_nonkeyframes(seq, kfs, feats_k, res, k, cfg,
                                        seed=KF_SEED + 99, device=dev,
                                        plain=plain)
           for plain in (False, True)}
    paths = {plain: [i.get("path", "fallback") for i in v[2]]
             for plain, v in loc.items()}
    pose_diff = max(float(np.abs(loc[False][0] - loc[True][0]).max()),
                    float(np.abs(loc[False][1] - loc[True][1]).max()))

    frames_dir = f"{out_dir}/keyframe_frames"
    write_frames(seq, frames_dir)
    t1 = time.perf_counter()
    cli = run_cli([frames_dir, "--fx", str(k[0, 0]), "--cx", str(k[0, 2]),
                   "--cy", str(k[1, 2]), "--keyframe-disp", str(KF_DISP_PX),
                   "--device", str(dev), "--cloud", f"{out_dir}/kf.ply",
                   "--trajectory", f"{out_dir}/kf.json"])
    with open(f"{out_dir}/kf.json") as fh:
        traj = json.load(fh)
    cli_s = time.perf_counter() - t1

    def once():
        return run_keyframed_sfm(seq, k, cfg, min_disp_px=KF_DISP_PX,
                                 seed=KF_SEED, device=dev)

    _, timing = profiled_run(once, dev, len(seq),
                             wall=wall_ms(once, dev))
    result = {
        "phase": "keyframes", "frames": list(seq.shape),
        "min_disp_px": KF_DISP_PX, "seed": KF_SEED, "seconds": seconds,
        "keyframes": kfs, "keyframes_plain": kfs_p,
        "features_identical": features_equal(feats_k, feats_p),
        "info": info, "fallbacks": sum(bool(i.get("fallback"))
                                       for i in info),
        "posed_frames": int(np.isfinite(rs).all(axis=(1, 2)).sum()),
        "ate": trajectory_ate(rs, ts, centers),
        "ate_keyframes": trajectory_ate(res.rs, res.ts, centers[kfs]),
        "landmarks": len(res.points), "quality": res.quality,
        "localize_paths_equal_plain": paths[False] == paths[True],
        "localize_pose_max_abs_diff_kernel_vs_plain": pose_diff,
        "run_sfm_keyframe_disp": dict(
            seconds=cli_s, keyframes=cli.get("keyframes"),
            quality=cli.get("quality"), centers=len(traj["centers"]),
            ate=trajectory_ate(traj["rotations"], traj["translations"],
                               centers)),
        "timing": timing, "launches": launches}
    emit(result)
    bad = []
    if not kfs == kfs_k == kfs_p or not 4 <= len(kfs) <= 8:
        bad.append("keyframes differ kernel vs plain, or not 4-8 of 12")
    if not result["features_identical"]:
        bad.append("keyframe features differ kernel vs plain")
    if not result["localize_paths_equal_plain"] or not pose_diff < 1e-4:
        bad.append("localization differs kernel vs plain")
    if result["posed_frames"] != len(seq) or rs.shape[0] != len(seq):
        bad.append("a frame without a pose")
    if cli.get("keyframes") != kfs or len(traj["centers"]) != len(seq):
        bad.append("run_sfm --keyframe-disp")
    if bad:
        raise AssertionError(f"keyframes out of bounds: {bad}")
    return launches


def drive_submaps(dev, seq, k, rs_gt, centers, counters, out_dir):
    """The submaps phase: ``run_sfm --submap-frames 12 --submap-overlap 4
    --loop-closure --loop-mode revisit --loop-min-gap 5`` on the 23-frame
    out-and-back pan as files, launches counted, its wall time (frames/s)
    the host clock around that call; the restarts each window took
    (``run_incremental_sfm`` calls by seed), each window's ATE and the
    stitched trajectory's (``run_submap_sfm``'s result) and the cross-seam
    refine's inputs, all spied on; spans, tracks, drops, loop edges, ATE
    before and after the refine; every accepted edge a fold pair, 23
    poses.  Then ``refine_submaps_global`` on the run's merged tracks and
    loop links under the ground-truth trajectory (the run's own stitch
    may fail: PERF.md), once with the kernels under the profiler (its
    busy time and idle share) and once with the plain versions: more than
    SUBMAP_REFINE_MIN_LANDMARKS landmarks, poses within
    SUBMAP_REFINE_POSE_SHARE of the correction the plain refine made."""
    from photogrammetry_tpu_torch.sfm import incremental, submaps
    from photogrammetry_tpu_torch.sfm.metrics import trajectory_ate

    import os

    frames, gt = out_and_back(seq, centers)
    n = len(frames)
    frames_dir = f"{out_dir}/loop_frames"       # written by the loop phase
    if not os.path.isdir(frames_dir) or len(os.listdir(frames_dir)) != n:
        write_frames(frames, frames_dir)
    windows, stitched, refines = {}, [], []
    run_one, run_all, refine = (incremental.run_incremental_sfm,
                                submaps.run_submap_sfm,
                                submaps.refine_submaps_global)

    def counting(frames_w, *args, seed=0, **kwargs):
        windows.setdefault(seed % 7919, []).append(len(frames_w))
        return run_one(frames_w, *args, seed=seed, **kwargs)

    def stitching(*args, **kwargs):
        res = run_all(*args, **kwargs)      # the CLI replaces its poses
        stitched.append((res, res.rs.copy(), res.ts.copy()))
        return res

    def spying(*args, **kwargs):
        refines.append((args, kwargs))
        return refine(*args, **kwargs)

    incremental.run_incremental_sfm = counting
    submaps.run_submap_sfm = stitching
    submaps.refine_submaps_global = spying
    for c in counters.values():
        c.launches = 0
    sync(dev)
    t0 = time.perf_counter()
    try:
        cli = run_cli([
            frames_dir, "--fx", str(k[0, 0]), "--cx", str(k[0, 2]),
            "--cy", str(k[1, 2]), "--submap-frames", str(SUBMAP_FRAMES),
            "--submap-overlap", str(SUBMAP_OVERLAP), "--loop-closure",
            "--loop-mode", "revisit", "--loop-min-gap", str(LOOP_MIN_GAP),
            "--device", str(dev), "--cloud", f"{out_dir}/sub.ply",
            "--trajectory", f"{out_dir}/sub.json"])
        sync(dev)
    finally:
        incremental.run_incremental_sfm = run_one
        submaps.run_submap_sfm = run_all
        submaps.refine_submaps_global = refine
    wall = (time.perf_counter() - t0) * 1e3
    launches = {name: c.launches for name, c in counters.items()}
    with open(f"{out_dir}/sub.json") as fh:
        traj = json.load(fh)
    edges = [tuple(e) for e in cli["loop_closure"]["loop_edges"]]
    res, rs_stitched, ts_stitched = stitched[0]
    args, kwargs = refines[0]
    rs_in, ts_in = args[0], args[1]

    # the refine under the ground truth, kernels against plain
    rs_true = np.concatenate([rs_gt, rs_gt[-2::-1]]).astype(np.float32)
    ts_true = -np.einsum("fij,fj->fi", rs_true, gt).astype(np.float32)
    true_args = (rs_true, ts_true, *args[2:])
    def refine_true():
        return refine(*true_args, **kwargs)

    (rs_k, ts_k, pts_k), refine_timing = profiled_run(
        refine_true, dev, n, wall=wall_ms(refine_true, dev))
    rs_p, ts_p, pts_p = refine(*true_args, **{**kwargs, "plain": True})
    correction = max(float(np.abs(rs_p - rs_true).max()),
                     float(np.abs(ts_p - ts_true).max()))
    diff = max(float(np.abs(rs_k - rs_p).max()),
               float(np.abs(ts_k - ts_p).max()))
    result = {
        "phase": "submaps", "frames": list(frames.shape),
        "submap_frames": SUBMAP_FRAMES, "overlap": SUBMAP_OVERLAP,
        "submaps": cli["submaps"],
        "restarts_per_window": {str(w): len(v)
                                for w, v in sorted(windows.items())},
        "windows_ate": [trajectory_ate(w.rs, w.ts, gt[a:b])
                        for w, (a, b) in zip(res.submaps, res.spans)],
        # a window's turn, first camera to last, beside the truth's: the
        # ATE of centres alone cannot tell a window from its mirror image
        "windows_yaw_deg": [yaw_deg(w.rs[0], w.rs[-1]) for w in res.submaps],
        "windows_yaw_deg_true": [yaw_deg(rs_true[a], rs_true[b - 1])
                                 for a, b in res.spans],
        "ate_stitched": trajectory_ate(rs_stitched, ts_stitched, gt),
        "loop_closure": cli["loop_closure"], "landmarks": cli["landmarks"],
        "refine_calls": len(refines),
        "refine_prior_weight": kwargs.get("prior_weight"),
        "refine_loop_links": len(kwargs.get("loop_links") or []),
        "ate_before_refine": trajectory_ate(rs_in, ts_in, gt),
        "ate_after_refine": trajectory_ate(traj["rotations"],
                                           traj["translations"], gt),
        "centers": len(traj["centers"]),
        "timing": dict(frames=n, wall_ms=wall, frames_per_s=n * 1e3 / wall,
                       wall_from="the run_sfm call, unprofiled"),
        "refine_at_ground_truth": dict(
            landmarks=[len(pts_k), len(pts_p)],
            correction_plain=correction,
            pose_max_abs_diff_kernel_vs_plain=diff,
            ate_after=trajectory_ate(rs_k, ts_k, gt),
            timing=refine_timing),
        "launches": launches}
    emit(result)
    bad = []
    if not edges or any(i + j != n - 1 for i, j in edges):
        bad.append("no loop edge, or one that is not a fold pair")
    if result["centers"] != n:
        bad.append("not one pose a frame")
    if len(refines) != 1:
        bad.append("the cross-seam refine did not run once")
    if not min(len(pts_k), len(pts_p)) > SUBMAP_REFINE_MIN_LANDMARKS:
        bad.append("the refine at the ground truth kept too few landmarks")
    if not diff <= SUBMAP_REFINE_POSE_SHARE * correction:
        bad.append("refine poses differ kernel vs plain")
    if bad:
        raise AssertionError(f"submaps out of bounds: {bad}")
    return launches


def yaw_deg(r_first, r_last) -> float:
    """The yaw (degrees, about the camera's y axis) that turns a camera
    from world->camera rotation ``r_first`` to ``r_last``."""
    rel = np.asarray(r_last, np.float64) @ np.asarray(r_first, np.float64).T
    return float(np.degrees(np.arctan2(rel[0, 2], rel[0, 0])))


def drive_pyramid(dev, seq, k, centers, counters, single_scale):
    """The pyramid phase: ``run_incremental_sfm_robust(restarts=3)`` on the
    12-frame pan with ``pyramid_octaves=PYRAMID_OCTAVES`` (run_sfm's track
    capacity 1024 x octaves), launches counted (FAST and BRIEF once an
    octave a restart); the pyramid frontend's features with the kernels
    identical to the plain ones; ATE < 0.2 and > 80 landmarks (reported
    beside the single-scale sfm phase's); then one
    ``run_incremental_sfm`` timed: wall from one call, busy time from a
    second under the profiler."""
    import torch

    from photogrammetry_tpu_torch.sfm.frontend import (
        make_pairs, precompute_frontend,
    )
    from photogrammetry_tpu_torch.sfm.incremental import (
        SfmConfig, run_incremental_sfm, run_incremental_sfm_robust,
    )
    from photogrammetry_tpu_torch.sfm.metrics import trajectory_ate

    cfg = SfmConfig(collect_diagnostics=False,
                    pyramid_octaves=PYRAMID_OCTAVES,
                    track_capacity=1024 * PYRAMID_OCTAVES)
    for c in counters.values():
        c.launches = 0
    t0 = time.perf_counter()
    res = run_incremental_sfm_robust(seq, k, cfg, seed=SFM_SEED, restarts=3,
                                     device=dev)
    sync(dev)
    seconds = time.perf_counter() - t0
    launches = {name: c.launches for name, c in counters.items()}
    pairs = make_pairs(cfg.frontend, device=dev)
    frames = torch.as_tensor(seq, dtype=torch.float32, device=dev)
    fa, fb = (precompute_frontend(frames, pairs, cfg.frontend,
                                  chunk=cfg.frontend_chunk,
                                  octaves=PYRAMID_OCTAVES, plain=plain)
              for plain in (False, True))

    def once():
        return run_incremental_sfm(seq, k, cfg, seed=SFM_SEED, device=dev)

    _, timing = profiled_run(once, dev, len(seq),
                             wall=wall_ms(once, dev))
    per_octave = fa.points.mask.reshape(len(seq), PYRAMID_OCTAVES, -1)
    result = {
        "phase": "pyramid", "frames": list(seq.shape),
        "octaves": PYRAMID_OCTAVES, "track_capacity": cfg.track_capacity,
        "seed": SFM_SEED, "seconds": seconds,
        "features_identical": features_equal(fa, fb),
        "keypoints_per_octave": per_octave.sum(-1).sum(0).tolist(),
        "ate": trajectory_ate(res.rs, res.ts, centers),
        "landmarks": len(res.points), "quality": res.quality,
        "centers": len(res.camera_centers),
        "single_scale": {key: single_scale[key] for key in
                         ("ate", "landmarks", "quality")},
        "timing": timing, "launches": launches}
    emit(result)
    bad = []
    if not result["features_identical"]:
        bad.append("pyramid features differ kernel vs plain")
    for name in ("fast_score", "brief_bits"):
        if launches[name] != 3 * PYRAMID_OCTAVES:
            bad.append(f"{name}: {launches[name]} launches, expected one "
                       f"an octave a restart")
    if (result["centers"] != len(seq) or not result["ate"] < 0.2
            or result["landmarks"] <= 80):
        bad.append("pyramid SfM out of bounds")
    if bad:
        raise AssertionError(f"pyramid out of bounds: {bad}")
    return launches


def schur_row(args) -> dict:
    """The Schur kernel's timing row for ``shape_times`` on its operands
    (w_hinv, w_cp (F, T, 6, 3), b_p (T, 3)), beside the cuBLAS pair on
    operands flattened to (6F, 3T) beforehand (the flattening is not in
    its time)."""
    import torch

    from photogrammetry_tpu_torch.kernels import schur

    f, t = args[0].shape[:2]
    a, b = (x.permute(0, 2, 1, 3).reshape(6 * f, 3 * t).contiguous()
            for x in args[:2])
    bp = args[2].reshape(-1)
    return dict(run=lambda: schur.schur_products(*args),
                plain=lambda: schur.schur_products_plain(*args),
                library=lambda: (torch.matmul(a, b.T), a @ bp),
                bytes=2 * (6 * f * 3 * t) * 4 + 3 * t * 4
                + (6 * f) ** 2 * 4 + 6 * f * 4,
                ops=2 * (6 * f) ** 2 * 3 * t + 2 * 6 * f * 3 * t)


def shape_times(rows) -> dict:
    """Each row's kernel by CUDA-graph replay (device ms, no profiler
    session) and CUDA events a call, beside its plain version's and its
    library call's ms and its bound; a BRIEF row also beside its gather
    floor."""
    out = {}
    for name, row in rows.items():
        b_ms, b_by = bound_ms(row["bytes"], row["ops"],
                              row.get("ops_per_s", FP32_OPS_PER_S))
        out[name] = dict(
            ms=graph_ms(row["run"]), ms_from="graph_ms",
            call_ms=cuda_ms(row["run"]),
            plain_ms=cuda_ms(row["plain"], iters=3),
            plain_ms_from="call_ms", library_ms=None, bound_ms=b_ms,
            bound_by=b_by, bytes=row["bytes"], ops=row["ops"])
        if row["library"] is not None:
            try:
                out[name].update(library_ms=graph_ms(row["library"]),
                                 library_ms_from="graph_ms")
            except RuntimeError:        # not capturable: a call's time
                out[name].update(library_ms=cuda_ms(row["library"]),
                                 library_ms_from="call_ms")
        if "floor" in row:
            out[name].update(gather_floor_ms=graph_ms(row["floor"]),
                             distinct_pixels=row["distinct_pixels"],
                             live_keypoints=row["live_keypoints"])
    return out


def run_main(main, args, dev):
    """A CLI's ``main(args)``: (its stdout lines, host-clock seconds to its
    return with the card idle)."""
    import contextlib
    import io

    out = io.StringIO()
    sync(dev)
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        if main(args) != 0:
            raise AssertionError(f"{main.__module__} {args} failed")
    sync(dev)
    return out.getvalue().splitlines(), time.perf_counter() - t0


def points_equal(a, b) -> bool:
    import torch

    return all(torch.equal(x, y) for x, y in zip(a, b))


def drive_frontend_clis(dev, render, counters, out_dir):
    """The frontend_clis phase: the reference's two-image tools at its
    photo size.  Frames 0 and 2 of the pan at CLI_SHAPE as PNG files go
    through ``detect_features``, ``cluster_features`` (grid and
    ``--exact``), ``match_keypoints`` (its default cluster reduction),
    ``estimate_pose`` three times (``--reduction nms --motion-filter``,
    ``--reduction anms``, ``--pyramid-octaves 2``; ``--fx`` the scene's
    focal) and ``image_editing``, each ``main`` timed by the host clock,
    launches counted over the phase and per CLI (each CLI's FAST, BRIEF
    and Hamming launches as its path needs them).  estimate_pose's gates:
    rotation error < POSE_MAX_DEG against the truth, >= POSE_MIN_MATCHES
    matches, > POSE_MIN_POINTS cloud points in front.  Then each CLI's
    device work again with the kernels and with ``plain=True`` on the
    card: score maps, keypoints, clusters, bits, matches and the motion
    mask equal.  Timed alone: the grid cluster step, and FAST, BRIEF and
    Hamming at this path's shapes."""
    import torch

    from photogrammetry_tpu_torch.cli import (
        cluster_features, detect_features, estimate_pose, image_editing,
        match_keypoints,
    )
    from photogrammetry_tpu_torch.cli.common import load_gray
    from photogrammetry_tpu_torch.io.image import write_image
    from photogrammetry_tpu_torch.kernels import fast_stencil, hamming
    from photogrammetry_tpu_torch.sfm.frontend import (
        FrontendConfig, make_pairs,
    )

    pool, pending = render
    t0 = time.perf_counter()
    frames = pending.get(timeout=900)
    pool.close()
    pool.join()
    render_wait = time.perf_counter() - t0
    _, (rs, _, _) = _cli_scene()
    r_gt = rs[CLI_FRAMES[1]] @ rs[CLI_FRAMES[0]].T
    paths = [f"{out_dir}/cli_{i}.png" for i in CLI_FRAMES]
    t0 = time.perf_counter()
    for path, frame in zip(paths, frames):
        write_image(path, frame)
    write_s = time.perf_counter() - t0
    p1, p2 = paths
    dev_arg = ["--device", str(dev)]
    pose = ["--fx", str(CLI_FOCAL)]
    runs = [
        ("detect_features", detect_features.main,
         [p1, "-o", f"{out_dir}/detected.png"], (1, 0, 0)),
        ("cluster_features", cluster_features.main,
         [p1, "-o", f"{out_dir}/clustered.png"], (1, 0, 0)),
        ("cluster_features_exact", cluster_features.main,
         [p1, "--exact", "-o", f"{out_dir}/clustered_exact.png"], (1, 0, 0)),
        ("match_keypoints", match_keypoints.main,
         [p1, p2, "-o", f"{out_dir}/matched.png"], (2, 2, 1)),
        ("estimate_pose_nms_motion", estimate_pose.main,
         [p1, p2, *pose, "--reduction", "nms", "--motion-filter",
          "--cloud", f"{out_dir}/nms.ply", "--plots", f"{out_dir}/nms",
          "--stats", f"{out_dir}/pose_stats.json"], (2, 2, 1)),
        ("estimate_pose_anms", estimate_pose.main,
         [p1, p2, *pose, "--reduction", "anms", "--cloud",
          f"{out_dir}/anms.ply"], (2, 2, 1)),
        ("estimate_pose_pyramid2", estimate_pose.main,
         [p1, p2, *pose, "--pyramid-octaves", "2", "--cloud",
          f"{out_dir}/pyramid.ply"], (4, 4, 1)),
        ("image_editing", image_editing.main,
         [p1, "-o", f"{out_dir}/shifted.png"], (0, 0, 0)),
    ]
    names = ("fast_score", "brief_bits", "hamming")
    for c in counters.values():
        c.launches = 0
    clis, bad = {}, []
    for label, main, args, want in runs:
        before = {n: counters[n].launches for n in names}
        lines, seconds = run_main(main, args + dev_arg, dev)
        got = {n: counters[n].launches - before[n] for n in names}
        clis[label] = dict(seconds=seconds, launches=got, line=lines[0])
        if tuple(got[n] for n in names) != want:
            bad.append(f"{label}: launches {got}, expected {want}")
        if label.startswith("estimate_pose"):
            rep = json.loads(lines[0])
            err = float(np.degrees(np.arccos(np.clip(
                (np.trace(np.asarray(rep["rotation"]) @ r_gt.T) - 1) / 2,
                -1, 1))))
            clis[label].update(rotation_error_deg=err,
                               matches=rep["matches"],
                               inliers=rep["inliers"],
                               points=rep["points"],
                               keypoints=rep["keypoints"])
            if not (err < POSE_MAX_DEG and rep["matches"] >= POSE_MIN_MATCHES
                    and rep["points"] > POSE_MIN_POINTS):
                bad.append(f"{label} out of bounds: {clis[label]}")
    launches = {n: c.launches for n, c in counters.items()}

    # each CLI's device work, kernels against plain versions
    g1, g2 = (torch.from_numpy(load_gray(p)).to(dev) for p in paths)
    h, w = g1.shape
    same = {}
    thr = 50.0
    same["fast_score"] = all(torch.equal(
        fast_stencil.fast_score_map(g, thr),
        fast_stencil.fast_score_map_plain(g, thr)) for g in (g1, g2))
    same["detect_features"] = points_equal(
        detect_features.detect(g1, thr, 4096),
        detect_features.detect(g1, thr, 4096, plain=True))
    raw, raw_plain = (cluster_features.detect_all(g1, thr, plain)
                      for plain in (False, True))
    same["cluster_detect"] = points_equal(raw, raw_plain)
    # the grid clustering runs on the device; the exact one is host numpy
    # on the same points
    got, ref = (cluster_features.cluster(x, h, w, 25.0, (4, 4))
                for x in (raw, raw_plain))
    same["clusters"] = bool(np.array_equal(got, ref))
    cfgs = {"match_keypoints": (FrontendConfig(reduction="cluster"), 1,
                                False),
            "pose_nms_motion": (FrontendConfig(reduction="nms",
                                               suppression_radius=4.0), 1,
                                True),
            "pose_anms": (FrontendConfig(reduction="anms",
                                         suppression_radius=4.0), 1, False),
            "pose_pyramid2": (FrontendConfig(suppression_radius=4.0), 2,
                              False)}
    for label, (cfg, octaves, motion) in cfgs.items():
        pairs = make_pairs(cfg, device=dev)
        fa, fb = (estimate_pose.frontend(g1, g2, pairs, cfg, octaves, motion,
                                         plain) for plain in (False, True))
        same[label] = (features_equal(list(fa[:2]), list(fb[:2]))
                       and all(torch.equal(x, y) for x, y in
                               zip(fa[2], fb[2])))
        if label == "pose_nms_motion":
            (f1, f2, _), nms_pairs = fa, pairs
    bad += [f"{k} differs kernel vs plain" for k, v in same.items() if not v]

    # timed alone: the grid cluster step at the CLI's chunk capacity, and
    # the kernels at this path's shapes (estimate_pose's nms frontend:
    # BRIEF on one frame's keypoints, Hamming between the two frames)
    cap = cluster_features.chunk_capacity(int(raw.count), (4, 4))
    cluster_ms = host_ms(lambda: cluster_features.cluster(raw, h, w, 25.0,
                                                          (4, 4)))
    a1, a2 = f1.bits.contiguous(), f2.bits.contiguous()
    m1, m2 = f1.points.mask, f2.points.mask
    n, p = a1.shape
    rows = shape_times({
        "fast_score_3000x4000": dict(
            run=lambda: fast_stencil.fast_score_map(g1, thr),
            plain=lambda: fast_stencil.fast_score_map_plain(g1, thr),
            library=None, bytes=h * w * 8, ops=h * w * 49),
        "brief_bits_3000x4000": brief_row(g1[None], type(f1.points)(
            *(x[None] for x in f1.points)), nms_pairs),
        "hamming_cli": dict(
            run=lambda: hamming.hamming_distance_matrix(a1, a2, m1, m2),
            plain=lambda: hamming.hamming_distance_matrix_plain(a1, a2, m1,
                                                                m2),
            library=lambda: torch.cdist(a1.float(), a2.float(), p=0),
            bytes=2 * n * p + 2 * n + n * n * 4, ops=2 * n * n * p,
            ops_per_s=INT8_OPS_PER_S),
    })
    rows["hamming_cli"]["shape"] = [n, n, p]
    result = {"phase": "frontend_clis", "shape": list(CLI_SHAPE),
              "focal": CLI_FOCAL, "render_wait_s": render_wait,
              "write_png_s": write_s, "clis": clis, "launches": launches,
              "kernel_equals_plain": same,
              "raw_keypoints": int(raw.count),
              "cluster_step": dict(chunk_capacity=cap, host_ms=cluster_ms),
              "rows": rows}
    emit(result)
    if bad:
        raise AssertionError(f"frontend_clis out of bounds: {bad}")
    return launches, rows


def time_new_shapes(dev, seq):
    """timing_shapes: the kernels at the shapes the keyframe, submap and
    pyramid paths first gave them, by CUDA-graph replay (device ms, no
    profiler session) and CUDA events a call, beside the plain version's
    and the library call's CUDA-event ms and the bound: FAST on the 12
    frames' 540x960 octave, BRIEF there at the keypoints the pyramid path
    detects on it (``detect_and_describe_batch_split`` on the octave, as
    the path's second octave), Hamming at the pyramid's 1024 x 1024
    (P = 256), Schur at the global BA's F = 23, T = 4096 beside the cuBLAS
    pair."""
    import torch

    from photogrammetry_tpu_torch.kernels import fast_stencil, hamming
    from photogrammetry_tpu_torch.sfm.frontend import (
        _downsample2, detect_and_describe_batch_split, make_pairs,
        precompute_frontend,
    )
    from photogrammetry_tpu_torch.sfm.incremental import SfmConfig

    fc = SfmConfig().frontend
    thr = fc.detection_threshold
    pan = torch.as_tensor(seq, dtype=torch.float32, device=dev)
    octave = _downsample2(pan).contiguous()
    b, h, w = octave.shape
    pairs = make_pairs(fc, device=dev)
    # the keypoints of the pyramid path's second octave, at its scale
    octave_pts = detect_and_describe_batch_split(octave, pairs, fc,
                                                 plain=True).points
    pyr = precompute_frontend(pan[:2], pairs, fc, octaves=PYRAMID_OCTAVES,
                              plain=True)
    a1, a2 = pyr.bits[0].contiguous(), pyr.bits[1].contiguous()
    m1, m2 = pyr.points.mask[0], pyr.points.mask[1]
    n, p = a1.shape
    f, t = 23, 4096
    rows = {
        "fast_score_540x960_b12": dict(
            run=lambda: fast_stencil.fast_score_map_batch(octave, thr),
            plain=lambda: fast_stencil.fast_score_map_plain(octave, thr),
            library=None, bytes=b * h * w * 8, ops=b * h * w * 49),
        "brief_bits_540x960_b12": brief_row(octave, octave_pts, pairs),
        "hamming_1024": dict(
            run=lambda: hamming.hamming_distance_matrix(a1, a2, m1, m2),
            plain=lambda: hamming.hamming_distance_matrix_plain(a1, a2, m1,
                                                                m2),
            library=lambda: torch.cdist(a1.float(), a2.float(), p=0),
            bytes=2 * n * p + 2 * n + n * n * 4, ops=2 * n * n * p,
            ops_per_s=INT8_OPS_PER_S),
        "schur_F23_T4096": schur_row(schur_inputs(dev, f, t, seed=f * t)),
    }
    out = shape_times(rows)
    brief = rows["brief_bits_540x960_b12"]
    out["brief_bits_540x960_b12"].update(
        gather_floor_ms=graph_ms(brief["floor"]),
        distinct_pixels=brief["distinct_pixels"],
        live_keypoints=brief["live_keypoints"])
    out["hamming_1024"]["live_keypoints"] = [int(m1.sum()), int(m2.sum())]
    emit({"phase": "timing_shapes", "rows": out,
          "inputs": "hot in L2: back-to-back calls on the same operands"})
    return out


def time_loop(dev, loop):
    """timing_loop: the batched Hamming kernel over the pair grid of F = 23
    (the loop phase's frames) and F = 64 (those frames cyclically) at
    SFM_KEYPOINTS x 256 bits: device ms by CUDA-graph replay, call ms,
    bound, the plain version's and ``torch.cdist(p=0)``'s CUDA-event ms;
    then the wall ms, busy ms and idle share of ``close_loops`` (revisit)
    at F = 23 and of ``optimize_pose_graph`` alone on its graph.  Returns
    the rows and that graph with its poses (numpy) for the distributed
    phase."""
    import torch

    from photogrammetry_tpu_torch.cli.run_sfm import LOOP_SEED as DRAWS
    from photogrammetry_tpu_torch.kernels import hamming
    from photogrammetry_tpu_torch.sfm.loop_closure import (
        build_pose_graph, close_loops, measure_loop_edges,
    )
    from photogrammetry_tpu_torch.sfm.pose_graph import optimize_pose_graph

    bits23 = loop["stacked"].bits.contiguous()
    masks23 = loop["stacked"].points.mask.contiguous()
    rows = {}
    for f in LOOP_GRID_FRAMES:
        sel = torch.arange(f, device=dev) % bits23.shape[0]
        bits, masks = bits23[sel].contiguous(), masks23[sel].contiguous()
        idx = torch.arange(f, dtype=torch.int32, device=dev)
        ii, jj = idx.repeat_interleave(f), idx.repeat(f)
        q, kk, p = f * f, bits.shape[1], bits.shape[2]
        iters = 20 if q <= 1024 else 4      # 4 GiB an output at F = 64
        b_ms, b_by = bound_ms(q * kk * kk * 4 + f * kk * p + f * kk + 8 * q,
                              2 * q * kk * kk * p, INT8_OPS_PER_S)

        def run():
            return hamming.hamming_distance_matrix_pairs(bits, masks, ii, jj)

        def plain():
            return hamming.hamming_distance_matrix_pairs_plain(bits, masks,
                                                               ii, jj)

        row = dict(frames=f, pairs=q, keypoints=kk, bits=p,
                   live_keypoints=int(masks.sum()), bound_ms=b_ms,
                   bound_by=b_by, graph_ms=graph_ms(run, iters=iters),
                   call_ms=cuda_ms(run, iters=iters),
                   plain_call_ms=cuda_ms(plain, iters=1, reps=3))
        fa, fb = bits[ii.long()].float(), bits[jj.long()].float()
        row["library_call_ms"] = cuda_ms(
            lambda: torch.cdist(fa, fb, p=0), iters=1, reps=3)
        del fa, fb
        before = hamming.hamming_distance_matrix_pairs.launches
        run()
        row.update(ms=row["graph_ms"], ms_from="graph_ms",
                   plain_ms=row["plain_call_ms"], plain_ms_from="call_ms",
                   library_ms=row["library_call_ms"],
                   library_ms_from="call_ms",
                   launches_a_call=(hamming.hamming_distance_matrix_pairs
                                    .launches - before))
        rows[f"F{f}"] = row
        torch.cuda.empty_cache()
    result = {"phase": "timing_loop", "rows": rows,
              "library": "torch.cdist(p=0) on the pairs' bits gathered and "
                         "made float beforehand, masks not applied",
              "plain_and_library_ms": "CUDA events a call (device-bound "
                                      "at these sizes)"}

    feats, rs, ts, cfg = loop["feats"], loop["rs"], loop["ts"], loop["cfg"]

    def close():
        gen = torch.Generator(device=dev).manual_seed(DRAWS)
        return close_loops(feats, rs, ts, loop["kmat"], cfg.frontend,
                           generator=gen, min_gap=LOOP_MIN_GAP,
                           mode="revisit")

    pairs = [tuple(e) for e in loop["revisit_edges"]]
    meas, _ = measure_loop_edges(feats, rs, ts, loop["kmat"], pairs,
                                 cfg.frontend, mode="revisit")
    graph = build_pose_graph(rs, ts, pairs, meas, loop_weight=4.0)

    def pose_graph():
        return optimize_pose_graph(rs, ts, graph, num_iterations=20)

    for label, fn in (("close_loops", close),
                      ("optimize_pose_graph", pose_graph)):
        wall = host_ms(fn, reps=3)
        try:
            busy, top = device_profile(fn, iters=1, top=8)
        except RuntimeError:     # the profiler has run dry in this process
            busy, top = None, "not measured: the profiler recorded nothing"
        result[label] = dict(
            wall_ms=wall, device_busy_ms=busy, top_device_ops=top,
            device_idle_share=(None if busy is None
                               else max(0.0, 1 - busy / wall)))
    result["pose_graph"] = dict(nodes=int(rs.shape[0]),
                                edges=int(graph.edges.shape[0]))
    emit(result)
    return rows, (rs.cpu().numpy(), ts.cpu().numpy(),
                  tuple(x.cpu().numpy() for x in graph))


def kernel_counters() -> dict:
    """Each kernel's wrapper, whose ``launches`` counts its launches."""
    from photogrammetry_tpu_torch.kernels import (
        brief_pack, fast_stencil, hamming, remap, schur,
    )

    return {"fast_score": fast_stencil.fast_score_map_batch,
            "brief_bits": brief_pack.brief_bits,
            "hamming": hamming.hamming_distance_matrix,
            "schur": schur.schur_products,
            "remap": remap.remap_bilinear}


def dist_problem(dev):
    """bench_all.py's BA problem (timing_ba's draws, ``bench_scaling``'s
    ``build_problem``) at DIST_BA's F and T on ``dev``."""
    import torch

    from photogrammetry_tpu_torch.cli.bench_scaling import build_problem
    from photogrammetry_tpu_torch.sfm.ba import BAProblem, BAState

    f, t, _ = DIST_BA
    rs, ts, points, obs, k = (torch.as_tensor(x, device=dev) for x in
                              build_problem(np.random.default_rng(0), f, t))
    mask = torch.ones((f, t), dtype=torch.bool, device=dev)
    return (BAState(rs=rs, ts=ts, points=points),
            BAProblem(obs=obs, mask=mask, k=k))


def ba_numpy(res) -> dict:
    return dict(rs=res.state.rs.cpu().numpy(), ts=res.state.ts.cpu().numpy(),
                points=res.state.points.cpu().numpy(),
                cost=float(res.cost), initial_cost=float(res.initial_cost))


def circle_graph(n: int, noise: float, seed: int = 0):
    """tests/test_pose_graph.py's noisy circle graph in the port (numpy
    out): n poses yawing along a circle of radius 2, odometry edges with
    ``noise`` on rotation and translation, two loop edges (n-1 -> 0,
    n/2 -> 0) at a tenth of it and weight 10."""
    import torch

    from photogrammetry_tpu_torch.core.lie import so3_exp
    from photogrammetry_tpu_torch.sfm.pose_graph import relative_pose

    rng = np.random.default_rng(seed)
    a = 2 * np.pi * np.arange(n) / n
    rs = so3_exp(torch.tensor(np.stack([0 * a, a, 0 * a], -1),
                              dtype=torch.float32))
    c = torch.tensor(np.stack([2 * np.sin(a), 0 * a, 2 * (1 - np.cos(a))],
                              -1), dtype=torch.float32)
    ts = -(rs @ c[..., None])[..., 0]
    edges, zr, zt, ww = [], [], [], []
    for i, j, sigma, weight in ([(i, i + 1, noise, 1.0) for i in range(n - 1)]
                                + [(n - 1, 0, noise / 10, 10.0),
                                   (n // 2, 0, noise / 10, 10.0)]):
        r, t = relative_pose(rs[i], ts[i], rs[j], ts[j])
        r = so3_exp(torch.tensor(rng.normal(0, sigma, 3),
                                 dtype=torch.float32)) @ r
        edges.append((i, j))
        zr.append(r.numpy())
        zt.append((t.numpy() + rng.normal(0, sigma, 3)).astype(np.float32))
        ww.append(weight)
    return (rs.numpy(), ts.numpy(),
            (np.asarray(edges, np.int32), np.stack(zr), np.stack(zt),
             np.asarray(ww, np.float32)))


def _graph_on(graph, dev):
    import torch

    from photogrammetry_tpu_torch.sfm.pose_graph import PoseGraph

    return PoseGraph(*(torch.as_tensor(x, device=dev) for x in graph))


def _pg_numpy(res) -> dict:
    return dict(rs=res.rs.cpu().numpy(), ts=res.ts.cpu().numpy(),
                cost=float(res.cost), initial_cost=float(res.initial_cost))


def _world_one(rank, device_type, seq, k, centers, frames_dir, out_dir,
               loop_graph):
    """The distributed phase's world of one rank (NCCL on the card; gloo
    in a CPU rehearsal): the sharded BA beside ``bundle_adjust``, both with
    the kernel and plain, their iterations/s; the dense pose graph on the
    loop phase's graph beside ``optimize_pose_graph``; CG at
    DIST_CG_NODES on the card and on the CPU; the robust SfM with the
    mesh at SFM_SEED; one ``run_sfm --mesh 1 --restarts 3``."""
    import torch

    from photogrammetry_tpu_torch.parallel import (
        distributed_bundle_adjust, make_mesh,
    )
    from photogrammetry_tpu_torch.parallel.dist_pose_graph import (
        distributed_optimize_pose_graph, pad_graph,
    )
    from photogrammetry_tpu_torch.parallel.mesh import mesh_device
    from photogrammetry_tpu_torch.sfm.ba import bundle_adjust
    from photogrammetry_tpu_torch.sfm.incremental import (
        SfmConfig, run_incremental_sfm_robust,
    )
    from photogrammetry_tpu_torch.sfm.metrics import trajectory_ate
    from photogrammetry_tpu_torch.sfm.pose_graph import optimize_pose_graph

    counters = kernel_counters()
    mesh = make_mesh(device_type=device_type)
    dev = mesh_device(mesh)
    out = {"backend": torch.distributed.get_backend()}
    state, prob = dist_problem(dev)
    iters = DIST_BA[2]

    def dist_ba(plain):
        return distributed_bundle_adjust(state, prob, mesh,
                                         num_iterations=iters, plain=plain)

    def single_ba(plain):
        return bundle_adjust(state, prob, num_iterations=iters, plain=plain)

    counters["schur"].launches = 0
    out["ba"] = {"distributed_kernel": ba_numpy(dist_ba(False))}
    out["schur_launches_a_call"] = counters["schur"].launches
    out["ba"].update(distributed_plain=ba_numpy(dist_ba(True)),
                     single_kernel=ba_numpy(single_ba(False)),
                     single_plain=ba_numpy(single_ba(True)))
    ms = {}
    if device_type == "cuda":       # in turns; not timed in a rehearsal
        for label, fn in (("distributed", dist_ba), ("single", single_ba),
                          ("single", single_ba), ("distributed", dist_ba)):
            ms.setdefault(label, []).append(
                host_ms(lambda fn=fn: fn(False), reps=5))
    out["ba_ms"] = ms

    lrs, lts, graph = loop_graph
    lrs, lts = (torch.as_tensor(x, device=dev) for x in (lrs, lts))
    g = _graph_on(graph, dev)
    out["pose_graph"] = dict(
        distributed=_pg_numpy(distributed_optimize_pose_graph(
            lrs, lts, pad_graph(g, 1), mesh, num_iterations=20)),
        single=_pg_numpy(optimize_pose_graph(lrs, lts, g,
                                             num_iterations=20)))

    crs, cts, cgraph = circle_graph(DIST_CG_NODES, 0.04)
    cpu_mesh = make_mesh(device_type="cpu")
    out["cg"] = {}
    for label, on, m in (("card", dev, mesh),
                         ("cpu", torch.device("cpu"), cpu_mesh)):
        t0 = time.perf_counter()
        res = distributed_optimize_pose_graph(
            torch.as_tensor(crs, device=on), torch.as_tensor(cts, device=on),
            _graph_on(cgraph, on), m, num_iterations=10, solver="cg",
            cg_iterations=60)
        out["cg"][label] = dict(_pg_numpy(res),
                                seconds=time.perf_counter() - t0)

    cfg = SfmConfig(collect_diagnostics=False, mesh=mesh)
    for c in counters.values():
        c.launches = 0
    res = run_incremental_sfm_robust(seq, k, cfg, seed=SFM_SEED, restarts=3,
                                     device=dev)
    out["sfm"] = dict(
        launches={n: c.launches for n, c in counters.items()},
        ate=trajectory_ate(res.rs, res.ts, centers),
        landmarks=len(res.points))

    for c in counters.values():
        c.launches = 0
    t0 = time.perf_counter()
    report = run_cli([frames_dir, "--fx", str(k[0, 0]), "--cx", str(k[0, 2]),
                      "--cy", str(k[1, 2]), "--mesh", "1", "--restarts", "3",
                      "--device", device_type,
                      "--cloud", f"{out_dir}/dist.ply",
                      "--trajectory", f"{out_dir}/dist.json"])
    with open(f"{out_dir}/dist.json") as fh:
        traj = json.load(fh)
    out["cli"] = dict(
        launches={n: c.launches for n, c in counters.items()},
        seconds=time.perf_counter() - t0, landmarks=report["landmarks"],
        quality=report.get("quality"), centers=len(traj["centers"]),
        ate=trajectory_ate(traj["rotations"], traj["translations"],
                           centers))
    return out


def _world_two(rank, device_type):
    """One of the distributed phase's two gloo ranks (both on the one
    card): the sharded BA with the kernel (launches counted, the first
    shard's Schur operands kept) and plain; the kernel against its plain
    version on those operands within its f32 bound; iterations/s; then
    rank 0 alone times Schur at the shard shape while rank 1 waits in an
    all-reduce."""
    import torch
    import torch.distributed as dist

    from photogrammetry_tpu_torch.kernels import schur
    from photogrammetry_tpu_torch.parallel import (
        distributed_bundle_adjust, make_mesh,
    )
    from photogrammetry_tpu_torch.parallel.mesh import mesh_device
    from photogrammetry_tpu_torch.sfm import ba

    mesh = make_mesh(device_type=device_type, backend="gloo")
    dev = mesh_device(mesh)
    state, prob = dist_problem(dev)
    iters = DIST_BA[2]

    def dist_ba(plain):
        return distributed_bundle_adjust(state, prob, mesh,
                                         num_iterations=iters, plain=plain)

    operands = []

    def keeping(*args):
        if not operands:
            operands.extend(x.clone() for x in args)
        return schur.schur_products(*args)

    schur.schur_products.launches = 0
    ba.schur_products = keeping
    try:
        kernel = ba_numpy(dist_ba(False))
    finally:
        ba.schur_products = schur.schur_products
    launches = schur.schur_products.launches
    out = dict(rank=rank, device=str(dev), kernel=kernel,
               plain=ba_numpy(dist_ba(True)), schur_launches=launches,
               shard_shape=list(operands[0].shape[:2]))
    got = schur.schur_products(*operands)
    ref = schur.schur_products_plain(*operands)
    bounds = schur.error_bound(*operands)
    out.update(
        schur_max_abs_err=max(max_err(a, b) for a, b in zip(got, ref)),
        schur_max_err_over_bound=max(
            float(((a.double() - b.double()).abs()
                   / c.clamp(min=1e-30)).max())
            for a, b, c in zip(got, ref, bounds)))
    if dev.type == "cuda":          # not timed in a rehearsal
        out["ba_ms"] = host_ms(lambda: dist_ba(False), reps=5)
        if rank == 0:
            out["schur_row"] = shape_times({"shard": schur_row(operands)})[
                "shard"]
    barrier = torch.zeros(1, device=dev)
    dist.all_reduce(barrier)
    return out


def drive_distributed(dev, seq, k, centers, loop_graph, sfm_stats, out_dir):
    """The distributed phase: a world of one rank (NCCL) and a world of two
    (gloo, both on the one card), each in spawned processes so that this
    process's profiler and CUDA state stay clean (``_world_one``,
    ``_world_two``).  Gates: the sharded BA within DIST_COST_RTOL /
    DIST_POSE_ATOL of ``bundle_adjust`` at both worlds, kernel and plain;
    the two ranks bit-identical; Schur at the shard shape within its f32
    bound of its plain version and launched once an LM iteration; the
    dense pose graph within the same tolerances of
    ``optimize_pose_graph``; CG at DIST_CG_NODES: its cost under 5% of the
    initial one, the card's within LOOP_CPU_COST_SHARE / LOOP_CPU_POSE_SHARE
    of the CPU's; the meshed SfM and ``run_sfm --mesh 1`` within the SfM
    gates, every kernel but remap launched.  Returns the CLI run's launches
    and the Schur row at the shard shape."""
    from photogrammetry_tpu_torch.parallel.multihost import run_world

    frames_dir = f"{out_dir}/dist_frames"
    write_frames(seq, frames_dir)
    device_type = dev.type
    backend = "cpu:gloo,cuda:nccl" if device_type == "cuda" else "gloo"
    t0 = time.perf_counter()
    one = run_world(_world_one, 1, (device_type, seq, k, centers, frames_dir,
                                    out_dir, loop_graph),
                    backend=backend, timeout=DIST_TIMEOUT)[0]
    t1 = time.perf_counter()
    two = run_world(_world_two, DIST_WORLD, (device_type,), backend="gloo",
                    timeout=DIST_TIMEOUT)
    t2 = time.perf_counter()
    bad = []

    def compare(label, got, ref):
        """The cost's relative and the poses' absolute difference, with a
        finding where they pass the phase's tolerances."""
        cost = abs(got["cost"] - ref["cost"]) / abs(ref["cost"])
        pose = max(float(np.abs(got[n] - ref[n]).max()) for n in ("rs", "ts"))
        if not (cost <= DIST_COST_RTOL and pose <= DIST_POSE_ATOL):
            bad.append(f"{label}: cost {cost:.3g} poses {pose:.3g}")
        return dict(cost_rel=cost, pose_abs=pose,
                    identical=all(np.array_equal(got[n], ref[n])
                                  for n in ("rs", "ts", "cost")))

    iters = DIST_BA[2]
    b1, b2 = one["ba"], [r["kernel"] for r in two]
    ranks_identical = all(
        all(np.array_equal(r[key][n], two[0][key][n]) for n in two[0][key])
        for r in two[1:] for key in ("kernel", "plain"))
    if not ranks_identical:
        bad.append("world 2: the ranks' results differ")
    ips = {f"world1_{label}": [iters * 1e3 / m for m in ms]
           for label, ms in one["ba_ms"].items()}
    if "ba_ms" in two[0]:
        ips["world2_distributed"] = iters * 1e3 / two[0]["ba_ms"]
    shard = two[0]
    if not shard["schur_max_err_over_bound"] <= 1.0:
        bad.append(f"Schur at the shard shape outside its bound: "
                   f"{shard['schur_max_err_over_bound']}")
    if any(r["schur_launches"] != iters for r in two) or \
            one["schur_launches_a_call"] != iters:
        bad.append("Schur not launched once an LM iteration a shard")
    cg = one["cg"]
    cg_cost = abs(cg["card"]["cost"] - cg["cpu"]["cost"]) / \
        cg["cpu"]["initial_cost"]
    # the correction the CPU run applied to the poses, as the loop phase
    crs, cts, _ = circle_graph(DIST_CG_NODES, 0.04)
    correction = max(float(np.abs(cg["cpu"]["rs"] - crs).max()),
                     float(np.abs(cg["cpu"]["ts"] - cts).max()))
    cg_pose = max(float(np.abs(cg["card"][n] - cg["cpu"][n]).max())
                  for n in ("rs", "ts"))
    if not (cg["card"]["cost"] < 0.05 * cg["card"]["initial_cost"]
            and cg_cost <= LOOP_CPU_COST_SHARE
            and cg_pose <= LOOP_CPU_POSE_SHARE * correction):
        bad.append(f"CG at {DIST_CG_NODES} nodes: {cg}")
    sfm, cli = one["sfm"], one["cli"]
    for label, run in (("meshed SfM", sfm), ("run_sfm --mesh 1", cli)):
        missing = [n for n, v in run["launches"].items()
                   if v < 1 and n != "remap"]
        if not (run["ate"] < 0.2 and run["landmarks"] > 80) or missing:
            bad.append(f"{label} out of bounds: ATE {run['ate']}, "
                       f"{run['landmarks']} landmarks, not launched "
                       f"{missing}")
    result = {
        "phase": "distributed", "seconds_world1": t1 - t0,
        "seconds_world2": t2 - t1, "backend_world1": one["backend"],
        "ba": {"cameras": DIST_BA[0], "landmarks": DIST_BA[1],
               "iterations": iters,
               "world1_vs_single_kernel": compare(
                   "world 1 kernel", b1["distributed_kernel"],
                   b1["single_kernel"]),
               "world1_vs_single_plain": compare(
                   "world 1 plain", b1["distributed_plain"],
                   b1["single_plain"]),
               "world2_vs_single_kernel": compare(
                   "world 2 kernel", b2[0], b1["single_kernel"]),
               "world2_vs_single_plain": compare(
                   "world 2 plain", two[0]["plain"], b1["single_plain"]),
               "world2_kernel_vs_plain": compare(
                   "world 2 kernel vs plain", b2[0], two[0]["plain"]),
               "world2_ranks_identical": ranks_identical,
               "cost": {"initial": b1["single_kernel"]["initial_cost"],
                        "single": b1["single_kernel"]["cost"],
                        "world1": b1["distributed_kernel"]["cost"],
                        "world2": b2[0]["cost"]},
               "iters_per_s": ips},
        "schur_shard": {"shape": shard["shard_shape"],
                        "launches_a_call": shard["schur_launches"],
                        "max_abs_err": shard["schur_max_abs_err"],
                        "max_err_over_bound":
                            shard["schur_max_err_over_bound"],
                        **shard.get("schur_row", {})},
        "pose_graph_dense": dict(
            nodes=int(loop_graph[0].shape[0]),
            edges=int(loop_graph[2][0].shape[0]),
            cost=one["pose_graph"]["distributed"]["cost"],
            initial_cost=one["pose_graph"]["distributed"]["initial_cost"],
            **compare("dense pose graph", one["pose_graph"]["distributed"],
                      one["pose_graph"]["single"])),
        "pose_graph_cg": dict(
            nodes=DIST_CG_NODES, cost_share_of_initial=cg_cost,
            pose_abs=cg_pose, correction=correction,
            **{label: {n: cg[label][n] for n in ("cost", "initial_cost",
                                                   "seconds")}
               for label in cg}),
        "sfm_meshed": {"seed": SFM_SEED, "ate": sfm["ate"],
                       "landmarks": sfm["landmarks"],
                       "ate_unmeshed": sfm_stats["ate"],
                       "landmarks_unmeshed": sfm_stats["landmarks"],
                       "launches": sfm["launches"]},
        "run_sfm_mesh1": {n: cli[n] for n in ("ate", "landmarks", "quality",
                                              "centers", "seconds",
                                              "launches")}}
    emit(result)
    if bad:
        raise AssertionError(f"distributed phase out of bounds: {bad}")
    return cli["launches"], result["schur_shard"]


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 2
    import atexit
    import tempfile

    from photogrammetry_tpu_torch.kernels import (
        _build, brief_pack, fast_stencil, hamming, remap, schur,
    )
    from photogrammetry_tpu_torch.sfm.frontend import (
        FrontendConfig, make_pairs,
    )
    from photogrammetry_tpu_torch.sfm.incremental import SfmConfig

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
    seq, k, rs_gt, centers = render_sequence()
    # the frontend_clis phase's frames render while the phases before it run
    cli_render = start_cli_render()
    atexit.register(cli_render[0].terminate)
    frames = [seq[0].astype(np.float32), seq[2].astype(np.float32)]
    r_gt = rs_gt[2] @ rs_gt[0].T
    emit({"phase": "render", "seconds": time.perf_counter() - t0,
          "shape": list(seq.shape)})

    cfg = FrontendConfig(detection_threshold=50.0,
                         max_keypoints=MAX_KEYPOINTS, reduction="nms",
                         suppression_radius=4.0)
    pairs = make_pairs(cfg, device=dev)
    errs = timed("parity", check_kernels, dev, frames, seq, pairs, cfg)
    errs["schur"] = timed("schur_parity", check_schur, dev)
    errs["remap"] = timed("remap_parity", check_remap, dev, seq)

    modules = {"fast_score": fast_stencil, "brief_bits": brief_pack,
               "hamming": hamming, "schur": schur, "remap": remap}
    counters = kernel_counters()
    earlier = {n: c for n, c in counters.items() if n != "remap"}
    out, launches_forward = timed(
        "slice", drive_main_path, dev, frames, k, r_gt, pairs, cfg,
        {n: counters[n] for n in ("fast_score", "brief_bits", "hamming")})
    launches_sfm, _, sfm_stats = timed("sfm", drive_sfm, dev, seq, k,
                                       centers, earlier)
    launches_pre, pre_rows = timed("precompute", drive_precompute, dev, seq,
                                   k, centers, earlier, sfm_stats)
    timed("fused", drive_fused, dev, seq, k, centers, earlier)
    with tempfile.TemporaryDirectory() as cache_dir:
        captured = capture_frames(dev, seq)
        launches = timed("dewarp_sfm", drive_dewarp_sfm, dev, seq, captured,
                         k, centers, counters, cache_dir)
        launches_pipeline = timed(
            "pipeline_demo", drive_pipeline, dev, seq[0],
            {n: counters[n] for n in ("remap", "fast_score")}, cache_dir)
        timed("steered", drive_steered, dev, earlier, cache_dir)
        # the loop path: every kernel's counter and the batched Hamming's
        loop_counters = {**counters,
                         "hamming_pairs": hamming.hamming_distance_matrix_pairs}
        errs["hamming_pairs"] = timed("loop_parity", check_loop_kernels,
                                      dev, loop_counters)
        errs["hamming"] = max(errs["hamming"], errs["hamming_pairs"])
        launches_loop, loop = timed("loop_closure", drive_loop_closure, dev,
                                    seq, k, centers, loop_counters, cache_dir)
        timed("checkpoint", drive_checkpoint, dev, seq, k, centers, earlier,
              cache_dir)
        launches_clis, cli_rows = timed(
            "frontend_clis", drive_frontend_clis, dev, cli_render,
            {n: counters[n] for n in ("fast_score", "brief_bits", "hamming")},
            cache_dir)
        shape_rows = timed("timing_shapes", time_new_shapes, dev, seq)
        timings = timed("timing", time_all, dev, frames, seq, k, pairs, cfg,
                        out)
        remap_rows = timed("timing_remap", time_remap, dev, seq, captured,
                           cache_dir)
        schur_rows = timed("timing_sfm", time_sfm, dev, seq, k, earlier)
        timed("timing_dewarp_sfm", time_dewarp_sfm, dev, captured, k,
              cache_dir)
        loop_rows, loop_graph = timed("timing_loop", time_loop, dev, loop)
        launches_dist, schur_shard = timed(
            "distributed", drive_distributed, dev, seq, k, centers,
            loop_graph, sfm_stats, cache_dir)
        new_paths = {
            "keyframes": timed("keyframes", drive_keyframes, dev, seq, k,
                               centers, earlier, cache_dir),
            "pyramid": timed("pyramid", drive_pyramid, dev, seq, k, centers,
                             earlier, sfm_stats),
            "submaps": timed("submaps", drive_submaps, dev, seq, k, rs_gt,
                             centers, earlier, cache_dir)}
        _, fused_timing = timed("timing_modes", time_modes, dev, seq, k,
                                earlier)
    # each kernel's row is taken at the shape the dewarp + SfM path gives it
    timings["schur"] = schur_rows["F%d_T%d" % SCHUR_SHAPES[0]]
    timings["remap"] = remap_rows["stack_f32"]

    # the rows of three kernels at their other main shape: FAST and BRIEF
    # on the SfM path's 12-frame batch, Hamming at the SfM path's 512 x 512
    other = {"fast_score": ("fast_score_b12", [len(seq), *seq.shape[1:]]),
             "brief_bits": ("brief_bits_b12", [len(seq), SFM_KEYPOINTS,
                                               256]),
             "hamming": (f"hamming_{SFM_KEYPOINTS}",
                         [SFM_KEYPOINTS, SFM_KEYPOINTS])}
    for n, (row, shape) in other.items():
        timings[n]["other_shape"] = dict(
            shape=shape, **{key: timings[row][key] for key in (
                "ms", "graph_ms", "call_ms", "bound_ms", "bound_by",
                "plain_ms", "library_ms") + (
                    ("gather_floor_ms",) if n == "brief_bits" else ())})
    # each kernel on the keyframe, submap and pyramid paths: FAST, BRIEF,
    # Hamming and Schur launched on all three
    missing = [(path, n) for path, got in new_paths.items()
               for n in earlier if got.get(n, 0) < 1]
    if missing:
        raise AssertionError(f"kernels not launched: {missing}")
    new_shape = {"fast_score": "fast_score_540x960_b12",
                 "brief_bits": "brief_bits_540x960_b12",
                 "hamming": "hamming_1024", "schur": "schur_F23_T4096"}
    cli_shape = {"fast_score": "fast_score_3000x4000",
                 "brief_bits": "brief_bits_3000x4000",
                 "hamming": "hamming_cli"}
    missing = [n for n in cli_shape if launches_clis.get(n, 0) < 1]
    if missing:
        raise AssertionError(f"kernels not launched by the CLIs: {missing}")
    # the batched entry of the Hamming kernel: its loop-path launches and
    # its rows at F = 23 and 64
    pre_row = pre_rows["Q%d_K%d" % (SfmConfig().frontend_chunk,
                                    SFM_KEYPOINTS)]
    batched = dict(entry="hamming_distance_matrix_pairs",
                   launches_loop=launches_loop["hamming_pairs"],
                   launches_precompute=launches_pre["hamming_pairs"],
                   precompute_shapes=pre_rows,
                   **{name: {key: row[key] for key in (
                       "pairs", "ms", "ms_from", "graph_ms", "call_ms",
                       "bound_ms", "bound_by", "plain_ms", "library_ms",
                       "launches_a_call")}
                      for name, row in loop_rows.items()})
    fused_launches = fused_timing["fused"]["profiled"]["trace_launches"]
    # launches: of the dewarp_sfm run, which goes through all five kernels;
    # the earlier paths' counts, the pipeline's and the loop path's beside it
    emit({"kernels": [
        dict(name=n, route="cuda", source=modules[n].SOURCE,
             replaces=modules[n].REPLACES, launches=launches[n],
             max_abs_err=errs[n], ms=timings[n]["ms"],
             plain_ms=timings[n]["plain_ms"],
             bound_ms=timings[n]["bound_ms"],
             bound_by=timings[n]["bound_by"],
             library_ms=timings[n]["library_ms"],
             call_ms=timings[n]["call_ms"],
             plain_call_ms=timings[n]["plain_call_ms"],
             library_call_ms=timings[n]["library_call_ms"],
             graph_ms=timings[n].get("graph_ms"),
             gather_floor_ms=timings[n].get("gather_floor_ms"),
             other_shape=timings[n].get("other_shape"),
             launches_forward=launches_forward.get(n, 0),
             launches_sfm=launches_sfm.get(n, 0),
             launches_pipeline=launches_pipeline.get(n, 0),
             launches_loop=launches_loop.get(n, 0),
             launches_frontend_clis=launches_clis.get(n, 0),
             launches_distributed=launches_dist.get(n, 0),
             launches_precompute=launches_pre.get(n, 0),
             # the fused run's, from the trace (inside the graphs too)
             launches_fused=fused_launches[KERNEL_NAMES[n]],
             **{f"launches_{path}": got.get(n, 0)
                for path, got in new_paths.items()},
             new_shape=(dict(row=new_shape[n], **shape_rows[new_shape[n]])
                        if n in new_shape else None),
             cli_shape=(dict(row=cli_shape[n], **cli_rows[cli_shape[n]])
                        if n in cli_shape else None),
             distributed_shape=(dict(row="schur_F%d_T%d" % tuple(
                 schur_shard["shape"]), **schur_shard)
                                if n == "schur" else None),
             **({"batched": batched} if n == "hamming" else {}))
        for n in counters] + [
        # the batched entry on its own row: its launches are the precompute
        # path's, its times the first chunk's shape (Q = 16, K = 512)
        dict(name="hamming_pairs", route="cuda", source=hamming.SOURCE,
             replaces=hamming.REPLACES,
             launches=launches_pre["hamming_pairs"],
             max_abs_err=errs["hamming_pairs"], ms=pre_row["graph_ms"],
             ms_from="graph_ms", plain_ms=pre_row["plain_call_ms"],
             plain_ms_from="call_ms", bound_ms=pre_row["bound_ms"],
             bound_by=pre_row["bound_by"],
             library_ms=pre_row["library_call_ms"],
             library_ms_from="call_ms", call_ms=pre_row["call_ms"],
             launches_loop=launches_loop["hamming_pairs"],
             # never inside the step: its wrapper's count in the fused run
             launches_fused=fused_timing["fused"]["launches"][
                 "hamming_pairs"],
             shape=dict(pairs=pre_row["pairs"],
                        keypoints=pre_row["keypoints"],
                        bits=pre_row["bits"]))]})
    emit({"ok": True, "device": {"platform": "gpu", "kind": name,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
