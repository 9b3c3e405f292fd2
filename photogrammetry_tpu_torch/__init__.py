"""photogrammetry_tpu_torch — the PyTorch/CUDA port of the JAX package
photogrammetry_tpu/.

The JAX package beside it is the reference; every module here mirrors the
file of the same path there and is held against it by the
``tests/test_torch_*.py`` parity tests.  The port imports torch and numpy,
never JAX and never the JAX package.

Layer map (bottom-up), as far as the port reaches:
  core/     — pinhole camera helpers, SO(3)/SE(3) exp and log (lie), the
              closed-form cubic solver of the dewarp (cubic)
  ops/      — dense static-shape image ops, plain PyTorch: FAST, NMS
              (sequential, fixed point, ANMS), clustering (grid and
              exact), BRIEF, refine, Hamming matching (mutual nearest,
              sorted, greedy, the motion filter), grayscale, the distortion
              maps and the plain remap (dewarp), plumb-line lens
              calibration (calibrate)
  kernels/  — hand-written CUDA kernels for Hopper (csrc/*.cu: FAST, BRIEF,
              Hamming single and over a batch of frame pairs, Schur,
              remap), each beside the plain PyTorch version
              it is held against; _build compiles and loads them
  sfm/      — frontend (single and batched), epipolar geometry, homography,
              triangulation, the two-view pipeline, tracks, PnP, Schur
              bundle adjustment (ba), incremental SfM (checkpointed and
              resumable) and its best-of-restarts form, SE(3)/Sim(3) pose
              graphs, loop closure, trajectory metrics
  store/    — content store with typed variants, the staged pipeline
              runner over it, distortion-map and keypoint caches, SfM
              checkpoints
  io/       — image files (Pillow, imported on use), overlay drawing, PLY
  synth/    — synthetic ground-truth star scenes: pan, orbit, dolly and
              roll trajectories (numpy)
  utils/    — padding container, stage timer and stats log, JAX-semantics
              reductions, JAX's threefry stream in numpy (prng: the BRIEF
              pair table)
  parallel/ — meshes over torch.distributed ranks, the landmark-sharded
              BA (the Schur kernel a shard) and the edge-sharded pose graph
  native / config — the ctypes binding of native/host_ops.cpp; the
              layered JSON + environment configuration
  cli/      — run_sfm (with the dewarp stage, checkpoints, loop closure
              and --mesh), bench_scaling, de_warp, pipeline_demo,
              calibrate_dewarp, sweep_sfm_seeds, and the two-image tools
              detect_features, cluster_features, match_keypoints,
              estimate_pose, image_editing
  entry / convert — the two-view forward step; carrying the JAX package's
              pairs, configuration, state and distortion maps across

Entry points that create tensors take ``device`` (default ``"cuda"``); with
no card they raise rather than run on the CPU.  Functions that take tensors
run on the tensors' device.
"""
from __future__ import annotations

import torch

__version__ = "0.1.0"

# Geometry estimation needs true f32 matmuls (the JAX package's policy,
# photogrammetry_tpu/__init__.py): no TF32 anywhere.
torch.set_float32_matmul_precision("highest")
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def resolve_device(device: str | torch.device = "cuda") -> torch.device:
    """``device`` as a torch.device; raises when CUDA is asked for and absent.

    The port never falls back to the CPU on its own: a caller that wants the
    CPU says so.
    """
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "photogrammetry_tpu_torch: CUDA device requested but "
            "torch.cuda.is_available() is False; pass device='cpu' to run "
            "the plain PyTorch path on the CPU")
    return dev
