"""photogrammetry_tpu_torch — the PyTorch/CUDA port of photogrammetry_tpu.

The JAX package beside it is the reference; every module here mirrors the
file of the same path there and is held against it by the
``tests/test_torch_*.py`` parity tests.  The port imports torch and numpy,
never JAX and never the JAX package.

Layer map (bottom-up), as far as the port reaches:
  core/     — pinhole camera helpers
  ops/      — dense static-shape image ops (FAST, NMS, BRIEF, refine,
              Hamming matching), plain PyTorch
  kernels/  — hand-written CUDA kernels for Hopper (csrc/*.cu), each beside
              the plain PyTorch version it is held against
  sfm/      — frontend, epipolar geometry, homography, triangulation,
              two-view pipeline
  synth/    — synthetic ground-truth star camera-pan scenes (numpy)
  utils/    — padding container

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
