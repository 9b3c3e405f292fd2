"""FAST-16 score map: CUDA kernel ``csrc/fast_stencil.cu`` and its wrapper.

Replaces the Pallas TPU kernels ``fast_score_map_pallas`` and
``fast_score_map_pallas_batch`` of photogrammetry_tpu/kernels/fast_stencil.py
with one kernel that takes a (B, H, W) batch.  One thread per pixel over a
shared-memory tile with a 3-px halo; bound on the H100 by bytes (one f32
read and one int32 write per pixel).  The plain PyTorch version it is held
against is ``fast_score_map_plain`` (ops/fast.py), which the wrapper runs
for tensors on the CPU and never for CUDA tensors.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from photogrammetry_tpu_torch.kernels import _build
from photogrammetry_tpu_torch.ops.fast import \
    fast_score_map as fast_score_map_plain

SOURCE = "photogrammetry_tpu_torch/csrc/fast_stencil.cu"
REPLACES = "photogrammetry_tpu/kernels/fast_stencil.py:143"


@functools.cache
def _launcher():
    fn = _build.load("fast_stencil").fast_score_launch
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                   ctypes.c_int, ctypes.c_int, ctypes.c_float,
                   ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def fast_score_map_batch(images: torch.Tensor,
                         threshold: float) -> torch.Tensor:
    """(B, H, W) float32 → (B, H, W) int32 FAST scores."""
    if images.dim() != 3:
        raise ValueError(f"fast_score_map_batch: expected (B, H, W), got "
                         f"{tuple(images.shape)}")
    if images.device.type == "cpu":
        return fast_score_map_plain(images, threshold)
    if images.device.type != "cuda":
        raise ValueError(f"fast_score_map_batch: unsupported device "
                         f"{images.device}")
    if images.dtype != torch.float32 or not images.is_contiguous():
        raise ValueError("fast_score_map_batch: needs contiguous float32")
    b, h, w = images.shape
    out = torch.empty((b, h, w), dtype=torch.int32, device=images.device)
    if out.numel() == 0:
        return out
    err = _launcher()(images.data_ptr(), out.data_ptr(), b, h, w,
                      float(threshold),
                      torch.cuda.current_stream(images.device).cuda_stream)
    _build.check(err, "fast_score_launch")
    fast_score_map_batch.launches += 1
    return out


fast_score_map_batch.launches = 0


def fast_score_map(image: torch.Tensor, threshold: float) -> torch.Tensor:
    """(H, W) float32 → (H, W) int32 FAST scores (a batch of one)."""
    if image.dim() != 2:
        raise ValueError(f"fast_score_map: expected (H, W), got "
                         f"{tuple(image.shape)}")
    return fast_score_map_batch(image[None], threshold)[0]
