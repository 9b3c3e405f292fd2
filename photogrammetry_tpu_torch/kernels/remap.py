"""Bilinear remap: CUDA kernel ``csrc/remap.cu`` and its wrapper.

Replaces the Pallas TPU kernel ``apply_remap_pallas`` of
photogrammetry_tpu/kernels/remap.py, a two-pass vertical/horizontal
approximation built around a host-side plan because TPU gathers are slow.
On Hopper one thread per output pixel gathers its four taps through L2, so
the kernel computes the exact bilinear remap for any map (folded ones too)
and there is no plan.  Bound on the H100 by bytes (map + image + output,
each once).  The plain PyTorch version is ``remap_bilinear_plain``
(ops/dewarp.py ``remap_plain``), which the wrapper runs for tensors on the
CPU and never for CUDA tensors; the kernel agrees with it bit for bit.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from photogrammetry_tpu_torch.kernels import _build
from photogrammetry_tpu_torch.ops.dewarp import \
    remap_plain as remap_bilinear_plain

SOURCE = "photogrammetry_tpu_torch/csrc/remap.cu"
REPLACES = "photogrammetry_tpu/kernels/remap.py:245"
MAX_BATCH = 65535   # the frame index is blockIdx.z


@functools.cache
def _launcher():
    fn = _build.load("remap").remap_launch
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                   ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def remap_bilinear(images: torch.Tensor,
                   dist_map: torch.Tensor) -> torch.Tensor:
    """(B, H_s, W_s, C) float32 or uint8 images through an (H, W, 2)
    float32 map of source (row, col) → (B, H, W, C) of the images' dtype:
    bilinear, zero outside (per tap), uint8 rounded half to even."""
    if images.dim() != 4 or dist_map.dim() != 3 or dist_map.shape[-1] != 2:
        raise ValueError(f"remap_bilinear: images {tuple(images.shape)} "
                         f"(want B, H, W, C) and map "
                         f"{tuple(dist_map.shape)} (want H, W, 2)")
    if images.device != dist_map.device:
        raise ValueError("remap_bilinear: images and map on two devices")
    if images.dtype not in (torch.float32, torch.uint8):
        raise ValueError(f"remap_bilinear: {images.dtype} images; the kernel "
                         f"takes float32 and uint8")
    if dist_map.dtype != torch.float32:
        raise ValueError("remap_bilinear: needs a float32 map")
    if images.device.type == "cpu":
        return remap_bilinear_plain(images, dist_map)
    if images.device.type != "cuda":
        raise ValueError(f"remap_bilinear: unsupported device "
                         f"{images.device}")
    if not images.is_contiguous() or not dist_map.is_contiguous():
        raise ValueError("remap_bilinear: needs contiguous tensors")
    b, hs, ws, ch = images.shape
    h, w, _ = dist_map.shape
    if b > MAX_BATCH:
        raise ValueError(f"remap_bilinear: batch {b} > {MAX_BATCH}")
    out = torch.empty((b, h, w, ch), dtype=images.dtype,
                      device=images.device)
    if out.numel() == 0:
        return out
    err = _launcher()(images.data_ptr(), dist_map.data_ptr(), out.data_ptr(),
                      b, hs, ws, h, w, ch, int(images.dtype == torch.uint8),
                      torch.cuda.current_stream(images.device).cuda_stream)
    _build.check(err, "remap_launch")
    remap_bilinear.launches += 1
    return out


remap_bilinear.launches = 0
