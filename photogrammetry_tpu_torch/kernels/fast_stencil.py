"""FAST-16 score map: CUDA kernel ``csrc/fast_stencil.cu`` and its wrapper.

Replaces the Pallas TPU kernels ``fast_score_map_pallas`` and
``fast_score_map_pallas_batch`` of photogrammetry_tpu/kernels/fast_stencil.py
with one kernel that takes a (B, H, W) batch.  A block stages a 32-wide,
64-row output tile and its 3-px halo in shared memory with 16-byte loads; a
thread scores four neighbouring pixels of a row, rejects most pixels on the
four compass points of the ring, takes the longest circular run
bit-parallel (``ring_score``) and stores the four scores as one 16-byte
word.  Bound on the H100 by bytes (one f32 read and one int32 write per
pixel).  The plain PyTorch version it is held against is
``fast_score_map_plain`` (ops/fast.py), which the wrapper runs for tensors
on the CPU and never for CUDA tensors; ``ring_score`` and ``compass_pass``
mirror the kernel's mask-to-score algebra for the CPU tests and are not on
any path.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from photogrammetry_tpu_torch.kernels import _build
from photogrammetry_tpu_torch.ops.fast import \
    fast_score_map as fast_score_map_plain
from photogrammetry_tpu_torch.utils import graphs

SOURCE = "photogrammetry_tpu_torch/csrc/fast_stencil.cu"
REPLACES = "photogrammetry_tpu/kernels/fast_stencil.py:143"
# ring positions (-3, 0), (0, 3), (3, 0), (0, -3)
COMPASS_BITS = (0, 4, 8, 12)


def ring_score(mask: torch.Tensor) -> torch.Tensor:
    """FAST score (12..16, else 0) of 16-bit ring masks (bit k set: ring
    pixel k outside the band), as ``ring_score`` in csrc/fast_stencil.cu
    computes it: bit k of ``a{L}`` is set iff bits k..k+L-1 of the doubled
    ring are all set."""
    x = mask.to(torch.int64) & 0xFFFF
    x = x | (x << 16)
    a2 = x & (x >> 1)
    a4 = a2 & (a2 >> 2)
    a8 = a4 & (a4 >> 4)
    a12 = a8 & (a4 >> 8)
    a13 = a12 & (x >> 12)
    a14 = a12 & (a2 >> 12)
    a15 = a14 & (x >> 14)
    a16 = a8 & (a8 >> 8)
    run = 12 + sum(((a & 0xFFFF) != 0).to(torch.int32)
                   for a in (a13, a14, a15, a16))
    return torch.where((a12 & 0xFFFF) != 0, run, 0).to(torch.int32)


def compass_pass(mask: torch.Tensor) -> torch.Tensor:
    """The kernel's pre-test: at least 3 of the 4 compass points of the
    ring outside the band (else the pixel scores 0 untested further)."""
    m = mask.to(torch.int64)
    return sum((m >> k) & 1 for k in COMPASS_BITS) >= 3


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
    if images.dtype != torch.float32 or not images.is_contiguous():
        raise ValueError("fast_score_map_batch: needs contiguous float32")
    if images.device.type != "cuda":
        raise ValueError(f"fast_score_map_batch: unsupported device "
                         f"{images.device}")
    b, h, w = images.shape
    out = torch.empty((b, h, w), dtype=torch.int32, device=images.device)
    if out.numel() == 0:
        return out
    err = _launcher()(images.data_ptr(), out.data_ptr(), b, h, w,
                      float(threshold),
                      torch.cuda.current_stream(images.device).cuda_stream)
    _build.check(err, "fast_score_launch")
    graphs.count_launch(fast_score_map_batch)
    return out


fast_score_map_batch.launches = 0


def fast_score_map(image: torch.Tensor, threshold: float) -> torch.Tensor:
    """(H, W) float32 → (H, W) int32 FAST scores (a batch of one)."""
    if image.dim() != 2:
        raise ValueError(f"fast_score_map: expected (H, W), got "
                         f"{tuple(image.shape)}")
    return fast_score_map_batch(image[None], threshold)[0]
