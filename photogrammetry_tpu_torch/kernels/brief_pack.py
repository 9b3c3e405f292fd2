"""BRIEF bits: CUDA kernel ``csrc/brief_pack.cu`` and its wrapper.

Replaces the Pallas TPU kernel ``brief_bits_packed`` (``_packed_planes`` +
``_gather_unpack``) of photogrammetry_tpu/kernels/brief_pack.py, and with it
the XLA gather the JAX frontend runs for the describe stage
(photogrammetry_tpu/ops/brief.py ``brief_bits``).  The TPU kernel built
dense bit planes for every pixel; this one samples per keypoint, one thread
per (keypoint, pair), with the image resident in L2.  Bound on the H100 by
bytes (the distinct pixels sampled and the (N, P) uint8 output).  The plain
PyTorch version is ``brief_bits_plain`` (ops/brief.py), which the wrapper
runs for tensors on the CPU and never for CUDA tensors.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from photogrammetry_tpu_torch.kernels import _build
from photogrammetry_tpu_torch.ops.brief import brief_bits as brief_bits_plain

SOURCE = "photogrammetry_tpu_torch/csrc/brief_pack.cu"
REPLACES = "photogrammetry_tpu/kernels/brief_pack.py:128"


@functools.cache
def _launcher():
    fn = _build.load("brief_pack").brief_bits_launch
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                   ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                   ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def brief_bits(image: torch.Tensor, coords: torch.Tensor,
               pairs: torch.Tensor) -> torch.Tensor:
    """(H, W) float32, (N, 2) int32 (row, col), (P, 2, 2) int32 →
    (N, P) uint8 in {0, 1}."""
    if image.dim() != 2 or coords.dim() != 2 or coords.shape[1] != 2 \
            or pairs.dim() != 3 or pairs.shape[1:] != (2, 2):
        raise ValueError("brief_bits: expected (H, W), (N, 2), (P, 2, 2)")
    devices = {image.device, coords.device, pairs.device}
    if len(devices) != 1:
        raise ValueError(f"brief_bits: tensors on several devices {devices}")
    if image.device.type == "cpu":
        return brief_bits_plain(image, coords, pairs)
    if image.device.type != "cuda":
        raise ValueError(f"brief_bits: unsupported device {image.device}")
    if image.dtype != torch.float32 or coords.dtype != torch.int32 \
            or pairs.dtype != torch.int32:
        raise ValueError("brief_bits: needs float32 image, int32 coords "
                         "and pairs")
    if not (image.is_contiguous() and coords.is_contiguous()
            and pairs.is_contiguous()):
        raise ValueError("brief_bits: needs contiguous tensors")
    h, w = image.shape
    n, p = coords.shape[0], pairs.shape[0]
    out = torch.empty((n, p), dtype=torch.uint8, device=image.device)
    if out.numel() == 0:
        return out
    err = _launcher()(image.data_ptr(), h, w, coords.data_ptr(), n,
                      pairs.data_ptr(), p, out.data_ptr(),
                      torch.cuda.current_stream(image.device).cuda_stream)
    _build.check(err, "brief_bits_launch")
    brief_bits.launches += 1
    return out


brief_bits.launches = 0
