"""Hamming distance matrix: CUDA kernel ``csrc/hamming.cu`` and its wrapper.

Replaces the Pallas TPU kernel ``hamming_distance_matrix_pallas`` of
photogrammetry_tpu/kernels/hamming.py, which ran |a|+|b|-2a.b on the MXU.
Here the bits are packed LSB-first into 32-bit words (``pack_bits``) and
each distance is an exact popcount sum, one thread per (i, j) over shared
A and B tiles, with masked rows/columns set to INT_INF in the store.  Bound
on the H100 by bytes (the (N1, N2) int32 output).  The plain PyTorch
version is ``hamming_distance_matrix_plain`` (ops/match.py), which the
wrapper runs for tensors on the CPU and never for CUDA tensors.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from photogrammetry_tpu_torch.kernels import _build
from photogrammetry_tpu_torch.ops.brief import pack_bits
from photogrammetry_tpu_torch.ops.match import \
    hamming_distance_matrix as hamming_distance_matrix_plain

SOURCE = "photogrammetry_tpu_torch/csrc/hamming.cu"
REPLACES = "photogrammetry_tpu/kernels/hamming.py:45"
MAX_BITS = 512  # MAX_WORDS in csrc/hamming.cu


@functools.cache
def _launcher():
    fn = _build.load("hamming").hamming_launch
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                   ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
                   ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _mask_ptr(mask: torch.Tensor | None, n: int, dev) -> int | None:
    """Pointer to a (n,) bool mask on ``dev`` (torch stores bool as one
    byte of 0 or 1, which the kernel reads as uint8), or None."""
    if mask is None:
        return None
    if mask.shape != (n,) or mask.device != dev \
            or mask.dtype != torch.bool or not mask.is_contiguous():
        raise ValueError(f"hamming: mask {mask.dtype} {tuple(mask.shape)} "
                         f"on {mask.device}, expected contiguous bool ({n},) "
                         f"on {dev}")
    return mask.data_ptr()


def hamming_distance_matrix(bits1: torch.Tensor, bits2: torch.Tensor,
                            mask1: torch.Tensor | None = None,
                            mask2: torch.Tensor | None = None
                            ) -> torch.Tensor:
    """(N1, P), (N2, P) {0,1} uint8 → (N1, N2) int32 Hamming distances;
    rows/cols whose mask is False get INT_INF."""
    if bits1.dim() != 2 or bits2.dim() != 2 \
            or bits1.shape[1] != bits2.shape[1]:
        raise ValueError(f"hamming: shapes {tuple(bits1.shape)} and "
                         f"{tuple(bits2.shape)} do not pair")
    if bits1.device != bits2.device:
        raise ValueError("hamming: bits on two devices")
    if bits1.device.type == "cpu":
        return hamming_distance_matrix_plain(bits1, bits2, mask1, mask2)
    if bits1.device.type != "cuda":
        raise ValueError(f"hamming: unsupported device {bits1.device}")
    if bits1.dtype != torch.uint8 or bits2.dtype != torch.uint8:
        raise ValueError("hamming: needs uint8 bits")
    n1, p = bits1.shape
    n2 = bits2.shape[0]
    if p % 32 or not 0 < p <= MAX_BITS:
        raise ValueError(f"hamming: P={p} must be a multiple of 32 in "
                         f"(0, {MAX_BITS}]")
    a = pack_bits(bits1).contiguous()
    b = pack_bits(bits2).contiguous()
    p1 = _mask_ptr(mask1, n1, bits1.device)
    p2 = _mask_ptr(mask2, n2, bits1.device)
    out = torch.empty((n1, n2), dtype=torch.int32, device=bits1.device)
    if out.numel() == 0:
        return out
    err = _launcher()(a.data_ptr(), n1, b.data_ptr(), n2, p // 32, p1, p2,
                      out.data_ptr(),
                      torch.cuda.current_stream(bits1.device).cuda_stream)
    _build.check(err, "hamming_launch")
    hamming_distance_matrix.launches += 1
    return out


hamming_distance_matrix.launches = 0
