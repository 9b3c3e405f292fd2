"""Hamming distance matrix: CUDA kernel ``csrc/hamming.cu`` and its wrapper.

Replaces the Pallas TPU kernel ``hamming_distance_matrix_pallas`` of
photogrammetry_tpu/kernels/hamming.py, which ran |a|+|b|-2a.b on the MXU.
Here the same identity runs on the int8 tensor cores (``mma.sync``
m16n8k32, u8 x u8 -> s32) straight from the (N, P) uint8 bits: no packing
pass, one launch per call, any P (staged 512 columns a pass, the tail
zero-filled).  A block stages its rows of both operands in shared memory,
sums each row, and writes its output tile, masked rows/columns set to
INT_INF, through shared memory as 16-byte stores.
Bound on the H100 by
bytes (the (N1, N2) int32 output).  The tile of a block is planned here
(``tile_plan``) so that the SfM path's 512 x 512 matrices fill the card
too.  The plain PyTorch version is ``hamming_distance_matrix_plain``
(ops/match.py), which the wrapper runs for tensors on the CPU and never
for CUDA tensors.

``hamming_distance_matrix_pairs`` is the batched entry of the same kernel:
stacked (F, K, P) bits and (F, K) masks, and Q frame pairs (ii, jj) in one
launch (the pair in ``blockIdx.z``), for loop closure's pair grid; its
plain version is ``ops/match.py``'s function of the same name.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from photogrammetry_tpu_torch.kernels import _build
from photogrammetry_tpu_torch.ops.match import \
    hamming_distance_matrix as hamming_distance_matrix_plain
from photogrammetry_tpu_torch.ops.match import \
    hamming_distance_matrix_pairs as hamming_distance_matrix_pairs_plain
from photogrammetry_tpu_torch.utils import graphs

SOURCE = "photogrammetry_tpu_torch/csrc/hamming.cu"
REPLACES = "photogrammetry_tpu/kernels/hamming.py:45"
CHUNK_BITS = 512  # columns staged a pass (CHUNK_BITS in csrc/hamming.cu)
SM_COUNT = 132  # H100 SXM
MAX_PAIRS = 65535  # pairs a launch: the grid's z extent
# (block rows, block columns, warp rows, warp columns): the tiles the
# kernel is compiled for, largest first (the TILE lines of csrc/hamming.cu)
TILES = ((128, 128, 64, 32), (64, 128, 32, 32), (64, 64, 32, 32),
         (32, 64, 16, 32), (32, 32, 16, 16))


class TilePlan(NamedTuple):
    """One call's output tiling: ``bm`` x ``bn`` outputs a block, ``wm`` x
    ``wn`` a warp, and a grid of ``grid_x`` (columns) by ``grid_y`` (rows)
    blocks."""
    bm: int
    bn: int
    wm: int
    wn: int
    grid_x: int
    grid_y: int


def tile_plan(n1: int, n2: int, batch: int = 1) -> TilePlan:
    """The largest tile whose grid, over ``batch`` matrices, still gives
    every SM a block (128 x 128 at 2048 x 2048: 256 blocks; at 512 x 512
    from 9 matrices on), else the smallest (32 x 32 at one 512 x 512: 256
    blocks, where 128 x 128 would leave 116 SMs idle)."""
    for tile in TILES:
        gx, gy = -(-n2 // tile[1]), -(-n1 // tile[0])
        if gx * gy * batch >= SM_COUNT:
            break
    return TilePlan(*tile, gx, gy)


@functools.cache
def _launcher():
    fn = _build.load("hamming").hamming_launch
    fn.argtypes = ([ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                    ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
                    ctypes.c_void_p, ctypes.c_void_p]
                   + [ctypes.c_int] * 4 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


@functools.cache
def _pairs_launcher():
    fn = _build.load("hamming").hamming_pairs_launch
    fn.argtypes = ([ctypes.c_void_p] + [ctypes.c_int] * 3
                   + [ctypes.c_void_p] * 3 + [ctypes.c_int, ctypes.c_void_p]
                   + [ctypes.c_int] * 4 + [ctypes.c_void_p])
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


def launch(bits1: torch.Tensor, bits2: torch.Tensor, p1: int | None,
           p2: int | None, out: torch.Tensor, plan: TilePlan) -> None:
    """One launch of the kernel on checked operands (mask pointers from
    ``_mask_ptr``) with the given tiling, on the current stream."""
    (n1, p), n2 = bits1.shape, bits2.shape[0]
    err = _launcher()(bits1.data_ptr(), n1, bits2.data_ptr(), n2, p, p1, p2,
                      out.data_ptr(), plan.bm, plan.bn, plan.wm, plan.wn,
                      torch.cuda.current_stream(out.device).cuda_stream)
    _build.check(err, "hamming_launch")


def hamming_distance_matrix(bits1: torch.Tensor, bits2: torch.Tensor,
                            mask1: torch.Tensor | None = None,
                            mask2: torch.Tensor | None = None
                            ) -> torch.Tensor:
    """(N1, P), (N2, P) {0,1} uint8 → (N1, N2) int32 Hamming distances,
    any P (P = 0: all 0); rows/cols whose mask is False get INT_INF."""
    if bits1.dim() != 2 or bits2.dim() != 2 \
            or bits1.shape[1] != bits2.shape[1]:
        raise ValueError(f"hamming: shapes {tuple(bits1.shape)} and "
                         f"{tuple(bits2.shape)} do not pair")
    dev = bits1.device
    if bits2.device != dev:
        raise ValueError("hamming: bits on two devices")
    if dev.type == "cpu":
        return hamming_distance_matrix_plain(bits1, bits2, mask1, mask2)
    if bits1.dtype != torch.uint8 or bits2.dtype != torch.uint8:
        raise ValueError("hamming: needs uint8 bits")
    if not bits1.is_contiguous() or not bits2.is_contiguous():
        raise ValueError("hamming: needs contiguous bits")
    n1, n2 = bits1.shape[0], bits2.shape[0]
    p1 = _mask_ptr(mask1, n1, dev)
    p2 = _mask_ptr(mask2, n2, dev)
    if dev.type != "cuda":
        raise ValueError(f"hamming: unsupported device {dev}")
    out = torch.empty((n1, n2), dtype=torch.int32, device=dev)
    if out.numel() == 0:
        return out
    launch(bits1, bits2, p1, p2, out, tile_plan(n1, n2))
    graphs.count_launch(hamming_distance_matrix)
    return out


hamming_distance_matrix.launches = 0


def hamming_distance_matrix_pairs(bits: torch.Tensor, masks: torch.Tensor,
                                  ii: torch.Tensor, jj: torch.Tensor
                                  ) -> torch.Tensor:
    """(F, K, P) {0,1} uint8 bits, (F, K) bool masks and (Q,) frame indices
    → (Q, K, K) int32, pair q the distances of frame ii[q]'s keypoints
    (rows) to frame jj[q]'s (masked rows/cols INT_INF), any P, one launch
    for up to MAX_PAIRS pairs.  On CUDA the indices are int32 tensors on
    the bits' device; a pair whose index lies outside [0, F) comes out
    INT_INF throughout (the plain version raises there)."""
    if bits.dim() != 3 or masks.shape != bits.shape[:2] \
            or ii.dim() != 1 or ii.shape != jj.shape:
        raise ValueError(f"hamming pairs: bits {tuple(bits.shape)}, masks "
                         f"{tuple(masks.shape)}, indices {tuple(ii.shape)} "
                         f"and {tuple(jj.shape)} do not pair")
    dev = bits.device
    if any(x.device != dev for x in (masks, ii, jj)):
        raise ValueError("hamming pairs: tensors on two devices")
    if dev.type == "cpu":
        return hamming_distance_matrix_pairs_plain(bits, masks, ii, jj)
    if bits.dtype != torch.uint8 or not bits.is_contiguous():
        raise ValueError("hamming pairs: needs contiguous uint8 bits")
    if masks.dtype != torch.bool or not masks.is_contiguous():
        raise ValueError("hamming pairs: needs contiguous bool masks")
    if any(x.dtype != torch.int32 or not x.is_contiguous()
           for x in (ii, jj)):
        raise ValueError("hamming pairs: needs contiguous int32 indices")
    f, k, p = bits.shape
    q = ii.shape[0]
    if q > MAX_PAIRS:
        raise ValueError(f"hamming pairs: {q} pairs, at most {MAX_PAIRS} "
                         f"a launch")
    if dev.type != "cuda":
        raise ValueError(f"hamming pairs: unsupported device {dev}")
    out = torch.empty((q, k, k), dtype=torch.int32, device=dev)
    if out.numel() == 0:
        return out
    plan = tile_plan(k, k, q)
    err = _pairs_launcher()(bits.data_ptr(), f, k, p, masks.data_ptr(),
                            ii.data_ptr(), jj.data_ptr(), q, out.data_ptr(),
                            plan.bm, plan.bn, plan.wm, plan.wn,
                            torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "hamming_pairs_launch")
    graphs.count_launch(hamming_distance_matrix_pairs)
    return out


hamming_distance_matrix_pairs.launches = 0
