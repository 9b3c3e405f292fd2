"""Schur-complement products of BA: CUDA kernel ``csrc/schur.cu`` and its
wrapper.

Replaces the Pallas TPU kernel ``schur_products_pallas`` of
photogrammetry_tpu/kernels/schur.py: both outputs of

    s_off = einsum("ftik,gtjk->fgij", w_hinv, w_cp)     # (F, F, 6, 6)
    corr  = einsum("ftik,tk->fi",     w_hinv, b_p)      # (F, 6)

from operands read in their (F, T, 6, 3) layout, written in the
(F, F, 6, 6) one.  At the SfM path's F=12, T=1024 the work is under a
microsecond by bytes and by operations alike, so the time is set by the
launches and by how much of the card takes part; at F=16, T=4096 the
operations bound it.  The kernel therefore splits the landmark axis into
S slabs (``split_plan``) so that (camera tiles)^2 x S blocks fill the 132
SMs; a thread keeps a 6 x 6 register tile of one camera pair, a block
stages its cameras' slab through shared memory with asynchronous copies,
and a second pass sums the S partial results in slab order.  f32 on the
CUDA cores (no TF32, no tensor cores: the result is gated on the f32
bound ``error_bound``), a fixed summation order and no atomics, so two
calls give the same bits.  The plain PyTorch version is
``schur_products_plain`` (the two einsums of ``sfm/ba.py``), which the
wrapper runs for tensors on the CPU and never for CUDA tensors.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from photogrammetry_tpu_torch.kernels import _build
from photogrammetry_tpu_torch.utils import graphs

SOURCE = "photogrammetry_tpu_torch/csrc/schur.cu"
REPLACES = "photogrammetry_tpu/kernels/schur.py:66"
SM_COUNT = 132          # H100 SXM
CAM_TILE = 4            # cameras per block side (CT in the source)
TILE_T = 32             # landmarks per shared-memory tile (TL in the source)
# blocks to aim for: S = 32 at both main shapes (288 blocks at F=12,
# T=1024, one landmark tile each; 512 at F=16, T=4096), the fastest of the
# values of S that chip_smoke.py's timing_schur times
TARGET_BLOCKS = 4 * SM_COUNT
MAX_SLABS = 65535       # the slab index is blockIdx.z


class SplitPlan(NamedTuple):
    """How one call splits the landmark axis: ``slabs`` slabs of
    ``slab_len`` landmarks (a multiple of TILE_T; the last slab may be
    shorter), and the shape of the partial-sum scratch buffer."""
    slabs: int
    slab_len: int
    scratch_shape: tuple[int, int, int]


def split_plan(f: int, t: int, slabs: int | None = None) -> SplitPlan:
    """The split of T landmarks for F cameras: enough slabs that the grid
    of ceil(F / CAM_TILE)^2 x slabs blocks reaches TARGET_BLOCKS, never
    more than there are landmark tiles, and none empty (T = 0 keeps one
    slab, whose partial sums are zero).  ``slabs`` asks for a number of
    slabs; the plan may give fewer."""
    tiles = -(-f // CAM_TILE)
    t_tiles = max(1, -(-t // TILE_T))
    if slabs is None:
        slabs = -(-TARGET_BLOCKS // max(1, tiles * tiles))
    slabs = max(1, min(slabs, t_tiles, MAX_SLABS))
    slab_len = -(-t_tiles // slabs) * TILE_T
    slabs = max(1, -(-t // slab_len))
    return SplitPlan(slabs, slab_len, (slabs, 6 * f, 6 * f + 1))


@functools.cache
def _launcher():
    fn = _build.load("schur").schur_launch
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                   ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


@functools.cache
def _empty_launcher():
    fn = _build.load("schur").schur_empty_launch
    fn.argtypes = [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def launch_empty(device: torch.device) -> None:
    """Launch a kernel that does nothing on ``device``'s current stream:
    the yardstick for what one launch costs."""
    err = _empty_launcher()(torch.cuda.current_stream(device).cuda_stream)
    _build.check(err, "schur_empty_launch")


def schur_products_plain(w_hinv: torch.Tensor, w_cp: torch.Tensor,
                         b_p: torch.Tensor):
    """(s_off (F, F, 6, 6), corr (F, 6)) as two einsums."""
    return (torch.einsum("ftik,gtjk->fgij", w_hinv, w_cp),
            torch.einsum("ftik,tk->fi", w_hinv, b_p))


def error_bound(w_hinv: torch.Tensor, w_cp: torch.Tensor,
                b_p: torch.Tensor):
    """Worst-case f32 rounding bound of (s_off, corr) for a sum of 3T
    products in any order: ``3T * 2^-23 * (|A| |B|^T)`` elementwise, and
    the same with |bp| — what two summation orders may differ by."""
    eps = 3 * w_hinv.shape[1] * 2.0 ** -23
    a, b, p = (x.double().abs() for x in (w_hinv, w_cp, b_p))
    s, c = schur_products_plain(a, b, p)
    return eps * s, eps * c


def schur_products(w_hinv: torch.Tensor, w_cp: torch.Tensor,
                   b_p: torch.Tensor, slabs: int | None = None):
    """w_hinv, w_cp (F, T, 6, 3) f32 and b_p (T, 3) f32 →
    (s_off (F, F, 6, 6), corr (F, 6)) f32, equal to
    ``schur_products_plain`` up to the order of f32 summation.  ``slabs``
    overrides the split plan's number of landmark slabs (for timing)."""
    f, t = w_hinv.shape[:2]
    if w_hinv.shape != (f, t, 6, 3) or w_cp.shape != (f, t, 6, 3) \
            or b_p.shape != (t, 3):
        raise ValueError(f"schur: shapes {tuple(w_hinv.shape)}, "
                         f"{tuple(w_cp.shape)}, {tuple(b_p.shape)} do not "
                         f"pair as (F, T, 6, 3), (F, T, 6, 3), (T, 3)")
    dev = w_hinv.device
    if w_cp.device != dev or b_p.device != dev:
        raise ValueError("schur: operands on two devices")
    if dev.type == "cpu":
        return schur_products_plain(w_hinv, w_cp, b_p)
    ops = (w_hinv, w_cp, b_p)
    if any(x.dtype != torch.float32 or not x.is_contiguous() for x in ops):
        raise ValueError("schur: needs contiguous float32 operands")
    if dev.type != "cuda":
        raise ValueError(f"schur: unsupported device {dev}")
    s_off = torch.empty((f, f, 6, 6), dtype=torch.float32, device=dev)
    corr = torch.empty((f, 6), dtype=torch.float32, device=dev)
    if f == 0:
        return s_off, corr
    plan = split_plan(f, t, slabs)
    part = torch.empty(plan.scratch_shape, dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = _launcher()(w_hinv.data_ptr(), w_cp.data_ptr(), b_p.data_ptr(),
                      f, t, plan.slabs, plan.slab_len, part.data_ptr(),
                      s_off.data_ptr(), corr.data_ptr(), stream)
    _build.check(err, "schur_launch")
    graphs.count_launch(schur_products)
    return s_off, corr


schur_products.launches = 0
