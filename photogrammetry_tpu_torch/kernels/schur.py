"""Schur-complement products of BA: CUDA kernel ``csrc/schur.cu`` and its
wrapper.

Replaces the Pallas TPU kernel ``schur_products_pallas`` of
photogrammetry_tpu/kernels/schur.py: both outputs of

    s_off = einsum("ftik,gtjk->fgij", w_hinv, w_cp)     # (F, F, 6, 6)
    corr  = einsum("ftik,tk->fi",     w_hinv, b_p)      # (F, 6)

in one pass over the operands, read in their (F, T, 6, 3) layout and
written in the (F, F, 6, 6) one.  One block per 2x2 tile of camera blocks,
looping over the landmark axis in shared-memory tiles; a fixed summation
order per output and no atomics.  Its bound on the H100 is set by bytes
at F=12, T=1024 and by operations at F=16, T=4096 (see the source).  The
plain PyTorch version is
``schur_products_plain`` (the two einsums of ``sfm/ba.py``), which the
wrapper runs for tensors on the CPU and never for CUDA tensors.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from photogrammetry_tpu_torch.kernels import _build

SOURCE = "photogrammetry_tpu_torch/csrc/schur.cu"
REPLACES = "photogrammetry_tpu/kernels/schur.py:66"


@functools.cache
def _launcher():
    fn = _build.load("schur").schur_launch
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
                   ctypes.c_void_p, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


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
                   b_p: torch.Tensor):
    """w_hinv, w_cp (F, T, 6, 3) f32 and b_p (T, 3) f32 →
    (s_off (F, F, 6, 6), corr (F, 6)) f32, equal to
    ``schur_products_plain`` up to the order of f32 summation."""
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
    if dev.type != "cuda":
        raise ValueError(f"schur: unsupported device {dev}")
    ops = (w_hinv, w_cp, b_p)
    if any(x.dtype != torch.float32 or not x.is_contiguous() for x in ops):
        raise ValueError("schur: needs contiguous float32 operands")
    s_off = torch.empty((f, f, 6, 6), dtype=torch.float32, device=dev)
    corr = torch.empty((f, 6), dtype=torch.float32, device=dev)
    if f == 0:
        return s_off, corr
    err = _launcher()(w_hinv.data_ptr(), w_cp.data_ptr(), b_p.data_ptr(),
                      f, t, s_off.data_ptr(), corr.data_ptr(),
                      torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "schur_launch")
    schur_products.launches += 1
    return s_off, corr


schur_products.launches = 0
