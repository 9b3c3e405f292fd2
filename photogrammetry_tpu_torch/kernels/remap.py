"""Bilinear remap: CUDA kernel ``csrc/remap.cu`` and its wrapper.

Replaces the Pallas TPU kernel ``apply_remap_pallas`` of
photogrammetry_tpu/kernels/remap.py, a two-pass vertical/horizontal
approximation built around a host-side plan because TPU gathers are slow.
On Hopper every output pixel gathers its four taps through L1/L2, so the
kernel computes the exact bilinear remap for any map (folded ones too)
and there is no plan.  Bound on the H100 by bytes (map + images + output,
each once).  To come near that bound a thread reads its map entries once
and loops over a chunk of frames (``frame_plan``; a stack reads the map
once), works in tiles of 8 rows so that the rows' shared taps stay in L1,
keeps the taps of two pixels and all channels in flight at full
occupancy, and uses 32-bit offsets within a frame and streaming loads
and stores for what is touched once.  The plain
PyTorch version is ``remap_bilinear_plain`` (ops/dewarp.py
``remap_plain``), which the wrapper runs for tensors on the CPU and never
for CUDA tensors; the kernel agrees with it bit for bit.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from photogrammetry_tpu_torch.kernels import _build
from photogrammetry_tpu_torch.ops.dewarp import \
    remap_plain as remap_bilinear_plain
from photogrammetry_tpu_torch.utils import graphs

SOURCE = "photogrammetry_tpu_torch/csrc/remap.cu"
REPLACES = "photogrammetry_tpu/kernels/remap.py:245"
SM_COUNT = 132              # H100 SXM
TILE_H, TILE_W = 8, 64      # output pixels per block (ROWS, SEG)
TARGET_BLOCKS = 4 * SM_COUNT
MAX_CHUNKS = 65535          # the chunk index is blockIdx.z
MAX_FRAME_ELEMS = 0x7fffff00    # offsets within a frame are 32-bit
KERNEL_DTYPES = (torch.float32, torch.uint8)


def frame_plan(b: int, h: int, w: int) -> tuple[int, int]:
    """(frame_chunk, chunks): a block loops over ``frame_chunk`` frames
    and ``chunks`` = ceil(B / frame_chunk) of them go into blockIdx.z.  One
    chunk holds the whole batch (the map is read once) when the pixels
    alone give the card TARGET_BLOCKS blocks; a batch of small images is
    cut into more chunks, at most MAX_CHUNKS."""
    pixel_blocks = max(1, -(-h // TILE_H) * -(-w // TILE_W))
    chunks = max(1, min(b, -(-TARGET_BLOCKS // pixel_blocks), MAX_CHUNKS))
    frame_chunk = max(1, -(-b // chunks))
    return frame_chunk, max(1, -(-b // frame_chunk))


@functools.cache
def _launcher():
    fn = _build.load("remap").remap_launch
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                   ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                   ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def remap_bilinear(images: torch.Tensor, dist_map: torch.Tensor,
                   frame_chunk: int | None = None) -> torch.Tensor:
    """(B, H_s, W_s, C) float32 or uint8 images through an (H, W, 2)
    float32 map of source (row, col) → (B, H, W, C) of the images' dtype:
    bilinear, zero outside (per tap), uint8 rounded half to even.  On the
    CPU any real dtype (the plain version).  ``frame_chunk`` overrides the
    plan's frames per block (for tests)."""
    if images.dim() != 4 or dist_map.dim() != 3 or dist_map.shape[-1] != 2:
        raise ValueError(f"remap_bilinear: images {tuple(images.shape)} "
                         f"(want B, H, W, C) and map "
                         f"{tuple(dist_map.shape)} (want H, W, 2)")
    if images.device != dist_map.device:
        raise ValueError("remap_bilinear: images and map on two devices")
    if dist_map.dtype != torch.float32:
        raise ValueError("remap_bilinear: needs a float32 map")
    if images.device.type == "cpu":
        return remap_bilinear_plain(images, dist_map)
    if images.dtype not in KERNEL_DTYPES:
        raise ValueError(f"remap_bilinear: {images.dtype} images; the kernel "
                         f"takes float32 and uint8")
    if not images.is_contiguous() or not dist_map.is_contiguous():
        raise ValueError("remap_bilinear: needs contiguous tensors")
    if images.device.type != "cuda":
        raise ValueError(f"remap_bilinear: unsupported device "
                         f"{images.device}")
    b, hs, ws, ch = images.shape
    h, w, _ = dist_map.shape
    if max((hs + 2) * (ws + 2) * ch, h * w * ch) > MAX_FRAME_ELEMS \
            or h > TILE_H * MAX_CHUNKS:
        raise ValueError(f"remap_bilinear: a frame of {hs}x{ws}x{ch} or "
                         f"{h}x{w}x{ch} elements is beyond the kernel's "
                         f"32-bit offsets")
    if frame_chunk is None:
        frame_chunk = frame_plan(b, h, w)[0]
    if frame_chunk < 1 or -(-b // frame_chunk) > MAX_CHUNKS:
        raise ValueError(f"remap_bilinear: frame_chunk {frame_chunk} for "
                         f"{b} frames")
    out = torch.empty((b, h, w, ch), dtype=images.dtype,
                      device=images.device)
    if out.numel() == 0:
        return out
    err = _launcher()(images.data_ptr(), dist_map.data_ptr(), out.data_ptr(),
                      b, frame_chunk, hs, ws, h, w, ch,
                      int(images.dtype == torch.uint8),
                      torch.cuda.current_stream(images.device).cuda_stream)
    _build.check(err, "remap_launch")
    graphs.count_launch(remap_bilinear)
    return out


remap_bilinear.launches = 0
