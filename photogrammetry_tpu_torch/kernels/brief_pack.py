"""BRIEF bits: CUDA kernel ``csrc/brief_pack.cu`` and its wrapper.

Replaces the Pallas TPU kernel ``brief_bits_packed`` (``_packed_planes`` +
``_gather_unpack``) of photogrammetry_tpu/kernels/brief_pack.py, and with it
the XLA gathers the JAX frontend runs for the describe stage
(photogrammetry_tpu/ops/brief.py ``brief_bits`` and, steered,
``brief_bits_oriented``, vmapped over a batch of frames).  The TPU kernel
built dense bit planes for every pixel; this one samples per keypoint: one
launch for a batch of frames, masked keypoints giving zero rows without a
load, the pair table staged in shared memory, a warp per keypoint and four
consecutive bits a lane.  Its floor is the gather of 2 N P scattered
samples, which ``gather_probe`` measures.  The plain PyTorch version is
``brief_bits_plain`` (ops/brief.py), which the wrapper runs for tensors on
the CPU and never for CUDA tensors.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from photogrammetry_tpu_torch.kernels import _build
from photogrammetry_tpu_torch.ops.brief import brief_bits as brief_bits_plain
from photogrammetry_tpu_torch.utils import graphs

SOURCE = "photogrammetry_tpu_torch/csrc/brief_pack.cu"
REPLACES = "photogrammetry_tpu/kernels/brief_pack.py:128"
THREADS = 256                  # a block: 8 warps (csrc/brief_pack.cu)
KEYPOINTS_PER_BLOCK = THREADS // 32   # one keypoint a warp
SMEM_LIMIT = 232448            # a block's dynamic shared memory at most
MAX_FRAMES = 65535             # the frame is blockIdx.y
MAX_FRAME_ELEMS = 0x7fffffff   # pixel offsets within a frame are 32-bit


def smem_bytes(p: int) -> int:
    """Dynamic shared memory of a block: four int arrays of the pair table,
    P rounded up to 4."""
    return 16 * (-(-p // 4) * 4)


def blocks_per_frame(n: int) -> int:
    """The grid's x extent: runs of KEYPOINTS_PER_BLOCK keypoints in the
    caller's order."""
    return -(-n // KEYPOINTS_PER_BLOCK)


@functools.cache
def _launchers():
    lib = _build.load("brief_pack")
    fns = []
    for fn in (lib.brief_bits_launch, lib.brief_probe_launch):
        fn.argtypes = ([ctypes.c_void_p] + [ctypes.c_int] * 3
                       + [ctypes.c_void_p] * 3 + [ctypes.c_int]
                       + [ctypes.c_void_p, ctypes.c_int]
                       + [ctypes.c_void_p] * 2)
        fn.restype = ctypes.c_int
        fns.append(fn)
    return fns


def _check(images, coords, pairs, mask, cos_sin):
    """Raise on what the kernel does not take; True when the tensors are
    on the CPU (the plain version's case)."""
    batched = images.dim() == 3
    lead = tuple(images.shape[:1]) if batched else ()
    if images.dim() not in (2, 3) or coords.dim() != images.dim() \
            or tuple(coords.shape[:-2]) != lead or coords.shape[-1] != 2 \
            or pairs.dim() != 3 or pairs.shape[1:] != (2, 2):
        raise ValueError(f"brief_bits: expected (B, H, W), (B, N, 2), "
                         f"(P, 2, 2) or (H, W), (N, 2), (P, 2, 2); got "
                         f"{tuple(images.shape)}, {tuple(coords.shape)}, "
                         f"{tuple(pairs.shape)}")
    if mask is not None and tuple(mask.shape) != tuple(coords.shape[:-1]):
        raise ValueError(f"brief_bits: mask {tuple(mask.shape)} for coords "
                         f"{tuple(coords.shape)}")
    if cos_sin is not None and tuple(cos_sin.shape) != tuple(coords.shape):
        raise ValueError(f"brief_bits: cos_sin {tuple(cos_sin.shape)} for "
                         f"coords {tuple(coords.shape)}")
    tensors = [t for t in (images, coords, pairs, mask, cos_sin)
               if t is not None]
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(f"brief_bits: tensors on several devices {devices}")
    if images.device.type == "cpu":
        return True
    if images.dtype != torch.float32 or coords.dtype != torch.int32 \
            or pairs.dtype != torch.int32 \
            or (mask is not None and mask.dtype != torch.bool) \
            or (cos_sin is not None and cos_sin.dtype != torch.float32):
        raise ValueError("brief_bits: needs float32 images, int32 coords "
                         "and pairs, a bool mask, float32 cos_sin")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("brief_bits: needs contiguous tensors")
    if images.device.type != "cuda":
        raise ValueError(f"brief_bits: unsupported device {images.device}")
    h, w = images.shape[-2:]
    if h * w > MAX_FRAME_ELEMS or (batched and images.shape[0] > MAX_FRAMES):
        raise ValueError(f"brief_bits: {tuple(images.shape)} is beyond the "
                         f"kernel's 32-bit offsets or {MAX_FRAMES} frames")
    return False


def launch(images, coords, pairs, mask, cos_sin, out,
           probe: torch.Tensor | None = None) -> None:
    """One launch on checked (B, H, W) / (B, N, 2) operands, on the current
    stream: of the kernel into ``out``, or with ``probe`` of its gather
    alone (``gather_probe``)."""
    b, h, w = images.shape
    n, p = coords.shape[1], pairs.shape[0]
    if smem_bytes(p) > SMEM_LIMIT:
        raise ValueError(f"brief_bits: P={p} pairs do not fit a block's "
                         f"shared memory")
    kernel, probe_fn = _launchers()
    fn, dst = (kernel, out) if probe is None else (probe_fn, probe)
    err = fn(images.data_ptr(), b, h, w, coords.data_ptr(),
             None if mask is None else mask.data_ptr(),
             None if cos_sin is None else cos_sin.data_ptr(), n,
             pairs.data_ptr(), p, dst.data_ptr(),
             torch.cuda.current_stream(images.device).cuda_stream)
    _build.check(err, "brief_probe_launch" if probe is not None
                 else "brief_bits_launch")


def brief_bits(images: torch.Tensor, coords: torch.Tensor,
               pairs: torch.Tensor, mask: torch.Tensor | None = None,
               cos_sin: torch.Tensor | None = None) -> torch.Tensor:
    """(B, H, W) float32 frames, (B, N, 2) int32 (row, col), (P, 2, 2)
    int32 offsets, (B, N) bool mask or None, (B, N, 2) float32 (cos, sin)
    or None → (B, N, P) uint8 in {0, 1}, one launch; the 2-D call (H, W),
    (N, 2), ... → (N, P) as B = 1.  A masked keypoint gives zeros; with
    ``cos_sin`` the offsets are rotated first (steered BRIEF)."""
    if _check(images, coords, pairs, mask, cos_sin):
        return brief_bits_plain(images, coords, pairs, mask, cos_sin)
    single = images.dim() == 2
    if single:
        images, coords = images[None], coords[None]
        mask = None if mask is None else mask[None]
        cos_sin = None if cos_sin is None else cos_sin[None]
    b, n, p = images.shape[0], coords.shape[1], pairs.shape[0]
    out = torch.empty((b, n, p), dtype=torch.uint8, device=images.device)
    if out.numel():
        launch(images, coords, pairs, mask, cos_sin, out)
        graphs.count_launch(brief_bits)
    return out[0] if single else out


brief_bits.launches = 0


def gather_probe(images, coords, pairs, mask=None,
                 cos_sin=None) -> torch.Tensor:
    """The kernel's loads alone, at the same addresses in the same order,
    each thread storing one word: its practical floor.  (B, H, W), ... as
    ``brief_bits`` on a CUDA card → the (B * blocks_per_frame(N) *
    THREADS,) uint32 words.  Not counted as a launch of the kernel."""
    if _check(images, coords, pairs, mask, cos_sin) or images.dim() != 3:
        raise ValueError("gather_probe: needs batched CUDA tensors")
    probe = torch.empty(images.shape[0] * blocks_per_frame(coords.shape[1])
                        * THREADS, dtype=torch.int32, device=images.device)
    if probe.numel() and pairs.shape[0]:
        launch(images, coords, pairs, mask, cos_sin, None, probe)
    return probe
