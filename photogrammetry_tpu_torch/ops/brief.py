"""BRIEF descriptors (port of photogrammetry_tpu/ops/brief.py).

Semantics: bit i of a keypoint is set iff intensity(p + a_i) < intensity(p +
b_i); a pair with either endpoint out of bounds leaves the bit 0.  Bit
order: pair i -> bit i (LSB-first) when packed.  Steered BRIEF rotates each
keypoint's offsets by its intensity-centroid orientation first
(``keypoint_orientations``, ``brief_bits_oriented``).

``brief_bits`` here is the plain PyTorch version (a batched gather); the
frontend calls the CUDA kernel in ``kernels/brief_pack.py``, whose wrapper
runs this function only for tensors on the CPU.
"""
from __future__ import annotations

import numpy as np
import torch

from photogrammetry_tpu_torch import resolve_device
from photogrammetry_tpu_torch.ops.refine import _box_filter
from photogrammetry_tpu_torch.utils import prng

NUM_PAIRS = 256
DEFAULT_SIGMA = 50.0
ORIENTATION_RADIUS = 15


def gaussian_pairs(seed: int, sigma: float = DEFAULT_SIGMA,
                   num_pairs: int = NUM_PAIRS, device="cuda") -> torch.Tensor:
    """(num_pairs, 2, 2) int32 — [(a_row, a_col), (b_row, b_col)] offsets
    on ``device``: the JAX package's ``gaussian_pairs(PRNGKey(seed), sigma,
    num_pairs)`` entry for entry.  The N(0, 1) draws are JAX's threefry
    stream and normal transform, in numpy (``utils/prng.py``), scaled by
    sigma in float32 and rounded half to even."""
    dev = resolve_device(device)
    pts = prng.normal(prng.prng_key(seed), (num_pairs, 2, 2)) \
        * np.float32(sigma)
    return torch.from_numpy(np.rint(pts).astype(np.int32)).to(dev)


def rotated_offsets(pairs: torch.Tensor,
                    cos_sin: torch.Tensor) -> torch.Tensor:
    """(P, 2, 2) offsets rotated by each keypoint's angle, (..., N, 2)
    float32 (cos, sin) -> (..., N, P, 2, 2) int64.

    [row', col'] = [[c, s], [-s, c]] @ [row, col] in f32, each product and
    the sum rounded separately (no FMA; csrc/brief_pack.cu repeats this
    order with __fmul_rn / __fadd_rn), then rounded half to even, as JAX's
    ``brief_bits_oriented`` does."""
    c = cos_sin[..., 0, None, None]                  # (..., N, 1, 1)
    s = cos_sin[..., 1, None, None]
    pr = pairs[..., 0].to(torch.float32)             # (P, 2)
    pc = pairs[..., 1].to(torch.float32)
    rr = c * pr + s * pc
    rc = -s * pr + c * pc
    return torch.stack([torch.round(rr), torch.round(rc)],
                       dim=-1).to(torch.int64)


def brief_bits(images: torch.Tensor, coords: torch.Tensor,
               pairs: torch.Tensor, mask: torch.Tensor | None = None,
               cos_sin: torch.Tensor | None = None) -> torch.Tensor:
    """BRIEF bits of a batch of frames, or of one frame.

    images (B, H, W), coords (B, N, 2) int32 (row, col), pairs (P, 2, 2)
    int32 offsets, mask (B, N) bool or None, cos_sin (B, N, 2) float32 or
    None → (B, N, P) uint8 in {0, 1}; without the B axis on every argument,
    (N, P).  A keypoint whose mask is False gives a row of zeros.  With
    ``cos_sin`` the offsets are first rotated by each keypoint's angle
    (``rotated_offsets``): steered BRIEF."""
    single = images.dim() == 2
    if single:
        images, coords = images[None], coords[None]
        mask = None if mask is None else mask[None]
        cos_sin = None if cos_sin is None else cos_sin[None]
    b, h, w = images.shape
    img = images.to(torch.float32).reshape(b, h * w)
    off = (pairs.to(torch.int64) if cos_sin is None
           else rotated_offsets(pairs, cos_sin))
    p = coords[:, :, None, None, :].to(torch.int64) + off  # (B, N, P, 2, 2)
    lim = torch.tensor([h, w], dtype=torch.int64, device=img.device)
    valid = ((p >= 0) & (p < lim)).all(dim=-1).all(dim=-1)  # (B, N, P)
    pc = torch.minimum(torch.clamp(p, min=0), lim - 1)
    idx = pc[..., 0] * w + pc[..., 1]                      # (B, N, P, 2)
    vals = torch.gather(img, 1, idx.reshape(b, -1)).reshape(idx.shape)
    bits = valid & (vals[..., 0] < vals[..., 1])
    if mask is not None:
        bits = bits & mask[..., None]
    bits = bits.to(torch.uint8)
    return bits[0] if single else bits


def keypoint_orientations(images: torch.Tensor, coords: torch.Tensor,
                          radius: int = ORIENTATION_RADIUS) -> torch.Tensor:
    """(..., N) patch orientations by the intensity-centroid method (ORB's
    orientation operator), theta = atan2(m01, m10) over a (2r+1)^2 patch,
    of (..., H, W) images at (..., N, 2) int (row, col) keypoints.

    As JAX's ``keypoint_orientations``: the patch moments are dense box
    filters of img, img*row and img*col (``_box_filter``, the JAX
    summation order), then 3 values are gathered per keypoint."""
    img = images.to(torch.float32)
    h, w = img.shape[-2:]
    rr = torch.arange(h, dtype=torch.float32, device=img.device)[:, None]
    cc = torch.arange(w, dtype=torch.float32, device=img.device)[None, :]
    moments = torch.stack([_box_filter(img, radius),
                           _box_filter(img * rr, radius),
                           _box_filter(img * cc, radius)], dim=-3)
    r0 = torch.clamp(coords[..., 0].to(torch.int64), 0, h - 1)
    c0 = torch.clamp(coords[..., 1].to(torch.int64), 0, w - 1)
    flat = moments.reshape(*moments.shape[:-2], h * w)   # (..., 3, H*W)
    idx = (r0 * w + c0)[..., None, :].expand(*flat.shape[:-1], -1)
    m00, m_r, m_c = torch.gather(flat, -1, idx).unbind(-2)
    # centroid offsets relative to the keypoint
    denom = torch.clamp(m00, min=1e-6)
    dr = m_r / denom - r0.to(torch.float32)
    dc = m_c / denom - c0.to(torch.float32)
    return torch.atan2(dr, dc)


def angles_cos_sin(thetas: torch.Tensor) -> torch.Tensor:
    """(..., N) angles → (..., N, 2) float32 (cos, sin), as
    ``brief_bits`` and the kernel take them."""
    thetas = thetas.to(torch.float32)
    return torch.stack([torch.cos(thetas), torch.sin(thetas)], dim=-1)


def brief_bits_oriented(images: torch.Tensor, coords: torch.Tensor,
                        pairs: torch.Tensor, thetas: torch.Tensor,
                        mask: torch.Tensor | None = None) -> torch.Tensor:
    """Steered BRIEF (JAX's ``brief_bits_oriented``): each keypoint's pair
    offsets rotated by its orientation ``thetas`` (..., N) before sampling;
    shapes as ``brief_bits``."""
    return brief_bits(images, coords, pairs, mask,
                      cos_sin=angles_cos_sin(thetas))


def pack_bits(bits: torch.Tensor) -> torch.Tensor:
    """(N, P) {0,1} → (N, P//32) uint32, LSB-first within each word.

    The bits of a word are disjoint, so their int32 sum is their OR: bit 31
    lands in the sign bit and the result is viewed back as uint32."""
    n, p = bits.shape
    if p % 32:
        raise ValueError(f"pack_bits: P={p} is not a multiple of 32")
    shifts = torch.arange(32, dtype=torch.int32, device=bits.device)
    w = bits.to(torch.int32).reshape(n, p // 32, 32) << shifts
    return w.sum(dim=-1, dtype=torch.int32).view(torch.uint32)


def brief_descriptors(image: torch.Tensor, coords: torch.Tensor,
                      pairs: torch.Tensor):
    """Convenience: (bits (N, P) uint8, packed (N, P//32) uint32) of one
    (H, W) frame's (N, 2) keypoints, through the plain ``brief_bits``."""
    bits = brief_bits(image, coords, pairs)
    return bits, pack_bits(bits)
