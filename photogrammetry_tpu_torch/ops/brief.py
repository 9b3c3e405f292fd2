"""BRIEF descriptors (port of photogrammetry_tpu/ops/brief.py).

Semantics: bit i of a keypoint is set iff intensity(p + a_i) < intensity(p +
b_i); a pair with either endpoint out of bounds leaves the bit 0.  Bit
order: pair i -> bit i (LSB-first) when packed.

``brief_bits`` here is the plain PyTorch version (a batched gather); the
frontend calls the CUDA kernel in ``kernels/brief_pack.py``, whose wrapper
runs this function only for tensors on the CPU.
"""
from __future__ import annotations

import torch

NUM_PAIRS = 256
DEFAULT_SIGMA = 50.0


def gaussian_pairs(generator: torch.Generator, sigma: float = DEFAULT_SIGMA,
                   num_pairs: int = NUM_PAIRS) -> torch.Tensor:
    """(num_pairs, 2, 2) int32 — [(a_row, a_col), (b_row, b_col)] offsets,
    drawn from N(0, sigma) on the generator's device and rounded half to
    even.  The draws differ from ``jax.random``'s; to reproduce the JAX
    package's pairs, take them from there (``convert.from_jax``)."""
    pts = torch.randn((num_pairs, 2, 2), generator=generator,
                      device=generator.device) * sigma
    return torch.round(pts).to(torch.int32)


def brief_bits(image: torch.Tensor, coords: torch.Tensor,
               pairs: torch.Tensor) -> torch.Tensor:
    """(H, W) image, (N, 2) int32 (row, col), (P, 2, 2) int32 offsets →
    (N, P) uint8 in {0, 1}."""
    h, w = image.shape
    img = image.to(torch.float32)
    p = coords[:, None, None, :].to(torch.int64) + pairs[None].to(torch.int64)
    lim = torch.tensor([h, w], dtype=torch.int64, device=img.device)
    valid = ((p >= 0) & (p < lim)).all(dim=-1).all(dim=-1)  # (N, P)
    pc = torch.minimum(torch.clamp(p, min=0), lim - 1)
    vals = img.reshape(-1)[pc[..., 0] * w + pc[..., 1]]  # (N, P, 2)
    return (valid & (vals[..., 0] < vals[..., 1])).to(torch.uint8)


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
