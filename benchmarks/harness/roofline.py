"""Published peaks of one NVIDIA H100 SXM (data sheet; dense rates at the
700 W power limit) and each kernel's operations and bytes from the shapes
it ran at.  Bytes count each input byte read once and each output byte
written once, whatever a kernel reads again."""
from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12          # outside the tensor cores


def bound_s(nbytes: float, ops: float = 0.0) -> float:
    """The least time the card could take: the larger of the bytes at the
    HBM rate and the float32 operations at the CUDA cores' rate."""
    return max(nbytes / HBM_BYTES_PER_S, ops / FP32_OPS_PER_S)


def fast_bytes(frames: int, h: int, w: int) -> int:
    """FAST score map: float32 frames in, int32 scores out."""
    return frames * h * w * (4 + 4)


def schur_bytes(f: int, t: int) -> int:
    """Schur products at F cameras, T landmarks: w_hinv and w_cp (F, T, 6,
    3) and b_p (T, 3) float32 in; s_off (F, F, 6, 6) and corr (F, 6)
    out."""
    return 4 * (2 * f * t * 18 + 3 * t + 36 * f * f + 6 * f)


def schur_ops(f: int, t: int) -> int:
    """Multiply-adds of s_off (F^2 T 6 6 3) and corr (F T 6 3), two
    operations each."""
    return 2 * (f * f * t * 108 + f * t * 18)


def hamming_bytes(n1: int, n2: int, p: int) -> int:
    """Hamming distances: (N, P) uint8 bits and masks in, int32 (N1, N2)
    out."""
    return (n1 + n2) * (p + 1) + 4 * n1 * n2


def remap_bytes(frames: int, h: int, w: int, itemsize: int = 4) -> int:
    """Remap: frames in and out, the (H, W, 2) float32 map once."""
    return 2 * frames * h * w * itemsize + h * w * 8
