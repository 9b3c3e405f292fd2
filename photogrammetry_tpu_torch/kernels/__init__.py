"""The hand-written CUDA kernels' entry points: each launches its kernel
on CUDA tensors and runs its plain PyTorch version on CPU tensors.  A
kernel is built at its first launch, never at import."""
from photogrammetry_tpu_torch.kernels.hamming import hamming_distance_matrix
from photogrammetry_tpu_torch.kernels.fast_stencil import fast_score_map
from photogrammetry_tpu_torch.kernels.schur import schur_products

__all__ = ["hamming_distance_matrix", "fast_score_map", "schur_products"]
