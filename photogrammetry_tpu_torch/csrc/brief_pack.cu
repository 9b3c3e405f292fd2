// BRIEF descriptor bits for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel photogrammetry_tpu/kernels/brief_pack.py
// (brief_bits_packed -> _packed_planes, + _gather_unpack), which evaluated
// every pair densely for all pixels because the TPU's per-element gather is
// slow.  A Hopper SM gathers from L2 cheaply, so this kernel samples per
// keypoint instead: one thread per (keypoint, pair), the image (8.3 MB f32
// at 1080p) stays resident in the 50 MB L2.
//
// Bound on the H100: bytes — the distinct pixels the pairs touch (at most
// 2 x N x P f32 samples, about 1M at N=2048, P=256), the coords and pairs,
// and N x P uint8 written (0.5 MB); every access after the first is an L2
// hit.  The comparison is strict <, and a pair with either endpoint out of
// bounds gives bit 0 without loading anything (ops/brief.py brief_bits).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__global__ void brief_bits_kernel(const float* __restrict__ img, int h, int w,
                                  const int32_t* __restrict__ coords, int n,
                                  const int32_t* __restrict__ pairs, int p,
                                  uint8_t* __restrict__ out) {
  const int64_t e = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= (int64_t)n * p) return;
  const int k = (int)(e / p);
  const int q = (int)(e % p);
  const int r = coords[2 * k];
  const int c = coords[2 * k + 1];
  const int ar = r + pairs[4 * q];
  const int ac = c + pairs[4 * q + 1];
  const int br = r + pairs[4 * q + 2];
  const int bc = c + pairs[4 * q + 3];
  uint8_t bit = 0;
  if (ar >= 0 && ar < h && ac >= 0 && ac < w &&
      br >= 0 && br < h && bc >= 0 && bc < w) {
    bit = __ldg(img + (size_t)ar * w + ac) < __ldg(img + (size_t)br * w + bc);
  }
  out[e] = bit;
}

}  // namespace

// img: (h, w) f32; coords: (n, 2) int32 (row, col); pairs: (p, 2, 2) int32;
// out: (n, p) uint8.  Returns cudaError_t.
extern "C" int brief_bits_launch(const float* img, int h, int w,
                                 const int32_t* coords, int n,
                                 const int32_t* pairs, int p, uint8_t* out,
                                 void* stream) {
  const int threads = 256;
  const int64_t total = (int64_t)n * p;
  const unsigned blocks = (unsigned)((total + threads - 1) / threads);
  if (blocks > 0) {
    brief_bits_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
        img, h, w, coords, n, pairs, p, out);
  }
  return (int)cudaGetLastError();
}
