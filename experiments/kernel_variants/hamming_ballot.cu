// The alternative to photogrammetry_tpu_torch/csrc/hamming.cu that was timed
// beside it (run.py): pack the {0, 1} bytes into words inside the kernel with
// __ballot_sync, then popcount.  A block owns a 64 x 64 output tile (256
// threads).  Each warp packs rows of both operands: lane l reads bytes
// 4l..4l+3 of a 128-byte segment, and ballot j over the lanes' byte j gives a
// word whose bit l is byte 4l + j, i.e. the bits in another order than
// pack_bits' LSB-first one, but in the same order for both operands, which is
// all a popcount of a ^ b needs.  Then a thread sums __popc(a ^ b) over the
// words for a 4 x 4 register block of outputs (rows 4 ty.., columns
// tx + 16 c) and stores them with masked rows/columns set to INT_INF.  Needs
// 4-byte aligned operands.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int T = 64;
constexpr int MAX_WORDS = 16;  // P <= 512
constexpr int32_t INT_INF = 2147483647;

__global__ void __launch_bounds__(256)
hamming_ballot_kernel(const uint8_t* __restrict__ a, int n1,
                      const uint8_t* __restrict__ b, int n2, int p,
                      const uint8_t* __restrict__ mask1,
                      const uint8_t* __restrict__ mask2,
                      int32_t* __restrict__ out) {
  __shared__ uint32_t sa[T][MAX_WORDS + 1];
  __shared__ uint32_t sb[T][MAX_WORDS + 1];
  const int i0 = blockIdx.y * T;
  const int j0 = blockIdx.x * T;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int segments = (p + 127) / 128;
  for (int r = warp; r < 2 * T; r += 8) {
    const bool is_a = r < T;
    const int gi = is_a ? i0 + r : j0 + r - T;
    const bool in = gi < (is_a ? n1 : n2);
    const uint8_t* row = (is_a ? a : b) + (size_t)gi * p;
    uint32_t* dst = is_a ? sa[r] : sb[r - T];
    for (int s = 0; s < segments; ++s) {
      const int byte = 128 * s + 4 * lane;
      const uint32_t v = (in && byte < p)
          ? *reinterpret_cast<const uint32_t*>(row + byte) : 0u;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const uint32_t word = __ballot_sync(0xffffffffu, (v >> (8 * j)) & 1u);
        if (lane == j) dst[4 * s + j] = word;
      }
    }
  }
  __syncthreads();

  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;
  int acc[4][4] = {};
  for (int wd = 0; wd < 4 * segments; ++wd) {
    uint32_t av[4], bv[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      av[q] = sa[4 * ty + q][wd];
      bv[q] = sb[tx + 16 * q][wd];
    }
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[r][c] += __popc(av[r] ^ bv[c]);
  }
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int i = i0 + 4 * ty + r;
    if (i >= n1) break;
    const bool row_ok = mask1 == nullptr || mask1[i];
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int j = j0 + tx + 16 * c;
      if (j >= n2) continue;
      const bool ok = row_ok && (mask2 == nullptr || mask2[j]);
      out[(size_t)i * n2 + j] = ok ? acc[r][c] : INT_INF;
    }
  }
}

}  // namespace

extern "C" int hamming_ballot_launch(const uint8_t* a, int n1,
                                     const uint8_t* b, int n2, int p,
                                     const uint8_t* mask1,
                                     const uint8_t* mask2, int32_t* out,
                                     void* stream) {
  if (p < 32 || p > 32 * MAX_WORDS || p % 32) return (int)cudaErrorInvalidValue;
  const dim3 grid((n2 + T - 1) / T, (n1 + T - 1) / T);
  hamming_ballot_kernel<<<grid, 256, 0, (cudaStream_t)stream>>>(
      a, n1, b, n2, p, mask1, mask2, out);
  return (int)cudaGetLastError();
}
