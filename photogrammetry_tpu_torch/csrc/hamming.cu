// Hamming distance matrix for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel photogrammetry_tpu/kernels/hamming.py
// (hamming_distance_matrix_pallas, _kernel), which computed |a|+|b|-2a.b as
// a matrix product on the MXU.  Here descriptors come packed LSB-first into
// 32-bit words (ops/brief.py pack_bits: 8 words for 256 bits) and each
// distance is the exact integer sum over words of __popc(a ^ b) — no float
// matrix product.
//
// One thread per output (i, j): a 256-thread block computes a 32 x 32 tile,
// with the tile's 32 A rows and 32 B rows staged in shared memory (B rows
// padded by one word so a warp's 32 threads hit 32 banks).  Rows or columns
// whose mask is 0 get INT_MAX, fused into the store.  Bound on the H100:
// bytes — the (N1, N2) int32 output (16.8 MB at 2048 x 2048, about 5 us at
// 3.35 TB/s); the inputs are 64 KB each and the popcounts are ~3 integer
// operations per word.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TILE = 32;
constexpr int ROWS = 8;       // threadIdx.y extent; each thread does 4 rows
constexpr int MAX_WORDS = 16;  // P <= 512 bits
constexpr int32_t INT_INF = 2147483647;

__global__ void hamming_kernel(const uint32_t* __restrict__ a, int n1,
                               const uint32_t* __restrict__ b, int n2,
                               int words,
                               const uint8_t* __restrict__ mask1,
                               const uint8_t* __restrict__ mask2,
                               int32_t* __restrict__ out) {
  __shared__ uint32_t sa[TILE][MAX_WORDS + 1];
  __shared__ uint32_t sb[TILE][MAX_WORDS + 1];
  const int i0 = blockIdx.y * TILE;
  const int j0 = blockIdx.x * TILE;
  const int tid = threadIdx.y * TILE + threadIdx.x;
  for (int e = tid; e < TILE * words; e += TILE * ROWS) {
    const int r = e / words;
    const int wd = e % words;
    sa[r][wd] = (i0 + r < n1) ? a[(size_t)(i0 + r) * words + wd] : 0u;
    sb[r][wd] = (j0 + r < n2) ? b[(size_t)(j0 + r) * words + wd] : 0u;
  }
  __syncthreads();

  const int j = j0 + threadIdx.x;
  if (j >= n2) return;
  const bool col_ok = mask2 == nullptr || mask2[j] != 0;
  for (int rr = threadIdx.y; rr < TILE; rr += ROWS) {
    const int i = i0 + rr;
    if (i >= n1) break;
    int d = 0;
    for (int wd = 0; wd < words; ++wd) {
      d += __popc(sa[rr][wd] ^ sb[threadIdx.x][wd]);
    }
    if (!col_ok || (mask1 != nullptr && mask1[i] == 0)) d = INT_INF;
    out[(size_t)i * n2 + j] = d;
  }
}

}  // namespace

// a: (n1, words) u32; b: (n2, words) u32; mask1/mask2: (n1,)/(n2,) uint8 or
// null; out: (n1, n2) int32.  Returns cudaError_t (cudaErrorInvalidValue for
// words > MAX_WORDS).
extern "C" int hamming_launch(const uint32_t* a, int n1, const uint32_t* b,
                              int n2, int words, const uint8_t* mask1,
                              const uint8_t* mask2, int32_t* out,
                              void* stream) {
  if (words < 1 || words > MAX_WORDS) return (int)cudaErrorInvalidValue;
  const dim3 block(TILE, ROWS);
  const dim3 grid((n2 + TILE - 1) / TILE, (n1 + TILE - 1) / TILE);
  if (grid.x > 0 && grid.y > 0) {
    hamming_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(
        a, n1, b, n2, words, mask1, mask2, out);
  }
  return (int)cudaGetLastError();
}
