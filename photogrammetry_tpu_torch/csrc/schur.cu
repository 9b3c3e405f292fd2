// Schur-complement products of bundle adjustment for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel photogrammetry_tpu/kernels/schur.py
// (schur_products_pallas, _kernel), which streamed the two (6F, 3T) operands
// through VMEM in landmark tiles and accumulated both outputs on the MXU:
//
//   s_off[f, g, i, j] = sum_{t, k} w_hinv[f, t, i, k] * w_cp[g, t, j, k]
//   corr[f, i]        = sum_{t, k} w_hinv[f, t, i, k] * b_p[t, k]
//
// i.e. S = A B^T and corr = A bp with A, B = (6F, 3T), row (f, i), column
// (t, k).  The kernel reads the (F, T, 6, 3) layout as it lies, and writes
// s_off in its (F, F, 6, 6) layout: no flattened or transposed copies.
//
// One block per output tile of CAMS x CAMS camera blocks (12 x 12 scalars,
// one thread each).  It loops over the landmark axis in tiles of TILE_T:
// each camera's TILE_T x 18 floats are contiguous in device memory, so the
// tile loads are coalesced; landmarks past T and cameras past F load as 0
// (the ragged edges are masked in the loads and stores, nothing is padded).
// The blocks of the first camera-column tile also accumulate corr for their
// rows.  Every output is one thread's sum in a fixed order (landmark, then
// k): no atomics, so two runs give the same bits.
//
// Bound on the H100: at the main path's F=12, T=1024 the operands are
// 1.8 MB and the products 32 MFLOP (about 0.5 us either way), so launch
// latency dominates; at F=16, T=4096 the 229 MFLOP are the bound (3.4 us
// at 67 TFLOP/s f32).  This version does not try to reach it: each thread
// runs a serial f32 FMA chain of 3T terms, on 36-64 blocks for 132 SMs.
// What it does do is keep the loads off the critical path: a tile's loads
// are issued together, one tile ahead of the products (a loop of dependent
// load-store pairs serialized their latencies: 107 us at F=12, T=1024 on
// an NVIDIA H100 80GB HBM3 at 700 W, 62 us with the loads ahead).
// Split-K across more blocks and tensor-core (wgmma) tiles are left for
// later.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int CAMS = 2;              // cameras per block side
constexpr int ROWS = 6 * CAMS;       // output rows (and columns) per block
constexpr int THREADS = ROWS * ROWS;  // one output per thread
constexpr int TILE_T = 64;           // landmarks per shared-memory tile
constexpr int CHUNK = TILE_T * 18;   // floats of one camera in one tile
constexpr int LOADS = CAMS * CHUNK / THREADS;  // per thread, per operand
static_assert(CAMS * CHUNK % THREADS == 0, "tile loads must divide evenly");

__global__ void schur_kernel(const float* __restrict__ w_hinv,
                             const float* __restrict__ w_cp,
                             const float* __restrict__ b_p, int f_count,
                             int t_count, float* __restrict__ s_off,
                             float* __restrict__ corr) {
  __shared__ float sa[CAMS][CHUNK];
  __shared__ float sb[CAMS][CHUNK];
  __shared__ float sp[TILE_T * 3];

  const int fa = blockIdx.y * CAMS;   // first row camera
  const int gb = blockIdx.x * CAMS;   // first column camera
  const int tid = threadIdx.x;        // 0 .. THREADS - 1
  const int r = tid / ROWS;
  const int c = tid % ROWS;
  const int rf = r / 6, ri = r % 6;
  const int cg = c / 6, cj = c % 6;
  const bool do_corr = blockIdx.x == 0 && c == 0;

  // the next tile's loads are issued before the current tile's products,
  // so that their latency overlaps the arithmetic
  float va[LOADS], vb[LOADS];
  auto load_tile = [&](int t0) {
    const int n = min(TILE_T, t_count - t0) * 18;
#pragma unroll
    for (int it = 0; it < LOADS; ++it) {
      const int e = tid + it * THREADS;
      const int cam = e / CHUNK;
      const int off = e % CHUNK;
      const bool in_t = off < n;
      const int f = fa + cam;
      const int g = gb + cam;
      va[it] = (in_t && f < f_count)
          ? w_hinv[((size_t)f * t_count + t0) * 18 + off] : 0.f;
      vb[it] = (in_t && g < f_count)
          ? w_cp[((size_t)g * t_count + t0) * 18 + off] : 0.f;
    }
  };

  float acc = 0.f;
  float acc_corr = 0.f;
  if (t_count > 0) load_tile(0);
  for (int t0 = 0; t0 < t_count; t0 += TILE_T) {
    const int t_len = min(TILE_T, t_count - t0);
#pragma unroll
    for (int it = 0; it < LOADS; ++it) {
      const int e = tid + it * THREADS;
      sa[e / CHUNK][e % CHUNK] = va[it];
      sb[e / CHUNK][e % CHUNK] = vb[it];
    }
    if (blockIdx.x == 0) {
      for (int e = tid; e < TILE_T * 3; e += THREADS) {
        sp[e] = e < t_len * 3 ? b_p[(size_t)t0 * 3 + e] : 0.f;
      }
    }
    __syncthreads();
    if (t0 + TILE_T < t_count) load_tile(t0 + TILE_T);
    const float* a_row = &sa[rf][ri * 3];
    const float* b_row = &sb[cg][cj * 3];
#pragma unroll 4
    for (int t = 0; t < t_len; ++t) {
      const float* a3 = a_row + t * 18;
      const float* b3 = b_row + t * 18;
      acc = fmaf(a3[0], b3[0], acc);
      acc = fmaf(a3[1], b3[1], acc);
      acc = fmaf(a3[2], b3[2], acc);
      if (do_corr) {
        acc_corr = fmaf(a3[0], sp[t * 3 + 0], acc_corr);
        acc_corr = fmaf(a3[1], sp[t * 3 + 1], acc_corr);
        acc_corr = fmaf(a3[2], sp[t * 3 + 2], acc_corr);
      }
    }
    __syncthreads();
  }

  const int f = fa + rf;
  const int g = gb + cg;
  if (f < f_count && g < f_count) {
    s_off[(((size_t)f * f_count + g) * 6 + ri) * 6 + cj] = acc;
  }
  if (do_corr && f < f_count) {
    corr[(size_t)f * 6 + ri] = acc_corr;
  }
}

}  // namespace

// w_hinv, w_cp: (F, T, 6, 3) f32; b_p: (T, 3) f32; s_off: (F, F, 6, 6) f32;
// corr: (F, 6) f32, all contiguous.  Returns cudaError_t.
extern "C" int schur_launch(const float* w_hinv, const float* w_cp,
                            const float* b_p, int f_count, int t_count,
                            float* s_off, float* corr, void* stream) {
  if (f_count < 0 || t_count < 0) return (int)cudaErrorInvalidValue;
  const int tiles = (f_count + CAMS - 1) / CAMS;
  if (tiles > 0) {
    const dim3 grid(tiles, tiles);
    schur_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
        w_hinv, w_cp, b_p, f_count, t_count, s_off, corr);
  }
  return (int)cudaGetLastError();
}
