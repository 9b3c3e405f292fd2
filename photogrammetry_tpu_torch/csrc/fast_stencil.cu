// FAST-16 score map for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel photogrammetry_tpu/kernels/fast_stencil.py
// (fast_score_map_pallas and fast_score_map_pallas_batch, body _make_kernel):
// one kernel serves both, with the frame index in blockIdx.z.
//
// Bound on the H100: bytes, one f32 read and one int32 write per pixel
// (16.6 MB at 1080p, 4.95 us at 3.35 TB/s).  Computed as ops/fast.py writes
// it, a pixel costs ~130 instructions for the 32-step run recurrence over
// the doubled ring and 17 loads, which keeps one thread a pixel issue-bound
// at several times the bytes bound.  So the kernel:
//
// - takes the longest circular run bit-parallel (ring_score below: about 15
//   logic and shift instructions for the whole 16-bit mask);
// - tests the four compass points of the ring first (COMPASS): a run of 12
//   of 16 covers at least 3 of ring positions {0, 4, 8, 12}, so fewer than
//   3 of those outside the band scores 0 without the other 12 compares
//   (68.75% of all masks; most of a flat background);
// - gives a thread PX neighbouring pixels of a row, so the store is one
//   16-byte word where W % 4 == 0 (scalar at a ragged edge), over a 32-wide
//   and TH-tall output tile a block (64 rows: a block's 256 threads take
//   two passes over the staged tile, and the halo makes 1.37 staged values
//   an output);
// - stages the tile with its halo as 16-byte loads (VEC: W % 4 == 0 and a
//   16-byte aligned image), 40 columns from x0 - 4, so a block issues a
//   quarter of the load instructions that one load a pixel would (the
//   scalar path, for the other images, stages the same columns).  The
//   tile's rows are an odd number of words apart, so the four rows a warp
//   reads fall into distinct banks.
//
// On an NVIDIA H100 80GB HBM3 at 700 W (experiments/kernel_variants/run.py)
// the compass pre-test halves the time on the star-scene frames and costs
// nothing on noise, 4 pixels a thread beat 1 by ~10%, the 16-byte staging
// takes a 1080p frame from ~11 to ~8 us, and 64-row tiles take the 12-frame
// batch from ~106 to ~94 us (a single frame stays within 2%).
//
// Bit-exactness: the band edges are formed in f32 as lower = c - thr and
// upper = c + thr and compared with <= / >=, as ops/fast.py does; no FMA
// can form here (there is no multiply).  ring_score equals ops/fast.py's
// recurrence with its cap at 16 and its >= 12 test for all 65,536 masks
// (kernels/fast_stencil.ring_score mirrors it; the CPU tests check it).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int R = 3;            // ring radius == border
constexpr int TW = 32;          // output tile columns
constexpr int THREADS = 256;
constexpr int LEFT = 4;         // staged columns left of x0 (R, rounded up
                                // to a 16-byte word)
constexpr int SW = TW + 2 * LEFT;  // 40 staged columns
constexpr int PITCH = SW + 1;      // 41: odd, see above

// Longest circular run of set bits of the 16-bit ring mask m, as a FAST
// score: 12..16, or 0 below 12.  Bit k of aL is set iff bits k..k+L-1 of
// the doubled ring x are all set; a start k < 16 covers every circular run.
__device__ __forceinline__ int ring_score(unsigned m) {
  const unsigned x = m | (m << 16);
  const unsigned a2 = x & (x >> 1);
  const unsigned a4 = a2 & (a2 >> 2);
  const unsigned a8 = a4 & (a4 >> 4);
  const unsigned a12 = a8 & (a4 >> 8);
  const unsigned a13 = a12 & (x >> 12);
  const unsigned a14 = a12 & (a2 >> 12);
  const unsigned a15 = a14 & (x >> 14);
  const unsigned a16 = a8 & (a8 >> 8);
  const int run = 12 + ((a13 & 0xFFFFu) != 0) + ((a14 & 0xFFFFu) != 0) +
                  ((a15 & 0xFFFFu) != 0) + ((a16 & 0xFFFFu) != 0);
  return (a12 & 0xFFFFu) ? run : 0;
}

template <bool COMPASS, int P>
__device__ __forceinline__ int pixel_score(float (*tile)[P], int ly, int lx,
                                           float thr) {
  const float c = tile[ly][lx];
  const float lower = c - thr;
  const float upper = c + thr;
#define OUT(k, dr, dc)                                                  \
  ((unsigned)((tile[ly + (dr)][lx + (dc)] <= lower) |                   \
              (tile[ly + (dr)][lx + (dc)] >= upper)) << (k))
  // radius-3 Bresenham ring in order (ops/fast.py RING_OFFSETS); the
  // compass points 0, 4, 8, 12 first
  unsigned m = OUT(0, -3, 0) | OUT(4, 0, 3) | OUT(8, 3, 0) | OUT(12, 0, -3);
  if (COMPASS && __popc(m) < 3) return 0;
  m |= OUT(1, -3, 1) | OUT(2, -2, 2) | OUT(3, -1, 3) | OUT(5, 1, 3) |
       OUT(6, 2, 2) | OUT(7, 3, 1) | OUT(9, 3, -1) | OUT(10, 2, -2) |
       OUT(11, 1, -3) | OUT(13, -1, -3) | OUT(14, -2, -2) | OUT(15, -3, -1);
#undef OUT
  return ring_score(m);
}

// A block: a TH x TW output tile of frame blockIdx.z; a thread: PX
// neighbouring pixels of a row, THREADS * PX / TW rows apart.
template <int PX, bool COMPASS, int TH, bool VEC>
__global__ void __launch_bounds__(THREADS)
fast_score_kernel(const float* __restrict__ img, int32_t* __restrict__ out,
                  int h, int w, float thr) {
  constexpr int SH = TH + 2 * R;  // staged rows
  __shared__ float tile[SH][PITCH];
  const size_t plane = (size_t)h * w;
  const float* src = img + blockIdx.z * plane;
  int32_t* dst = out + blockIdx.z * plane;
  const int x0 = blockIdx.x * TW;
  const int y0 = blockIdx.y * TH;
  // stage the tile and its halo (staged column c is image column
  // x0 - LEFT + c); outside the image only border pixels read the zeros,
  // and they score 0
  if (VEC) {
    // W % 4 == 0: a 16-byte word lies wholly inside the image or outside
    for (int e = threadIdx.x; e < SH * (SW / 4); e += THREADS) {
      const int ty = e / (SW / 4);
      const int q = e - ty * (SW / 4);
      const int gy = y0 + ty - R;
      const int gx = x0 - LEFT + 4 * q;
      float4 v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      if (gy >= 0 && gy < h && gx >= 0 && gx < w) {
        v = *reinterpret_cast<const float4*>(src + (size_t)gy * w + gx);
      }
      tile[ty][4 * q] = v.x;
      tile[ty][4 * q + 1] = v.y;
      tile[ty][4 * q + 2] = v.z;
      tile[ty][4 * q + 3] = v.w;
    }
  } else {
    const int warp = threadIdx.x >> 5;
    const int lane = threadIdx.x & 31;
    for (int ty = warp; ty < SH; ty += THREADS / 32) {
      const int gy = y0 + ty - R;
      const bool row_in = gy >= 0 && gy < h;
      for (int tx = lane; tx < SW; tx += 32) {
        const int gx = x0 - LEFT + tx;
        tile[ty][tx] = (row_in && gx >= 0 && gx < w)
                           ? src[(size_t)gy * w + gx] : 0.0f;
      }
    }
  }
  __syncthreads();

  constexpr int PER_ROW = TW / PX;            // threads across a row
  constexpr int ROWS = THREADS / PER_ROW;     // rows a pass
  const int cx = (threadIdx.x % PER_ROW) * PX;
  const bool vector_store = PX == 4 && (w & 3) == 0;
  for (int ry = threadIdx.x / PER_ROW; ry < TH; ry += ROWS) {
    const int y = y0 + ry;
    if (y >= h) break;
    const bool row_interior = y >= R && y < h - R;
    int score[PX];
#pragma unroll
    for (int q = 0; q < PX; ++q) {
      const int x = x0 + cx + q;
      score[q] = (row_interior && x >= R && x < w - R)
                     ? pixel_score<COMPASS>(tile, ry + R, cx + q + LEFT, thr)
                     : 0;
    }
    const int x = x0 + cx;
    int32_t* o = dst + (size_t)y * w + x;
    if (vector_store && x + PX <= w) {
      *reinterpret_cast<int4*>(o) =
          make_int4(score[0], score[PX > 1 ? 1 : 0], score[PX > 2 ? 2 : 0],
                    score[PX > 3 ? 3 : 0]);
    } else {
#pragma unroll
      for (int q = 0; q < PX; ++q) {
        if (x + q < w) o[q] = score[q];
      }
    }
  }
}

// VEC where every row of every frame starts 16-byte aligned
inline bool rows_aligned(const float* img, int w) {
  return (w & 3) == 0 && (reinterpret_cast<uintptr_t>(img) & 15) == 0;
}

template <int PX, bool COMPASS, int TH, bool VEC>
int launch(const float* img, int32_t* out, int b, int h, int w, float thr,
           cudaStream_t stream) {
  const dim3 grid((w + TW - 1) / TW, (h + TH - 1) / TH, b);
  fast_score_kernel<PX, COMPASS, TH, VEC><<<grid, THREADS, 0, stream>>>(
      img, out, h, w, thr);
  return (int)cudaGetLastError();
}

}  // namespace

// img: (b, h, w) f32 contiguous; out: (b, h, w) int32 (16-byte aligned, as
// torch allocates it).  Returns cudaError_t.
extern "C" int fast_score_launch(const float* img, int32_t* out, int b, int h,
                                 int w, float thr, void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  return rows_aligned(img, w) ? launch<4, true, 64, true>(img, out, b, h, w,
                                                          thr, s)
                              : launch<4, true, 64, false>(img, out, b, h, w,
                                                           thr, s);
}
