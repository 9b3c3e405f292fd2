// FAST-16 score map for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel photogrammetry_tpu/kernels/fast_stencil.py
// (fast_score_map_pallas and fast_score_map_pallas_batch, body _make_kernel):
// one kernel serves both, with the frame index in blockIdx.z.
//
// One thread per output pixel.  A block loads its 32x8 output tile plus a
// 3-pixel halo into shared memory once (38x14 floats), so each image pixel is
// read from device memory about 1.7 times instead of 17; the 16 ring reads,
// the doubled-ring run recurrence, the cap at 16, the >= 12 test and the
// border zeroing all run in registers.  Bound on the H100: bytes — one f32
// read and one int32 write per pixel (16.6 MB at 1080p, about 5 us at
// 3.35 TB/s); the ~100 integer/compare operations per pixel are far below
// the card's rate.
//
// Bit-exactness: the band edges are formed in f32 as lower = c - thr and
// upper = c + thr and compared with <= / >=, as ops/fast.py does; no FMA
// can form here (there is no multiply).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TX = 32;
constexpr int TY = 8;
constexpr int R = 3;  // ring radius == border

__global__ void fast_score_kernel(const float* __restrict__ img,
                                  int32_t* __restrict__ out, int h, int w,
                                  float thr) {
  __shared__ float tile[TY + 2 * R][TX + 2 * R];
  const size_t plane = (size_t)h * w;
  const float* src = img + blockIdx.z * plane;
  const int x0 = blockIdx.x * TX;
  const int y0 = blockIdx.y * TY;
  const int tid = threadIdx.y * TX + threadIdx.x;
  for (int i = tid; i < (TY + 2 * R) * (TX + 2 * R); i += TX * TY) {
    const int ty = i / (TX + 2 * R);
    const int tx = i % (TX + 2 * R);
    const int gy = y0 + ty - R;
    const int gx = x0 + tx - R;
    // outside the image only border pixels read this, and they score 0
    tile[ty][tx] = (gy >= 0 && gy < h && gx >= 0 && gx < w)
                       ? src[(size_t)gy * w + gx] : 0.0f;
  }
  __syncthreads();

  const int x = x0 + threadIdx.x;
  const int y = y0 + threadIdx.y;
  if (x >= w || y >= h) return;
  int score = 0;
  if (y >= R && y < h - R && x >= R && x < w - R) {
    const int ly = threadIdx.y + R;
    const int lx = threadIdx.x + R;
    const float c = tile[ly][lx];
    const float lower = c - thr;
    const float upper = c + thr;
    unsigned m = 0;
#define RING_BIT(k, dr, dc)                                   \
    {                                                         \
      const float s = tile[ly + (dr)][lx + (dc)];             \
      m |= (unsigned)((s <= lower) | (s >= upper)) << (k);    \
    }
    // radius-3 Bresenham ring in order (ops/fast.py RING_OFFSETS)
    RING_BIT(0, -3, 0)  RING_BIT(1, -3, 1)  RING_BIT(2, -2, 2)
    RING_BIT(3, -1, 3)  RING_BIT(4, 0, 3)   RING_BIT(5, 1, 3)
    RING_BIT(6, 2, 2)   RING_BIT(7, 3, 1)   RING_BIT(8, 3, 0)
    RING_BIT(9, 3, -1)  RING_BIT(10, 2, -2) RING_BIT(11, 1, -3)
    RING_BIT(12, 0, -3) RING_BIT(13, -1, -3) RING_BIT(14, -2, -2)
    RING_BIT(15, -3, -1)
#undef RING_BIT
    // longest circular run: backward recurrence over the doubled ring
    int run = 0;
    int best = 0;
#pragma unroll
    for (int k = 31; k >= 0; --k) {
      run = ((m >> (k & 15)) & 1u) ? run + 1 : 0;
      if (k < 16) best = max(best, run);
    }
    best = min(best, 16);
    score = best >= 12 ? best : 0;
  }
  out[blockIdx.z * plane + (size_t)y * w + x] = score;
}

}  // namespace

// img: (b, h, w) f32 contiguous; out: (b, h, w) int32.  Returns cudaError_t.
extern "C" int fast_score_launch(const float* img, int32_t* out, int b, int h,
                                 int w, float thr, void* stream) {
  const dim3 block(TX, TY);
  const dim3 grid((w + TX - 1) / TX, (h + TY - 1) / TY, b);
  fast_score_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(img, out, h, w,
                                                              thr);
  return (int)cudaGetLastError();
}
