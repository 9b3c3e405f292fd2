// A probe of photogrammetry_tpu_torch/csrc/fast_stencil.cu timed by run.py:
// the same 32 x 32 tile, 4-pixel threads and compass pre-test, but
// persistent and software-pipelined: a grid of 132 * 2^variant blocks walks
// all (frame, tile) pairs, staging the next tile with 4-byte cp.async
// (zero-filled outside the image) into the second of two shared buffers
// while it scores the current one.  (The 16-byte staging the package took
// was the other probe of that round.)
#include "../../photogrammetry_tpu_torch/csrc/fast_stencil.cu"

namespace {

// this probe's own tile: 38 x 38 floats staged from (x0 - 3, y0 - 3)
constexpr int TH = 32;
constexpr int SH = TH + 2 * R;
constexpr int SR = TW + 2 * R;
constexpr int PR = SR + 1;

__device__ __forceinline__ void score_tile(float (*tile)[PR], int32_t* dst,
                                           int x0, int y0, int h, int w,
                                           float thr) {
  const int cx = (threadIdx.x % 8) * 4;
  const int ry = threadIdx.x / 8;
  const int y = y0 + ry;
  if (y >= h) return;
  const bool row_interior = y >= R && y < h - R;
  int score[4];
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const int x = x0 + cx + q;
    score[q] = (row_interior && x >= R && x < w - R)
                   ? pixel_score<true>(tile, ry + R, cx + q + R, thr) : 0;
  }
  const int x = x0 + cx;
  int32_t* o = dst + (size_t)y * w + x;
  if ((w & 3) == 0 && x + 4 <= w) {
    *reinterpret_cast<int4*>(o) = make_int4(score[0], score[1], score[2],
                                            score[3]);
  } else {
#pragma unroll
    for (int q = 0; q < 4; ++q)
      if (x + q < w) o[q] = score[q];
  }
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool in) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
               "l"(__cvta_generic_to_global(src)), "r"(in ? 4 : 0));
}

__device__ __forceinline__ void stage_async(float (*tile)[PR],
                                            const float* img, int t, int gx,
                                            int gyt, int h, int w) {
  const int per_frame = gx * gyt;
  const int f = t / per_frame, r = t % per_frame;
  const int x0 = (r % gx) * TW, y0 = (r / gx) * TH;
  const float* src = img + (size_t)f * h * w;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int ty = warp; ty < SH; ty += 8) {
    const int gy = y0 + ty - R;
    for (int tx = lane; tx < SR; tx += 32) {
      const int gxx = x0 + tx - R;
      const bool in = gy >= 0 && gy < h && gxx >= 0 && gxx < w;
      cp_async4(&tile[ty][tx], in ? src + (size_t)gy * w + gxx : img, in);
    }
  }
}

__global__ void __launch_bounds__(256)
fast_pipelined_kernel(const float* __restrict__ img,
                      int32_t* __restrict__ out, int b, int h, int w,
                      float thr) {
  __shared__ float tiles[2][SH][PR];
  const int gx = (w + TW - 1) / TW, gyt = (h + TH - 1) / TH;
  const int total = b * gx * gyt;
  int t = blockIdx.x;
  if (t >= total) return;
  stage_async(tiles[0], img, t, gx, gyt, h, w);
  asm volatile("cp.async.commit_group;\n" ::);
  for (int buf = 0; t < total; t += gridDim.x, buf ^= 1) {
    const int next = t + gridDim.x;
    if (next < total) stage_async(tiles[buf ^ 1], img, next, gx, gyt, h, w);
    asm volatile("cp.async.commit_group;\n" ::);
    asm volatile("cp.async.wait_group 1;\n" ::);
    __syncthreads();
    const int per_frame = gx * gyt;
    const int f = t / per_frame, r = t % per_frame;
    score_tile(tiles[buf], out + (size_t)f * h * w, (r % gx) * TW,
               (r / gx) * TH, h, w, thr);
    __syncthreads();  // before the next stage overwrites this buffer
  }
}

}  // namespace

extern "C" int probe_launch(int variant, const float* img, int32_t* out,
                            int b, int h, int w, float thr, void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  fast_pipelined_kernel<<<132 << variant, 256, 0, s>>>(img, out, b, h, w,
                                                       thr);
  return (int)cudaGetLastError();
}
