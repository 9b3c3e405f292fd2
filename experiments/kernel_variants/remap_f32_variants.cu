// Variants of the bilinear remap kernel for one-channel float32 frames, timed
// by run.py beside photogrammetry_tpu_torch/csrc/remap.cu to choose its
// tiling: k2d<PX, ADJ, ROWS, MINB, STREAM> is a tile of ROWS rows by 32 * PX
// columns, a thread owning PX pixels of its row, 32 apart (ADJ = 0) or
// neighbouring (ADJ = 1), compiled for MINB blocks per SM, with streaming
// (STREAM = 1) or plain map loads and stores; kold is the earlier kernel (one
// pixel per thread, 64-bit offsets, the frame in blockIdx.z).
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>
struct Tap { float fr, fc; int o00; unsigned in; };
__device__ __forceinline__ Tap make_tap(float s_row, float s_col, int hs, int ws, int ch) {
  const float sr = isfinite(s_row) ? s_row : -2.0f;
  const float sc = isfinite(s_col) ? s_col : -2.0f;
  const float r0 = floorf(sr), c0 = floorf(sc);
  Tap t; t.fr = __fsub_rn(sr, r0); t.fc = __fsub_rn(sc, c0);
  const int ra = (int)fminf(fmaxf(r0, -2.0f), (float)hs);
  const int ca = (int)fminf(fmaxf(c0, -2.0f), (float)ws);
  const bool ra_in = ra >= 0 && ra < hs, rb_in = ra + 1 >= 0 && ra + 1 < hs;
  const bool ca_in = ca >= 0 && ca < ws, cb_in = ca + 1 >= 0 && ca + 1 < ws;
  t.o00 = (ra * ws + ca) * ch;
  t.in = (unsigned)(ra_in && ca_in) | (unsigned)(ra_in && cb_in) << 1 | (unsigned)(rb_in && ca_in) << 2 | (unsigned)(rb_in && cb_in) << 3;
  return t;
}
__device__ __forceinline__ float blend(float v00, float v01, float v10, float v11, const Tap& t) {
  const float gr = __fsub_rn(1.0f, t.fr), gc = __fsub_rn(1.0f, t.fc);
  float acc = __fmul_rn(__fmul_rn(v00, gr), gc);
  acc = __fadd_rn(acc, __fmul_rn(__fmul_rn(v01, gr), t.fc));
  acc = __fadd_rn(acc, __fmul_rn(__fmul_rn(v10, t.fr), gc));
  acc = __fadd_rn(acc, __fmul_rn(__fmul_rn(v11, t.fr), t.fc));
  return acc;
}
// 2D tile: block = 32 x ROWS threads; thread handles PX pixels of its row, strided by 32 (ADJ=0) or adjacent (ADJ=1)
template <int PX, int ADJ, int ROWS, int MINB, int STREAM>
__global__ void __launch_bounds__(32 * ROWS, MINB)
k2d(const float* __restrict__ img, const float* __restrict__ map, float* __restrict__ out, int frames, int hs, int ws, int h, int w) {
  const int lane = threadIdx.x;
  const int y = blockIdx.y * ROWS + threadIdx.y;
  if (y >= h) return;
  const int x0 = blockIdx.x * 32 * PX;
  Tap taps[PX]; int xs[PX];
#pragma unroll
  for (int k = 0; k < PX; ++k) {
    const int x = ADJ ? x0 + lane * PX + k : x0 + lane + 32 * k;
    xs[k] = x;
    float2 s = make_float2(-2.f, -2.f);
    if (x < w) s = STREAM ? __ldcs(reinterpret_cast<const float2*>(map) + (size_t)y * w + x) : reinterpret_cast<const float2*>(map)[(size_t)y * w + x];
    taps[k] = make_tap(s.x, s.y, hs, ws, 1);
  }
  for (int f = 0; f < frames; ++f) {
    const float* src = img + (size_t)f * hs * ws;
    float* dst = out + ((size_t)f * h + y) * w;
    float v[PX][4];
#pragma unroll
    for (int k = 0; k < PX; ++k) {
      const float* p = src + taps[k].o00; const unsigned in = taps[k].in;
      v[k][0] = (in & 1) ? __ldg(p) : 0.f; v[k][1] = (in & 2) ? __ldg(p + 1) : 0.f;
      v[k][2] = (in & 4) ? __ldg(p + ws) : 0.f; v[k][3] = (in & 8) ? __ldg(p + ws + 1) : 0.f;
    }
#pragma unroll
    for (int k = 0; k < PX; ++k) if (xs[k] < w) {
      const float r = blend(v[k][0], v[k][1], v[k][2], v[k][3], taps[k]);
      if (STREAM) __stcs(dst + xs[k], r); else dst[xs[k]] = r;
    }
  }
}
// the earlier kernel, as it was
__global__ void kold(const float* __restrict__ img, const float2* __restrict__ map, float* __restrict__ out, int hs, int ws, int h, int w, int ch) {
  const int x = blockIdx.x * 32 + threadIdx.x, y = blockIdx.y * 8 + threadIdx.y;
  if (x >= w || y >= h) return;
  const size_t pix = (size_t)y * w + x;
  const float2 s = map[pix];
  const float sr = isfinite(s.x) ? s.x : -2.0f, sc = isfinite(s.y) ? s.y : -2.0f;
  const float r0 = floorf(sr), c0 = floorf(sc);
  const float fr = __fsub_rn(sr, r0), fc = __fsub_rn(sc, c0), gr = __fsub_rn(1.0f, fr), gc = __fsub_rn(1.0f, fc);
  const int ra = (int)fminf(fmaxf(r0, -2.0f), (float)hs), ca = (int)fminf(fmaxf(c0, -2.0f), (float)ws);
  const int rb = ra + 1, cb = ca + 1;
  const bool ra_in = ra >= 0 && ra < hs, rb_in = rb >= 0 && rb < hs, ca_in = ca >= 0 && ca < ws, cb_in = cb >= 0 && cb < ws;
  const float* src = img + (size_t)blockIdx.z * hs * ws * ch;
  float* dst = out + ((size_t)blockIdx.z * h * w + pix) * ch;
  const size_t o00 = ((size_t)ra * ws + ca) * ch, o01 = ((size_t)ra * ws + cb) * ch, o10 = ((size_t)rb * ws + ca) * ch, o11 = ((size_t)rb * ws + cb) * ch;
  for (int c = 0; c < ch; ++c) {
    const float v00 = (ra_in && ca_in) ? src[o00 + c] : 0.0f, v01 = (ra_in && cb_in) ? src[o01 + c] : 0.0f;
    const float v10 = (rb_in && ca_in) ? src[o10 + c] : 0.0f, v11 = (rb_in && cb_in) ? src[o11 + c] : 0.0f;
    float acc = __fmul_rn(__fmul_rn(v00, gr), gc);
    acc = __fadd_rn(acc, __fmul_rn(__fmul_rn(v01, gr), fc));
    acc = __fadd_rn(acc, __fmul_rn(__fmul_rn(v10, fr), gc));
    acc = __fadd_rn(acc, __fmul_rn(__fmul_rn(v11, fr), fc));
    dst[c] = acc;
  }
}
#define V(ID, PX, ADJ, ROWS, MINB, STREAM) case ID: { dim3 grid((w + 32 * PX - 1) / (32 * PX), (h + ROWS - 1) / ROWS); k2d<PX, ADJ, ROWS, MINB, STREAM><<<grid, dim3(32, ROWS), 0, st>>>(img, map, out, b, hs, ws, h, w); break; }
extern "C" int exp_launch(int variant, const float* img, const float* map, float* out, int b, int hs, int ws, int h, int w, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  switch (variant) {
    case 0: kold<<<dim3((w + 31) / 32, (h + 7) / 8, b), dim3(32, 8), 0, st>>>(img, (const float2*)map, out, hs, ws, h, w, 1); break;
    V(1, 1, 0, 8, 1, 0) V(2, 1, 0, 8, 1, 1) V(3, 2, 0, 8, 1, 1) V(4, 4, 0, 8, 1, 1) V(5, 4, 0, 8, 4, 1) V(6, 2, 0, 8, 4, 1)
    V(7, 2, 1, 8, 1, 1) V(8, 4, 1, 8, 1, 1) V(9, 4, 1, 8, 4, 1) V(10, 2, 0, 4, 1, 1) V(11, 2, 0, 16, 1, 1) V(12, 4, 0, 4, 8, 1)
    V(13, 1, 0, 4, 1, 1) V(14, 1, 0, 16, 1, 1) V(15, 1, 0, 32, 1, 1) V(16, 2, 0, 8, 8, 1) V(17, 8, 0, 8, 1, 1) V(18, 2, 0, 2, 1, 1)
    default: return 1;
  }
  return (int)cudaGetLastError();
}
