// Variants of the bilinear remap kernel for uint8 RGB frames, timed by run.py
// beside photogrammetry_tpu_torch/csrc/remap.cu: ku8<CH, PX, LOADW, STOREW,
// MINB> gathers a tap's CH bytes from aligned 32-bit words (LOADW = 1) or as
// single bytes, and stores a warp's results as 32-bit words through shared
// memory (STOREW = 1) or as single bytes, PX pixels per thread, compiled for
// MINB blocks per SM.
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
template <int CH, int LOADW>
__device__ __forceinline__ uint32_t load_bytes(const uint8_t* p) {
  if (CH == 1) return __ldg(p);
  if (!LOADW) { uint32_t r = 0;
#pragma unroll
    for (int c = 0; c < CH; ++c) r |= (uint32_t)__ldg(p + c) << 8 * c; return r; }
  const uintptr_t a = (uintptr_t)p;
  const uint32_t* w = (const uint32_t*)(a & ~(uintptr_t)3);
  const unsigned sh = (unsigned)(a & 3);
  const uint32_t lo = __ldg(w);
  const uint32_t hi = sh + CH > 4 ? __ldg(w + 1) : 0u;
  return __funnelshift_r(lo, hi, sh * 8);
}
template <int CH, int PX, int LOADW, int STOREW, int MINB>
__global__ void __launch_bounds__(256, MINB)
ku8(const uint8_t* __restrict__ img, const float* __restrict__ map, uint8_t* __restrict__ out, int frames, int hs, int ws, int h, int w) {
  constexpr int SEG = 32 * PX;
  __shared__ __align__(16) uint8_t line[8][SEG * CH];
  const int lane = threadIdx.x, warp = threadIdx.y;
  const int y = blockIdx.y * 8 + warp;
  if (y >= h) return;
  const int x0 = blockIdx.x * SEG;
  Tap taps[PX];
#pragma unroll
  for (int k = 0; k < PX; ++k) {
    const int x = x0 + lane + 32 * k;
    float2 s = make_float2(-2.f, -2.f);
    if (x < w) s = __ldcs(reinterpret_cast<const float2*>(map) + (size_t)y * w + x);
    taps[k] = make_tap(s.x, s.y, hs, ws, CH);
  }
  const int row = ws * CH;
  const int seg_bytes = min(SEG, w - x0) * CH;
  for (int f = 0; f < frames; ++f) {
    const uint8_t* src = img + (size_t)f * hs * ws * CH;
    uint8_t* dst = out + (((size_t)f * h + y) * w + x0) * CH;
    uint32_t v[PX][4];
#pragma unroll
    for (int k = 0; k < PX; ++k) {
      const uint8_t* p = src + taps[k].o00; const unsigned in = taps[k].in;
      v[k][0] = (in & 1) ? load_bytes<CH, LOADW>(p) : 0u;
      v[k][1] = (in & 2) ? load_bytes<CH, LOADW>(p + CH) : 0u;
      v[k][2] = (in & 4) ? load_bytes<CH, LOADW>(p + row) : 0u;
      v[k][3] = (in & 8) ? load_bytes<CH, LOADW>(p + row + CH) : 0u;
    }
#pragma unroll
    for (int k = 0; k < PX; ++k) {
#pragma unroll
      for (int c = 0; c < CH; ++c) {
        const float acc = blend((float)(v[k][0] >> 8 * c & 0xffu), (float)(v[k][1] >> 8 * c & 0xffu), (float)(v[k][2] >> 8 * c & 0xffu), (float)(v[k][3] >> 8 * c & 0xffu), taps[k]);
        const uint8_t r = (uint8_t)(int)rintf(acc);
        if (STOREW) line[warp][(lane + 32 * k) * CH + c] = r;
        else if ((lane + 32 * k) * CH < seg_bytes) dst[(lane + 32 * k) * CH + c] = r;
      }
    }
    if (STOREW) {
      __syncwarp();
      const bool words = ((uintptr_t)dst & 3) == 0;
#pragma unroll
      for (int j = 0; j < (CH * PX + 3) / 4; ++j) {
        const int b = (j * 32 + lane) * 4;
        if (words && b + 4 <= seg_bytes) __stcs(reinterpret_cast<uint32_t*>(dst + b), *reinterpret_cast<const uint32_t*>(&line[warp][b]));
        else for (int e = b; e < min(b + 4, seg_bytes); ++e) __stcs(dst + e, line[warp][e]);
      }
      __syncwarp();
    }
  }
}
#define V(ID, PX, LOADW, STOREW, MINB) case ID: { dim3 grid((w + 32 * PX - 1) / (32 * PX), (h + 7) / 8); ku8<3, PX, LOADW, STOREW, MINB><<<grid, dim3(32, 8), 0, st>>>(img, map, out, b, hs, ws, h, w); break; }
extern "C" int exp_launch(int variant, const uint8_t* img, const float* map, uint8_t* out, int b, int hs, int ws, int h, int w, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  switch (variant) {
    V(0, 4, 1, 1, 1) V(1, 4, 1, 1, 3) V(2, 4, 1, 1, 4) V(3, 4, 0, 1, 1) V(4, 4, 0, 1, 4) V(5, 4, 0, 0, 1) V(6, 4, 0, 0, 4) V(7, 4, 1, 0, 4)
    V(8, 2, 1, 1, 1) V(9, 2, 1, 1, 4) V(10, 2, 0, 1, 4) V(11, 2, 0, 0, 4) V(12, 2, 0, 0, 6) V(13, 1, 0, 0, 4) V(14, 1, 1, 1, 4) V(15, 2, 1, 0, 4)
    V(16, 2, 1, 1, 6) V(17, 2, 0, 1, 6) V(18, 1, 0, 1, 6) V(19, 1, 1, 0, 6)
    default: return 1;
  }
  return (int)cudaGetLastError();
}
