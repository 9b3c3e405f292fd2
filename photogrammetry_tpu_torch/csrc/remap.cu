// Bilinear remap through a fixed source-coordinate map, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel photogrammetry_tpu/kernels/remap.py
// (apply_remap_pallas: build_remap_plan + two _run_pass programs).  That
// kernel approximates the remap by a vertical and a horizontal pass over
// precomputed slab tables because the TPU gathers slowly; its result carries
// a cross-term error and a folded map makes it give way to another path.
// Here one thread per output pixel reads its map entry and gathers its four
// taps through L2, so the result is the exact function
// ops/dewarp.py remap_plain(mode="bilinear") for every map: no plan, no
// second pass, no special case.
//
// Shapes: images (B, Hs, Ws, C), map (H, W, 2) f32 of source (row, col),
// out (B, H, W, C); the frame is in blockIdx.z and the channels in the
// thread's inner loop, so the map entry, the indices and the four weights
// are computed once per pixel.  float32 and uint8 images.
//
// Bound on the H100: bytes.  The map (8 B per output pixel), the image and
// the output are each moved once (33.2 MB for one 1080x1920 f32 frame, about
// 10 us at 3.35 TB/s); the ~20 operations per pixel and channel are far below
// the card's rate.  Neighbouring threads read neighbouring map entries
// (coalesced float2) and, for a smooth map, neighbouring source pixels.
//
// Bit-exactness against the plain version: nvcc would contract a*b + c into
// an FMA, which PyTorch's elementwise ops never form, so every product, sum
// and difference below is an explicit round-to-nearest intrinsic in the
// plain version's order of evaluation: (1-fr) and (1-fc) first, each term
// ((tap * wr) * wc), the four terms summed left to right.  Weights come from
// the unclamped floor; only the index is clamped, in float, to [-2, size]
// before the cast, so a coordinate far outside casts safely and both its
// taps stay outside.  A non-finite coordinate becomes -2 (samples nothing).
// Integer images round half to even (rintf), as torch.round does.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int TX = 32;
constexpr int TY = 8;

__device__ __forceinline__ float finish(float acc, float*) { return acc; }
__device__ __forceinline__ uint8_t finish(float acc, uint8_t*) {
  return (uint8_t)(int)rintf(acc);
}

template <typename T>
__global__ void remap_kernel(const T* __restrict__ img,
                             const float2* __restrict__ map,
                             T* __restrict__ out, int hs, int ws, int h, int w,
                             int ch) {
  const int x = blockIdx.x * TX + threadIdx.x;
  const int y = blockIdx.y * TY + threadIdx.y;
  if (x >= w || y >= h) return;
  const size_t pix = (size_t)y * w + x;
  const float2 s = map[pix];
  const float sr = isfinite(s.x) ? s.x : -2.0f;
  const float sc = isfinite(s.y) ? s.y : -2.0f;
  const float r0 = floorf(sr);
  const float c0 = floorf(sc);
  const float fr = __fsub_rn(sr, r0);
  const float fc = __fsub_rn(sc, c0);
  const float gr = __fsub_rn(1.0f, fr);
  const float gc = __fsub_rn(1.0f, fc);
  const int ra = (int)fminf(fmaxf(r0, -2.0f), (float)hs);
  const int ca = (int)fminf(fmaxf(c0, -2.0f), (float)ws);
  const int rb = ra + 1;
  const int cb = ca + 1;
  const bool ra_in = ra >= 0 && ra < hs;
  const bool rb_in = rb >= 0 && rb < hs;
  const bool ca_in = ca >= 0 && ca < ws;
  const bool cb_in = cb >= 0 && cb < ws;

  const T* src = img + (size_t)blockIdx.z * hs * ws * ch;
  T* dst = out + ((size_t)blockIdx.z * h * w + pix) * ch;
  const size_t o00 = ((size_t)ra * ws + ca) * ch;
  const size_t o01 = ((size_t)ra * ws + cb) * ch;
  const size_t o10 = ((size_t)rb * ws + ca) * ch;
  const size_t o11 = ((size_t)rb * ws + cb) * ch;
  for (int c = 0; c < ch; ++c) {
    // an offset is formed from an outside index but read only when inside
    const float v00 = (ra_in && ca_in) ? (float)src[o00 + c] : 0.0f;
    const float v01 = (ra_in && cb_in) ? (float)src[o01 + c] : 0.0f;
    const float v10 = (rb_in && ca_in) ? (float)src[o10 + c] : 0.0f;
    const float v11 = (rb_in && cb_in) ? (float)src[o11 + c] : 0.0f;
    float acc = __fmul_rn(__fmul_rn(v00, gr), gc);
    acc = __fadd_rn(acc, __fmul_rn(__fmul_rn(v01, gr), fc));
    acc = __fadd_rn(acc, __fmul_rn(__fmul_rn(v10, fr), gc));
    acc = __fadd_rn(acc, __fmul_rn(__fmul_rn(v11, fr), fc));
    dst[c] = finish(acc, (T*)nullptr);
  }
}

template <typename T>
int launch(const void* img, const void* map, void* out, int b, int hs, int ws,
           int h, int w, int ch, void* stream) {
  const dim3 block(TX, TY);
  const dim3 grid((w + TX - 1) / TX, (h + TY - 1) / TY, b);
  remap_kernel<T><<<grid, block, 0, (cudaStream_t)stream>>>(
      (const T*)img, (const float2*)map, (T*)out, hs, ws, h, w, ch);
  return (int)cudaGetLastError();
}

}  // namespace

// img: (b, hs, ws, ch) contiguous, float32 (is_u8 == 0) or uint8; map:
// (h, w, 2) f32 contiguous; out: (b, h, w, ch) of img's type.  b <= 65535.
// Returns cudaError_t.
extern "C" int remap_launch(const void* img, const void* map, void* out, int b,
                            int hs, int ws, int h, int w, int ch, int is_u8,
                            void* stream) {
  return is_u8 ? launch<uint8_t>(img, map, out, b, hs, ws, h, w, ch, stream)
               : launch<float>(img, map, out, b, hs, ws, h, w, ch, stream);
}
