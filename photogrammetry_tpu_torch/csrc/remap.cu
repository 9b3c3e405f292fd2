// Bilinear remap through a fixed source-coordinate map, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel photogrammetry_tpu/kernels/remap.py
// (apply_remap_pallas: build_remap_plan + two _run_pass programs).  That
// kernel approximates the remap by a vertical and a horizontal pass over
// precomputed slab tables because the TPU gathers slowly; its result carries
// a cross-term error and a folded map makes it give way to another path.
// Here every output pixel reads its map entry and gathers its four taps
// through L1/L2, so the result is the exact function ops/dewarp.py
// remap_plain(mode="bilinear") for every map: no plan, no second pass, no
// special case.
//
// Shapes: images (B, Hs, Ws, C), map (H, W, 2) f32 of source (row, col),
// out (B, H, W, C).  float32 and uint8 images.
//
// Bound on the H100: bytes.  The map (8 B per output pixel), the images and
// the output are each moved once (33.2 MB for one 1080x1920 f32 frame, about
// 10 us at 3.35 TB/s); the ~20 operations per pixel and channel are far
// below the card's rate.  What the design does to come near it:
//
// - Frames inside the thread.  A thread reads its map entries once, forms
//   the fractions, the in-bounds flags and the tap offset once, and loops
//   over a chunk of frames (the chunk index in blockIdx.z, the chunk length
//   from the wrapper's plan), so a stack reads the map once, not once per
//   frame, and a large batch of small images still fills the card.
// - More bytes in flight, and the reuse of the taps kept in L1.  A block is
//   a tile of 8 output rows by SEG = 64 columns, one warp per row, and a
//   thread owns PX = 2 pixels of its row, 32 apart, so that every map read
//   (float2), tap read and store of the warp stays coalesced; the taps of
//   both pixels (for uint8 of up to 4 channels, all channels of a tap in
//   one register) are requested before any is combined, and the lower taps
//   of one row are the upper taps of the next, which the same block
//   reads.  The channel count is a template parameter for 1 to 4 channels
//   and those kernels are held to 40 registers, so that an SM holds 1536
//   threads.  Tap offsets are
//   32-bit within a frame (the frame's base pointer is 64-bit); the image
//   is read through the read-only path (__ldg), the map and the output,
//   touched once, with streaming loads and stores (__ldcs, __stcs).
//
// What was timed on the way (experiments/kernel_variants/run.py, one
// 1080x1920 frame on an NVIDIA H100 80GB HBM3 at 700.00 W, device time per
// call by CUDA-graph replay; the earlier kernel, one pixel per thread,
// 64-bit offsets and the frame in blockIdx.z, took 17.4 us there for
// float32):
// - float32: one pixel per thread in the 8-row tile 17.7 us, two pixels
//   12.2 us, two at 32 registers 11.6 us, four 11.8-12.1 us, eight 19.3
//   us; four neighbouring pixels per thread (float4 map reads) 15.3-16.2
//   us; tiles of 4 and 16 rows 12.0 and 14.0 us.  A first form of this
//   kernel that gave a block 1024 consecutive pixels of one row, so that
//   no two rows shared their taps in L1, was no faster than the earlier
//   kernel.
// - uint8 RGB: a tap's three bytes taken from the one or two aligned 32-bit
//   words that hold them, and the results of a warp put together in shared
//   memory and stored as 32-bit words, was slower than single bytes at
//   every setting (two pixels, 40 registers: 19.1 us with words both ways,
//   17.4 us with word stores only, 16.3 us with bytes; four pixels at 127
//   registers with words both ways 29.9 us): the taps of neighbouring
//   lanes share sectors already and the extra arithmetic and registers
//   cost more than the narrower accesses, so the byte path stayed.
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

constexpr int PX = 2;               // pixels per thread, 32 apart
constexpr int SEG = 32 * PX;        // consecutive pixels of a row per warp
constexpr int ROWS = 8;             // rows per block, one warp each
constexpr int THREADS = 32 * ROWS;

// what a thread keeps of one output pixel across the frames
struct Tap {
  float fr, fc;      // fractions of the source row and column
  int o00;           // element offset of the upper left tap in a frame
  unsigned in;       // bit 0..3: tap 00, 01, 10, 11 lies inside the source
};

__device__ __forceinline__ Tap make_tap(float s_row, float s_col, int hs,
                                        int ws, int ch) {
  const float sr = isfinite(s_row) ? s_row : -2.0f;
  const float sc = isfinite(s_col) ? s_col : -2.0f;
  const float r0 = floorf(sr);
  const float c0 = floorf(sc);
  Tap t;
  t.fr = __fsub_rn(sr, r0);
  t.fc = __fsub_rn(sc, c0);
  const int ra = (int)fminf(fmaxf(r0, -2.0f), (float)hs);
  const int ca = (int)fminf(fmaxf(c0, -2.0f), (float)ws);
  const bool ra_in = ra >= 0 && ra < hs;
  const bool rb_in = ra + 1 >= 0 && ra + 1 < hs;
  const bool ca_in = ca >= 0 && ca < ws;
  const bool cb_in = ca + 1 >= 0 && ca + 1 < ws;
  // an offset is formed from an outside index but read only when inside
  t.o00 = (ra * ws + ca) * ch;
  t.in = (unsigned)(ra_in && ca_in) | (unsigned)(ra_in && cb_in) << 1 |
         (unsigned)(rb_in && ca_in) << 2 | (unsigned)(rb_in && cb_in) << 3;
  return t;
}

__device__ __forceinline__ float blend(float v00, float v01, float v10,
                                       float v11, const Tap& t) {
  const float gr = __fsub_rn(1.0f, t.fr);
  const float gc = __fsub_rn(1.0f, t.fc);
  float acc = __fmul_rn(__fmul_rn(v00, gr), gc);
  acc = __fadd_rn(acc, __fmul_rn(__fmul_rn(v01, gr), t.fc));
  acc = __fadd_rn(acc, __fmul_rn(__fmul_rn(v10, t.fr), gc));
  acc = __fadd_rn(acc, __fmul_rn(__fmul_rn(v11, t.fr), t.fc));
  return acc;
}

__device__ __forceinline__ float finish(float acc, float*) { return acc; }
__device__ __forceinline__ uint8_t finish(float acc, uint8_t*) {
  return (uint8_t)(int)rintf(acc);
}

// the map entries of the thread's PX pixels of row y (x, x + 32, ...);
// `live` bit k: pixel k lies inside the output
__device__ __forceinline__ unsigned load_taps(const float* __restrict__ map,
                                              bool map_vec, int y, int x,
                                              int w, int hs, int ws, int ch,
                                              Tap (&taps)[PX]) {
  unsigned live = 0;
  float2 s[PX];
  const size_t row = (size_t)y * w;
#pragma unroll
  for (int k = 0; k < PX; ++k) {
    const int xk = x + 32 * k;
    s[k] = make_float2(-2.0f, -2.0f);
    if (xk < w) {
      live |= 1u << k;
      if (map_vec) {
        s[k] = __ldcs(reinterpret_cast<const float2*>(map) + row + xk);
      } else {
        s[k].x = __ldcs(map + 2 * (row + xk));
        s[k].y = __ldcs(map + 2 * (row + xk) + 1);
      }
    }
  }
#pragma unroll
  for (int k = 0; k < PX; ++k) taps[k] = make_tap(s[k].x, s[k].y, hs, ws, ch);
  return live;
}

// the CH <= 4 bytes of a uint8 pixel in one register, channel c in byte c
template <int CH>
__device__ __forceinline__ uint32_t load_pixel(const uint8_t* p) {
  uint32_t word = 0;
#pragma unroll
  for (int c = 0; c < CH; ++c) word |= (uint32_t)__ldg(p + c) << 8 * c;
  return word;
}

// CH channels (CH = 0: `ch_any` of them, any number), frames
// [blockIdx.z * frame_chunk, ...) of the batch
template <typename T, int CH, int MIN_BLOCKS>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
remap_kernel(const T* __restrict__ img, const float* __restrict__ map,
             T* __restrict__ out, int frames, int frame_chunk, int hs, int ws,
             int h, int w, int ch_any, bool map_vec) {
  const int ch = CH ? CH : ch_any;
  const int y = blockIdx.y * ROWS + threadIdx.y;
  if (y >= h) return;
  const int x = blockIdx.x * SEG + threadIdx.x;
  Tap taps[PX];
  const unsigned live = load_taps(map, map_vec, y, x, w, hs, ws, ch, taps);
  const int row = ws * ch;
  const int f_begin = blockIdx.z * frame_chunk;
  const int f_end = min(frames, f_begin + frame_chunk);
  for (int f = f_begin; f < f_end; ++f) {
    const T* src = img + (size_t)f * hs * ws * ch;
    T* dst = out + (((size_t)f * h + y) * w + x) * ch;
    if constexpr (sizeof(T) == 1 && CH != 0) {
      // uint8 pixels of up to 4 channels: all channels of a tap in flight
      uint32_t v[PX][4];
#pragma unroll
      for (int k = 0; k < PX; ++k) {
        const uint8_t* p = src + taps[k].o00;
        const unsigned in = taps[k].in;
        v[k][0] = (in & 1) ? load_pixel<CH>(p) : 0u;
        v[k][1] = (in & 2) ? load_pixel<CH>(p + CH) : 0u;
        v[k][2] = (in & 4) ? load_pixel<CH>(p + row) : 0u;
        v[k][3] = (in & 8) ? load_pixel<CH>(p + row + CH) : 0u;
      }
#pragma unroll
      for (int k = 0; k < PX; ++k) {
        if (live >> k & 1) {
#pragma unroll
          for (int c = 0; c < CH; ++c) {
            const float acc = blend((float)(v[k][0] >> 8 * c & 0xffu),
                                    (float)(v[k][1] >> 8 * c & 0xffu),
                                    (float)(v[k][2] >> 8 * c & 0xffu),
                                    (float)(v[k][3] >> 8 * c & 0xffu),
                                    taps[k]);
            __stcs(dst + 32 * k * CH + c, finish(acc, (T*)nullptr));
          }
        }
      }
    } else {
      for (int c = 0; c < ch; ++c) {
        float v[PX][4];
#pragma unroll
        for (int k = 0; k < PX; ++k) {
          const T* p = src + taps[k].o00 + c;
          const unsigned in = taps[k].in;
          v[k][0] = (in & 1) ? (float)__ldg(p) : 0.0f;
          v[k][1] = (in & 2) ? (float)__ldg(p + ch) : 0.0f;
          v[k][2] = (in & 4) ? (float)__ldg(p + row) : 0.0f;
          v[k][3] = (in & 8) ? (float)__ldg(p + row + ch) : 0.0f;
        }
#pragma unroll
        for (int k = 0; k < PX; ++k) {
          if (live >> k & 1) {
            const float acc = blend(v[k][0], v[k][1], v[k][2], v[k][3],
                                    taps[k]);
            __stcs(dst + 32 * k * ch + c, finish(acc, (T*)nullptr));
          }
        }
      }
    }
  }
}

template <typename T>
int launch(const void* img, const float* map, void* out, int b,
           int frame_chunk, int hs, int ws, int h, int w, int ch,
           cudaStream_t st) {
  const dim3 grid((w + SEG - 1) / SEG, (h + ROWS - 1) / ROWS,
                  (b + frame_chunk - 1) / frame_chunk);
  const dim3 block(32, ROWS);
  const bool map_vec = ((uintptr_t)map & 7) == 0;
  const T* src = (const T*)img;
  T* dst = (T*)out;
  // six blocks of 256 threads on an SM: 40 registers a thread
#define REMAP_LAUNCH(CH, MIN_BLOCKS)                                   \
  remap_kernel<T, CH, MIN_BLOCKS><<<grid, block, 0, st>>>(             \
      src, map, dst, b, frame_chunk, hs, ws, h, w, ch, map_vec)
  switch (ch) {
    case 1: REMAP_LAUNCH(1, 6); break;
    case 2: REMAP_LAUNCH(2, 6); break;
    case 3: REMAP_LAUNCH(3, 6); break;
    case 4: REMAP_LAUNCH(4, 6); break;
    default: REMAP_LAUNCH(0, 4);
  }
#undef REMAP_LAUNCH
  return (int)cudaGetLastError();
}

}  // namespace

// img: (b, hs, ws, ch) contiguous, float32 (is_u8 == 0) or uint8; map:
// (h, w, 2) f32 contiguous; out: (b, h, w, ch) of img's type.  A block's
// blockIdx.z takes frames [z * frame_chunk, (z + 1) * frame_chunk).  The
// elements of one source frame (with a margin of two rows and columns) and
// of one output frame (with a margin of one segment) must fit 31 bits,
// and h <= 8 * 65535.  Returns cudaError_t.
extern "C" int remap_launch(const void* img, const void* map, void* out, int b,
                            int frame_chunk, int hs, int ws, int h, int w,
                            int ch, int is_u8, void* stream) {
  if (b < 1 || frame_chunk < 1 || hs < 1 || ws < 1 || h < 1 || w < 1 ||
      ch < 1 || (long long)(hs + 2) * (ws + 2) * ch > 0x7fffffffLL ||
      (long long)h * w * ch > 0x7fffff00LL) {
    return (int)cudaErrorInvalidValue;
  }
  const int chunks = (b + frame_chunk - 1) / frame_chunk;
  if (chunks > 65535) return (int)cudaErrorInvalidValue;
  if ((h + ROWS - 1) / ROWS > 65535) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  const float* m = (const float*)map;
  return is_u8 ? launch<uint8_t>(img, m, out, b, frame_chunk, hs, ws, h, w,
                                 ch, st)
               : launch<float>(img, m, out, b, frame_chunk, hs, ws, h, w, ch,
                               st);
}
