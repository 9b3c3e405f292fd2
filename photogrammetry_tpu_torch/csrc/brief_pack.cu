// BRIEF descriptor bits for Hopper (sm_90a): a batch of frames in one
// launch, masked keypoints folded in, optionally steered.
//
// Replaces the Pallas TPU kernel photogrammetry_tpu/kernels/brief_pack.py
// (brief_bits_packed -> _packed_planes, + _gather_unpack), which evaluated
// every pair densely for all pixels because the TPU's per-element gather is
// slow, and the XLA gathers of JAX's brief_bits / brief_bits_oriented
// (ops/brief.py), vmapped over frames by the batched frontend.  A Hopper SM
// gathers from L2 cheaply, so this kernel samples per keypoint: bit q of
// keypoint k is img[k + a_q] < img[k + b_q], 0 when either end is out of
// bounds (nothing is loaded then) or the keypoint is masked out (nothing at
// all is loaded for it).  Steered, the offsets are first rotated by the
// keypoint's (cos, sin): row' = c r + s col, col' = (-s) r + c col, each
// product and sum rounded on its own (__fmul_rn / __fadd_rn, no FMA), then
// rintf (half to even) -- the plain version's order, so the two agree bit
// for bit, ties included.  c and s come from torch.cos / torch.sin, not from
// cosf / sinf here.
//
// What bounds it on the H100.  The bytes bound (distinct pixels sampled,
// the coords, the (B, N, P) uint8 output) is far below what any gather of
// this pattern reaches: sigma = 50 spreads a keypoint's 2P samples over
// +-150 px, so nearly every sample is its own 32-byte sector, 2 N P sectors
// through L2 -> L1 (33.6 MB at N = 2048, P = 256).  The gather floor is
// measured by brief_probe_launch below (the same loads at the same
// addresses in the same order, one word stored per thread); PERF.md has
// both, and the kernel runs within a few percent of that floor.  TMA and
// wgmma have no role: there is no dense tile and no product.
//
// The design: a block of 8 warps per (frame, run of 8 keypoints in the
// caller's order); the pair table staged once per block in shared memory
// as four int arrays (or their f32 values, steered), so that lane l reads
// its four consecutive pairs as one 16-byte word per array and a warp
// reads 512 contiguous bytes; a warp takes one keypoint, loads its coords
// (and c, s) once, and each lane makes 4 consecutive bits (8 loads in
// flight) and stores them as one 32-bit word, so a warp writes 128
// contiguous bytes.  Runs of 16 and 32 keypoints a block were slower.  No division: the keypoint comes from the warp's
// loop and the pair from the lane.  Index sums saturate (add.sat.s32), so
// any int32 coords and offsets give the plain version's bounds test.
// Visiting the keypoints in a spatial order, texture fetches and longer
// runs a block were timed and lost or tied
// (experiments/kernel_variants/brief_variants.cu).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;            // = keypoints a block
constexpr int LANE_BITS = 4;                   // consecutive bits a lane
constexpr int WARP_BITS = 32 * LANE_BITS;      // pairs a warp step covers
constexpr int SMEM_LIMIT = 232448;             // a block's most (227 KB)

__device__ __forceinline__ int add_sat(int a, int b) {
  int r;
  asm("add.sat.s32 %0, %1, %2;" : "=r"(r) : "r"(a), "r"(b));
  return r;
}

__device__ __forceinline__ int rot_row(float c, float s, float r, float col) {
  return (int)rintf(__fadd_rn(__fmul_rn(c, r), __fmul_rn(s, col)));
}

__device__ __forceinline__ int rot_col(float c, float s, float r, float col) {
  return (int)rintf(__fadd_rn(__fmul_rn(-s, r), __fmul_rn(c, col)));
}

// PROBE: the kernel's loads alone; each thread stores the xor of what it
// loaded as one word into probe[] (the gather floor, brief_probe_launch).
template <bool ORIENTED, bool PROBE>
__global__ void __launch_bounds__(THREADS)
brief_kernel(const float* __restrict__ img, int h, int w,
             const int32_t* __restrict__ coords,
             const uint8_t* __restrict__ mask,
             const float* __restrict__ cos_sin,
             const int32_t* __restrict__ pairs, int n, int p,
             uint8_t* __restrict__ out, uint32_t* __restrict__ probe) {
  extern __shared__ int4 smem[];
  const int p4 = (p + 3) & ~3;
  int* sa_r = reinterpret_cast<int*>(smem);  // four arrays of p4 entries
  int* sa_c = sa_r + p4;
  int* sb_r = sa_c + p4;
  int* sb_c = sb_r + p4;
  const int tid = threadIdx.x;
  for (int q = tid; q < p4; q += THREADS) {
    int v[4] = {0, 0, 0, 0};
    if (q < p) {
#pragma unroll
      for (int e = 0; e < 4; ++e) v[e] = pairs[4 * q + e];
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      if (ORIENTED) v[e] = __float_as_int((float)v[e]);
    }
    sa_r[q] = v[0];
    sa_c[q] = v[1];
    sb_r[q] = v[2];
    sb_c[q] = v[3];
  }
  __syncthreads();

  const int b = blockIdx.y;
  const float* fimg = img + (size_t)b * h * w;
  const int32_t* fcoords = coords + (size_t)b * n * 2;
  const int k = blockIdx.x * WARPS + (tid >> 5);
  const int lane = tid & 31;
  const bool vec = (p & 3) == 0;
  uint32_t acc = 0;
  if (k < n) {
    const size_t row = (size_t)b * n + k;
    uint8_t* o = out + row * p;
    const bool live = mask == nullptr || mask[row];
    int r = 0, c = 0;
    float cs = 0.f, sn = 0.f;
    if (live) {
      r = fcoords[2 * k];
      c = fcoords[2 * k + 1];
      if (ORIENTED) {
        cs = cos_sin[2 * row];
        sn = cos_sin[2 * row + 1];
      }
    }
    for (int q0 = lane * LANE_BITS; q0 < p; q0 += WARP_BITS) {
      uint32_t word = 0;
      if (live) {
        const int4 ar = *reinterpret_cast<const int4*>(sa_r + q0);
        const int4 ac = *reinterpret_cast<const int4*>(sa_c + q0);
        const int4 br = *reinterpret_cast<const int4*>(sb_r + q0);
        const int4 bc = *reinterpret_cast<const int4*>(sb_c + q0);
        const int oar[4] = {ar.x, ar.y, ar.z, ar.w};
        const int oac[4] = {ac.x, ac.y, ac.z, ac.w};
        const int obr[4] = {br.x, br.y, br.z, br.w};
        const int obc[4] = {bc.x, bc.y, bc.z, bc.w};
#pragma unroll
        for (int j = 0; j < LANE_BITS; ++j) {
          int dar = oar[j], dac = oac[j], dbr = obr[j], dbc = obc[j];
          if (ORIENTED) {
            const float far = __int_as_float(dar), fac = __int_as_float(dac);
            const float fbr = __int_as_float(dbr), fbc = __int_as_float(dbc);
            dar = rot_row(cs, sn, far, fac);
            dac = rot_col(cs, sn, far, fac);
            dbr = rot_row(cs, sn, fbr, fbc);
            dbc = rot_col(cs, sn, fbr, fbc);
          }
          const int ra = add_sat(r, dar), ca = add_sat(c, dac);
          const int rb = add_sat(r, dbr), cb = add_sat(c, dbc);
          const bool in = q0 + j < p && (unsigned)ra < (unsigned)h &&
                          (unsigned)ca < (unsigned)w &&
                          (unsigned)rb < (unsigned)h &&
                          (unsigned)cb < (unsigned)w;
          float va = 0.f, vb = 0.f;
          if (in) {
            va = __ldg(fimg + ra * w + ca);
            vb = __ldg(fimg + rb * w + cb);
          }
          if (PROBE) {
            acc ^= __float_as_uint(va) ^ (__float_as_uint(vb) << 1);
          } else {
            word |= (uint32_t)(in && va < vb) << (8 * j);
          }
        }
      }
      if (PROBE) continue;
      if (vec) {
        *reinterpret_cast<uint32_t*>(o + q0) = word;
      } else {
#pragma unroll
        for (int j = 0; j < LANE_BITS; ++j)
          if (q0 + j < p) o[q0 + j] = (uint8_t)(word >> (8 * j));
      }
    }
  }
  if (PROBE)
    probe[((size_t)blockIdx.y * gridDim.x + blockIdx.x) * THREADS + tid] =
        acc;
}

// dynamic shared memory of a block: the pair table, P rounded up to 4
size_t smem_bytes(int p) { return (size_t)16 * ((p + 3) & ~3); }

template <bool ORIENTED, bool PROBE>
int launch_one(const float* img, int b, int h, int w, const int32_t* coords,
               const uint8_t* mask, const float* cos_sin, int n,
               const int32_t* pairs, int p, uint8_t* out, uint32_t* probe,
               cudaStream_t stream) {
  auto kernel = brief_kernel<ORIENTED, PROBE>;
  const size_t smem = smem_bytes(p);
  static bool attribute_set = false;  // per instantiation; setting twice is
                                      // harmless
  if (smem > 48 * 1024 && !attribute_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_LIMIT);
    if (err != cudaSuccess) return (int)err;
    attribute_set = true;
  }
  const dim3 grid((n + WARPS - 1) / WARPS, b);
  kernel<<<grid, THREADS, smem, stream>>>(img, h, w, coords, mask, cos_sin,
                                          pairs, n, p, out, probe);
  return (int)cudaGetLastError();
}

template <bool PROBE>
int dispatch(const float* img, int b, int h, int w, const int32_t* coords,
             const uint8_t* mask, const float* cos_sin, int n,
             const int32_t* pairs, int p, uint8_t* out, uint32_t* probe,
             cudaStream_t stream) {
  if (b <= 0 || n <= 0 || p <= 0) return (int)cudaSuccess;
  if (b > 65535 || (size_t)h * w > 0x7fffffffu ||
      smem_bytes(p) > (size_t)SMEM_LIMIT)
    return (int)cudaErrorInvalidValue;
  if (cos_sin != nullptr)
    return launch_one<true, PROBE>(img, b, h, w, coords, mask, cos_sin, n,
                                   pairs, p, out, probe, stream);
  return launch_one<false, PROBE>(img, b, h, w, coords, mask, nullptr, n,
                                  pairs, p, out, probe, stream);
}

}  // namespace

// img: (b, h, w) f32; coords: (b, n, 2) int32 (row, col); mask: (b, n)
// uint8 or null; cos_sin: (b, n, 2) f32 or null (unsteered); pairs: (p, 2,
// 2) int32; out: (b, n, p) uint8.  Returns cudaError_t
// (cudaErrorInvalidValue for arguments the kernel does not take).
extern "C" int brief_bits_launch(const float* img, int b, int h, int w,
                                 const int32_t* coords, const uint8_t* mask,
                                 const float* cos_sin, int n,
                                 const int32_t* pairs, int p, uint8_t* out,
                                 void* stream) {
  return dispatch<false>(img, b, h, w, coords, mask, cos_sin, n, pairs, p,
                         out, nullptr, (cudaStream_t)stream);
}

// The gather floor of the same call: the kernel's loads at the same
// addresses in the same order and nothing else; each thread stores one
// uint32 into probe, ceil(n / 8) * b * 256 of them.
extern "C" int brief_probe_launch(const float* img, int b, int h, int w,
                                  const int32_t* coords, const uint8_t* mask,
                                  const float* cos_sin, int n,
                                  const int32_t* pairs, int p,
                                  uint32_t* probe, void* stream) {
  return dispatch<true>(img, b, h, w, coords, mask, cos_sin, n, pairs, p,
                        nullptr, probe, (cudaStream_t)stream);
}
