// Variants of photogrammetry_tpu_torch/csrc/brief_pack.cu timed by run.py.
// The first part is the package's kernel as it stood while they were timed,
// with two parameters the package dropped afterwards: a sampler (__ldg, or
// a texture fetch below) and SPATIAL, an in-kernel visit order in which a
// prologue in every block histograms the frame's keypoints over 64-px
// cells in Morton order and the block takes the cells whose first sorted
// position falls in its run (no second launch, the output still in the
// caller's order).  Every block reads all N keypoints for that, so the
// prologue costs more than any L1 reuse gains (PERF.md).  Beside it: a
// warp = 32 keypoints x 4 pairs (a lane per keypoint), and the gather probe
// of each order.  The visit order of a caller that sorts its keypoints
// beforehand is timed by run.py with variant 0 on permuted inputs.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int LANE_BITS = 4;                   // consecutive bits a lane
constexpr int WARP_BITS = 32 * LANE_BITS;      // pairs a warp step covers
constexpr int CELLS = 1024;                    // 32 x 32 Morton cells
constexpr int SMEM_LIMIT = 232448;             // a block's most (227 KB)

__device__ __forceinline__ int add_sat(int a, int b) {
  int r;
  asm("add.sat.s32 %0, %1, %2;" : "=r"(r) : "r"(a), "r"(b));
  return r;
}

// the sample at a pixel of the frame: __ldg through L1, or (for the
// texture-fetch variant of experiments/kernel_variants) another sampler
struct LdgSampler {
  const float* img;
  size_t frame_elems;
  __device__ __forceinline__ float operator()(int b, int i) const {
    return __ldg(img + (size_t)b * frame_elems + i);
  }
};

__device__ __forceinline__ int rot_row(float c, float s, float r, float col) {
  return (int)rintf(__fadd_rn(__fmul_rn(c, r), __fmul_rn(s, col)));
}

__device__ __forceinline__ int rot_col(float c, float s, float r, float col) {
  return (int)rintf(__fadd_rn(__fmul_rn(-s, r), __fmul_rn(c, col)));
}

__device__ __forceinline__ int morton(int r, int c) {
  int key = 0;
#pragma unroll
  for (int i = 0; i < 5; ++i) {
    key |= ((c >> i) & 1) << (2 * i);
    key |= ((r >> i) & 1) << (2 * i + 1);
  }
  return key;
}

__device__ __forceinline__ int cell_of(const int32_t* xy, int h, int w,
                                       int shift) {
  const int r = min(max(xy[0], 0), h - 1) >> shift;
  const int c = min(max(xy[1], 0), w - 1) >> shift;
  return morton(r, c);
}

// The keypoints (indices into the frame's n) that this block visits, in
// list[0, count): its run of the caller's order, or the cells it owns in
// spatial order.  Returns count.
template <bool SPATIAL>
__device__ int block_keypoints(const int32_t* coords, int n, int h, int w,
                               int kpb, int shift, int* list, int* hist) {
  const int tid = threadIdx.x;
  if (!SPATIAL) {
    const int k0 = blockIdx.x * kpb;
    return max(0, min(n, k0 + kpb) - k0);
  }
  __shared__ int count;
  for (int i = tid; i < CELLS; i += THREADS) hist[i] = 0;
  if (tid == 0) count = 0;
  __syncthreads();
  for (int k = tid; k < n; k += THREADS)
    atomicAdd(&hist[cell_of(coords + 2 * k, h, w, shift)], 1);
  __syncthreads();
  if (tid < 32) {  // exclusive scan: lane l holds cells [32 l, 32 l + 32)
    int v[32];
    int s = 0;
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      v[j] = hist[32 * tid + j];
      s += v[j];
    }
    int incl = s;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int t = __shfl_up_sync(0xffffffffu, incl, d);
      if (tid >= d) incl += t;
    }
    int run = incl - s;
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      hist[32 * tid + j] = run;
      run += v[j];
    }
  }
  __syncthreads();
  // a cell belongs to the block whose run holds the cell's first position
  for (int k = tid; k < n; k += THREADS) {
    if (hist[cell_of(coords + 2 * k, h, w, shift)] / kpb == (int)blockIdx.x)
      list[atomicAdd(&count, 1)] = k;
  }
  __syncthreads();
  return count;
}

// PROBE: the kernel's loads alone; each thread stores the xor of what it
// loaded as one word into probe[] (the gather floor, brief_probe_launch).
template <bool ORIENTED, bool SPATIAL, bool PROBE, typename Sampler>
__global__ void __launch_bounds__(THREADS)
brief_kernel(Sampler sample, int h, int w,
             const int32_t* __restrict__ coords,
             const uint8_t* __restrict__ mask,
             const float* __restrict__ cos_sin,
             const int32_t* __restrict__ pairs, int n, int p, int kpb,
             int shift, uint8_t* __restrict__ out,
             uint32_t* __restrict__ probe) {
  extern __shared__ int4 smem[];
  __shared__ int hist[SPATIAL ? CELLS : 1];
  const int p4 = (p + 3) & ~3;
  int* sa_r = reinterpret_cast<int*>(smem);  // four arrays of p4 entries
  int* sa_c = sa_r + p4;
  int* sb_r = sa_c + p4;
  int* sb_c = sb_r + p4;
  int* list = sb_c + p4;                     // SPATIAL: up to n entries
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
  const int b = blockIdx.y;
  const int32_t* fcoords = coords + (size_t)b * n * 2;
  const int count = block_keypoints<SPATIAL>(fcoords, n, h, w, kpb, shift,
                                             list, hist);
  __syncthreads();

  const int warp = tid >> 5;
  const int lane = tid & 31;
  const bool vec = (p & 3) == 0;
  uint32_t acc = 0;
  for (int i = warp; i < count; i += WARPS) {
    const int k = SPATIAL ? list[i] : blockIdx.x * kpb + i;
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
            va = sample(b, ra * w + ca);
            vb = sample(b, rb * w + cb);
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

// dynamic shared memory of a block: the pair table, and the spatial list
size_t smem_bytes(int p, int n, bool spatial) {
  return (size_t)4 * ((p + 3) & ~3) * 4 + (spatial ? (size_t)n * 4 : 0);
}

// the smallest cell shift >= 6 that puts the frame in 32 x 32 cells
int cell_shift(int h, int w) {
  int s = 6;
  while (((h - 1) >> s) >= 32 || ((w - 1) >> s) >= 32) ++s;
  return s;
}

template <bool ORIENTED, bool SPATIAL, bool PROBE, typename Sampler>
int launch_one(Sampler sample, int b, int h, int w, const int32_t* coords,
               const uint8_t* mask, const float* cos_sin, int n,
               const int32_t* pairs, int p, int kpb, uint8_t* out,
               uint32_t* probe, cudaStream_t stream) {
  auto kernel = brief_kernel<ORIENTED, SPATIAL, PROBE, Sampler>;
  const size_t smem = smem_bytes(p, n, SPATIAL);
  static bool attribute_set = false;  // per instantiation; setting twice is
                                      // harmless
  if (smem > 48 * 1024 && !attribute_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        SMEM_LIMIT - (SPATIAL ? CELLS * 4 + 16 : 16));
    if (err != cudaSuccess) return (int)err;
    attribute_set = true;
  }
  const dim3 grid((n + kpb - 1) / kpb, b);
  kernel<<<grid, THREADS, smem, stream>>>(sample, h, w, coords, mask,
                                          cos_sin, pairs, n, p, kpb,
                                          cell_shift(h, w), out, probe);
  return (int)cudaGetLastError();
}

template <bool PROBE, typename Sampler>
int dispatch(Sampler sample, int b, int h, int w, const int32_t* coords,
             const uint8_t* mask, const float* cos_sin, int n,
             const int32_t* pairs, int p, int kpb, int spatial, uint8_t* out,
             uint32_t* probe, cudaStream_t stream) {
  if (b <= 0 || n <= 0 || p <= 0) return (int)cudaSuccess;
  if (kpb <= 0 || b > 65535 || (size_t)h * w > 0x7fffffffu ||
      smem_bytes(p, n, spatial) + (spatial ? CELLS * 4 + 16 : 16) >
          (size_t)SMEM_LIMIT)
    return (int)cudaErrorInvalidValue;
#define ONE(O, S)                                                          \
  return launch_one<O, S, PROBE>(sample, b, h, w, coords, mask, cos_sin, n, \
                                 pairs, p, kpb, out, probe, stream)
  if (cos_sin != nullptr) {
    if (spatial) ONE(true, true);
    ONE(true, false);
  }
  if (spatial) ONE(false, true);
  ONE(false, false);
#undef ONE
}

}  // namespace

namespace {

// point filtering on a linear f32 texture: exact texels; the bounds test
// stays in the kernel
struct TexSampler {
  cudaTextureObject_t tex;
  int frame_elems;
  __device__ __forceinline__ float operator()(int b, int i) const {
    return tex1Dfetch<float>(tex, b * frame_elems + i);
  }
};

// a block: 32 keypoints (one a lane) x 32 pairs (4 consecutive pairs a
// warp); grid (ceil(n / 32), b, ceil(p / 32)); unsteered
__global__ void __launch_bounds__(256)
brief_lane_per_keypoint(const float* __restrict__ img, int h, int w,
                        const int32_t* __restrict__ coords,
                        const uint8_t* __restrict__ mask,
                        const int32_t* __restrict__ pairs, int n, int p,
                        uint8_t* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int k = blockIdx.x * 32 + lane;
  const int b = blockIdx.y;
  const int q0 = blockIdx.z * 32 + warp * 4;
  if (k >= n || q0 >= p) return;
  const size_t row = (size_t)b * n + k;
  const bool live = mask == nullptr || mask[row];
  const float* im = img + (size_t)b * h * w;
  uint32_t word = 0;
  if (live) {
    const int r = coords[2 * row];
    const int c = coords[2 * row + 1];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int q = q0 + j;
      if (q >= p) break;
      const int ra = add_sat(r, __ldg(pairs + 4 * q));
      const int ca = add_sat(c, __ldg(pairs + 4 * q + 1));
      const int rb = add_sat(r, __ldg(pairs + 4 * q + 2));
      const int cb = add_sat(c, __ldg(pairs + 4 * q + 3));
      const bool in = (unsigned)ra < (unsigned)h &&
                      (unsigned)ca < (unsigned)w &&
                      (unsigned)rb < (unsigned)h && (unsigned)cb < (unsigned)w;
      float va = 0.f, vb = 0.f;
      if (in) {
        va = __ldg(im + ra * w + ca);
        vb = __ldg(im + rb * w + cb);
      }
      word |= (uint32_t)(in && va < vb) << (8 * j);
    }
  }
  uint8_t* o = out + row * p + q0;
  if ((p & 3) == 0) {
    *reinterpret_cast<uint32_t*>(o) = word;
  } else {
    for (int j = 0; j < 4 && q0 + j < p; ++j) o[j] = (uint8_t)(word >> (8 * j));
  }
}

}  // namespace

extern "C" unsigned long long exp_tex_create(const float* img, size_t count) {
  cudaResourceDesc res = {};
  res.resType = cudaResourceTypeLinear;
  res.res.linear.devPtr = const_cast<float*>(img);
  res.res.linear.desc = cudaCreateChannelDesc<float>();
  res.res.linear.sizeInBytes = count * sizeof(float);
  cudaTextureDesc td = {};
  td.filterMode = cudaFilterModePoint;
  td.readMode = cudaReadModeElementType;
  td.normalizedCoords = 0;
  cudaTextureObject_t tex = 0;
  if (cudaCreateTextureObject(&tex, &res, &td, nullptr) != cudaSuccess)
    return 0;
  return (unsigned long long)tex;
}

extern "C" int exp_tex_destroy(unsigned long long tex) {
  return (int)cudaDestroyTextureObject((cudaTextureObject_t)tex);
}

// variant: 0 = the package's kernel (kpb, spatial as given); 1 = the same
// through the texture `tex`; 2 = a lane per keypoint; 3 = the package's
// gather probe into `probe`
extern "C" int exp_launch(int variant, const float* img,
                          unsigned long long tex, int b, int h, int w,
                          const int32_t* coords, const uint8_t* mask, int n,
                          const int32_t* pairs, int p, int kpb, int spatial,
                          uint8_t* out, uint32_t* probe, void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  switch (variant) {
    case 0:
      return dispatch<false>(LdgSampler{img, (size_t)h * w}, b, h, w, coords,
                             mask, nullptr, n, pairs, p, kpb, spatial, out,
                             nullptr, s);
    case 1:
      return dispatch<false>(TexSampler{(cudaTextureObject_t)tex, h * w}, b,
                             h, w, coords, mask, nullptr, n, pairs, p, kpb,
                             spatial, out, nullptr, s);
    case 2: {
      const dim3 grid((n + 31) / 32, b, (p + 31) / 32);
      brief_lane_per_keypoint<<<grid, 256, 0, s>>>(img, h, w, coords, mask,
                                                   pairs, n, p, out);
      return (int)cudaGetLastError();
    }
    case 3:
      return dispatch<true>(LdgSampler{img, (size_t)h * w}, b, h, w, coords,
                            mask, nullptr, n, pairs, p, kpb, spatial, nullptr,
                            probe, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
