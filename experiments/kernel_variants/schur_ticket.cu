// The Schur products kernel of photogrammetry_tpu_torch/csrc/schur.cu with
// the reduction it did not keep: one launch, in which the last block of a
// camera tile to arrive (an integer ticket, __threadfence) sums the tile's
// partial sums in slab order.  tickets == nullptr gives the kept two-kernel
// form, so that run.py times both from one binary.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int CT = 4;                  // cameras per block side
constexpr int KL = 8;                  // landmark lanes per camera pair
constexpr int THREADS = CT * CT * KL;  // 128
constexpr int WARPS = THREADS / 32;
constexpr int TL = 32;                 // landmarks per shared-memory tile
constexpr int ROW = TL * 18;           // floats of one camera in one tile
constexpr int PITCH = ROW + 16;        // 16 mod 32 words between cameras
constexpr int STAGES = 2;
static_assert(KL == 8, "the butterfly below sums 8 lanes");
static_assert(PITCH % 4 == 0, "rows must stay 16-byte aligned");

// W bytes from global to shared memory, asynchronously; the bytes past
// `bytes` (< W on a ragged tail) are written as zero
template <int W>
__device__ __forceinline__ void cp_async(float* dst, const float* src,
                                         int bytes) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  const size_t s = __cvta_generic_to_global(src);
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n"
               :: "r"(d), "l"(s), "n"(W), "r"(bytes) : "memory");
}

template <int W>
__device__ __forceinline__ void stage_chunks(float* dst, const float* src,
                                             int nbytes, int lane) {
  for (int b = lane * W; b < nbytes; b += 32 * W) {
    cp_async<W>(dst + b / 4, src + b / 4, min(W, nbytes - b));
  }
}

// one warp stages one camera's `nfloats` contiguous floats, by the widest
// copy the source address allows
__device__ __forceinline__ void stage_row(float* dst, const float* src,
                                          int nfloats, int lane) {
  const unsigned a = (unsigned)(uintptr_t)src;
  if ((a & 15) == 0) {
    stage_chunks<16>(dst, src, nfloats * 4, lane);
  } else if ((a & 7) == 0) {
    stage_chunks<8>(dst, src, nfloats * 4, lane);
  } else {
    stage_chunks<4>(dst, src, nfloats * 4, lane);
  }
}

__global__ void __launch_bounds__(THREADS)
schur_partial_kernel(const float* __restrict__ w_hinv,
                     const float* __restrict__ w_cp,
                     const float* __restrict__ b_p, int f_count, int t_count,
                     int slab_len, float* __restrict__ part,
                     unsigned* __restrict__ tickets,
                     float* __restrict__ s_off, float* __restrict__ corr) {
  __shared__ __align__(16) float sa[STAGES][CT][PITCH];
  __shared__ __align__(16) float sb[STAGES][CT][PITCH];
  __shared__ __align__(16) float sp[STAGES][TL * 3];

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int kl = tid % KL;            // landmark lane
  const int fl = (tid / KL) / CT;     // camera pair within the tile: a warp
  const int gl = (tid / KL) % CT;     // holds one fl and all CT gl
  const int fa = blockIdx.y * CT;     // first row camera
  const int gb = blockIdx.x * CT;     // first column camera
  const int f = fa + fl;
  const int g = gb + gl;
  const bool live = f < f_count && g < f_count;
  const bool with_corr = blockIdx.x == 0;
  const bool do_corr = with_corr && gl == 0 && live;
  const int t_begin = blockIdx.z * slab_len;
  const int t_end = min(t_count, t_begin + slab_len);
  const int n_tiles = t_end > t_begin ? (t_end - t_begin + TL - 1) / TL : 0;

  // warp w stages rows w, w + WARPS, ... of the tile's 2 * CT camera rows
  auto stage_tile = [&](int tile) {
    const int t0 = t_begin + tile * TL;
    const int n = min(TL, t_end - t0);
    const int buf = tile % STAGES;
    for (int row = warp; row < 2 * CT; row += WARPS) {
      const bool is_b = row >= CT;
      const int cl = row % CT;
      const int cam = (is_b ? gb : fa) + cl;
      if (cam < f_count) {
        stage_row(is_b ? sb[buf][cl] : sa[buf][cl],
                  (is_b ? w_cp : w_hinv) + ((size_t)cam * t_count + t0) * 18,
                  n * 18, lane);
      }
    }
    if (with_corr) {
      for (int e = tid; e < n * 3; e += THREADS) {
        cp_async<4>(&sp[buf][e], b_p + (size_t)t0 * 3 + e, 4);
      }
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  };

  float acc[6][6];
  float acc_corr[6];
#pragma unroll
  for (int i = 0; i < 6; ++i) {
    acc_corr[i] = 0.f;
#pragma unroll
    for (int j = 0; j < 6; ++j) acc[i][j] = 0.f;
  }

  if (n_tiles > 0) stage_tile(0);
  for (int tile = 0; tile < n_tiles; ++tile) {
    if (tile + 1 < n_tiles) {
      stage_tile(tile + 1);
      asm volatile("cp.async.wait_group 1;\n" ::: "memory");
    } else {
      asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    }
    __syncthreads();
    if (live) {
      const int buf = tile % STAGES;
      const int n = min(TL, t_end - (t_begin + tile * TL));
      const float* a_row = sa[buf][fl];
      const float* b_row = sb[buf][gl];
#pragma unroll 2
      for (int t = kl; t < n; t += KL) {
        float a[18], b[18];
        const float2* a2 = reinterpret_cast<const float2*>(a_row + t * 18);
        const float2* b2 = reinterpret_cast<const float2*>(b_row + t * 18);
#pragma unroll
        for (int q = 0; q < 9; ++q) {
          const float2 va = a2[q];
          const float2 vb = b2[q];
          a[2 * q] = va.x;
          a[2 * q + 1] = va.y;
          b[2 * q] = vb.x;
          b[2 * q + 1] = vb.y;
        }
#pragma unroll
        for (int i = 0; i < 6; ++i) {
#pragma unroll
          for (int j = 0; j < 6; ++j) {
            float s = acc[i][j];
            s = fmaf(a[3 * i], b[3 * j], s);
            s = fmaf(a[3 * i + 1], b[3 * j + 1], s);
            s = fmaf(a[3 * i + 2], b[3 * j + 2], s);
            acc[i][j] = s;
          }
        }
        if (do_corr) {
          const float p0 = sp[buf][t * 3];
          const float p1 = sp[buf][t * 3 + 1];
          const float p2 = sp[buf][t * 3 + 2];
#pragma unroll
          for (int i = 0; i < 6; ++i) {
            float s = acc_corr[i];
            s = fmaf(a[3 * i], p0, s);
            s = fmaf(a[3 * i + 1], p1, s);
            s = fmaf(a[3 * i + 2], p2, s);
            acc_corr[i] = s;
          }
        }
      }
    }
    __syncthreads();
  }

  // the KL lanes of a pair are neighbouring lanes of one warp
#pragma unroll
  for (int off = 1; off < KL; off <<= 1) {
#pragma unroll
    for (int i = 0; i < 6; ++i) {
      acc_corr[i] += __shfl_xor_sync(0xffffffffu, acc_corr[i], off);
#pragma unroll
      for (int j = 0; j < 6; ++j) {
        acc[i][j] += __shfl_xor_sync(0xffffffffu, acc[i][j], off);
      }
    }
  }

  if (kl == 0 && live) {
    const int r_count = 6 * f_count;
    float* row = part + ((size_t)blockIdx.z * r_count + f * 6) * (r_count + 1);
#pragma unroll
    for (int i = 0; i < 6; ++i) {
#pragma unroll
      for (int j = 0; j < 6; ++j) {
        row[(size_t)i * (r_count + 1) + g * 6 + j] = acc[i][j];
      }
      if (do_corr) row[(size_t)i * (r_count + 1) + r_count] = acc_corr[i];
    }
  }
  if (tickets == nullptr) return;

  __shared__ bool last;
  const int tile_id = blockIdx.y * gridDim.x + blockIdx.x;
  __threadfence();
  __syncthreads();
  if (tid == 0) {
    last = atomicAdd(&tickets[tile_id], 1u) == gridDim.z - 1;
  }
  __syncthreads();
  if (!last) return;
  __threadfence();
  const int r_count = 6 * f_count;
  const size_t total = (size_t)r_count * (r_count + 1);
  for (int e = tid; e < 6 * CT * (6 * CT + 1); e += THREADS) {
    const int lr = e / (6 * CT + 1), lc = e % (6 * CT + 1);
    const int r = fa * 6 + lr;
    const int c = lc == 6 * CT ? r_count : gb * 6 + lc;
    if (r >= r_count || (lc == 6 * CT ? !with_corr : c >= r_count)) continue;
    const float* src = part + (size_t)r * (r_count + 1) + c;
    float sum = __ldcg(src);
    for (int s = 1; s < (int)gridDim.z; ++s) sum += __ldcg(src + s * total);
    if (c == r_count) {
      corr[r] = sum;
    } else {
      s_off[(((size_t)(r / 6) * f_count + c / 6) * 6 + r % 6) * 6 + c % 6] =
          sum;
    }
  }
  if (tid == 0) tickets[tile_id] = 0;   // ready for the next call
}

// part (S, 6F, 6F + 1) summed over S in slab order into s_off (F, F, 6, 6)
// and corr (F, 6)
__global__ void schur_reduce_kernel(const float* __restrict__ part,
                                    int f_count, int slabs,
                                    float* __restrict__ s_off,
                                    float* __restrict__ corr) {
  const int r_count = 6 * f_count;
  const int total = r_count * (r_count + 1);
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= total) return;
  float sum = part[idx];
  for (int s = 1; s < slabs; ++s) sum += part[(size_t)s * total + idx];
  const int r = idx / (r_count + 1);
  const int c = idx % (r_count + 1);
  if (c == r_count) {
    corr[r] = sum;
  } else {
    const int f = r / 6, i = r % 6, g = c / 6, j = c % 6;
    s_off[(((size_t)f * f_count + g) * 6 + i) * 6 + j] = sum;
  }
}

}  // namespace

// w_hinv, w_cp: (F, T, 6, 3) f32; b_p: (T, 3) f32; part: (slabs, 6F, 6F + 1)
// f32 scratch; s_off: (F, F, 6, 6) f32; corr: (F, 6) f32, all contiguous
// and at least 4-byte aligned.  slabs * slab_len >= T, slab_len a multiple
// of 32.  Returns cudaError_t.
extern "C" int schur_ticket_launch(const float* w_hinv, const float* w_cp,
                            const float* b_p, int f_count, int t_count,
                            int slabs, int slab_len, float* part,
                            unsigned* tickets, float* s_off, float* corr,
                            void* stream) {
  const int tiles = (f_count + CT - 1) / CT;
  if (f_count < 0 || t_count < 0 || slabs < 1 || slabs > 65535 ||
      slab_len < 1 || slab_len % TL != 0 || tiles > 65535 ||
      (long long)slabs * slab_len < t_count ||
      (long long)6 * f_count * (6 * f_count + 1) > 0x7fffffffLL) {
    return (int)cudaErrorInvalidValue;
  }
  if (tiles == 0) return (int)cudaSuccess;
  const cudaStream_t st = (cudaStream_t)stream;
  schur_partial_kernel<<<dim3(tiles, tiles, slabs), THREADS, 0, st>>>(
      w_hinv, w_cp, b_p, f_count, t_count, slab_len, part, tickets, s_off,
      corr);
  if (tickets != nullptr) return (int)cudaGetLastError();
  const int total = 6 * f_count * (6 * f_count + 1);
  schur_reduce_kernel<<<(total + 255) / 256, 256, 0, st>>>(
      part, f_count, slabs, s_off, corr);
  return (int)cudaGetLastError();
}
