// Hamming distance matrix for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel photogrammetry_tpu/kernels/hamming.py
// (hamming_distance_matrix_pallas, _kernel), which computed
//
//   d[i, j] = |a_i| + |b_j| - 2 a_i . b_j
//
// over {0, 1} bits as one matrix product on the MXU.  Here the same identity
// runs on the int8 tensor cores (mma.sync m16n8k32, u8 x u8 -> s32), straight
// from the (N, P) uint8 bits the BRIEF kernel writes: no packing pass.  Both
// operands already have the layout the instruction wants: A = bits1 row-major
// with K (the P bits) contiguous, and B "col", i.e. bits2's N2 rows with K
// contiguous, so nothing is transposed.
//
// What bounds it on the H100: bytes, the (N1, N2) int32 output (16.8 MB at
// 2048 x 2048, 5.0 us at 3.35 TB/s); the tensor-core work, 2 N1 N2 P = 2.1 G
// operations at P = 256, is about 1 us at the int8 rate.  At the SfM path's
// 512 x 512 the bound (0.39 us) is below what one launch costs.
//
// The design: a block owns a BM x BN output tile (the wrapper's tile_plan
// picks it, so that the grid covers the 132 SMs at the SfM shape as well).
// It stages its BM rows of bits1 and BN rows of bits2 in shared memory, a
// chunk of at most CHUNK_BITS (512) columns at a time (one chunk for the
// frontend's P <= 512; any P takes ceil(P / 512) passes), with 16-byte
// cp.async (byte loads where an operand's base or P is not 16-byte
// aligned; rows past N1 / N2 and the columns of the last chunk past P,
// rounded up to 32, are zero, which adds nothing to a product or a sum),
// rows PAD bytes apart so that the fragment reads of eight rows fall into
// eight different groups of four banks.  Each row's sum |a_i| (|b_j|)
// accumulates over the chunks from the staged rows by __dp4a, with the
// row's mask folded in as -1 at the end.  Each warp accumulates a WM x WN
// sub-tile over the k-steps of 32 columns in s32 registers (exact for {0,
// 1} bits: at most P; P = 0 gives 0, or INT_INF where masked).  The
// epilogue forms na + nb - 2 acc, or INT_INF where either mask is False,
// writes the tile from the fragments into shared memory (over the staged
// rows, which the products no longer need) and stores it row by row as
// 16-byte words where N2 % 4 == 0 (scalar otherwise): a warp writes 512
// contiguous bytes at a time, where the fragments' own 8-byte stores reach
// eight rows at once (those took 14.0 us at 2048 x 2048 against 13.0; a
// TMA bulk copy a row for the staging took 15.8;
// experiments/kernel_variants/run.py).  Plain
// stores: mutual_nearest_matches reads the matrix twice right after, and
// 16.8 MB stay in the 50 MB L2.
//
// Exactness: integer arithmetic throughout, equal to the plain version's f32
// product wherever that is exact (sums of products below 2^24), which holds
// for {0, 1} bits at every P below 2^24.
//
// The batched entry (hamming_pairs_launch) runs the same kernel over a
// batch of frame pairs in one launch, for loop closure's place recognition
// (photogrammetry_tpu/sfm/loop_closure.py pairwise_match_counts, a lax.map
// over the F x F pair grid): blockIdx.z is the pair q, the A operand is
// frame ii[q] of the stacked (F, K, P) bits, the B operand frame jj[q], the
// masks rows of the stacked (F, K) masks, and the output the q-th (K, K)
// matrix of a (Q, K, K) int32 tensor.  A pair whose index lies outside
// [0, F) reads nothing and is written as INT_INF throughout.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int CHUNK_BITS = 512;  // columns staged a pass
constexpr int PAD = 16;  // bytes after each staged row
constexpr int OPAD = 8;  // ints after each row of the staged output tile
constexpr int32_t INT_INF = 2147483647;

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(__cvta_generic_to_global(src)));
}

// columns [k0, k0 + kw) of rows [r0, r0 + rows) of src (n rows of p bytes)
// into dst, rows stride bytes apart; kw is a multiple of 32, and what lies
// past row n or column p is zero (ONE: k0 = 0 and kw = p, no column tail)
template <bool ONE>
__device__ __forceinline__ void stage(uint8_t* dst, const uint8_t* src,
                                      int r0, int rows, int n, int p, int k0,
                                      int kw, int stride, bool aligned,
                                      int tid, int threads) {
  const int chunks = kw / 16;
  for (int e = tid; e < rows * chunks; e += threads) {
    const int r = e / chunks;
    const int c = e - r * chunks;
    const int col = k0 + c * 16;
    uint8_t* d = dst + r * stride + c * 16;
    if (r0 + r >= n || (!ONE && col >= p)) {
      *reinterpret_cast<uint4*>(d) = make_uint4(0u, 0u, 0u, 0u);
      continue;
    }
    const uint8_t* s = src + (size_t)(r0 + r) * p + col;
    if (aligned) {  // p % 16 == 0: the 16 bytes lie within the row
      cp_async16(d, s);
    } else {
      const int left = ONE ? 16 : p - col;
      uint32_t w[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        w[q] = 0;
#pragma unroll
        for (int i = 0; i < 4; ++i)
          if (4 * q + i < left) w[q] |= (uint32_t)s[4 * q + i] << (8 * i);
      }
      *reinterpret_cast<uint4*>(d) = make_uint4(w[0], w[1], w[2], w[3]);
    }
  }
}

__device__ __forceinline__ void mma_u8(int* c, const uint32_t* a,
                                       const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.u8.u8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// One pass: columns [k0, k0 + kw) of the block's rows of both operands
// into shared memory, then each row's sum of them (a row's sum stays with
// one thread).  ONE: the only pass, so the sums are stored with the mask
// folded in (-1 where the row is masked out or past the end); otherwise
// they are added to na / nb.
template <bool ONE, int BM, int BN, int THREADS>
__device__ __forceinline__ void stage_pass(
    uint8_t* sa, uint8_t* sb, const uint8_t* a, const uint8_t* b, int i0,
    int j0, int n1, int n2, int p, int k0, int kw, int stride, bool aligned,
    const uint8_t* mask1, const uint8_t* mask2, int* na, int* nb, int tid) {
  stage<ONE>(sa, a, i0, BM, n1, p, k0, kw, stride, aligned, tid, THREADS);
  stage<ONE>(sb, b, j0, BN, n2, p, k0, kw, stride, aligned, tid, THREADS);
  asm volatile("cp.async.commit_group;\n" ::);
  asm volatile("cp.async.wait_group 0;\n" ::);
  __syncthreads();
  for (int r = tid; r < BM + BN; r += THREADS) {
    const bool is_a = r < BM;
    const uint8_t* row = is_a ? sa + r * stride : sb + (r - BM) * stride;
    unsigned s = 0;
    for (int c = 0; c < kw; c += 16) {
      const uint4 v = *reinterpret_cast<const uint4*>(row + c);
      s = __dp4a(v.x, 0x01010101u, s);
      s = __dp4a(v.y, 0x01010101u, s);
      s = __dp4a(v.z, 0x01010101u, s);
      s = __dp4a(v.w, 0x01010101u, s);
    }
    int& sum = is_a ? na[r] : nb[r - BM];
    if (ONE) {
      const int gi = is_a ? i0 + r : j0 + r - BM;
      const uint8_t* mask = is_a ? mask1 : mask2;
      const bool ok = gi < (is_a ? n1 : n2) && (mask == nullptr || mask[gi]);
      sum = ok ? (int)s : -1;
    } else {
      sum += (int)s;
    }
  }
}

// ONE: p a multiple of 32 in (0, CHUNK_BITS] (the frontend's 256), staged
// in one pass before the accumulators are set up, with no column tail and
// nothing zeroed or synchronised for a second pass: the kernel as it was
// before the K loop (the general form cost 4-7% at 512 x 512,
// experiments/kernel_variants/run.py hamming_p)
// ii / jj: null for one matrix; else pair blockIdx.z takes frame ii[q] of
// a as its rows and frame jj[q] of b as its columns (frames n1 / n2 rows
// apart, nf of them) and writes the q-th n1 x n2 matrix of out
template <int BM, int BN, int WM, int WN, bool ONE>
__global__ void __launch_bounds__((BM / WM) * (BN / WN) * 32)
hamming_mma_kernel(const uint8_t* __restrict__ a, int n1,
                   const uint8_t* __restrict__ b, int n2, int p,
                   const uint8_t* __restrict__ mask1,
                   const uint8_t* __restrict__ mask2,
                   const int* __restrict__ ii, const int* __restrict__ jj,
                   int nf, int32_t* __restrict__ out) {
  constexpr int THREADS = (BM / WM) * (BN / WN) * 32;
  constexpr int MT = WM / 16;  // 16-row mma tiles of a warp
  constexpr int NT = WN / 8;   // 8-column mma tiles of a warp
  extern __shared__ uint4 smem[];
  __shared__ int na[BM];
  __shared__ int nb[BN];
  const int kmax = ONE ? p : min((p + 31) & ~31, CHUNK_BITS);  // staged
  const int stride = kmax + PAD;
  uint8_t* sa = reinterpret_cast<uint8_t*>(smem);
  uint8_t* sb = sa + BM * stride;
  const int i0 = blockIdx.y * BM;
  const int j0 = blockIdx.x * BN;
  const int tid = threadIdx.x;
  if (ii != nullptr) {  // one pair of a batch (uniform over the block)
    const int q = blockIdx.z;
    const int fa = ii[q];
    const int fb = jj[q];
    out += (size_t)q * n1 * n2;
    if (fa < 0 || fa >= nf || fb < 0 || fb >= nf) {
      for (int e = tid; e < BM * BN; e += THREADS) {
        const int i = i0 + e / BN;
        const int j = j0 + e % BN;
        if (i < n1 && j < n2) out[(size_t)i * n2 + j] = INT_INF;
      }
      return;
    }
    a += (size_t)fa * n1 * p;
    b += (size_t)fb * n2 * p;
    if (mask1 != nullptr) mask1 += (size_t)fa * n1;
    if (mask2 != nullptr) mask2 += (size_t)fb * n2;
  }
  const bool aligned = (p & 15) == 0 &&
                       ((reinterpret_cast<uintptr_t>(a) |
                         reinterpret_cast<uintptr_t>(b)) & 15) == 0;
  if (ONE) {
    stage_pass<true, BM, BN, THREADS>(sa, sb, a, b, i0, j0, n1, n2, p, 0, p,
                                      stride, aligned, mask1, mask2, na, nb,
                                      tid);
  } else {
    for (int r = tid; r < BM + BN; r += THREADS)
      (r < BM ? na[r] : nb[r - BM]) = 0;
  }

  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;  // row (A, C) or column (B) within a tile
  const int t4 = lane & 3;  // 4-byte group of K; column pair of C
  const int wm0 = (warp / (BN / WN)) * WM;
  const int wn0 = (warp % (BN / WN)) * WN;
  int acc[MT][NT][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[mt][nt][q] = 0;

  for (int k0 = 0; k0 < (ONE ? 1 : p); k0 += CHUNK_BITS) {
    const int kw = ONE ? p : min((p - k0 + 31) & ~31, CHUNK_BITS);
    if (!ONE) {
      if (k0 > 0) __syncthreads();  // the last pass's products are done
      stage_pass<false, BM, BN, THREADS>(sa, sb, a, b, i0, j0, n1, n2, p, k0,
                                         kw, stride, aligned, mask1, mask2,
                                         na, nb, tid);
    }
    for (int k = 0; k < kw; k += 32) {
      uint32_t af[MT][4];
      uint32_t bf[NT][2];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        const uint8_t* base =
            sa + (wm0 + mt * 16 + g) * stride + k + t4 * 4;
        af[mt][0] = *reinterpret_cast<const uint32_t*>(base);
        af[mt][1] = *reinterpret_cast<const uint32_t*>(base + 8 * stride);
        af[mt][2] = *reinterpret_cast<const uint32_t*>(base + 16);
        af[mt][3] =
            *reinterpret_cast<const uint32_t*>(base + 8 * stride + 16);
      }
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const uint8_t* base =
            sb + (wn0 + nt * 8 + g) * stride + k + t4 * 4;
        bf[nt][0] = *reinterpret_cast<const uint32_t*>(base);
        bf[nt][1] = *reinterpret_cast<const uint32_t*>(base + 16);
      }
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) mma_u8(acc[mt][nt], af[mt], bf[nt]);
    }
  }
  if (!ONE) {  // -1 where the row is masked out or past the end
    for (int r = tid; r < BM + BN; r += THREADS) {
      const bool is_a = r < BM;
      const int gi = is_a ? i0 + r : j0 + r - BM;
      const uint8_t* mask = is_a ? mask1 : mask2;
      const bool ok =
          gi < (is_a ? n1 : n2) && (mask == nullptr || mask[gi]);
      if (!ok) (is_a ? na[r] : nb[r - BM]) = -1;
    }
  }
  __syncthreads();  // na / nb in place; the staged rows free

  // the tile into shared memory, rows OS ints apart (OS = 8 mod 32: the
  // 8-byte writes of a warp's eight rows and four column pairs fall into
  // distinct banks; rows stay 16-byte aligned)
  constexpr int OS = BN + OPAD;
  int* so = reinterpret_cast<int*>(smem);
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = wm0 + mt * 16 + half * 8 + g;
      const int nai = na[r];
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const int c = wn0 + nt * 8 + t4 * 2;
        const int nb0 = nb[c];
        const int nb1 = nb[c + 1];
        const int d0 = (nai < 0 || nb0 < 0)
                           ? INT_INF
                           : nai + nb0 - 2 * acc[mt][nt][half * 2];
        const int d1 = (nai < 0 || nb1 < 0)
                           ? INT_INF
                           : nai + nb1 - 2 * acc[mt][nt][half * 2 + 1];
        *reinterpret_cast<int2*>(so + r * OS + c) = make_int2(d0, d1);
      }
    }
  }
  __syncthreads();

  // row by row, 16 bytes a thread
  const bool vec = (n2 & 3) == 0;  // 16-byte stores stay aligned
  for (int e = tid; e < BM * (BN / 4); e += THREADS) {
    const int r = e / (BN / 4);
    const int c = (e - r * (BN / 4)) * 4;
    const int i = i0 + r;
    const int j = j0 + c;
    if (i >= n1) break;
    const int4 v = *reinterpret_cast<const int4*>(so + r * OS + c);
    int32_t* o = out + (size_t)i * n2 + j;
    if (vec && j + 4 <= n2) {
      *reinterpret_cast<int4*>(o) = v;
    } else {
      if (j < n2) o[0] = v.x;
      if (j + 1 < n2) o[1] = v.y;
      if (j + 2 < n2) o[2] = v.z;
      if (j + 3 < n2) o[3] = v.w;
    }
  }
}

// shared memory of one block: the staged rows, or the output tile after them
template <int BM, int BN>
constexpr size_t smem_bytes(int p) {
  const int k32 = (p + 31) & ~31;
  const int kmax = k32 < CHUNK_BITS ? k32 : CHUNK_BITS;
  return (size_t)(BM + BN) * (kmax + PAD) > (size_t)BM * (BN + OPAD) * 4
             ? (size_t)(BM + BN) * (kmax + PAD)
             : (size_t)BM * (BN + OPAD) * 4;
}

template <int BM, int BN, int WM, int WN>
int launch(const uint8_t* a, int n1, const uint8_t* b, int n2, int p,
           const uint8_t* mask1, const uint8_t* mask2, const int* ii,
           const int* jj, int nf, int nq, int32_t* out,
           cudaStream_t stream) {
  const bool one = p > 0 && p <= CHUNK_BITS && p % 32 == 0;
  auto kernel = one ? hamming_mma_kernel<BM, BN, WM, WN, true>
                    : hamming_mma_kernel<BM, BN, WM, WN, false>;
  static bool attribute_set[2] = {false, false};  // per instantiation;
                                                  // setting twice is harmless
  if (!attribute_set[one]) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem_bytes<BM, BN>(CHUNK_BITS));
    if (err != cudaSuccess) return (int)err;
    attribute_set[one] = true;
  }
  const dim3 grid((n2 + BN - 1) / BN, (n1 + BM - 1) / BM, nq);
  const size_t smem = smem_bytes<BM, BN>(p);
  kernel<<<grid, (BM / WM) * (BN / WN) * 32, smem, stream>>>(
      a, n1, b, n2, p, mask1, mask2, ii, jj, nf, out);
  return (int)cudaGetLastError();
}

// the tile's instantiation (the TILE lines, which kernels/hamming.py's TILES
// lists), or cudaErrorInvalidValue for a tile that is not compiled
int dispatch(const uint8_t* a, int n1, const uint8_t* b, int n2, int p,
             const uint8_t* mask1, const uint8_t* mask2, const int* ii,
             const int* jj, int nf, int nq, int32_t* out, int bm, int bn,
             int wm, int wn, cudaStream_t s) {
#define TILE(BM, BN, WM, WN)                                             \
  if (bm == BM && bn == BN && wm == WM && wn == WN)                      \
    return launch<BM, BN, WM, WN>(a, n1, b, n2, p, mask1, mask2, ii, jj, \
                                  nf, nq, out, s);
  TILE(128, 128, 64, 32)
  TILE(64, 128, 32, 32)
  TILE(64, 64, 32, 32)
  TILE(32, 64, 16, 32)
  TILE(32, 32, 16, 16)
#undef TILE
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// a: (n1, p) uint8; b: (n2, p) uint8, both with rows p bytes apart;
// mask1/mask2: (n1,)/(n2,) uint8 or null; out: (n1, n2) int32.  The tile
// (bm x bn outputs a block, wm x wn a warp) is one of those compiled (the
// TILE lines above).  Any p >= 0.  Returns cudaError_t
// (cudaErrorInvalidValue for p < 0 or a tile that is not compiled).
extern "C" int hamming_launch(const uint8_t* a, int n1, const uint8_t* b,
                              int n2, int p, const uint8_t* mask1,
                              const uint8_t* mask2, int32_t* out, int bm,
                              int bn, int wm, int wn, void* stream) {
  if (p < 0) return (int)cudaErrorInvalidValue;
  if (n1 <= 0 || n2 <= 0) return (int)cudaSuccess;
  return dispatch(a, n1, b, n2, p, mask1, mask2, nullptr, nullptr, 1, 1, out,
                  bm, bn, wm, wn, (cudaStream_t)stream);
}

// bits: (nf, k, p) uint8, frames k * p bytes apart; masks: (nf, k) uint8 or
// null; ii / jj: (nq,) int32 frame indices on the device; out: (nq, k, k)
// int32, out[q] the distances of frame ii[q]'s rows to frame jj[q]'s.  One
// launch, pair q in blockIdx.z (nq <= 65535).  Returns cudaError_t.
extern "C" int hamming_pairs_launch(const uint8_t* bits, int nf, int k, int p,
                                    const uint8_t* masks, const int* ii,
                                    const int* jj, int nq, int32_t* out,
                                    int bm, int bn, int wm, int wn,
                                    void* stream) {
  if (p < 0 || nq > 65535) return (int)cudaErrorInvalidValue;
  if (k <= 0 || nq <= 0) return (int)cudaSuccess;
  return dispatch(bits, k, bits, k, p, masks, masks, ii, jj, nf, nq, out, bm,
                  bn, wm, wn, (cudaStream_t)stream);
}
