// Probes of photogrammetry_tpu_torch/csrc/hamming.cu's 128 x 128 tile, timed
// by run.py to see where its time goes: the package's kernel body with
// phases left out (MODE), and a persistent form that overlaps the staging of
// the next tile's B rows with the products and stores of the current one.
//
// MODE 0: everything, as the package's kernel was before its epilogue went
// through shared memory (the fragments stored straight to global memory,
// 8 bytes a thread); 1: no products (acc = 0);
// 2: no stores (a store only where a distance equals an impossible value);
// 3: no staging (the products of whatever shared memory holds);
// 4: stores only (no staging, no products, no row sums);
// 5: rows staged by the TMA, one bulk copy a row completing on an mbarrier;
// 6: the output tile written to shared memory from the fragments, then
//    stored as 16-byte words, a warp 512 contiguous bytes of a row;
// 7: both.
#include "../../photogrammetry_tpu_torch/csrc/hamming.cu"

namespace {

// products of one tile into acc; A rows at sa, B rows at sb
template <int BM, int BN, int WM, int WN>
__device__ __forceinline__ void products(const uint8_t* sa, const uint8_t* sb,
                                         int stride, int p,
                                         int (&acc)[WM / 16][WN / 8][4]) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int wm0 = (warp / (BN / WN)) * WM, wn0 = (warp % (BN / WN)) * WN;
#pragma unroll
  for (int mt = 0; mt < WM / 16; ++mt)
#pragma unroll
    for (int nt = 0; nt < WN / 8; ++nt)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[mt][nt][q] = 0;
  for (int k = 0; k < p; k += 32) {
    uint32_t af[WM / 16][4], bf[WN / 8][2];
#pragma unroll
    for (int mt = 0; mt < WM / 16; ++mt) {
      const uint8_t* base = sa + (wm0 + mt * 16 + g) * stride + k + t4 * 4;
      af[mt][0] = *reinterpret_cast<const uint32_t*>(base);
      af[mt][1] = *reinterpret_cast<const uint32_t*>(base + 8 * stride);
      af[mt][2] = *reinterpret_cast<const uint32_t*>(base + 16);
      af[mt][3] = *reinterpret_cast<const uint32_t*>(base + 8 * stride + 16);
    }
#pragma unroll
    for (int nt = 0; nt < WN / 8; ++nt) {
      const uint8_t* base = sb + (wn0 + nt * 8 + g) * stride + k + t4 * 4;
      bf[nt][0] = *reinterpret_cast<const uint32_t*>(base);
      bf[nt][1] = *reinterpret_cast<const uint32_t*>(base + 16);
    }
#pragma unroll
    for (int mt = 0; mt < WM / 16; ++mt)
#pragma unroll
      for (int nt = 0; nt < WN / 8; ++nt) mma_u8(acc[mt][nt], af[mt], bf[nt]);
  }
}

__device__ __forceinline__ void row_sums(const uint8_t* rows, int count,
                                         int stride, int p, int g0, int n,
                                         const uint8_t* mask, int* sums,
                                         int tid, int threads) {
  for (int r = tid; r < count; r += threads) {
    unsigned s = 0;
    for (int c = 0; c < p; c += 16) {
      const uint4 v = *reinterpret_cast<const uint4*>(rows + r * stride + c);
      s = __dp4a(v.x, 0x01010101u, s);
      s = __dp4a(v.y, 0x01010101u, s);
      s = __dp4a(v.z, 0x01010101u, s);
      s = __dp4a(v.w, 0x01010101u, s);
    }
    const int gi = g0 + r;
    sums[r] = (gi < n && (mask == nullptr || mask[gi])) ? (int)s : -1;
  }
}

template <int BM, int BN, int WM, int WN>
__device__ __forceinline__ void epilogue(const int (&acc)[WM / 16][WN / 8][4],
                                         const int* na, const int* nb, int i0,
                                         int j0, int n1, int n2,
                                         int32_t* out, bool never) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int wm0 = (warp / (BN / WN)) * WM, wn0 = (warp % (BN / WN)) * WN;
  const bool pairs = (n2 & 1) == 0;
#pragma unroll
  for (int mt = 0; mt < WM / 16; ++mt)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = wm0 + mt * 16 + half * 8 + g;
      const int i = i0 + r;
      if (i >= n1) continue;
      const int nai = na[r];
      int32_t* orow = out + (size_t)i * n2;
#pragma unroll
      for (int nt = 0; nt < WN / 8; ++nt) {
        const int c = wn0 + nt * 8 + t4 * 2;
        const int j = j0 + c;
        const int nb0 = nb[c], nb1 = nb[c + 1];
        const int d0 = (nai < 0 || nb0 < 0) ? INT_INF
                           : nai + nb0 - 2 * acc[mt][nt][half * 2];
        const int d1 = (nai < 0 || nb1 < 0) ? INT_INF
                           : nai + nb1 - 2 * acc[mt][nt][half * 2 + 1];
        if (never && d0 != -12345) continue;
        if (pairs && j + 1 < n2) {
          *reinterpret_cast<int2*>(orow + j) = make_int2(d0, d1);
        } else {
          if (j < n2) orow[j] = d0;
          if (j + 1 < n2) orow[j + 1] = d1;
        }
      }
    }
}

// rows [r0, r0 + rows) of src into dst by the TMA (one bulk copy a row;
// rows past n zeroed by the threads), all arriving on bar
__device__ __forceinline__ void stage_bulk(uint8_t* dst, const uint8_t* src,
                                           int r0, int rows, int n, int p,
                                           uint64_t* bar, int tid) {
  if (tid >= 0 && tid < rows) {
    uint8_t* d = dst + tid * (p + PAD);
    if (r0 + tid < n) {
      asm volatile(
          "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
          "[%0], [%1], %2, [%3];\n" ::"r"((unsigned)__cvta_generic_to_shared(d)),
          "l"(__cvta_generic_to_global(src + (size_t)(r0 + tid) * p)),
          "r"(p), "r"((unsigned)__cvta_generic_to_shared(bar))
          : "memory");
    } else {
      for (int c = 0; c < p; c += 16)
        *reinterpret_cast<uint4*>(d + c) = make_uint4(0u, 0u, 0u, 0u);
    }
  }
}

__device__ __forceinline__ void bar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(
      (unsigned)__cvta_generic_to_shared(bar)));
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::);
  asm volatile("fence.proxy.async.shared::cta;\n" ::);
}

__device__ __forceinline__ void bar_expect(uint64_t* bar, unsigned bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          (unsigned)__cvta_generic_to_shared(bar)),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void bar_wait(uint64_t* bar, unsigned phase) {
  asm volatile(
      "{\n.reg .pred p;\nWAIT_%=:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra WAIT_%=;\n}\n" ::"r"((unsigned)__cvta_generic_to_shared(bar)),
      "r"(phase)
      : "memory");
}

// the tile's distances into shared memory (row pitch OP ints) from the
// fragments, then to global memory as 16-byte words where N2 % 4 == 0
constexpr int OP = 128 + 8;
template <int BM, int BN, int WM, int WN>
__device__ __forceinline__ void epilogue_smem(
    const int (&acc)[WM / 16][WN / 8][4], const int* na, const int* nb,
    int i0, int j0, int n1, int n2, int32_t* out, int* so) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int wm0 = (warp / (BN / WN)) * WM, wn0 = (warp % (BN / WN)) * WN;
#pragma unroll
  for (int mt = 0; mt < WM / 16; ++mt)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = wm0 + mt * 16 + half * 8 + g;
      const int nai = na[r];
#pragma unroll
      for (int nt = 0; nt < WN / 8; ++nt) {
        const int c = wn0 + nt * 8 + t4 * 2;
        const int nb0 = nb[c], nb1 = nb[c + 1];
        const int d0 = (nai < 0 || nb0 < 0) ? INT_INF
                           : nai + nb0 - 2 * acc[mt][nt][half * 2];
        const int d1 = (nai < 0 || nb1 < 0) ? INT_INF
                           : nai + nb1 - 2 * acc[mt][nt][half * 2 + 1];
        *reinterpret_cast<int2*>(so + r * OP + c) = make_int2(d0, d1);
      }
    }
  __syncthreads();
  const bool vec = (n2 & 3) == 0;
  for (int e = threadIdx.x; e < BM * (BN / 4); e += 256) {
    const int r = e / (BN / 4), c = (e % (BN / 4)) * 4;
    const int i = i0 + r, j = j0 + c;
    if (i >= n1) break;
    const int4 v = *reinterpret_cast<const int4*>(so + r * OP + c);
    int32_t* o = out + (size_t)i * n2 + j;
    if (vec && j + 3 < n2) {
      *reinterpret_cast<int4*>(o) = v;
    } else {
      if (j < n2) o[0] = v.x;
      if (j + 1 < n2) o[1] = v.y;
      if (j + 2 < n2) o[2] = v.z;
      if (j + 3 < n2) o[3] = v.w;
    }
  }
}

template <int MODE>
__global__ void __launch_bounds__(256)
probe_kernel(const uint8_t* __restrict__ a, int n1,
             const uint8_t* __restrict__ b, int n2, int p,
             const uint8_t* __restrict__ mask1,
             const uint8_t* __restrict__ mask2, int32_t* __restrict__ out) {
  constexpr int BM = 128, BN = 128, WM = 64, WN = 32;
  extern __shared__ uint4 smem[];
  __shared__ int na[BM];
  __shared__ int nb[BN];
  __shared__ uint64_t bar;
  const int stride = p + PAD;
  uint8_t* sa = reinterpret_cast<uint8_t*>(smem);
  uint8_t* sb = sa + BM * stride;
  const int i0 = blockIdx.y * BM, j0 = blockIdx.x * BN;
  const int tid = threadIdx.x;
  if (MODE == 5 || MODE == 7) {
    if (tid == 0) bar_init(&bar);
    __syncthreads();
    if (tid == 0) {
      const int ra = min(BM, n1 - i0), rb = min(BN, n2 - j0);
      bar_expect(&bar, (unsigned)((ra + rb) * p));
    }
    __syncthreads();
    stage_bulk(sa, a, i0, BM, n1, p, &bar, tid);
    stage_bulk(sb, b, j0, BN, n2, p, &bar, tid - BM);
    bar_wait(&bar, 0);
  } else if (MODE != 3 && MODE != 4) {
    stage(sa, a, i0, BM, n1, p, true, tid, 256);
    stage(sb, b, j0, BN, n2, p, true, tid, 256);
    asm volatile("cp.async.commit_group;\n" ::);
    asm volatile("cp.async.wait_group 0;\n" ::);
  }
  __syncthreads();
  if (MODE != 4) {
    row_sums(sa, BM, stride, p, i0, n1, mask1, na, tid, 256);
    row_sums(sb, BN, stride, p, j0, n2, mask2, nb, tid, 256);
  } else {
    if (tid < BM) na[tid] = tid;
    if (tid < BN) nb[tid] = tid;
  }
  int acc[WM / 16][WN / 8][4] = {};
  if (MODE != 1 && MODE != 4)
    products<BM, BN, WM, WN>(sa, sb, stride, p, acc);
  __syncthreads();
  if (MODE == 6 || MODE == 7) {
    epilogue_smem<BM, BN, WM, WN>(acc, na, nb, i0, j0, n1, n2, out,
                                  reinterpret_cast<int*>(smem));
  } else {
    epilogue<BM, BN, WM, WN>(acc, na, nb, i0, j0, n1, n2, out, MODE == 2);
  }
}

// Persistent: block b takes tiles [b * per, (b + 1) * per) in row-major
// order, keeps its A rows while the tile row stays the same, and stages the
// next tile's B rows (double-buffered) while it computes and stores this one.
__global__ void __launch_bounds__(256)
persistent_kernel(const uint8_t* __restrict__ a, int n1,
                  const uint8_t* __restrict__ b, int n2, int p,
                  const uint8_t* __restrict__ mask1,
                  const uint8_t* __restrict__ mask2,
                  int32_t* __restrict__ out, int per) {
  constexpr int BM = 128, BN = 128, WM = 64, WN = 32;
  extern __shared__ uint4 smem[];
  __shared__ int na[BM];
  __shared__ int nb[2][BN];
  const int stride = p + PAD;
  uint8_t* sa = reinterpret_cast<uint8_t*>(smem);
  uint8_t* sbuf[2] = {sa + BM * stride, sa + (BM + BN) * stride};
  const int gx = (n2 + BN - 1) / BN;
  const int tiles = gx * ((n1 + BM - 1) / BM);
  const int t0 = blockIdx.x * per;
  const int t1 = min(tiles, t0 + per);
  const int tid = threadIdx.x;
  if (t0 >= t1) return;
  int a_row = t0 / gx;
  stage(sa, a, a_row * BM, BM, n1, p, true, tid, 256);
  stage(sbuf[0], b, (t0 % gx) * BN, BN, n2, p, true, tid, 256);
  asm volatile("cp.async.commit_group;\n" ::);
  bool new_a = true;
  for (int t = t0, buf = 0; t < t1; ++t, buf ^= 1) {
    asm volatile("cp.async.wait_group 0;\n" ::);
    __syncthreads();  // this tile's rows have landed; the last tile is done
    const int i0 = (t / gx) * BM, j0 = (t % gx) * BN;
    if (new_a) row_sums(sa, BM, stride, p, i0, n1, mask1, na, tid, 256);
    row_sums(sbuf[buf], BN, stride, p, j0, n2, mask2, nb[buf], tid, 256);
    const bool next_same_row = t + 1 < t1 && (t + 1) / gx == t / gx;
    if (next_same_row) {
      stage(sbuf[buf ^ 1], b, ((t + 1) % gx) * BN, BN, n2, p, true, tid, 256);
      asm volatile("cp.async.commit_group;\n" ::);
    }
    int acc[WM / 16][WN / 8][4];
    products<BM, BN, WM, WN>(sa, sbuf[buf], stride, p, acc);
    __syncthreads();  // row sums of this tile are in place
    epilogue<BM, BN, WM, WN>(acc, na, nb[buf], i0, j0, n1, n2, out, false);
    new_a = false;
    if (t + 1 < t1 && !next_same_row) {
      __syncthreads();  // everyone is done with A
      stage(sa, a, ((t + 1) / gx) * BM, BM, n1, p, true, tid, 256);
      stage(sbuf[buf ^ 1], b, ((t + 1) % gx) * BN, BN, n2, p, true, tid,
            256);
      asm volatile("cp.async.commit_group;\n" ::);
      new_a = true;
    }
  }
}

// the largest dynamic shared memory a kernel may take, set once each
template <typename K>
int prepare(K kernel, bool& done) {
  if (done) return 0;
  done = true;
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, 384 * (512 + PAD));
}

}  // namespace

// variant 0-7: probe MODE; 8-11: the package's kernel at tiles it does not
// compile, (bm, bn, wm, wn) = (128, 128, 32, 32), (256, 128, 64, 32),
// (256, 128, 32, 32), (128, 256, 32, 64); 12 + k (k < 3): persistent with
// k + 1 tiles a block
extern "C" int probe_launch(int variant, const uint8_t* a, int n1,
                            const uint8_t* b, int n2, int p,
                            const uint8_t* mask1, const uint8_t* mask2,
                            int32_t* out, void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  const size_t smem = max((size_t)256 * (p + PAD), (size_t)128 * OP * 4);
  const dim3 grid((n2 + 127) / 128, (n1 + 127) / 128);
  static bool ready[9] = {};
  int err = 0;
#define MODE_CASE(M)                                                     \
  case M:                                                                \
    err = prepare(probe_kernel<M>, ready[M]);                            \
    if (err) return err;                                                 \
    probe_kernel<M><<<grid, 256, smem, s>>>(a, n1, b, n2, p, mask1,      \
                                            mask2, out);                 \
    return (int)cudaGetLastError();
  switch (variant) {
    MODE_CASE(0) MODE_CASE(1) MODE_CASE(2) MODE_CASE(3) MODE_CASE(4)
    MODE_CASE(5) MODE_CASE(6) MODE_CASE(7)
    default: break;
  }
#undef MODE_CASE
  switch (variant) {
    case 8: return launch<128, 128, 32, 32>(a, n1, b, n2, p, mask1, mask2, out, s);
    case 9: return launch<256, 128, 64, 32>(a, n1, b, n2, p, mask1, mask2, out, s);
    case 10: return launch<256, 128, 32, 32>(a, n1, b, n2, p, mask1, mask2, out, s);
    case 11: return launch<128, 256, 32, 64>(a, n1, b, n2, p, mask1, mask2, out, s);
    default: break;
  }
  const int per = variant - 11;
  const int tiles = grid.x * grid.y;
  const size_t psmem = (size_t)384 * (p + PAD);
  err = prepare(persistent_kernel, ready[8]);
  if (err) return err;
  persistent_kernel<<<(tiles + per - 1) / per, 256, psmem, s>>>(
      a, n1, b, n2, p, mask1, mask2, out, per);
  return (int)cudaGetLastError();
}
