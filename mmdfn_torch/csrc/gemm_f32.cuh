// A tiled f32 matrix product, with the operands read in place through
// strides and the output handed to an epilogue functor, on one of two
// cores: the tensor cores in 3xTF32 (launch_tc, gemm_tc_kernel: kernels B
// and D's f32 mode) or the CUDA cores (launch, gemm_kernel: their bf16
// modes, which the checks hold to f32 sums of bf16 values in this core's
// order).
//
//   out(z, r, c) = sum over k of A(z, r, k) * B(z, c, k),  r < M, c < N
//
// Both operands are seen as (rows, K): A as (M, K), B as (N, K), so that a
// transposed operand (adj^T, W^T, h1^T) is only another pair of strides.
// An Operand may take its columns (split_k) or its rows from a second
// pointer from index `split` on ([h | lh], [W_ih; W_hh]), and may have one
// row of ones (the bias row of a weight gradient).  z indexes a batch
// (one dialogue, or one layer); blockIdx.z = z * splits + s, where split s
// of a split-K product sums k in [s kchunk, (s + 1) kchunk).  Batch z of a
// segment starts at p + z bs + (z / zg) gs: a group stride gs every zg
// batches (a configuration's weights, shared by its dialogues, under the
// grouped sweep's config axis; gs = 0 without one).  A block computes its
// batch's group z / zg once and passes it to every load; a launch whose
// batches all lie in group 0 (a run alone) runs the kernel compiled
// without the group term.
//
// Tiling (the CUDA cores): a block computes a BM x BN tile; 8-deep slices
// of both operands are staged k-major in shared memory through a ring of
// three slices filled by cp.async (16 bytes where the operand is aligned
// and lands contiguous, else 4: every stride and ragged edge is legal).
// Each thread holds a TM x 8 register tile, split into 4-wide chunks
// BM/(TM/4) rows and BN/2 columns apart, so that its float4 reads of a
// slice are broadcasts (A) or consecutive (B).  The epilogue is a
// functor with a type In, `In load(z, r, c)` (the global values it reads)
// and `operator()(z, r, c, acc, in)`, called for every element inside M x
// N.  An epilogue derived from Chunk4 is called once
// per 4-wide chunk of a thread's columns instead, with c the chunk's first
// column (a multiple of 4) and acc a float4 of columns c .. c + 3; N must
// be a multiple of 4.  An epilogue may resolve what depends on its batch
// alone (a configuration's weights or rate) once a block, in a method
// `Epi for_batch(int z) const`; without one it is used as given.
//
// The tensor-core core (launch_tc): the same operands, loader, ring and
// epilogues, BM x BN tiles of 8 warps, each warp a WM x WN tile of
// mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 products (wgmma
// would want K-major operands in swizzled shared memory; these are read
// in place through any strides).  Slices are TBK = 16 deep, STAGES = 3
// in flight; an operand whose k is contiguous is staged row-major (16-byte
// copies), else k-major, each at a row stride that puts the 32 lanes of a
// fragment's read on 32 banks (TcSlice).  TF32 keeps 10 of f32's 23
// stored significand bits (about 3 decimal digits): one TF32 product
// misses the checks' f32 tolerances by 1-2 orders of magnitude
// (tests/test_torch_tf32x3.py).  So each value is split as a fragment is
// read, big = tf32(x), small = tf32(x - big) (to nearest, ties away, as
// cvt.rna), which hold x to 2^-22 of |x|, and each k8 step's product is
// three TF32 products, small_a big_b + big_a small_b + big_a big_b (the
// small terms first, as CUTLASS's 3xTF32; small x small, 2^-22 of each
// term, left out), summed into a partial sum that an f32 add (to
// nearest) puts into the accumulator.  The tensor cores round each sum
// toward zero: summed into the accumulator itself, the three products
// would lose up to a unit of it a product, always the same way, several
// times f32's error over a K of 200-400.  A warp whose tile lies past M or
// N, and a slice's k8 steps past K, multiply nothing.  The accumulators
// then pass through shared memory to gemm_kernel's epilogue layout
// (coalesced loads and stores, Chunk4's four columns in one thread).  The
// bound is the tensor cores' TF32 rate, 495 TFLOP/s dense on an H100 SXM
// (mma.sync reaches about 323 of it), a third of it for 3xTF32, against
// 67 TFLOP/s of f32 on the CUDA cores.  Tile shapes depend on no K, batch
// or configuration count, so a configuration in a grouped launch sums as
// in its launch alone.
//
// bf16 operands (the GCNII kernels' bf16 mode): bf16 times bf16 is exact in
// f32, so a product on bf16 values is the f32 sum of the exact products,
// as the TPU's bf16 dot with f32 accumulation.  Most of them arrive as f32
// tensors that hold bf16 values (rounded by round_bf16 in an epilogue) and
// take the cp.async path.  A segment stored in bf16 (OperandT<T0, T1>, each
// of float or bf16: kernel D reads the bf16 residual slabs so) is widened
// to f32 as it is staged, into the same shared-memory slices and register
// tiles, through registers (cp.async cannot widen): its slice t + 2 is read
// from global memory before slice t is multiplied and stored to shared
// memory after, so that the multiply hides the reads.  As load_slice, a
// thread reads groups of 4 elements along the contiguous axis from one
// address (8 bytes at once where 4 bf16 are aligned), and an edge group
// element by element.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <type_traits>

namespace gemm {

using bf16 = __nv_bfloat16;

__device__ __forceinline__ float widen(float x) { return x; }
__device__ __forceinline__ float widen(bf16 x) { return __bfloat162float(x); }

// x rounded to bf16 (to nearest even) and held in f32: a bf16 operand that
// the cp.async path stages as f32
__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

constexpr int BK = 8;       // depth of a slice
constexpr int STAGES = 3;   // slices in flight

__device__ float kOne = 1.0f;   // the source of a row of ones

struct NoIn {};   // the In of an epilogue that reads nothing

// the base of an epilogue that takes a thread's columns 4 at a time
struct Chunk4 {};

template <class Epi>
constexpr bool kChunked = std::is_base_of<Chunk4, Epi>::value;

template <class T0, class T1 = T0>
struct OperandT {
  const T0* p0;         // segment 0
  const T1* p1;         // segment 1: index >= split along k or rows
  long long bs0, bs1;   // batch strides of the segments (elements)
  long long rs, ks;     // strides of a row and of k
  int split;            // where segment 1 starts; a large value: never
  int split_k;          // 1: split along k; 0: along the rows
  int one_row;          // a row that reads 1.0; -1: none
  int zg;               // batches a group
  long long gs0, gs1;   // group strides of the segments (elements)

  // both segments f32: staged by cp.async
  static constexpr bool kF32 =
      std::is_same<T0, float>::value && std::is_same<T1, float>::value;

  // element (r, k) of batch z, whose group is zgrp = z / zg (f32 only)
  __device__ __forceinline__ const float* at(int z, int zgrp, int r,
                                             int k) const {
    if (r == one_row) return &kOne;
    const float* p = p0;
    long long bs = bs0, gs = gs0;
    if (split_k) {
      if (k >= split) { p = p1; bs = bs1; gs = gs1; k -= split; }
    } else if (r >= split) {
      p = p1; bs = bs1; gs = gs1; r -= split;
    }
    return p + z * bs + zgrp * gs + r * rs + k * ks;
  }

  // 4 consecutive elements along the contiguous axis (k where KC, else the
  // rows) from (gr, gk), widened; zeros outside rows < nrows, k < ke
  template <bool KC>
  __device__ __forceinline__ void get4(int z, int zgrp, int gr, int gk,
                                       int nrows, int ke, float* v) const {
    const int c = KC ? gk : gr;
    const bool in = KC ? gr < nrows && gk + 3 < ke : gk < ke && gr + 3 < nrows;
    const bool split_here = (split_k != 0) == KC;
    const bool whole =
        in && !(split_here && c < split && c + 3 >= split) &&
        !(KC ? gr == one_row : one_row >= gr && one_row <= gr + 3);
    if (!whole) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int rr = gr + (KC ? 0 : j), kk = gk + (KC ? j : 0);
        v[j] = rr < nrows && kk < ke ? get(z, zgrp, rr, kk) : 0.0f;
      }
      return;
    }
    int r = gr, k = gk;
    bool second = false;
    if (split_k) {
      if (k >= split) { second = true; k -= split; }
    } else if (r >= split) {
      second = true; r -= split;
    }
    const long long o = (long long)r * rs + (long long)k * ks;
    if (second)
      load4(p1 + z * bs1 + zgrp * gs1 + o, v);
    else
      load4(p0 + z * bs0 + zgrp * gs0 + o, v);
  }

  __device__ __forceinline__ static void load4(const float* p, float* v) {
    if ((reinterpret_cast<unsigned long long>(p) & 15) == 0) {
      const float4 x = *reinterpret_cast<const float4*>(p);
      v[0] = x.x; v[1] = x.y; v[2] = x.z; v[3] = x.w;
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j) v[j] = p[j];
    }
  }

  __device__ __forceinline__ static void load4(const bf16* p, float* v) {
    if ((reinterpret_cast<unsigned long long>(p) & 7) == 0) {
      const uint2 x = *reinterpret_cast<const uint2*>(p);   // bf16 is the
      v[0] = __uint_as_float(x.x << 16);                   // top half of
      v[1] = __uint_as_float(x.x & 0xffff0000u);           // an f32
      v[2] = __uint_as_float(x.y << 16);
      v[3] = __uint_as_float(x.y & 0xffff0000u);
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j) v[j] = widen(p[j]);
    }
  }

  // the value of element (r, k) of batch z, widened to f32
  __device__ __forceinline__ float get(int z, int zgrp, int r, int k) const {
    if (r == one_row) return 1.0f;
    bool second = false;
    if (split_k) {
      if (k >= split) { second = true; k -= split; }
    } else if (r >= split) {
      second = true; r -= split;
    }
    const long long o = (long long)r * rs + (long long)k * ks;
    return second ? widen(p1[z * bs1 + zgrp * gs1 + o])
                  : widen(p0[z * bs0 + zgrp * gs0 + o]);
  }
};

using Operand = OperandT<float>;

// A dense operand: element (r, k) at p + z bs + r rs + k ks.
template <class T>
inline OperandT<T> dense(const T* p, long long bs, long long rs,
                         long long ks) {
  return OperandT<T>{p, p, bs, bs, rs, ks, 1 << 30, 0, -1, 1, 0, 0};
}

// Two operands side by side along k (split_k) or stacked along the rows,
// with the same strides.
template <class T0, class T1>
inline OperandT<T0, T1> cat(const T0* p0, long long bs0, const T1* p1,
                            long long bs1, long long rs, long long ks,
                            int split, bool split_k) {
  return OperandT<T0, T1>{p0, p1, bs0, bs1, rs, ks, split, split_k ? 1 : 0,
                          -1, 1, 0, 0};
}

// `o` with a group stride: batch z's segments start gs0 / gs1 further per
// zg batches.
template <class O>
inline O grouped(O o, int zg, long long gs0, long long gs1) {
  o.zg = zg;
  o.gs0 = gs0;
  o.gs1 = gs1;
  return o;
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          int bytes) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
               "l"(src), "r"(bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src));
}

// An edge group, element by element (out of line: rare, and kept out of the
// main loop's code).
__device__ __noinline__ void load_edge(float* d, int step, const Operand op,
                                       int z, int zgrp, int gr, int gk,
                                       bool kc, int nrows, int ke) {
  for (int j = 0; j < 4; ++j) {
    const int rr = kc ? gr : gr + j, kk = kc ? gk + j : gk;
    const bool ok = rr < nrows && kk < ke;
    cp_async4(d + j * step, ok ? op.at(z, zgrp, rr, kk) : op.p0,
              ok ? 4 : 0);
  }
}

// One SK-deep slice of an operand's rows [r0, r0 + ROWS) into dst, element
// (r, k) at dst + k DK + r DR (by default k-major, dst[k][r] with row
// stride ROWS + 4); zeros outside rows < nrows and k < ke.  Each
// thread copies groups of 4 elements along the operand's contiguous axis
// (k where KC, else the rows; its stride must be 1), so that one address
// serves four elements and the global reads coalesce: a group that lies
// inside the operand and in one segment is copied from that address, by
// one 16-byte copy where it is aligned and lands contiguous (the
// contiguous axis's stride in dst is 1), else by four 4-byte copies; an
// edge group element by element.
template <int ROWS, bool KC, int T, int SK = BK, int DK = ROWS + 4,
          int DR = 1>
__device__ __forceinline__ void load_slice(float* dst, const Operand& op,
                                           int z, int zgrp, int r0,
                                           int nrows, int k0, int ke,
                                           int tid) {
  constexpr int NG = SK * ROWS / 4;
  static_assert(ROWS % 4 == 0 && (DK % 4 == 0 || DK == 1) &&
                    (DR % 4 == 0 || DR == 1),
                "groups of 4 land 16-byte aligned");
#pragma unroll
  for (int i = 0; i < (NG + T - 1) / T; ++i) {
    const int g = tid + i * T;
    if (NG % T == 0 || g < NG) {
      const int r = KC ? g / (SK / 4) : g % (ROWS / 4) * 4;
      const int k = KC ? g % (SK / 4) * 4 : g / (ROWS / 4);
      const int gr = r0 + r, gk = k0 + k;
      float* d = dst + k * DK + r * DR;
      constexpr int step = KC ? DK : DR;   // the next element's place
      const int c = KC ? gk : gr;        // the contiguous coordinate
      const bool in = KC ? gr < nrows && gk + 3 < ke
                         : gk < ke && gr + 3 < nrows;
      const bool split_here = (op.split_k != 0) == KC;
      const bool whole =
          in && !(split_here && c < op.split && c + 3 >= op.split) &&
          !(KC ? gr == op.one_row
               : op.one_row >= gr && op.one_row <= gr + 3);
      if (whole) {
        const float* src = op.at(z, zgrp, gr, gk);
        if (step == 1 &&
            (reinterpret_cast<unsigned long long>(src) & 15) == 0) {
          cp_async16(d, src);
        } else {
#pragma unroll
          for (int j = 0; j < 4; ++j) cp_async4(d + j * step, src + j, 4);
        }
      } else {
        load_edge(d, step, op, z, zgrp, gr, gk, KC, nrows, ke);
      }
    }
  }
}

// A slice staged through registers (an operand with a bf16 segment): the
// same slice and layout as load_slice, fetched into v and stored later.
template <int ROWS, bool KC, int T>
struct RegSlice {
  static constexpr int S = ROWS + 4;
  static constexpr int NG = BK * ROWS / 4;
  static constexpr int NI = (NG + T - 1) / T;
  float v[NI][4];

  template <class Op>
  __device__ __forceinline__ void fetch(const Op& op, int z, int zgrp,
                                        int r0, int nrows, int k0, int ke,
                                        int tid) {
#pragma unroll
    for (int i = 0; i < NI; ++i) {
      const int g = tid + i * T;
      if (NG % T == 0 || g < NG) {
        const int r = KC ? g / (BK / 4) : g % (ROWS / 4) * 4;
        const int k = KC ? g % (BK / 4) * 4 : g / (ROWS / 4);
        op.template get4<KC>(z, zgrp, r0 + r, k0 + k, nrows, ke, v[i]);
      }
    }
  }

  __device__ __forceinline__ void store(float* dst, int tid) const {
#pragma unroll
    for (int i = 0; i < NI; ++i) {
      const int g = tid + i * T;
      if (NG % T == 0 || g < NG) {
        const int r = KC ? g / (BK / 4) : g % (ROWS / 4) * 4;
        const int k = KC ? g % (BK / 4) * 4 : g / (ROWS / 4);
        float* d = dst + k * S + r;
        if (KC) {
#pragma unroll
          for (int j = 0; j < 4; ++j) d[j * S] = v[i][j];
        } else {
          *reinterpret_cast<float4*>(d) =
              make_float4(v[i][0], v[i][1], v[i][2], v[i][3]);
        }
      }
    }
  }
};

template <class Epi>
__device__ __forceinline__ auto batch_epilogue(const Epi& e, int z, int)
    -> decltype(e.for_batch(z)) {
  return e.for_batch(z);
}
template <class Epi>
__device__ __forceinline__ Epi batch_epilogue(const Epi& e, int, long) {
  return e;
}

// GROUPED: whether a group stride applies (false: every batch's group is
// 0, and the loads skip the group term, as for a run alone).
template <int BM, int BN, int TM, bool AKC, bool BKC, int MINB, bool GROUPED,
          class OA, class OB, class Epi>
__global__ void __launch_bounds__((BM / TM) * (BN / 8), MINB)
    gemm_kernel(const OA A, const OB B, int M, int N, int K,
                int splits, int kchunk, const Epi epi_all) {
  constexpr int TN = 8;
  constexpr int TR = BM / TM, TC = BN / TN, T = TR * TC;
  constexpr int SA = BM + 4, SB = BN + 4;
  static_assert(TM == 4 || TM == 8, "TM is 4 or 8");
  static_assert(BM % TM == 0 && BN % TN == 0, "tile shape");
  __shared__ __align__(16) float As[STAGES][BK * SA];
  __shared__ __align__(16) float Bs[STAGES][BK * SB];

  const int tid = threadIdx.x;
  const int tc = tid % TC, tr = tid / TC;
  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * BM;
  const int z = blockIdx.z / splits, s = blockIdx.z % splits;
  const int kb = s * kchunk, ke = min(K, kb + kchunk);
  const int ga = GROUPED ? z / A.zg : 0, gb = GROUPED ? z / B.zg : 0;
  const int nk = ke > kb ? (ke - kb + BK - 1) / BK : 0;

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.0f;

  // an operand with a bf16 segment goes through registers (see the top)
  RegSlice<BM, AKC, T> ra;
  RegSlice<BN, BKC, T> rb;

  // a ring of STAGES slices: slice t + STAGES - 1 is fetched while slice t
  // is multiplied; one barrier a slice
#pragma unroll
  for (int p = 0; p < STAGES - 1; ++p) {
    if (p < nk) {
      if constexpr (OA::kF32) {
        load_slice<BM, AKC, T>(As[p], A, z, ga, m0, M, kb + p * BK, ke, tid);
      } else {
        ra.fetch(A, z, ga, m0, M, kb + p * BK, ke, tid);
        ra.store(As[p], tid);
      }
      if constexpr (OB::kF32) {
        load_slice<BN, BKC, T>(Bs[p], B, z, gb, n0, N, kb + p * BK, ke, tid);
      } else {
        rb.fetch(B, z, gb, n0, N, kb + p * BK, ke, tid);
        rb.store(Bs[p], tid);
      }
    }
    cp_async_commit();
  }
  for (int t = 0; t < nk; ++t) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();
    const int p = t + STAGES - 1, nb = p % STAGES;
    {
      if (p < nk) {
        if constexpr (OA::kF32)
          load_slice<BM, AKC, T>(As[nb], A, z, ga, m0, M, kb + p * BK, ke,
                                 tid);
        else
          ra.fetch(A, z, ga, m0, M, kb + p * BK, ke, tid);
        if constexpr (OB::kF32)
          load_slice<BN, BKC, T>(Bs[nb], B, z, gb, n0, N, kb + p * BK, ke,
                                 tid);
        else
          rb.fetch(B, z, gb, n0, N, kb + p * BK, ke, tid);
      }
      cp_async_commit();
    }
    const float* as = As[t % STAGES] + tr * 4;
    const float* bs = Bs[t % STAGES] + tc * 4;
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      float a[TM], b[TN];
#pragma unroll
      for (int q = 0; q < TM / 4; ++q) {
        const float4 v =
            *reinterpret_cast<const float4*>(as + kk * SA + q * TR * 4);
        a[4 * q] = v.x; a[4 * q + 1] = v.y; a[4 * q + 2] = v.z;
        a[4 * q + 3] = v.w;
      }
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        const float4 v =
            *reinterpret_cast<const float4*>(bs + kk * SB + q * TC * 4);
        b[4 * q] = v.x; b[4 * q + 1] = v.y; b[4 * q + 2] = v.z;
        b[4 * q + 3] = v.w;
      }
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    // slice p's registers into its buffer, which no thread reads until
    // the barrier of step p
    if (p < nk) {
      if constexpr (!OA::kF32) ra.store(As[nb], tid);
      if constexpr (!OB::kF32) rb.store(Bs[nb], tid);
    }
  }
  cp_async_wait<0>();
  const Epi epi = batch_epilogue(epi_all, z, 0);

  // a row of the register tile at a time: first every global value its
  // epilogue reads, then the epilogue itself (its stores would otherwise
  // order each later load behind them)
  if constexpr (kChunked<Epi>) {
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const int r = m0 + (i / 4) * TR * 4 + tr * 4 + i % 4;
      if (r >= M) continue;
      typename Epi::In in[2];
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        const int c = n0 + q * TC * 4 + tc * 4;
        if (c < N) in[q] = epi.load(z, r, c);
      }
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        const int c = n0 + q * TC * 4 + tc * 4;
        if (c < N)
          epi(z, r, c,
              make_float4(acc[i][4 * q], acc[i][4 * q + 1],
                          acc[i][4 * q + 2], acc[i][4 * q + 3]),
              in[q]);
      }
    }
  } else {
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const int r = m0 + (i / 4) * TR * 4 + tr * 4 + i % 4;
      if (r >= M) continue;
      typename Epi::In in[TN];
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        const int c = n0 + (j / 4) * TC * 4 + tc * 4 + j % 4;
        if (c < N) in[j] = epi.load(z, r, c);
      }
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        const int c = n0 + (j / 4) * TC * 4 + tc * 4 + j % 4;
        if (c < N) epi(z, r, c, acc[i][j], in[j]);
      }
    }
  }
}

// Launches out = A B^T over `batches` batches and `splits` splits of K on
// `st`; returns cudaGetLastError().
template <int BM, int BN, int TM, bool AKC, bool BKC, int MINB, class OA,
          class OB, class Epi>
cudaError_t launch(const OA& A, const OB& B, int M, int N, int K,
                   int batches, int splits, const Epi& epi, cudaStream_t st) {
  constexpr int T = (BM / TM) * (BN / 8);
  // the loader steps along the contiguous axis with stride 1
  if ((AKC ? A.ks : A.rs) != 1 || (BKC ? B.ks : B.rs) != 1)
    return cudaErrorInvalidValue;
  if (kChunked<Epi> && N % 4 != 0) return cudaErrorInvalidValue;
  int kchunk = (K + splits - 1) / splits;
  kchunk = (kchunk + BK - 1) / BK * BK;
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM, batches * splits);
  // a group stride applies only past an operand's first group
  const bool grouped = ((A.gs0 || A.gs1) && batches > A.zg) ||
                       ((B.gs0 || B.gs1) && batches > B.zg);
  if (grouped)
    gemm_kernel<BM, BN, TM, AKC, BKC, MINB, true, OA, OB, Epi>
        <<<grid, T, 0, st>>>(A, B, M, N, K, splits, kchunk, epi);
  else
    gemm_kernel<BM, BN, TM, AKC, BKC, MINB, false, OA, OB, Epi>
        <<<grid, T, 0, st>>>(A, B, M, N, K, splits, kchunk, epi);
  return cudaGetLastError();
}


// ---------------------------------------------------------------------
// The tensor-core core: the same product, operands, loader and epilogues,
// its multiply as 3xTF32 on mma.sync (see the top).

constexpr int TBK = 16;    // depth of a slice

// A TBK-deep slice of an operand's ROWS rows in shared memory: row-major
// (k contiguous, row stride TBK + 4, = 20 (mod 32)) where the operand's k
// is contiguous in global memory (KC), so that groups of 4 copy as 16
// bytes; else k-major (row stride ROWS + 8, = 8 (mod 32)).  Either stride
// puts the 32 lanes of a fragment's read (8 rows g x 4 k q) on 32 banks.
template <int ROWS, bool KC>
struct TcSlice {
  static constexpr int DK = KC ? 1 : ROWS + 8;       // a step along k
  static constexpr int DR = KC ? TBK + 4 : 1;        // a step along rows
  static constexpr int SIZE = KC ? ROWS * (TBK + 4) : TBK * (ROWS + 8);
  static_assert(KC ? (TBK + 4) % 8 == 4 : (ROWS + 8) % 32 == 8,
                "a fragment's 32 lanes on 32 banks");
};

// x rounded to TF32 (10 stored bits), to nearest, ties away from zero, as
// cvt.rna.tf32.f32 rounds a finite x: half a TF32 unit added to the
// magnitude's bits, the 13 low bits cleared (two integer operations)
__device__ __forceinline__ unsigned tf32_rna(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// x = big + small to 2^-22 of |x|, each a TF32 value
__device__ __forceinline__ void split_tf32(float x, unsigned& big,
                                           unsigned& small) {
  big = tf32_rna(x);
  small = tf32_rna(x - __uint_as_float(big));
}

// d += a b on one m16n8k8 tile (a row-major 16 x 8, b 8 x 8 by columns)
__device__ __forceinline__ void mma_tf32(float* d, const unsigned* a,
                                         const unsigned* b) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// d = a b on one m16n8k8 tile
__device__ __forceinline__ void mma_tf32_0(float* d, const unsigned* a,
                                           const unsigned* b) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%10, %10, %10, %10};\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]),
        "f"(0.0f));
}

// The shared memory of a launch_tc tile: STAGES slices of both operands.
template <int BM, int BN, bool AKC, bool BKC>
constexpr int tc_smem_bytes() {
  return STAGES * (TcSlice<BM, AKC>::SIZE + TcSlice<BN, BKC>::SIZE) *
         (int)sizeof(float);
}

// A BM x BN tile by (BM / WM) x (BN / WN) warps, each a WM x WN tile of
// m16n8k8 products.  Lane (g, q) = (lane / 4, lane % 4) holds rows g and
// g + 8 of each m16 tile, columns 2q and 2q + 1 of each n8 tile.
template <int BM, int BN, int WM, int WN, bool AKC, bool BKC, int MINB,
          bool GROUPED, class OA, class OB, class Epi>
__global__ void __launch_bounds__((BM / WM) * (BN / WN) * 32, MINB)
    gemm_tc_kernel(const OA A, const OB B, int M, int N, int K, int splits,
                   int kchunk, const Epi epi_all) {
  constexpr int WR = BM / WM, T = WR * (BN / WN) * 32;
  constexpr int MT = WM / 16, NT = WN / 8;
  using SA = TcSlice<BM, AKC>;
  using SB = TcSlice<BN, BKC>;
  static_assert(BM % WM == 0 && BN % WN == 0 && WM % 16 == 0 &&
                    WN % 8 == 0 && TBK % 8 == 0,
                "tile shape");
  extern __shared__ __align__(16) float tc_smem[];
  float* const As = tc_smem;
  float* const Bs = tc_smem + STAGES * SA::SIZE;

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int g = lane / 4, q = lane % 4;
  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * BM;
  const int wr = m0 + (warp % WR) * WM, wc = n0 + (warp / WR) * WN;
  const int z = blockIdx.z / splits, s = blockIdx.z % splits;
  const int kb = s * kchunk, ke = min(K, kb + kchunk);
  const int ga = GROUPED ? z / A.zg : 0, gb = GROUPED ? z / B.zg : 0;
  const int nk = ke > kb ? (ke - kb + TBK - 1) / TBK : 0;
  // a warp whose tile holds no row < M or no column < N multiplies
  // nothing (the rest of a tile's rows and columns, zeros, are multiplied
  // and not stored)
  const bool live = wr < M && wc < N;

  float acc[MT][NT][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.0f;

#pragma unroll
  for (int p = 0; p < STAGES - 1; ++p) {
    if (p < nk) {
      load_slice<BM, AKC, T, TBK, SA::DK, SA::DR>(
          As + p * SA::SIZE, A, z, ga, m0, M, kb + p * TBK, ke, tid);
      load_slice<BN, BKC, T, TBK, SB::DK, SB::DR>(
          Bs + p * SB::SIZE, B, z, gb, n0, N, kb + p * TBK, ke, tid);
    }
    cp_async_commit();
  }
  for (int t = 0; t < nk; ++t) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();
    const int p = t + STAGES - 1, nb = p % STAGES;
    if (p < nk) {
      load_slice<BM, AKC, T, TBK, SA::DK, SA::DR>(
          As + nb * SA::SIZE, A, z, ga, m0, M, kb + p * TBK, ke, tid);
      load_slice<BN, BKC, T, TBK, SB::DK, SB::DR>(
          Bs + nb * SB::SIZE, B, z, gb, n0, N, kb + p * TBK, ke, tid);
    }
    cp_async_commit();
    // the lane's (row g, k q) of the warp's tile in slice t
    const float* as =
        As + (t % STAGES) * SA::SIZE + (wr - m0 + g) * SA::DR + q * SA::DK;
    const float* bs =
        Bs + (t % STAGES) * SB::SIZE + (wc - n0 + g) * SB::DR + q * SB::DK;
    const int kn = ke - kb - t * TBK;   // the slice's depth inside k < ke
#pragma unroll
    for (int k8 = 0; k8 < TBK; k8 += 8) {
      if (k8 >= kn || !live) break;
      // each operand value split as it is read: b = bb + bs_ (all of the
      // warp's n8 tiles), a = ab + as_ (an m16 tile at a time); no guard
      // inside, so that the tiles' products interleave
      unsigned bb[NT][2], bs_[NT][2];
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const float* x = bs + k8 * SB::DK + j * 8 * SB::DR;
        split_tf32(x[0], bb[j][0], bs_[j][0]);             // (k q, n g)
        split_tf32(x[4 * SB::DK], bb[j][1], bs_[j][1]);    // (k q + 4, n g)
      }
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        unsigned ab[4], as_[4];
        const float* x = as + k8 * SA::DK + i * 16 * SA::DR;
        constexpr int r8 = 8 * SA::DR, k4 = 4 * SA::DK;
        split_tf32(x[0], ab[0], as_[0]);             // (g, q)
        split_tf32(x[r8], ab[1], as_[1]);            // (g + 8, q)
        split_tf32(x[k4], ab[2], as_[2]);            // (g, q + 4)
        split_tf32(x[r8 + k4], ab[3], as_[3]);       // (g + 8, q + 4)
        // the step's three products into a partial sum, the small terms
        // first (small x small, 2^-22 of the product, left out), then
        // into the accumulator by an f32 add: the tensor cores round
        // their sums toward zero, which summed into the accumulator
        // itself would lose up to a unit of it a product, always the same
        // way (tests/test_torch_tf32x3.py)
        float part[NT][4];
#pragma unroll
        for (int j = 0; j < NT; ++j) mma_tf32_0(part[j], as_, bb[j]);
#pragma unroll
        for (int j = 0; j < NT; ++j) mma_tf32(part[j], ab, bs_[j]);
#pragma unroll
        for (int j = 0; j < NT; ++j) mma_tf32(part[j], ab, bb[j]);
#pragma unroll
        for (int j = 0; j < NT; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[i][j][e] += part[j][e];
      }
    }
  }
  cp_async_wait<0>();
  const Epi epi = batch_epilogue(epi_all, z, 0);

  // The epilogue as gemm_kernel's, on its thread layout: the accumulators
  // pass through shared memory (the ring, free now), one row of warps at
  // a time, WM rows x BN columns (row stride BN + 8, = 8 (mod 32): each
  // lane's float2 of a fragment row on its own banks); then thread (tr,
  // tc) takes rows tr, tr + 16, ... and the 4-wide chunks at columns 4 tc
  // and 4 tc + BN / 2, so that a warp's loads and stores cover two rows of
  // consecutive columns.  A row at a time: first every global value its
  // epilogue reads, then the epilogue (its stores would otherwise order
  // each later load behind them).
  constexpr int CS = BN + 8, TCOL = 16, TROW = T / TCOL;
  static_assert(BN == 8 * TCOL && WM % TROW == 0 &&
                    WM * CS <= STAGES * (SA::SIZE + SB::SIZE),
                "the epilogue's layout");
  float* const cs = tc_smem;
  const int tc = tid % TCOL, tr = tid / TCOL;
#pragma unroll 1
  for (int pass = 0; pass < WR; ++pass) {
    __syncthreads();   // the ring's last reads, or the last pass's
    if (warp % WR == pass) {
#pragma unroll
      for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int j = 0; j < NT; ++j)
#pragma unroll
          for (int h = 0; h < 2; ++h)
            *reinterpret_cast<float2*>(
                cs + (i * 16 + g + h * 8) * CS + (wc - n0) + j * 8 + 2 * q) =
                make_float2(acc[i][j][2 * h], acc[i][j][2 * h + 1]);
    }
    __syncthreads();
    const int rp = m0 + pass * WM;   // the pass's first row
#pragma unroll
    for (int i = 0; i < WM / TROW; ++i) {
      const int rl = i * TROW + tr, r = rp + rl;
      if (r >= M) continue;
      float4 v[2];
#pragma unroll
      for (int h = 0; h < 2; ++h)
        v[h] = *reinterpret_cast<const float4*>(cs + rl * CS + h * (BN / 2) +
                                                tc * 4);
      if constexpr (kChunked<Epi>) {
        typename Epi::In in[2];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int c = n0 + h * (BN / 2) + tc * 4;
          if (c < N) in[h] = epi.load(z, r, c);
        }
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int c = n0 + h * (BN / 2) + tc * 4;
          if (c < N) epi(z, r, c, v[h], in[h]);
        }
      } else {
        const float a[8] = {v[0].x, v[0].y, v[0].z, v[0].w,
                            v[1].x, v[1].y, v[1].z, v[1].w};
        typename Epi::In in[8];
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int c = n0 + (j / 4) * (BN / 2) + tc * 4 + j % 4;
          if (c < N) in[j] = epi.load(z, r, c);
        }
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int c = n0 + (j / 4) * (BN / 2) + tc * 4 + j % 4;
          if (c < N) epi(z, r, c, a[j], in[j]);
        }
      }
    }
  }
}

// Lets `kernel` take `bytes` of dynamic shared memory (above 48 KB only
// after this call).
template <class Kernel>
cudaError_t allow_smem(Kernel* kernel, int bytes) {
  return bytes > 48 * 1024
             ? cudaFuncSetAttribute(
                   kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes)
             : cudaSuccess;
}

// launch's counterpart on the tensor cores: out = A B^T in 3xTF32, f32
// operands only (the tile WM x WN a warp).
template <int BM, int BN, int WM, int WN, bool AKC, bool BKC, int MINB,
          class OA, class OB, class Epi>
cudaError_t launch_tc(const OA& A, const OB& B, int M, int N, int K,
                      int batches, int splits, const Epi& epi,
                      cudaStream_t st) {
  static_assert(OA::kF32 && OB::kF32, "the tensor-core core reads f32");
  constexpr int T = (BM / WM) * (BN / WN) * 32;
  constexpr int smem = tc_smem_bytes<BM, BN, AKC, BKC>();
  if ((AKC ? A.ks : A.rs) != 1 || (BKC ? B.ks : B.rs) != 1)
    return cudaErrorInvalidValue;
  if (kChunked<Epi> && N % 4 != 0) return cudaErrorInvalidValue;
  int kchunk = (K + splits - 1) / splits;
  kchunk = (kchunk + TBK - 1) / TBK * TBK;
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM, batches * splits);
  const bool grouped = ((A.gs0 || A.gs1) && batches > A.zg) ||
                       ((B.gs0 || B.gs1) && batches > B.zg);
  if (grouped) {
    auto* k = gemm_tc_kernel<BM, BN, WM, WN, AKC, BKC, MINB, true, OA, OB,
                             Epi>;
    static const cudaError_t attr = allow_smem(k, smem);
    if (attr != cudaSuccess) return attr;
    k<<<grid, T, smem, st>>>(A, B, M, N, K, splits, kchunk, epi);
  } else {
    auto* k = gemm_tc_kernel<BM, BN, WM, WN, AKC, BKC, MINB, false, OA, OB,
                             Epi>;
    static const cudaError_t attr = allow_smem(k, smem);
    if (attr != cudaSuccess) return attr;
    k<<<grid, T, smem, st>>>(A, B, M, N, K, splits, kchunk, epi);
  }
  return cudaGetLastError();
}

}  // namespace gemm
