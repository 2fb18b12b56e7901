// Masked bidirectional GRU layer backward (BPTT), both directions, with the
// time loop inside the kernel.
//
// Replaces: mmdfn_tpu/ops/pallas_rnn.py:_bigru_bwd (kernel body _bwd_kernel).
//
// Semantics, per direction (torch GRU gate order r, z, n).  BPTT walks the
// forward walk backwards: the forward direction from t = L-1 down to 0, the
// backward direction from t = 0 up.  h_prev is the walk-order previous
// output (ys_f[t-1] forward, ys_b[t+1] backward, zero at the walk's start),
// and hg = h_prev @ W_hh + b_hh is the one the forward's training mode
// saved (bigru_fwd.cu), so no gate is recomputed:
//   r, z, n as in the forward, from xg[t] and hg[t]
//   dh     += dy[t]
//   dh_eff  = m ? dh : 0
//   dz = dh_eff (h_prev - n) z (1 - z);  dn = dh_eff (1 - z)(1 - n^2)
//   dr = dn hn r (1 - r)
//   dhg[t]  = m ? [dr, dz, dn r] : 0;   dxg[t] = m ? [dr, dz, dn] : 0
//   dh      = m ? dh_eff z + dhg[t] @ W_hh^T : dh
// and after the time loop
//   dW_hh = sum_{b,t} h_prev[b,t]^T dhg[b,t];  db_hh = sum_{b,t} dhg[b,t]
// Masked frames are selected away, never multiplied, so a non-finite value
// parked in one reaches no gradient.
//
// Bound: the time loop is a serial chain of L dependent steps, each one
// (BT, 3H) x (3H, H) product per block: latency-bound like the forward.
// The weight gradient is one (H+1) x (B L) x 3H product per direction
// (~1.9 GFLOP at B = 192, L = 80): bound by FP32 operations, and free of
// the chain once it leaves the time loop.
//
// Design: the forward's persistent-RNN layout (see bigru_fwd.cu).
// - One block per (direction, tile of BT rows), BT in {1, 2, 4} chosen by
//   the caller.
// - W_hh in registers: thread (i, s) holds W_hh[i, g H + k] for the three
//   gates g and k in slice s (75 values, 416 threads); the kS lanes of unit
//   i reduce dhg @ W_hh^T over j by a reduce-scatter of shuffles, which
//   leaves each lane the sums of one row.
// - The same lanes first compute unit i's cotangents from xg, hg, h_prev,
//   dy and the mask, which one more warp brings kDepth steps ahead into a
//   ring of shared slots with cp.async, and write dhg into a
//   double-buffered shared slot: one __syncthreads per step.  The gates do
//   not depend on the carried dh, so they are computed a step ahead,
//   beside the product, and only a few multiplies wait for dh.
// - dW_hh / db_hh leave the loop: each step writes dhg to a (B, L, 3H)
//   scratch beside dxg, and a second kernel computes [h_prev, 1]^T dhg as a
//   tiled A^T B over fixed row splits (64 x 64 tiles, 4 x 4 per thread),
//   both directions in one launch; a third sums the splits in split order.
//   No atomics: the gradients are the same bit for bit from run to run.
//
// C interface: pointers are device pointers; the stream is the caller's.
// dhg_f / dhg_b are (B, L, 3H) scratch; part holds 2 * splits * (H+1) * 3H
// floats with splits = ceil(B L / split_rows); dwb (2, H+1, 3H) receives
// [dW_hh; db_hh] of each direction.  Returns cudaErrorInvalidValue for an
// H or BT the kernel does not take, else cudaGetLastError() after the
// launches.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kH = 100;                   // hidden width: the port's only one
constexpr int kG = 3 * kH;
constexpr int kLogS = 2;
constexpr int kS = 1 << kLogS;            // lanes per hidden unit (j slices)
constexpr int kK = (kH + kS - 1) / kS;    // 25 per gate and slice
constexpr int kKP = 28;                   // a slice's stride in shared memory
constexpr int kRow = kS * kKP;            // one gate of a dhg row, by slices
constexpr int kUnits = 104;               // kH, padded to whole warps
constexpr int kCompute = kUnits * kS;     // 416 threads: the recurrence
constexpr int kThreads = kCompute + 32;   // and one warp that fetches
constexpr int kDepth = 4;                 // steps fetched ahead
constexpr int kRing = kDepth + 1;
// per row of a ring slot: xg, hg (3H each), h_prev, dy (H each), padded so
// that the rows of a warp's lanes fall in distinct banks
constexpr int kXg = 0, kHg = kG, kHp = 2 * kG, kDy = 2 * kG + kH;
constexpr int kPerRow = 2 * kG + 2 * kH + 8;

// the weight-gradient product
constexpr int kWM = 64, kWN = 64, kWR = 32, kWThreads = 256;

__device__ __forceinline__ float sigmoidf_(float x) {
  return 1.0f / (1.0f + expf(-x));
}

__device__ __forceinline__ int slot_of(int k) {
  return (k / kK) * kKP + k % kK;
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
               "l"(src) : "memory");
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

template <int BT>
__host__ __device__ constexpr int log2_rows() {
  return BT == 1 ? 0 : BT == 2 ? 1 : 2;
}

// Lane s of a unit orders its BT rows so that position p holds row
// p ^ xor_of(s), as in bigru_fwd.cu: the rows it keeps at each stage of the
// reduce-scatter come first, and its partner sends them in the same places.
// The lane finishes row xor_of(s), at position 0.
template <int BT>
__device__ __forceinline__ int xor_of(int s) {
  return (s << log2_rows<BT>()) >> kLogS;
}

// v holds this lane's partial sums at each of BT positions; afterwards
// v[0] holds the full sum over the kS lanes of the unit for the lane's row.
template <int BT>
__device__ __forceinline__ void reduce_rows(float (&v)[BT]) {
  static_assert(BT <= kS, "each lane finishes one row");
#pragma unroll
  for (int st = 0; st < kLogS; ++st) {
    const int o = (kS / 2) >> st;
    const int n = BT >> st;
    if (n > 1) {
#pragma unroll
      for (int q = 0; q < n / 2; ++q)
        v[q] += __shfl_xor_sync(0xffffffffu, v[q + n / 2], o);
    } else {
      v[0] += __shfl_xor_sync(0xffffffffu, v[0], o);
    }
  }
}

// n floats (a multiple of 4) from src to dst, over the producer warp
__device__ __forceinline__ void copy_row(float* dst, const float* src, int n,
                                         int lane) {
  for (int v = 4 * lane; v < n; v += 4 * 32) cp_async16(dst + v, src + v);
}

// xg, hg, h_prev, dy and the mask of time t for the block's rows
template <int BT>
__device__ __forceinline__ void fetch(float* slot, const float* xg,
                                      const float* hg, const float* ys,
                                      const float* dy, const float* mask,
                                      int b0, int nb, int t, int tp, int L,
                                      int lane) {
  const bool has_prev = tp >= 0 && tp < L;
  for (int r = 0; r < nb; ++r) {
    const long long row = (long long)(b0 + r) * L + t;
    float* d = slot + r * kPerRow;
    copy_row(d + kXg, xg + row * kG, kG, lane);
    copy_row(d + kHg, hg + row * kG, kG, lane);
    if (has_prev) copy_row(d + kHp, ys + (row + tp - t) * kH, kH, lane);
    copy_row(d + kDy, dy + row * kH, kH, lane);
  }
  if (lane < nb)
    cp_async4(slot + BT * kPerRow + lane, mask + (long long)(b0 + lane) * L + t);
}

// What a step's cotangents need besides the carried dh: the mask, dy,
// h_prev and the gates, read from the step's ring slot.  The gates do not
// depend on dh, so they are computed one step ahead, beside the product.
struct StepIn {
  bool m;
  float dy, hp, hn, rg, zg, ng;
};

template <int BT>
__device__ __forceinline__ StepIn step_in(const float* slot, int r, int i,
                                          bool has_prev) {
  const float* d = slot + r * kPerRow;
  StepIn a;
  a.m = slot[BT * kPerRow + r] > 0.0f;
  a.dy = d[kDy + i];
  a.hp = has_prev ? d[kHp + i] : 0.0f;
  a.hn = d[kHg + 2 * kH + i];
  a.rg = sigmoidf_(d[kXg + i] + d[kHg + i]);
  a.zg = sigmoidf_(d[kXg + kH + i] + d[kHg + kH + i]);
  a.ng = tanhf(d[kXg + 2 * kH + i] + a.rg * a.hn);
  return a;
}

// one direction's walk; kDir is 0 (forward) or 1 (backward), fixed at
// compile time so that its operands stay kernel parameters, not registers
template <int BT, int kDir>
__device__ __forceinline__ void bwd_walk(
    const float* __restrict__ xg, const float* __restrict__ hg,
    const float* __restrict__ w, long long s0, long long s1,
    const float* __restrict__ mask, const float* __restrict__ ys,
    const float* __restrict__ dy, float* __restrict__ dxg,
    float* __restrict__ dhg, int B, int L) {
  constexpr int kSlot = BT * kPerRow + 8;
  extern __shared__ __align__(16) float smem[];
  float* dg_s = smem;                     // [2][BT][3][kRow]
  float* ring = smem + 2 * BT * 3 * kRow; // [kRing][kSlot]

  const int b0 = blockIdx.y * BT;
  const int nb = min(BT, B - b0);
  const int tid = threadIdx.x;
  auto time_of = [L](int step) { return kDir == 0 ? L - 1 - step : step; };
  constexpr int shift = kDir == 0 ? -1 : 1;   // h_prev's time is t + shift
  auto has_prev = [L](int t) { return t + shift >= 0 && t + shift < L; };

  // rows past B keep a zero dhg; the slice padding stays zero
  for (int e = tid; e < 2 * BT * 3 * kRow; e += kThreads) dg_s[e] = 0.0f;

  if (tid >= kCompute) {
    // the producer warp: step + kDepth's inputs into the slot that step - 1
    // read, and step + 1's landed before each barrier
    const int lane = tid - kCompute;
    for (int q = 0; q < kDepth; ++q) {
      if (q < L) {
        const int t = time_of(q);
        fetch<BT>(ring + q * kSlot, xg, hg, ys, dy, mask, b0, nb, t,
                  t + shift, L, lane);
      }
      cp_commit();
    }
    cp_wait<kDepth - 1>();
    __syncthreads();
    for (int step = 0; step < L; ++step) {
      const int q = step + kDepth;
      if (q < L) {
        const int tq = time_of(q);
        fetch<BT>(ring + (q % kRing) * kSlot, xg, hg, ys, dy, mask, b0, nb,
                  tq, tq + shift, L, lane);
      }
      cp_commit();
      cp_wait<kDepth - 1>();
      __syncthreads();
    }
    return;
  }

  const int i = tid / kS, s = tid % kS;
  // row i of W_hh over slice s of each gate, for the whole loop
  float wr[3][kK];
#pragma unroll
  for (int g = 0; g < 3; ++g)
#pragma unroll
    for (int q = 0; q < kK; ++q) {
      const int k = s * kK + q;
      wr[g][q] = k < kH && i < kH ? w[i * s0 + (g * kH + k) * s1] : 0.0f;
    }
  // the lanes that share rows (BT < kS) compute alike; the first stores
  constexpr int kShare = BT >= kS ? 1 : kS / BT;
  const bool writer = s % kShare == 0 && i < kH;
  const int r = xor_of<BT>(s);           // the row this lane finishes
  const bool live = r < nb && i < kH;
  const int pos = slot_of(i);
  __syncthreads();

  // the carried dh of row r, and a step's inputs, read one step ahead
  auto read_in = [&](StepIn& in, int step) {
    if (live)
      in = step_in<BT>(ring + (step % kRing) * kSlot, r, i,
                       has_prev(time_of(step)));
  };
  float dh = 0.0f;
  StepIn in;
  in.m = false;
  read_in(in, 0);
  for (int step = 0; step < L; ++step) {
    const int t = time_of(step);
    float* dg = dg_s + (step & 1) * BT * 3 * kRow;

    // unit i's cotangents for row r
    bool m = false;
    float dhz = 0.0f;
    if (live) {
      m = in.m;
      dh += in.dy;
      float dr = 0.0f, dz = 0.0f, dn = 0.0f, dnr = 0.0f;
      if (m) {
        const float zg = in.zg, ng = in.ng, rg = in.rg;
        dz = dh * (in.hp - ng) * zg * (1.0f - zg);
        dn = dh * (1.0f - zg) * (1.0f - ng * ng);
        dr = dn * in.hn * rg * (1.0f - rg);
        dnr = dn * rg;
        dhz = dh * zg;
      }
      if (writer) {
        float* dgr = dg + r * 3 * kRow + pos;
        dgr[0] = dr;
        dgr[kRow] = dz;
        dgr[2 * kRow] = dnr;
        const long long row = (long long)(b0 + r) * L + t;
        dxg[row * kG + i] = dr;
        dxg[row * kG + kH + i] = dz;
        dxg[row * kG + 2 * kH + i] = dn;
        dhg[row * kG + i] = dr;
        dhg[row * kG + kH + i] = dz;
        dhg[row * kG + 2 * kH + i] = dnr;
      }
    }
    __syncthreads();

    // the next step's gates (its slot has landed) beside this step's
    // product dhg @ W_hh^T
    if (step + 1 < L) read_in(in, step + 1);
    // this lane's partials over slice s of each gate, row p ^ r at
    // position p, then reduced: one FMA chain per gate where one or two
    // rows give little parallelism, one per row where four do
    constexpr int kChains = BT >= 4 ? 1 : 3;
    float acc[BT];
#pragma unroll
    for (int p = 0; p < BT; ++p) {
      float a[kChains];
#pragma unroll
      for (int c = 0; c < kChains; ++c) a[c] = 0.0f;
#pragma unroll
      for (int g = 0; g < 3; ++g) {
        const float* dr = dg + ((p ^ r) * 3 + g) * kRow + s * kKP;
        float& ag = a[g % kChains];
#pragma unroll
        for (int q4 = 0; q4 < kK / 4; ++q4) {
          const float4 v = *reinterpret_cast<const float4*>(dr + 4 * q4);
          ag = fmaf(v.x, wr[g][4 * q4], ag);
          ag = fmaf(v.y, wr[g][4 * q4 + 1], ag);
          ag = fmaf(v.z, wr[g][4 * q4 + 2], ag);
          ag = fmaf(v.w, wr[g][4 * q4 + 3], ag);
        }
#pragma unroll
        for (int q = kK / 4 * 4; q < kK; ++q) ag = fmaf(dr[q], wr[g][q], ag);
      }
      acc[p] = a[0];
#pragma unroll
      for (int c = 1; c < kChains; ++c) acc[p] += a[c];
    }
    reduce_rows<BT>(acc);
    if (m) dh = dhz + acc[0];
  }
}

template <int BT>
__global__ void __launch_bounds__(kThreads, 1) bigru_bwd_kernel(
    const float* __restrict__ xg_f, const float* __restrict__ xg_b,
    const float* __restrict__ hg_f, const float* __restrict__ hg_b,
    const float* __restrict__ w_f, const float* __restrict__ w_b,
    long long w_f_s0, long long w_f_s1, long long w_b_s0, long long w_b_s1,
    const float* __restrict__ mask, const float* __restrict__ ys_f,
    const float* __restrict__ ys_b, const float* __restrict__ dy_f,
    const float* __restrict__ dy_b, float* __restrict__ dxg_f,
    float* __restrict__ dxg_b, float* __restrict__ dhg_f,
    float* __restrict__ dhg_b, int B, int L) {
  if (blockIdx.x == 0)
    bwd_walk<BT, 0>(xg_f, hg_f, w_f, w_f_s0, w_f_s1, mask, ys_f, dy_f, dxg_f,
                    dhg_f, B, L);
  else
    bwd_walk<BT, 1>(xg_b, hg_b, w_b, w_b_s0, w_b_s1, mask, ys_b, dy_b, dxg_b,
                    dhg_b, B, L);
}

// this thread's kPer elements of A (column k) and Bm (column j) of the
// chunk at row r0: rows r0 + rr0 + q * row_step
template <int kPer>
__device__ __forceinline__ void wgrad_load(
    float (&an)[kPer], float (&bn)[kPer], const float* __restrict__ ys,
    const float* __restrict__ dg, int r0, int rr0, int row_step, int r_end,
    int k, int j, int L, int shift) {
  int t = (r0 + rr0) % L;                // row's time, stepped along
#pragma unroll
  for (int q = 0; q < kPer; ++q) {
    const int row = r0 + rr0 + q * row_step;
    if (q > 0)
      for (t += row_step; t >= L;) t -= L;
    float av = 0.0f, bv = 0.0f;
    if (row < r_end) {
      const int tp = t + shift;
      if (k < kH) {
        if (tp >= 0 && tp < L) av = ys[(long long)(row + shift) * kH + k];
      } else if (k == kH) {
        av = 1.0f;
      }
      if (j < kG) bv = dg[(long long)row * kG + j];
    }
    an[q] = av;
    bn[q] = bv;
  }
}

// part[dir][split] = [h_prev, 1]^T dhg over the rows of one split:
// A (R, H+1) with row (b, t) = [ys[b, t + shift], 1] (zeros where t + shift
// leaves [0, L)), Bm = dhg (R, 3H); a 64 x 64 output tile per block, 4 x 4
// per thread, over chunks of kWR rows staged in shared memory while the
// next chunk is loaded into registers.
__global__ void __launch_bounds__(kWThreads) bigru_wgrad_kernel(
    const float* __restrict__ ys_f, const float* __restrict__ ys_b,
    const float* __restrict__ dhg_f, const float* __restrict__ dhg_b,
    int B, int L, int split_rows, float* __restrict__ part) {
  constexpr int kPer = kWR * kWM / kWThreads;   // elements per thread
  constexpr int kRowStep = kWThreads / kWM;     // rows apart of those
  __shared__ __align__(16) float a_s[kWR][kWM];
  __shared__ __align__(16) float b_s[kWR][kWN];
  const int splits = gridDim.z / 2;
  const int dir = blockIdx.z / splits, split = blockIdx.z % splits;
  const float* ys = dir == 0 ? ys_f : ys_b;
  const float* dg = dir == 0 ? dhg_f : dhg_b;
  const int shift = dir == 0 ? -1 : 1;
  const int R = B * L;
  const int k0 = blockIdx.y * kWM, j0 = blockIdx.x * kWN;
  const int r_begin = split * split_rows;
  const int r_end = min(R, r_begin + split_rows);
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int c = tid % kWM, rr0 = tid / kWM;
  const int k = k0 + c, j = j0 + c;

  float an[kPer], bn[kPer];
  float acc[4][4];
#pragma unroll
  for (int p = 0; p < 4; ++p)
#pragma unroll
    for (int q = 0; q < 4; ++q) acc[p][q] = 0.0f;
  wgrad_load(an, bn, ys, dg, r_begin, rr0, kRowStep, r_end, k, j, L, shift);
  for (int r0 = r_begin; r0 < r_end; r0 += kWR) {
#pragma unroll
    for (int q = 0; q < kPer; ++q) {
      a_s[rr0 + q * kRowStep][c] = an[q];
      b_s[rr0 + q * kRowStep][c] = bn[q];
    }
    __syncthreads();
    if (r0 + kWR < r_end)
      wgrad_load(an, bn, ys, dg, r0 + kWR, rr0, kRowStep, r_end, k, j, L,
                 shift);
#pragma unroll
    for (int rr = 0; rr < kWR; ++rr) {
      const float4 a = *reinterpret_cast<const float4*>(&a_s[rr][ty * 4]);
      const float4 b = *reinterpret_cast<const float4*>(&b_s[rr][tx * 4]);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int p = 0; p < 4; ++p)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[p][q] = fmaf(av[p], bv[q], acc[p][q]);
    }
    __syncthreads();
  }
  float* out = part + (long long)blockIdx.z * (kH + 1) * kG;
#pragma unroll
  for (int p = 0; p < 4; ++p)
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int kk = k0 + ty * 4 + p, jj = j0 + tx * 4 + q;
      if (kk <= kH && jj < kG) out[kk * kG + jj] = acc[p][q];
    }
}

// dwb[dir][e] = sum over splits of part[dir][split][e], in split order
__global__ void bigru_wgrad_reduce(const float* __restrict__ part,
                                   int splits, float* __restrict__ dwb) {
  constexpr int E = (kH + 1) * kG;
  const int dir = blockIdx.y;
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= E) return;
  const float* p = part + (long long)dir * splits * E + e;
  float acc = 0.0f;
  for (int sp = 0; sp < splits; ++sp) acc += p[(long long)sp * E];
  dwb[dir * E + e] = acc;
}

template <int BT>
int launch(const float* xg_f, const float* xg_b, const float* hg_f,
           const float* hg_b, const float* w_f, const float* w_b,
           long long w_f_s0, long long w_f_s1, long long w_b_s0,
           long long w_b_s1, const float* mask, const float* ys_f,
           const float* ys_b, const float* dy_f, const float* dy_b,
           float* dxg_f, float* dxg_b, float* dhg_f, float* dhg_b, int B,
           int L, cudaStream_t st) {
  const size_t smem =
      sizeof(float) * (2 * BT * 3 * kRow + kRing * (BT * kPerRow + 8));
  auto kernel = bigru_bwd_kernel<BT>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<dim3(2, (B + BT - 1) / BT), kThreads, smem, st>>>(
      xg_f, xg_b, hg_f, hg_b, w_f, w_b, w_f_s0, w_f_s1, w_b_s0, w_b_s1, mask,
      ys_f, ys_b, dy_f, dy_b, dxg_f, dxg_b, dhg_f, dhg_b, B, L);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int bigru_bwd(const float* xg_f, const float* xg_b,
                         const float* hg_f, const float* hg_b,
                         const float* w_f, const float* w_b,
                         long long w_f_s0, long long w_f_s1,
                         long long w_b_s0, long long w_b_s1,
                         const float* mask, const float* ys_f,
                         const float* ys_b, const float* dy_f,
                         const float* dy_b, float* dxg_f, float* dxg_b,
                         float* dhg_f, float* dhg_b, float* part, float* dwb,
                         int B, int L, int H, int BT, int split_rows,
                         void* stream) {
  if (H != kH || split_rows <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  int err;
  switch (BT) {
#define BIGRU_BWD_CASE(N)                                                     \
  case N:                                                                     \
    err = launch<N>(xg_f, xg_b, hg_f, hg_b, w_f, w_b, w_f_s0, w_f_s1, w_b_s0, \
                    w_b_s1, mask, ys_f, ys_b, dy_f, dy_b, dxg_f, dxg_b,       \
                    dhg_f, dhg_b, B, L, st);                                  \
    break;
    BIGRU_BWD_CASE(1)
    BIGRU_BWD_CASE(2)
    BIGRU_BWD_CASE(4)
#undef BIGRU_BWD_CASE
    default:
      return (int)cudaErrorInvalidValue;
  }
  if (err != cudaSuccess) return err;
  const int splits = (B * L + split_rows - 1) / split_rows;
  bigru_wgrad_kernel<<<dim3((kG + kWN - 1) / kWN, (kH + 1 + kWM - 1) / kWM,
                            2 * splits),
                       kWThreads, 0, st>>>(ys_f, ys_b, dhg_f, dhg_b, B, L,
                                           split_rows, part);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  constexpr int E = (kH + 1) * kG;
  bigru_wgrad_reduce<<<dim3((E + 255) / 256, 2), 256, 0, st>>>(part, splits,
                                                               dwb);
  return (int)cudaGetLastError();
}
