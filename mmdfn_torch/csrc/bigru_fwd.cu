// Masked bidirectional GRU layer forward: the hidden recurrence of one layer,
// both directions, with the time loop inside the kernel.
//
// Replaces: mmdfn_tpu/ops/pallas_rnn.py:_bigru_fwd (kernel body _fwd_kernel).
//
// Semantics (torch GRU gate order r, z, n):
//   hg  = h @ W_hh + b_hh
//   r   = sigmoid(xr + hr);  z = sigmoid(xz + hz);  n = tanh(xn + r * hn)
//   h'  = (1 - z) * n + z * h
//   h_t = mask[b, t] > 0 ? h' : h          (a select, never a multiply)
// The forward direction walks t = 0..L-1, the backward direction walks the
// same arrays from t = L-1 down to 0.  A masked frame outputs the carried
// state, so a mask with holes (the CRN party streams) selects a subsequence.
// In training mode the kernel also writes hg (B, L, 3H) per direction, the
// gate pre-activations that the backward (bigru_bwd.cu) reads instead of
// recomputing them.
//
// Bound: a serial chain of L dependent steps.  Each step multiplies 1-4
// rows by the 100 x 300 W_hh: far below one tensor-core tile, and the bytes
// and FLOPs of a whole launch are tens of microseconds of the card's rates
// at most, so the kernel is bound by the latency of one step: the product,
// the gate math and the barrier that publishes the new h.
//
// Design (the persistent-RNN layout, Diamos et al., ICML 2016):
// - one block per (direction, tile of BT batch rows); BT in {1, 2, 4} is
//   chosen by the caller, the fewest rows for which the grid fits the card
//   in one wave, and 4 (more than one wave) beyond that;
// - W_hh lives in registers for the whole loop: thread (i, s) of
//   kUnits x kS holds the three gate columns i, H+i, 2H+i of hidden unit i
//   over slice s of the k axis (kK = 25 values each, 75 registers; with
//   416 such threads and the fetching warp, 14 warps, a thread may hold
//   128 registers, which keeps every BT variant free of spills, where 8
//   lanes of 13 values and 800 threads left 72 and spilled);
// - the kS lanes of unit i sit in one warp and sum their partials by
//   shuffles: a reduce-scatter leaves each lane the finished sums of one
//   row (lanes order their rows so that what they keep comes first, so
//   the exchange needs no selects), and those lanes apply the gate math of
//   unit i for their rows at once, with no barrier between the product and
//   the gates;
// - h is double-buffered in shared memory, each row laid out by k slices
//   (stride kKP = 28, conflict-free float4 broadcasts), so a step has one
//   __syncthreads;
// - a ring of kRing slots in shared memory holds xg and the mask of the next
//   kDepth steps, which one more warp fetches with cp.async while the others
//   compute, so the recurrence's warps make no copies.
//
// C interface: pointers are device pointers; the stream is the caller's.
// hg_f / hg_b are null in serve mode.  Returns cudaErrorInvalidValue for an
// H or BT the kernel does not take, else cudaGetLastError() after the launch.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kH = 100;                   // hidden width: the port's only one
constexpr int kG = 3 * kH;
constexpr int kLogS = 2;
constexpr int kS = 1 << kLogS;            // lanes per hidden unit (k slices)
constexpr int kK = (kH + kS - 1) / kS;    // 25 k per slice
constexpr int kKP = 28;                   // a slice's stride in shared memory
constexpr int kRow = kS * kKP;            // one h row, laid out by slices
constexpr int kUnits = 104;               // kH, padded to whole warps
constexpr int kCompute = kUnits * kS;     // 416 threads: the recurrence
constexpr int kThreads = kCompute + 32;   // and one warp that fetches
constexpr int kDepth = 4;                 // steps fetched ahead
constexpr int kRing = kDepth + 1;

__device__ __forceinline__ float sigmoidf_(float x) {
  return 1.0f / (1.0f + expf(-x));
}

// where hidden index k sits in a row laid out by slices
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
// p ^ xor_of(s): then at each stage of the reduce-scatter the rows it keeps
// are the first half of its positions, and its partner sends the same rows
// in the same positions.  The lane finishes row xor_of(s), at position 0.
template <int BT>
__device__ __forceinline__ int xor_of(int s) {
  return (s << log2_rows<BT>()) >> kLogS;
}

// v holds this lane's partial sums of 3 gates at each of BT positions.
// After the call v[0 .. 3) hold the full sums over the kS lanes of the unit
// for the lane's row: a reduce-scatter while more than one position is
// left, then a butterfly over the remaining lane bits.
template <int BT>
__device__ __forceinline__ void reduce_rows(float (&v)[3 * BT]) {
  static_assert(BT <= kS, "each lane finishes one row");
#pragma unroll
  for (int st = 0; st < kLogS; ++st) {
    const int o = (kS / 2) >> st;
    const int n = 3 * (BT >> st);
    if ((BT >> st) > 1) {
#pragma unroll
      for (int q = 0; q < n / 2; ++q)
        v[q] += __shfl_xor_sync(0xffffffffu, v[q + n / 2], o);
    } else {
#pragma unroll
      for (int q = 0; q < 3; ++q)
        v[q] += __shfl_xor_sync(0xffffffffu, v[q], o);
    }
  }
}

// xg rows and mask values of time t for the block's rows, into one slot
template <int BT>
__device__ __forceinline__ void fetch(float* slot, const float* xg,
                                      const float* mask, int b0, int nb,
                                      int t, int L, int lane) {
  for (int r = 0; r < nb; ++r) {
    const float* src = xg + ((long long)(b0 + r) * L + t) * kG;
    for (int v = 4 * lane; v < kG; v += 4 * 32)
      cp_async16(slot + r * kG + v, src + v);
  }
  if (lane < nb)
    cp_async4(slot + BT * kG + lane, mask + (long long)(b0 + lane) * L + t);
}

// one direction's walk; kDir is 0 (forward) or 1 (backward), fixed at
// compile time so that its operands stay kernel parameters, not registers
template <int BT, bool kTrain, int kDir>
__device__ __forceinline__ void fwd_walk(
    const float* __restrict__ xg, const float* __restrict__ w,
    const float* __restrict__ bias, long long s0, long long s1,
    const float* __restrict__ mask, float* __restrict__ ys,
    float* __restrict__ hg, int B, int L) {
  constexpr int kSlot = BT * kG + 8;
  extern __shared__ __align__(16) float smem[];
  float* h_s = smem;                      // [2][BT][kRow]
  float* ring = smem + 2 * BT * kRow;     // [kRing][kSlot]

  const int b0 = blockIdx.y * BT;
  const int nb = min(BT, B - b0);
  const int tid = threadIdx.x;
  auto time_of = [L](int step) { return kDir == 0 ? step : L - 1 - step; };

  for (int e = tid; e < 2 * BT * kRow; e += kThreads) h_s[e] = 0.0f;

  if (tid >= kCompute) {
    // the producer warp: step + kDepth's inputs into the slot that step - 1
    // read, and step + 1's landed before each barrier
    const int lane = tid - kCompute;
    for (int q = 0; q < kDepth; ++q) {
      if (q < L)
        fetch<BT>(ring + q * kSlot, xg, mask, b0, nb, time_of(q), L, lane);
      cp_commit();
    }
    cp_wait<kDepth - 1>();
    __syncthreads();
    for (int step = 0; step < L; ++step) {
      const int q = step + kDepth;
      if (q < L)
        fetch<BT>(ring + (q % kRing) * kSlot, xg, mask, b0, nb, time_of(q),
                  L, lane);
      cp_commit();
      cp_wait<kDepth - 1>();
      __syncthreads();
    }
    return;
  }

  const int i = tid / kS, s = tid % kS;
  // columns i, H+i, 2H+i of W_hh over k slice s, for the whole loop
  float wr[3][kK];
#pragma unroll
  for (int g = 0; g < 3; ++g)
#pragma unroll
    for (int q = 0; q < kK; ++q) {
      const int k = s * kK + q;
      wr[g][q] = k < kH && i < kH ? w[k * s0 + (g * kH + i) * s1] : 0.0f;
    }
  // the lanes that share rows (BT < kS) compute alike; the first stores
  constexpr int kShare = BT >= kS ? 1 : kS / BT;
  const bool writer = s % kShare == 0 && i < kH;
  const int r = xor_of<BT>(s);           // the row this lane finishes
  const int hpos = slot_of(i);
  __syncthreads();

  for (int step = 0; step < L; ++step) {
    const int t = time_of(step);
    const float* hc = h_s + (step & 1) * BT * kRow;
    float* hn = h_s + ((step + 1) & 1) * BT * kRow;

    // this lane's partials of h @ W_hh, row p ^ r at position p
    float acc[3 * BT];
#pragma unroll
    for (int p = 0; p < BT; ++p) {
      const float* hr = hc + (p ^ r) * kRow + s * kKP;
      float a0 = 0.0f, a1 = 0.0f, a2 = 0.0f;
#pragma unroll
      for (int q4 = 0; q4 < kK / 4; ++q4) {
        const float4 h4 = *reinterpret_cast<const float4*>(hr + 4 * q4);
        const float hv[4] = {h4.x, h4.y, h4.z, h4.w};
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          a0 = fmaf(hv[u], wr[0][4 * q4 + u], a0);
          a1 = fmaf(hv[u], wr[1][4 * q4 + u], a1);
          a2 = fmaf(hv[u], wr[2][4 * q4 + u], a2);
        }
      }
#pragma unroll
      for (int q = kK / 4 * 4; q < kK; ++q) {
        a0 = fmaf(hr[q], wr[0][q], a0);
        a1 = fmaf(hr[q], wr[1][q], a1);
        a2 = fmaf(hr[q], wr[2][q], a2);
      }
      acc[3 * p] = a0;
      acc[3 * p + 1] = a1;
      acc[3 * p + 2] = a2;
    }
    reduce_rows<BT>(acc);

    const float* slot = ring + (step % kRing) * kSlot;
    if (r < nb && i < kH) {
      const float* x = slot + r * kG;
      const float m = slot[BT * kG + r];
      const float ghr = acc[0] + __ldg(bias + i);
      const float ghz = acc[1] + __ldg(bias + kH + i);
      const float ghn = acc[2] + __ldg(bias + 2 * kH + i);
      const float hprev = hc[r * kRow + hpos];
      const float rg = sigmoidf_(x[i] + ghr);
      const float zg = sigmoidf_(x[kH + i] + ghz);
      const float ng = tanhf(x[2 * kH + i] + rg * ghn);
      const float hnew = (1.0f - zg) * ng + zg * hprev;
      const float hout = m > 0.0f ? hnew : hprev;
      if (writer) {
        const long long row = (long long)(b0 + r) * L + t;
        hn[r * kRow + hpos] = hout;
        ys[row * kH + i] = hout;
        if (kTrain) {
          hg[row * kG + i] = ghr;
          hg[row * kG + kH + i] = ghz;
          hg[row * kG + 2 * kH + i] = ghn;
        }
      }
    }
    __syncthreads();
  }
}

template <int BT, bool kTrain>
__global__ void __launch_bounds__(kThreads, 1) bigru_fwd_kernel(
    const float* __restrict__ xg_f, const float* __restrict__ xg_b,
    const float* __restrict__ w_f, const float* __restrict__ b_f,
    const float* __restrict__ w_b, const float* __restrict__ b_b,
    long long w_f_s0, long long w_f_s1, long long w_b_s0, long long w_b_s1,
    const float* __restrict__ mask, float* __restrict__ ys_f,
    float* __restrict__ ys_b, float* __restrict__ hg_f,
    float* __restrict__ hg_b, int B, int L) {
  if (blockIdx.x == 0)
    fwd_walk<BT, kTrain, 0>(xg_f, w_f, b_f, w_f_s0, w_f_s1, mask, ys_f, hg_f,
                            B, L);
  else
    fwd_walk<BT, kTrain, 1>(xg_b, w_b, b_b, w_b_s0, w_b_s1, mask, ys_b, hg_b,
                            B, L);
}

template <int BT, bool kTrain>
int launch(const float* xg_f, const float* xg_b, const float* w_f,
           const float* b_f, const float* w_b, const float* b_b,
           long long w_f_s0, long long w_f_s1, long long w_b_s0,
           long long w_b_s1, const float* mask, float* ys_f, float* ys_b,
           float* hg_f, float* hg_b, int B, int L, cudaStream_t st) {
  const size_t smem = sizeof(float) * (2 * BT * kRow + kRing * (BT * kG + 8));
  auto kernel = bigru_fwd_kernel<BT, kTrain>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<dim3(2, (B + BT - 1) / BT), kThreads, smem, st>>>(
      xg_f, xg_b, w_f, b_f, w_b, b_b, w_f_s0, w_f_s1, w_b_s0, w_b_s1, mask,
      ys_f, ys_b, hg_f, hg_b, B, L);
  return (int)cudaGetLastError();
}

template <bool kTrain>
int dispatch(int BT, const float* xg_f, const float* xg_b, const float* w_f,
             const float* b_f, const float* w_b, const float* b_b,
             long long w_f_s0, long long w_f_s1, long long w_b_s0,
             long long w_b_s1, const float* mask, float* ys_f, float* ys_b,
             float* hg_f, float* hg_b, int B, int L, cudaStream_t st) {
#define BIGRU_FWD_CASE(N)                                                    \
  case N:                                                                    \
    return launch<N, kTrain>(xg_f, xg_b, w_f, b_f, w_b, b_b, w_f_s0, w_f_s1, \
                             w_b_s0, w_b_s1, mask, ys_f, ys_b, hg_f, hg_b, B, \
                             L, st);
  switch (BT) {
    BIGRU_FWD_CASE(1)
    BIGRU_FWD_CASE(2)
    BIGRU_FWD_CASE(4)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef BIGRU_FWD_CASE
}

}  // namespace

extern "C" int bigru_fwd(const float* xg_f, const float* xg_b,
                         const float* w_f, const float* b_f,
                         const float* w_b, const float* b_b,
                         long long w_f_s0, long long w_f_s1,
                         long long w_b_s0, long long w_b_s1,
                         const float* mask, float* ys_f, float* ys_b,
                         float* hg_f, float* hg_b, int B, int L, int H,
                         int BT, void* stream) {
  if (H != kH) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (hg_f != nullptr)
    return dispatch<true>(BT, xg_f, xg_b, w_f, b_f, w_b, b_b, w_f_s0, w_f_s1,
                          w_b_s0, w_b_s1, mask, ys_f, ys_b, hg_f, hg_b, B, L,
                          st);
  return dispatch<false>(BT, xg_f, xg_b, w_f, b_f, w_b, b_b, w_f_s0, w_f_s1,
                         w_b_s0, w_b_s1, mask, ys_f, ys_b, hg_f, hg_b, B, L,
                         st);
}
