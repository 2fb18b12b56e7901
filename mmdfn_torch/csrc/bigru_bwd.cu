// Masked bidirectional GRU layer backward (BPTT), both directions, with the
// time loop inside the kernel.
//
// Replaces: mmdfn_tpu/ops/pallas_rnn.py:_bigru_bwd (kernel body _bwd_kernel).
//
// Semantics, per direction (torch GRU gate order r, z, n).  BPTT walks the
// forward walk backwards: the forward direction from t = L-1 down to 0, the
// backward direction from t = 0 up.  h_prev is the walk-order previous
// output (ys_f[t-1] forward, ys_b[t+1] backward, zero at the walk's start),
// and the gates are recomputed from it:
//   hg = h_prev @ W_hh + b_hh;  r, z, n as in the forward
//   dh     += dy[t]
//   dh_eff  = m ? dh : 0
//   dz = dh_eff (h_prev - n) z (1 - z);  dn = dh_eff (1 - z)(1 - n^2)
//   dr = dn hn r (1 - r)
//   dhg     = m ? [dr, dz, dn r] : 0;   dxg[t] = m ? [dr, dz, dn] : 0
//   dh      = m ? dh_eff z + dhg @ W_hh^T : dh
//   dW_hh  += h_prev^T dhg;  db_hh += sum_rows dhg
// Masked frames are selected away, never multiplied, so a non-finite value
// parked in one reaches no gradient.
//
// Bound: like the forward, a serial chain of L dependent steps.  At the
// training shape of the party streams (B = 192, L = 80, H = 100) the bytes
// (xg, ys, dy in; dxg out: ~98 MB) take ~29 us of the card's memory time
// and the FLOPs (three (B, H) x (H, 3H) products per step and direction:
// ~5.6 GFLOP) ~84 us of its f32 rate; the kernel is bound instead by the
// per-step latency of those small products on one SM per (direction,
// 8 rows), with 48 of the 132 SMs busy.
//
// Design: one block per (direction, tile of kBT batch rows), as kernel A.
// W_hh (H x 3H f32, 120 KB at H = 100) stays in dynamic shared memory,
// laid out [k][j]: thread j reads column j for the gate recompute
// h_prev @ W_hh, and thread i reads row i for dhg @ W_hh^T.  A second copy
// transposed for the latter does not fit beside it (2 x 120 KB > 227 KB),
// so the row reads take a 4-way bank conflict.  Each block accumulates
// dW_hh / db_hh over its own rows into a private slice of a partials
// buffer in device memory (L2-resident: 121 KB per block); a second small
// kernel sums the slices in a fixed order, so the result is deterministic
// run to run (no atomics).
//
// C interface: pointers are device pointers; the stream is the caller's.
// The partials buffer holds 2 * ceil(B / kBT) * (H * 3H + 3H) floats.
// Returns cudaGetLastError() after the launches.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kBT = 8;          // batch rows per block (as kernel A)
constexpr int kThreads = 512;

__device__ __forceinline__ float sigmoidf_(float x) {
  return 1.0f / (1.0f + expf(-x));
}

__global__ void __launch_bounds__(kThreads) bigru_bwd_kernel(
    const float* __restrict__ xg_f, const float* __restrict__ xg_b,
    const float* __restrict__ w_f, const float* __restrict__ b_f,
    const float* __restrict__ w_b, const float* __restrict__ b_b,
    long long w_f_s0, long long w_f_s1, long long w_b_s0, long long w_b_s1,
    const float* __restrict__ mask, const float* __restrict__ ys_f,
    const float* __restrict__ ys_b, const float* __restrict__ dy_f,
    const float* __restrict__ dy_b, float* __restrict__ dxg_f,
    float* __restrict__ dxg_b, float* __restrict__ partials, int B, int L,
    int H) {
  extern __shared__ float smem[];
  const int G = 3 * H;
  float* w_s = smem;                 // [H][3H]
  float* hp_s = w_s + H * G;         // [kBT][H]   h_prev
  float* dh_s = hp_s + kBT * H;      // [kBT][H]   the carried dh
  float* dhz_s = dh_s + kBT * H;     // [kBT][H]   dh_eff * z
  float* hg_s = dhz_s + kBT * H;     // [kBT][3H]
  float* dhg_s = hg_s + kBT * G;     // [kBT][3H]

  const int dir = blockIdx.x;        // 0 forward, 1 backward
  const int tile = blockIdx.y;
  const int b0 = tile * kBT;
  const int nb = min(kBT, B - b0);
  const float* xg = dir == 0 ? xg_f : xg_b;
  const float* w = dir == 0 ? w_f : w_b;
  const float* bias = dir == 0 ? b_f : b_b;
  const long long s0 = dir == 0 ? w_f_s0 : w_b_s0;
  const long long s1 = dir == 0 ? w_f_s1 : w_b_s1;
  const float* ys = dir == 0 ? ys_f : ys_b;
  const float* dy = dir == 0 ? dy_f : dy_b;
  float* dxg = dir == 0 ? dxg_f : dxg_b;
  const long long slice = (long long)H * G + G;
  float* part = partials + ((long long)dir * gridDim.y + tile) * slice;
  const int tid = threadIdx.x;

  for (int e = tid; e < H * G; e += blockDim.x) {
    const int k = e / G, j = e % G;
    w_s[e] = w[k * s0 + j * s1];
  }
  for (int e = tid; e < kBT * H; e += blockDim.x) dh_s[e] = 0.0f;
  for (long long e = tid; e < slice; e += blockDim.x) part[e] = 0.0f;
  __syncthreads();

  for (int s = 0; s < L; ++s) {
    const int t = dir == 0 ? L - 1 - s : s;
    const int tp = dir == 0 ? t - 1 : t + 1;
    // phase 0: h_prev, and dh += dy[t]
    for (int e = tid; e < kBT * H; e += blockDim.x) {
      const int r = e / H, i = e % H;
      float hp = 0.0f;
      if (r < nb) {
        if (tp >= 0 && tp < L) hp = ys[((long long)(b0 + r) * L + tp) * H + i];
        dh_s[e] += dy[((long long)(b0 + r) * L + t) * H + i];
      }
      hp_s[e] = hp;
    }
    __syncthreads();
    // phase 1: hg = h_prev @ W_hh + b_hh
    for (int j = tid; j < G; j += blockDim.x) {
      float acc[kBT];
      const float bj = bias[j];
#pragma unroll
      for (int r = 0; r < kBT; ++r) acc[r] = bj;
      for (int k = 0; k < H; ++k) {
        const float wk = w_s[k * G + j];
#pragma unroll
        for (int r = 0; r < kBT; ++r)
          if (r < nb) acc[r] += hp_s[r * H + k] * wk;
      }
#pragma unroll
      for (int r = 0; r < kBT; ++r) hg_s[r * G + j] = acc[r];
    }
    __syncthreads();
    // phase 2: the gates and their cotangents
    for (int e = tid; e < nb * H; e += blockDim.x) {
      const int r = e / H, i = e % H;
      const long long row = (long long)(b0 + r) * L + t;
      float* dx = dxg + row * G;
      float* dg = dhg_s + r * G;
      if (mask[row] > 0.0f) {
        const float* x = xg + row * G;
        const float* hg = hg_s + r * G;
        const float hp = hp_s[e];
        const float rg = sigmoidf_(x[i] + hg[i]);
        const float zg = sigmoidf_(x[H + i] + hg[H + i]);
        const float hn = hg[2 * H + i];
        const float ng = tanhf(x[2 * H + i] + rg * hn);
        const float dh = dh_s[e];
        const float dz = dh * (hp - ng) * zg * (1.0f - zg);
        const float dn = dh * (1.0f - zg) * (1.0f - ng * ng);
        const float dr = dn * hn * rg * (1.0f - rg);
        dg[i] = dr;
        dg[H + i] = dz;
        dg[2 * H + i] = dn * rg;
        dx[i] = dr;
        dx[H + i] = dz;
        dx[2 * H + i] = dn;
        dhz_s[e] = dh * zg;
      } else {
        dg[i] = 0.0f;
        dg[H + i] = 0.0f;
        dg[2 * H + i] = 0.0f;
        dx[i] = 0.0f;
        dx[H + i] = 0.0f;
        dx[2 * H + i] = 0.0f;
      }
    }
    __syncthreads();
    // phase 3: the carried dh, and this block's dW_hh / db_hh
    for (int e = tid; e < nb * H; e += blockDim.x) {
      const int r = e / H, i = e % H;
      if (mask[(long long)(b0 + r) * L + t] > 0.0f) {
        const float* dg = dhg_s + r * G;
        const float* wi = w_s + i * G;
        float acc = dhz_s[e];
        for (int j = 0; j < G; ++j) acc += dg[j] * wi[j];
        dh_s[e] = acc;
      }
    }
    for (int e = tid; e < H * G; e += blockDim.x) {
      const int k = e / G, j = e % G;
      float acc = part[e];
      for (int r = 0; r < nb; ++r) acc += hp_s[r * H + k] * dhg_s[r * G + j];
      part[e] = acc;
    }
    for (int j = tid; j < G; j += blockDim.x) {
      float acc = part[H * G + j];
      for (int r = 0; r < nb; ++r) acc += dhg_s[r * G + j];
      part[H * G + j] = acc;
    }
    __syncthreads();
  }
}

// dW_hh / db_hh of each direction: the blocks' partials summed in tile order.
__global__ void bigru_bwd_reduce(const float* __restrict__ partials,
                                 int tiles, int H, float* __restrict__ dw_f,
                                 float* __restrict__ db_f,
                                 float* __restrict__ dw_b,
                                 float* __restrict__ db_b) {
  const int G = 3 * H;
  const long long slice = (long long)H * G + G;
  const int dir = blockIdx.y;
  for (long long e = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       e < slice; e += (long long)gridDim.x * blockDim.x) {
    const float* p = partials + (long long)dir * tiles * slice + e;
    float acc = 0.0f;
    for (int tile = 0; tile < tiles; ++tile) acc += p[tile * slice];
    if (e < (long long)H * G)
      (dir == 0 ? dw_f : dw_b)[e] = acc;
    else
      (dir == 0 ? db_f : db_b)[e - (long long)H * G] = acc;
  }
}

}  // namespace

extern "C" int bigru_bwd(const float* xg_f, const float* xg_b,
                         const float* w_f, const float* b_f,
                         const float* w_b, const float* b_b,
                         long long w_f_s0, long long w_f_s1,
                         long long w_b_s0, long long w_b_s1,
                         const float* mask, const float* ys_f,
                         const float* ys_b, const float* dy_f,
                         const float* dy_b, float* dxg_f, float* dxg_b,
                         float* dw_f, float* db_f, float* dw_b, float* db_b,
                         float* partials, int B, int L, int H,
                         void* stream) {
  const size_t smem = sizeof(float) * ((size_t)H * 3 * H + 3 * (size_t)kBT * H +
                                       2 * (size_t)kBT * 3 * H);
  cudaError_t err = cudaFuncSetAttribute(
      bigru_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int tiles = (B + kBT - 1) / kBT;
  cudaStream_t st = (cudaStream_t)stream;
  bigru_bwd_kernel<<<dim3(2, tiles), kThreads, smem, st>>>(
      xg_f, xg_b, w_f, b_f, w_b, b_b, w_f_s0, w_f_s1, w_b_s0, w_b_s1, mask,
      ys_f, ys_b, dy_f, dy_b, dxg_f, dxg_b, partials, B, L, H);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int slice = H * 3 * H + 3 * H;
  bigru_bwd_reduce<<<dim3((slice + 255) / 256, 2), 256, 0, st>>>(
      partials, tiles, H, dw_f, db_f, dw_b, db_b);
  return (int)cudaGetLastError();
}
