// GCNII stack backward (GCNII_lyc wiring, variant=True): the reverse layer
// walk of the training stack, dropout bits drawn again in the kernel.
//
// Replaces: mmdfn_tpu/ops/pallas_gcnii_train.py:_stack_bwd (kernel body
// _bwd_kernel, without its timing-only `ablate` paths).
//
// Per layer l, from the last to the first, with the carries dh (the
// gradient of the layer's output), dlh and dlc, and the forward's residuals
// h, lh, lc (pre-layer) and h1 (the layer's LSTM output) of layer l:
//   hi   = adj @ h1;   pre = theta (hi W1 + h0 W2) + (1 - theta)((1-a) hi + a h0)
//   dh2  = drop ? (keep ? dh / (1 - rate) : 0) : dh;  dpre = pre > 0 ? dh2 : 0
//   tdpre = theta dpre
//   dW[l] = [hi, h0]^T tdpre                       (sums over all B N rows)
//   d_hi = tdpre W1^T + (1-theta)(1-a) dpre;  d_h0 += tdpre W2^T + (1-theta) a dpre
//   d_adj += d_hi h1^T;   d_h1 = adj^T d_hi      (the transposed contraction,
//                                                   adj is not assumed symmetric)
//   reason: the LSTM step's backward from d_h1 + dlh and dlc (gates
//     recomputed from h, lh, lc); d[W_ih; W_hh; b] += [h, lh, 1]^T dgates;
//     dh = dh + dgates W_ih^T;  dlh = dgates W_hh^T;  dlc = dlc1 f
//   else: dh = d_h1
// After layer 0, dh is the gradient of the stack's entry h.
//
// Bound: at the training shapes (B = 32, N = 240, H = 100, 16 layers) the
// backward does ~87 GFLOP in f32 (per layer 6 B N^2 H for adj @ h1,
// adj^T d_hi and d_hi h1^T, and 56 B N H^2 for the support products and
// their transposes, the LSTM recompute, its two input-gradient products and
// the weight-gradient sums), 1.3 ms of the card's f32 rate; its bytes (the
// four 49 MB residual slabs and the adjacency read once, d_adj written
// once) take ~0.07 ms.  So it is bound by operations.  This first version
// runs on the CUDA cores.
//
// Design: as in the forward, a product that reads every row of a layer
// needs a launch boundary.  Because the forward stored h1, hi = adj @ h1 is
// recomputed inside the first launch of the layer (kernel X: one block per
// kR rows of one dialogue), which also does the row-local update gradients,
// writes d_hi, and adds d_hi[rows] h1^T into d_adj (h1 streamed a second
// time).  d_h1 = adj^T d_hi needs every row's d_hi, so the LSTM backward is
// a second launch (kernel Y).  The weight gradients are sums over all B N
// rows: kernel W computes A^T B for each tile of the output and each split
// of 256 rows into a private partial; a last kernel sums the partials in a
// fixed order (deterministic, no atomics).  The transposed weights (W^T,
// W_ih^T, W_hh^T) are handed in contiguous so that every weight read in the
// input-gradient products coalesces.
//
// C interface: device pointers to contiguous f32 arrays; the stream is the
// caller's.  gcnii_bwd_layer runs one layer (kernels X, Y and W);
// gcnii_bwd_finish sums the weight-gradient partials.  Each returns
// cudaGetLastError() after its launches.

#include <cuda_runtime.h>
#include <math.h>

#include "philox.cuh"

namespace {

constexpr int kR = 8;        // rows of one dialogue per block
constexpr int kTX = 128;     // threads over the hidden axis (H <= 128)
constexpr int kTY = 4;
constexpr int kRT = kR / kTY;
constexpr int kKC = 32;      // row tile of the adjacency products
constexpr int kHMax = kTX;
constexpr int kWT = 32;      // output tile of the weight-gradient sums
constexpr int kRows = 256;   // rows per weight-gradient split

__device__ __forceinline__ float sigmoidf_(float x) {
  return 1.0f / (1.0f + expf(-x));
}

// Kernel X: the update's backward for kR rows of dialogue b, layer l.
__global__ void __launch_bounds__(kTX * kTY) gcnii_bwd_conv_kernel(
    const float* __restrict__ adj, const float* __restrict__ h0,
    const float* __restrict__ w, const float* __restrict__ wt,
    const float* __restrict__ theta_l, float alpha,
    const float* __restrict__ h1, const float* __restrict__ dh,
    float* __restrict__ d_hi, float* __restrict__ hih0,
    float* __restrict__ tdpre, float* __restrict__ dh0,
    float* __restrict__ dadj, int drop, unsigned int thresh, float inv_keep,
    const long long* __restrict__ seed_ptr, int l, int nl, int N, int H) {
  __shared__ float adj_s[kR][kKC];
  __shared__ float h1_s[kKC][kHMax + 1];
  __shared__ float hi_s[kR][kHMax];
  __shared__ float h0_s[kR][kHMax];
  __shared__ float tdp_s[kR][kHMax];
  __shared__ float dhi_s[kR][kHMax];

  const int c = threadIdx.x;
  const int ty = threadIdx.y;
  const int tid = ty * kTX + c;
  const int nthreads = kTX * kTY;
  const int b = blockIdx.y;
  const int row0 = blockIdx.x * kR;
  const long long base = (long long)b * N * H;
  const float* A = adj + (long long)b * N * N;
  const float* h1b = h1 + ((long long)b * nl + l) * N * H;
  const float* w1 = w;
  const float* w2 = w + H * H;

  // hi = adj[rows] @ h1
  float acc[kRT];
#pragma unroll
  for (int q = 0; q < kRT; ++q) acc[q] = 0.0f;
  for (int k0 = 0; k0 < N; k0 += kKC) {
    const int kc = min(kKC, N - k0);
    for (int e = tid; e < kR * kKC; e += nthreads) {
      const int r = e / kKC, kk = e % kKC, row = row0 + r;
      adj_s[r][kk] =
          (row < N && kk < kc) ? A[(long long)row * N + k0 + kk] : 0.0f;
    }
    for (int e = tid; e < kKC * H; e += nthreads) {
      const int kk = e / H, cc = e % H;
      h1_s[kk][cc] = kk < kc ? h1b[(long long)(k0 + kk) * H + cc] : 0.0f;
    }
    __syncthreads();
    if (c < H) {
      for (int kk = 0; kk < kc; ++kk) {
        const float v = h1_s[kk][c];
#pragma unroll
        for (int q = 0; q < kRT; ++q) acc[q] += adj_s[ty + q * kTY][kk] * v;
      }
    }
    __syncthreads();
  }
  if (c < H) {
#pragma unroll
    for (int q = 0; q < kRT; ++q) {
      const int r = ty + q * kTY, row = row0 + r;
      hi_s[r][c] = acc[q];
      h0_s[r][c] = row < N ? h0[base + (long long)row * H + c] : 0.0f;
    }
  }
  __syncthreads();

  // pre, dpre, tdpre; the operands of dW[l]
  const float theta = *theta_l;
  const unsigned long long seed = drop ? (unsigned long long)*seed_ptr : 0ull;
  float dpre[kRT];
  if (c < H) {
#pragma unroll
    for (int q = 0; q < kRT; ++q) {
      const int r = ty + q * kTY, row = row0 + r;
      dpre[q] = 0.0f;
      float tdp = 0.0f;
      if (row < N) {
        float sup = 0.0f;
        for (int k = 0; k < H; ++k)
          sup += hi_s[r][k] * w1[k * H + c] + h0_s[r][k] * w2[k * H + c];
        const float rr = (1.0f - alpha) * hi_s[r][c] + alpha * h0_s[r][c];
        const float pre = theta * sup + (1.0f - theta) * rr;
        const long long o = base + (long long)row * H + c;
        float d = dh[o];
        if (drop)
          d = philox::keep(seed, b, l, row, c, thresh) ? d * inv_keep : 0.0f;
        dpre[q] = pre > 0.0f ? d : 0.0f;
        tdp = theta * dpre[q];
        tdpre[o] = tdp;
        const long long o2 = ((long long)b * N + row) * 2 * H;
        hih0[o2 + c] = hi_s[r][c];
        hih0[o2 + H + c] = h0_s[r][c];
      }
      tdp_s[r][c] = tdp;
    }
  }
  __syncthreads();

  // d_hi and d_h0 (thread c now indexes the input feature k)
  if (c < H) {
#pragma unroll
    for (int q = 0; q < kRT; ++q) {
      const int r = ty + q * kTY, row = row0 + r;
      float dhi = 0.0f;
      if (row < N) {
        float a1 = 0.0f, a2 = 0.0f;
        for (int j = 0; j < H; ++j) {
          const float t = tdp_s[r][j];
          a1 += t * wt[j * 2 * H + c];
          a2 += t * wt[j * 2 * H + H + c];
        }
        const long long o = base + (long long)row * H + c;
        dhi = a1 + (1.0f - theta) * (1.0f - alpha) * dpre[q];
        dh0[o] += a2 + (1.0f - theta) * alpha * dpre[q];
        d_hi[o] = dhi;
      }
      dhi_s[r][c] = dhi;
    }
  }
  __syncthreads();

  // d_adj[rows] += d_hi[rows] @ h1^T
  float* dA = dadj + (long long)b * N * N;
  for (int m0 = 0; m0 < N; m0 += kKC) {
    const int mc = min(kKC, N - m0);
    for (int e = tid; e < kKC * H; e += nthreads) {
      const int mm = e / H, cc = e % H;
      h1_s[mm][cc] = mm < mc ? h1b[(long long)(m0 + mm) * H + cc] : 0.0f;
    }
    __syncthreads();
    for (int p = tid; p < kR * kKC; p += nthreads) {
      const int r = p / kKC, mm = p % kKC, row = row0 + r;
      if (row < N && mm < mc) {
        float s = 0.0f;
        for (int cc = 0; cc < H; ++cc) s += dhi_s[r][cc] * h1_s[mm][cc];
        dA[(long long)row * N + m0 + mm] += s;
      }
    }
    __syncthreads();
  }
}

// Kernel Y: d_h1 = adj^T d_hi for kR rows, then the reason-LSTM step's
// backward (or dh = d_h1 without it).
__global__ void __launch_bounds__(kTX * kTY) gcnii_bwd_lstm_kernel(
    const float* __restrict__ adj, const float* __restrict__ d_hi,
    const float* __restrict__ res_h, const float* __restrict__ res_lh,
    const float* __restrict__ res_lc, const float* __restrict__ ih,
    const float* __restrict__ hh, const float* __restrict__ lb,
    const float* __restrict__ iht, const float* __restrict__ hht,
    float* __restrict__ dh, float* __restrict__ dlh, float* __restrict__ dlc,
    float* __restrict__ xcat, float* __restrict__ dgates, int reason, int l,
    int nl, int N, int H) {
  __shared__ float adjt_s[kR][kKC + 1];
  __shared__ float dhi_s[kKC][kHMax];
  __shared__ float hs[kR][kHMax];
  __shared__ float lhs[kR][kHMax];
  __shared__ float dg_s[kR][4 * kHMax];

  const int c = threadIdx.x;
  const int ty = threadIdx.y;
  const int tid = ty * kTX + c;
  const int nthreads = kTX * kTY;
  const int b = blockIdx.y;
  const int row0 = blockIdx.x * kR;
  const long long base = (long long)b * N * H;
  const float* A = adj + (long long)b * N * N;

  float acc[kRT];
#pragma unroll
  for (int q = 0; q < kRT; ++q) acc[q] = 0.0f;
  for (int m0 = 0; m0 < N; m0 += kKC) {
    const int mc = min(kKC, N - m0);
    for (int e = tid; e < kR * kKC; e += nthreads) {
      const int r = e % kR, mm = e / kR, row = row0 + r;
      adjt_s[r][mm] =
          (row < N && mm < mc) ? A[(long long)(m0 + mm) * N + row] : 0.0f;
    }
    for (int e = tid; e < kKC * H; e += nthreads) {
      const int mm = e / H, cc = e % H;
      dhi_s[mm][cc] = mm < mc ? d_hi[base + (long long)(m0 + mm) * H + cc]
                              : 0.0f;
    }
    __syncthreads();
    if (c < H) {
      for (int mm = 0; mm < mc; ++mm) {
        const float v = dhi_s[mm][c];
#pragma unroll
        for (int q = 0; q < kRT; ++q) acc[q] += adjt_s[ty + q * kTY][mm] * v;
      }
    }
    __syncthreads();
  }
  if (!reason) {
    if (c < H) {
#pragma unroll
      for (int q = 0; q < kRT; ++q) {
        const int row = row0 + ty + q * kTY;
        if (row < N) dh[base + (long long)row * H + c] = acc[q];
      }
    }
    return;
  }

  const long long rbase = ((long long)b * nl + l) * N * H;
  if (c < H) {
#pragma unroll
    for (int q = 0; q < kRT; ++q) {
      const int r = ty + q * kTY, row = row0 + r;
      const bool in = row < N;
      hs[r][c] = in ? res_h[rbase + (long long)row * H + c] : 0.0f;
      lhs[r][c] = in ? res_lh[rbase + (long long)row * H + c] : 0.0f;
    }
  }
  __syncthreads();
  const int G = 4 * H;
  if (c < H) {
#pragma unroll
    for (int q = 0; q < kRT; ++q) {
      const int r = ty + q * kTY, row = row0 + r;
      if (row >= N) {
#pragma unroll
        for (int u = 0; u < 4; ++u) dg_s[r][u * H + c] = 0.0f;
        continue;
      }
      float g[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) g[u] = lb[u * H + c];
      for (int k = 0; k < H; ++k) {
        const float x = hs[r][k], y = lhs[r][k];
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int j = k * G + u * H + c;
          g[u] += x * ih[j] + y * hh[j];
        }
      }
      const float ig = sigmoidf_(g[0]), fg = sigmoidf_(g[1]);
      const float gg = tanhf(g[2]), og = sigmoidf_(g[3]);
      const long long o = base + (long long)row * H + c;
      const float lc = res_lc[rbase + (long long)row * H + c];
      const float lc1 = fg * lc + ig * gg;
      const float tl = tanhf(lc1);
      const float dlh1 = acc[q] + dlh[o];
      const float dlc1 = dlc[o] + dlh1 * og * (1.0f - tl * tl);
      const float dgv[4] = {dlc1 * gg * ig * (1.0f - ig),
                            dlc1 * lc * fg * (1.0f - fg),
                            dlc1 * ig * (1.0f - gg * gg),
                            dlh1 * tl * og * (1.0f - og)};
      const long long row2 = (long long)b * N + row;
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        dg_s[r][u * H + c] = dgv[u];
        dgates[row2 * G + u * H + c] = dgv[u];
      }
      dlc[o] = dlc1 * fg;
      float* xc = xcat + row2 * (2 * H + 1);
      xc[c] = hs[r][c];
      xc[H + c] = lhs[r][c];
      if (c == 0) xc[2 * H] = 1.0f;
    }
  }
  __syncthreads();
  if (c < H) {
#pragma unroll
    for (int q = 0; q < kRT; ++q) {
      const int r = ty + q * kTY, row = row0 + r;
      if (row >= N) continue;
      float a = 0.0f, bb = 0.0f;
      for (int j = 0; j < G; ++j) {
        const float d = dg_s[r][j];
        a += d * iht[j * H + c];
        bb += d * hht[j * H + c];
      }
      const long long o = base + (long long)row * H + c;
      dh[o] += a;       // the skip's dh plus the LSTM input's gradient
      dlh[o] = bb;
    }
  }
}

// Kernel W: part[split] (+)= A[rows of split]^T @ Bm[rows of split], A (R, K)
// and Bm (R, J) row-major, part (splits, K, J).
__global__ void __launch_bounds__(256) gcnii_wgrad_kernel(
    const float* __restrict__ A, const float* __restrict__ Bm, int R, int K,
    int J, float* __restrict__ part, int accumulate) {
  __shared__ float a_s[kWT][kWT + 1];
  __shared__ float b_s[kWT][kWT + 1];
  const int tx = threadIdx.x, ty = threadIdx.y;   // (32, 8)
  const int tid = ty * kWT + tx;
  const int j0 = blockIdx.x * kWT, k0 = blockIdx.y * kWT;
  const int r_begin = blockIdx.z * kRows;
  const int r_end = min(R, r_begin + kRows);
  float acc[kWT / 8];
#pragma unroll
  for (int q = 0; q < kWT / 8; ++q) acc[q] = 0.0f;
  for (int r0 = r_begin; r0 < r_end; r0 += kWT) {
    for (int e = tid; e < kWT * kWT; e += 256) {
      const int rr = e / kWT, xx = e % kWT, row = r0 + rr;
      const bool in = row < r_end;
      a_s[rr][xx] = (in && k0 + xx < K) ? A[(long long)row * K + k0 + xx] : 0.0f;
      b_s[rr][xx] = (in && j0 + xx < J) ? Bm[(long long)row * J + j0 + xx] : 0.0f;
    }
    __syncthreads();
    for (int rr = 0; rr < kWT; ++rr) {
      const float bv = b_s[rr][tx];
#pragma unroll
      for (int q = 0; q < kWT / 8; ++q) acc[q] += a_s[rr][ty + 8 * q] * bv;
    }
    __syncthreads();
  }
  float* out = part + (long long)blockIdx.z * K * J;
#pragma unroll
  for (int q = 0; q < kWT / 8; ++q) {
    const int k = k0 + ty + 8 * q, j = j0 + tx;
    if (k < K && j < J) {
      const long long i = (long long)k * J + j;
      out[i] = accumulate ? out[i] + acc[q] : acc[q];
    }
  }
}

// out[g][e] = sum over s of part[g][s][e], in split order.
__global__ void gcnii_reduce_kernel(const float* __restrict__ part,
                                    int splits, long long E,
                                    float* __restrict__ out) {
  const int g = blockIdx.y;
  for (long long e = blockIdx.x * (long long)blockDim.x + threadIdx.x; e < E;
       e += (long long)gridDim.x * blockDim.x) {
    const float* p = part + (long long)g * splits * E + e;
    float acc = 0.0f;
    for (int s = 0; s < splits; ++s) acc += p[s * E];
    out[(long long)g * E + e] = acc;
  }
}

int splits_of(int R) { return (R + kRows - 1) / kRows; }

}  // namespace

extern "C" int gcnii_bwd_splits(int R) { return splits_of(R); }

extern "C" int gcnii_bwd_layer(
    const float* adj, const float* h0, const float* w, const float* wt,
    const float* theta_l, float alpha, const float* res_h,
    const float* res_lh, const float* res_lc, const float* res_h1,
    const float* ih, const float* hh, const float* lb, const float* iht,
    const float* hht, float* dh, float* dlh, float* dlc, float* d_hi,
    float* hih0, float* tdpre, float* xcat, float* dgates, float* dh0,
    float* dadj, float* part_w, float* part_l, int drop, unsigned int thresh,
    float inv_keep, const long long* seed_ptr, int reason, int l, int nl,
    int B, int N, int H, void* stream) {
  if (H > kHMax) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  dim3 grid((N + kR - 1) / kR, B);
  dim3 block(kTX, kTY);
  gcnii_bwd_conv_kernel<<<grid, block, 0, st>>>(
      adj, h0, w, wt, theta_l, alpha, res_h1, dh, d_hi, hih0, tdpre, dh0,
      dadj, drop, thresh, inv_keep, seed_ptr, l, nl, N, H);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  gcnii_bwd_lstm_kernel<<<grid, block, 0, st>>>(
      adj, d_hi, res_h, res_lh, res_lc, ih, hh, lb, iht, hht, dh, dlh, dlc,
      xcat, dgates, reason, l, nl, N, H);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int R = B * N;
  const int S = splits_of(R);
  dim3 wblock(kWT, 8);
  // dW[l] = [hi, h0]^T tdpre, into layer l's partials
  gcnii_wgrad_kernel<<<dim3((H + kWT - 1) / kWT, (2 * H + kWT - 1) / kWT, S),
                       wblock, 0, st>>>(hih0, tdpre, R, 2 * H, H, part_w, 0);
  err = cudaGetLastError();
  if (err != cudaSuccess || !reason) return (int)err;
  // d[W_ih; W_hh; b] += [h, lh, 1]^T dgates, summed over the layers
  gcnii_wgrad_kernel<<<dim3((4 * H + kWT - 1) / kWT,
                            (2 * H + 1 + kWT - 1) / kWT, S),
                       wblock, 0, st>>>(xcat, dgates, R, 2 * H + 1, 4 * H,
                                        part_l, l != nl - 1);
  return (int)cudaGetLastError();
}

extern "C" int gcnii_bwd_finish(const float* part_w, const float* part_l,
                                int R, int nl, int H, int reason, float* dW,
                                float* dl, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const int S = splits_of(R);
  const long long Ew = 2LL * H * H;
  gcnii_reduce_kernel<<<dim3((unsigned)((Ew + 255) / 256), nl), 256, 0, st>>>(
      part_w, S, Ew, dW);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || !reason) return (int)err;
  const long long El = (2LL * H + 1) * 4 * H;
  gcnii_reduce_kernel<<<dim3((unsigned)((El + 255) / 256), 1), 256, 0, st>>>(
      part_l, S, El, dl);
  return (int)cudaGetLastError();
}
