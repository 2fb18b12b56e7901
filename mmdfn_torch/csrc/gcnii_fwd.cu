// GCNII stack forward (GCNII_lyc wiring, variant=True), one launch per
// layer, with a training mode: dropout drawn in the kernel and the
// per-layer residuals the backward (gcnii_bwd.cu) reads.
//
// Replaces: mmdfn_tpu/ops/pallas_gcnii.py:gcnii_stack_fused (kernel body
// _kernel) and mmdfn_tpu/ops/pallas_gcnii_train.py:_stack_fwd (kernel body
// _fwd_kernel, with its in-kernel dropout and residual outputs).
//
// Per layer l (theta = theta[l]):
//   q       = h
//   h1      = reason ? LSTM step(h; lh, lc) : h      (gates i, f, g, o)
//   hi      = adj @ h1
//   support = hi @ W1[l] + h0 @ W2[l]
//   h       = relu(theta * support + (1 - theta) * ((1 - a) hi + a h0))
//   h       = drop ? (keep(seed, b, l, node, c) ? h / (1 - rate) : 0) : h
//   h       = reason ? h + q : h
// keep is Philox4x32-10 (philox.cuh) on the counter (b, l, node, channel)
// under the 64-bit step seed, read from device memory so that a new seed
// per step needs no host round trip; rate and seed are runtime arguments.
//
// Residuals (training mode): the pre-layer h, lh, lc of every layer and the
// layer's h1 (the LSTM output), as (B, nl, N, H) f32 slabs.  The TPU
// kernel stores h, lh, lc in bf16 and recomputes h1; here they stay f32
// (the port's parity default), and h1 is stored as well so that the
// backward needs no launch to recompute it.  At the training shapes
// (B = 32, N = 3 * 80 = 240, 16 layers, H = 100) each slab is 49 MB, 197 MB
// for the four: a small share of the card's 80 GB.
//
// Bound: at serve (B = 1, N = 3 * 200, H = 100, 16 layers) the stack does
// about 3.1 GFLOP in f32 and moves about 1.8 MB, so it is bound by
// operations (FP32 outside the tensor cores).  At the training shapes the
// stack does ~31 GFLOP (0.46 ms of the f32 rate), and the four residual
// slabs add 197 MB of writes (~59 us of memory time): still operations.
// This first version does all of its arithmetic on the CUDA cores; tensor
// cores, TMA and wgmma are for a later version.
//
// Design: the TPU kernel keeps the adjacency resident for all layers; here
// the f32 adjacency at N = 600 is 1.44 MB against a block's 227 KB, and
// adj @ h1 at layer l needs the LSTM output of EVERY row of layer l, a
// device-wide dependency.  So the stack is one launch per layer.  Each block
// owns kR rows of one dialogue: it computes hi = adj[rows] @ h1 (the K axis
// streamed through shared memory in kKC-row tiles), the update, the dropout
// and the skip, and then the NEXT layer's row-local LSTM step, writing that
// layer's h1 into the other buffer of a ping-pong pair.  A first launch with
// do_conv = 0 runs layer 0's LSTM step.  Because layer l+1's LSTM step runs
// in layer l's launch, the pre-layer lh, lc of layer l+1 are stored there,
// just before they are overwritten; the pre-layer h and h1 of layer l are
// stored by layer l's launch.  Pad rows may turn nonzero through the LSTM
// bias; pad columns of adj are zero, so valid rows never read them.
//
// C interface: device pointers to contiguous f32 arrays, the reason-LSTM
// weights as (H, 4H); residual pointers null when not training; the stream
// is the caller's.  Returns cudaGetLastError() after the launch.

#include <cuda_runtime.h>
#include <math.h>

#include "philox.cuh"

namespace {

constexpr int kR = 8;        // rows of one dialogue per block
constexpr int kTX = 128;     // threads over the hidden axis (H <= 128)
constexpr int kTY = 4;       // thread rows; each covers kR / kTY rows
constexpr int kRT = kR / kTY;
constexpr int kKC = 32;      // K tile of adj @ h1
constexpr int kHMax = kTX;

__device__ __forceinline__ float sigmoidf_(float x) {
  return 1.0f / (1.0f + expf(-x));
}

__global__ void __launch_bounds__(kTX * kTY) gcnii_layer_kernel(
    const float* __restrict__ adj, const float* __restrict__ h0,
    const float* __restrict__ w1, const float* __restrict__ w2,
    const float* __restrict__ theta_l, float alpha,
    const float* h_in, const float* __restrict__ h1_in, float* h_out,
    float* __restrict__ h1_out, float* __restrict__ lh,
    float* __restrict__ lc, const float* __restrict__ ih,
    const float* __restrict__ hh, const float* __restrict__ lb, int do_conv,
    int do_lstm, int reason, int N, int H, int l_conv, int l_lstm, int nl,
    float* __restrict__ res_h, float* __restrict__ res_lh,
    float* __restrict__ res_lc, float* __restrict__ res_h1, int drop,
    unsigned int thresh, float inv_keep,
    const long long* __restrict__ seed_ptr) {
  __shared__ float adj_s[kR][kKC];
  __shared__ float h1_s[kKC][kHMax];
  __shared__ float hi_s[kR][kHMax];
  __shared__ float h0_s[kR][kHMax];
  __shared__ float hn_s[kR][kHMax];
  __shared__ float lh_s[kR][kHMax];

  const int c = threadIdx.x;
  const int ty = threadIdx.y;
  const int tid = ty * kTX + c;
  const int nthreads = kTX * kTY;
  const int b = blockIdx.y;
  const int row0 = blockIdx.x * kR;
  const long long base = (long long)b * N * H;
  const float* A = adj + (long long)b * N * N;
  const bool store = res_h != nullptr;

  if (do_conv) {
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
        h1_s[kk][cc] =
            kk < kc ? h1_in[base + (long long)(k0 + kk) * H + cc] : 0.0f;
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
    const float theta = *theta_l;
    const unsigned long long seed =
        drop ? (unsigned long long)*seed_ptr : 0ull;
    if (c < H) {
#pragma unroll
      for (int q = 0; q < kRT; ++q) {
        const int r = ty + q * kTY, row = row0 + r;
        float hn = 0.0f;
        if (row < N) {
          float sup = 0.0f;
          for (int k = 0; k < H; ++k)
            sup += hi_s[r][k] * w1[k * H + c] + h0_s[r][k] * w2[k * H + c];
          const float rr = (1.0f - alpha) * hi_s[r][c] + alpha * h0_s[r][c];
          hn = fmaxf(theta * sup + (1.0f - theta) * rr, 0.0f);
          if (drop)
            hn = philox::keep(seed, b, l_conv, row, c, thresh) ? hn * inv_keep
                                                               : 0.0f;
          const long long o = base + (long long)row * H + c;
          if (store) {
            const long long ro =
                (((long long)b * nl + l_conv) * N + row) * H + c;
            res_h[ro] = h_in[o];
            res_h1[ro] = h1_in[o];
          }
          if (reason) hn += h_in[o];
          h_out[o] = hn;
          if (!do_lstm) h1_out[o] = hn;
        }
        hn_s[r][c] = hn;
      }
    }
  } else if (c < H) {
#pragma unroll
    for (int q = 0; q < kRT; ++q) {
      const int r = ty + q * kTY, row = row0 + r;
      hn_s[r][c] = row < N ? h_in[base + (long long)row * H + c] : 0.0f;
    }
  }
  if (!do_lstm) return;  // uniform over the block
  if (c < H) {
#pragma unroll
    for (int q = 0; q < kRT; ++q) {
      const int r = ty + q * kTY, row = row0 + r;
      lh_s[r][c] = row < N ? lh[base + (long long)row * H + c] : 0.0f;
    }
  }
  __syncthreads();
  if (c < H) {
#pragma unroll
    for (int q = 0; q < kRT; ++q) {
      const int r = ty + q * kTY, row = row0 + r;
      if (row >= N) continue;
      float g[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) g[u] = lb[u * H + c];
      for (int k = 0; k < H; ++k) {
        const float x = hn_s[r][k], y = lh_s[r][k];
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int j = k * 4 * H + u * H + c;
          g[u] += x * ih[j] + y * hh[j];
        }
      }
      const long long o = base + (long long)row * H + c;
      const float lco = lc[o];
      if (store) {   // layer l_lstm's pre-layer LSTM state
        const long long ro = (((long long)b * nl + l_lstm) * N + row) * H + c;
        res_lh[ro] = lh_s[r][c];
        res_lc[ro] = lco;
      }
      const float cn = sigmoidf_(g[1]) * lco + sigmoidf_(g[0]) * tanhf(g[2]);
      const float hnew = sigmoidf_(g[3]) * tanhf(cn);
      lc[o] = cn;
      lh[o] = hnew;
      h1_out[o] = hnew;
    }
  }
}

}  // namespace

extern "C" int gcnii_layer(
    const float* adj, const float* h0, const float* w1, const float* w2,
    const float* theta_l, float alpha, const float* h_in, const float* h1_in,
    float* h_out, float* h1_out, float* lh, float* lc, const float* ih,
    const float* hh, const float* lb, int do_conv, int do_lstm, int reason,
    int B, int N, int H, int l_conv, int l_lstm, int nl, float* res_h,
    float* res_lh, float* res_lc, float* res_h1, int drop,
    unsigned int thresh, float inv_keep, const long long* seed_ptr,
    void* stream) {
  if (H > kHMax) return (int)cudaErrorInvalidValue;
  dim3 grid((N + kR - 1) / kR, B);
  dim3 block(kTX, kTY);
  gcnii_layer_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(
      adj, h0, w1, w2, theta_l, alpha, h_in, h1_in, h_out, h1_out, lh, lc, ih,
      hh, lb, do_conv, do_lstm, reason, N, H, l_conv, l_lstm, nl, res_h,
      res_lh, res_lc, res_h1, drop, thresh, inv_keep, seed_ptr);
  return (int)cudaGetLastError();
}
