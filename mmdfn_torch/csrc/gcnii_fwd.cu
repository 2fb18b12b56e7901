// GCNII stack forward (GCNII_lyc wiring, variant=True), with a training
// mode: dropout drawn in the kernel and the per-layer residuals the
// backward (gcnii_bwd.cu) reads.
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
// Bound: at the training shapes the stack does ~31 GFLOP (0.46 ms of the
// card's f32 rate), and the four residual slabs add 197 MB of writes (~59
// us of memory time): bound by operations.  At serve (B = 1, N = 3 * 200,
// 16 layers) it does about 3.1 GFLOP and moves about 1.8 MB: operations.
//
// Design (the tiled path): each layer is three launches of the tiled f32
// product of gemm_f32.cuh (the one kernel D runs on), batched over the B
// dialogues with rows = the N nodes of one dialogue, the elementwise work
// in each product's epilogue:
//   F1 [h | lh] [W_ih; W_hh] + b; the LSTM cell    wide   -> h1, lh', lc'
//   F2 hi = adj h1                                  narrow -> hi scratch
//   F3 [hi | h0] W[l]; the update, the Philox keep, the skip
//                                                   narrow -> the next h
// (without reason F1 is skipped and h1 = h).  F1's cell needs the four
// gates of one (row, channel) in one thread: the wrapper interleaves the
// gate columns of [W_ih; W_hh; b] (column 4c + u is gate u of channel c),
// so that each 4-wide chunk of a thread's register tile is one channel's
// i, f, g, o and the epilogue (a gemm::Chunk4) writes h1 and the cell
// state straight from registers; writing the gates to a scratch and
// running a cell kernel instead would cost a (B, N, 4H) round trip and a
// launch a layer.  adj @ h1 reads every row's h1 of the layer, a
// dialogue-wide dependency, so the layers follow each other in stream
// order; a first launch copies h into the layer-0 state.
//
// Where the state lives: F1 reads lh as its A operand in all four column
// blocks of a row tile, so the new lh never overwrites the old in place.
// In training mode the residual slabs are the carries: layer l reads slab
// [:, l] through the batch stride nl N H and writes layer l + 1's pre-layer
// h, lh, lc into slab [:, l + 1] (the last layer's h into out).  In serve
// mode lh ping-pongs between two buffers, and h and lc are updated in
// place: each element of them is read and written by the one thread that
// owns it in F3 (h, the skip) and F1 (lc).
//
// Tiles: as kernel D's (gcnii_bwd.cu): F1 wide 128 x 128 (8 x 8 a thread,
// 256 threads, two blocks per SM), F2 and F3 narrow 64 x 128 (4 x 8, 256
// threads).  F2 and F3 are kernel D's P2 and P3 on the same operands at
// the same tiles, and F3 forms the pre-activation by the same expression
// as P3, so the backward recomputes hi and the ReLU's input bit for bit:
// its ReLU decisions are the forward's.  f32 on the CUDA cores: TF32 keeps
// ~3 decimal digits, and the port holds kernel B to 1e-5 of max |h|
// against the plain f32 version.
//
// The row-wise design (gcnii_layer_kernel, one launch per layer): each
// block owns kR rows of one dialogue and computes hi = adj[rows] @ h1 (the
// K axis streamed through shared memory), both support products, the
// update, the dropout, the skip and the NEXT layer's row-local LSTM step,
// with the weights read from global memory one per FMA.  A first launch
// with do_conv = 0 runs layer 0's LSTM step.  At a serve forward (B = 1, N
// <= 600) the tiled products have 2-20 blocks for 132 SMs and each runs
// latency-bound; there the row-wise design is the faster one (PERF.md).
//
// C interface: device pointers to contiguous f32 arrays; the stream is the
// caller's.  gcnii_fwd runs the whole stack and returns the number of
// kernels it launched, or minus the CUDA error of the first launch that
// failed (cudaGetLastError() after each launch).

#include <cuda_runtime.h>
#include <math.h>

#include "gemm_f32.cuh"
#include "philox.cuh"

namespace {

using gemm::Operand;

__device__ __forceinline__ float sigmoidf_(float x) {
  return 1.0f / (1.0f + expf(-x));
}

// A (B, N, H) state seen through a batch stride: element (b, r, c) at
// p + b bs + r H + c (one layer of a (B, nl, N, H) slab: bs = nl N H; a
// buffer: bs = N H).  p null: not kept.
struct View {
  float* p;
  long long bs;
  int H;
  __device__ __forceinline__ float* at(int b, int r, int c) const {
    return p + b * bs + (long long)r * H + c;
  }
};

// F1: the chunk at column c holds the gates i, f, g, o of channel c / 4
// (before their bias); the LSTM cell.
struct F1Cell : gemm::Chunk4 {
  const float* bias;   // (4H), interleaved as the weights
  View lc;             // the pre-layer cell state
  View h1;             // the layer's LSTM output
  View lh_next;        // the next layer's pre-layer lh (= h1)
  View lc_next;        // and lc; in serve mode lc itself
  struct In { float bi, bf, bg, bo, lc; };
  __device__ In load(int b, int r, int c) const {
    return {bias[c], bias[c + 1], bias[c + 2], bias[c + 3],
            *lc.at(b, r, c / 4)};
  }
  __device__ void operator()(int b, int r, int c, float4 v, In in) const {
    const int ch = c / 4;
    const float ig = sigmoidf_(v.x + in.bi), fg = sigmoidf_(v.y + in.bf);
    const float gg = tanhf(v.z + in.bg), og = sigmoidf_(v.w + in.bo);
    const float cn = fg * in.lc + ig * gg;
    const float hn = og * tanhf(cn);
    *h1.at(b, r, ch) = hn;
    if (lh_next.p) *lh_next.at(b, r, ch) = hn;
    if (lc_next.p) *lc_next.at(b, r, ch) = cn;
  }
};

// F2: hi = adj h1 into the (B, N, H) scratch.
struct F2Hi {
  float* hi;
  int N, H;
  using In = gemm::NoIn;
  __device__ In load(int, int, int) const { return {}; }
  __device__ void operator()(int b, int r, int c, float v, In) const {
    hi[((long long)b * N + r) * H + c] = v;
  }
};

// F3: v = (hi W1 + h0 W2)(r, c); the update, the dropout and the skip.
struct F3Update {
  const float* hi;     // (B, N, H)
  const float* h0;     // (B, N, H)
  View q;              // the pre-layer h (the skip)
  View out;            // the layer's output h
  View h1_next;        // without reason in training mode: the next
                       // layer's h1 residual (= its h)
  const float* theta;  // theta[l]
  float alpha;
  int l, N, H, reason, drop;
  unsigned int thresh;
  float inv_keep;
  const long long* seed;
  struct In { float hi, h0, q, th; unsigned long long seed; };
  __device__ In load(int b, int r, int c) const {
    const long long o = ((long long)b * N + r) * H + c;
    return {hi[o], h0[o], reason ? *q.at(b, r, c) : 0.0f, *theta,
            drop ? (unsigned long long)*seed : 0ull};
  }
  __device__ void operator()(int b, int r, int c, float v, In in) const {
    const float th = in.th;
    const float pre =   // as P3Pre (gcnii_bwd.cu) forms it
        th * v + (1.0f - th) * ((1.0f - alpha) * in.hi + alpha * in.h0);
    float hn = fmaxf(pre, 0.0f);
    if (drop)
      hn = philox::keep(in.seed, b, l, r, c, thresh) ? hn * inv_keep : 0.0f;
    if (reason) hn += in.q;
    *out.at(b, r, c) = hn;
    if (h1_next.p) *h1_next.at(b, r, c) = hn;
  }
};

// h into the layer-0 state (and into h1's when h1.p); lh, lc zeroed.
__global__ void gcnii_fwd_init(const float* __restrict__ h, View hs, View h1,
                               View lh, View lc, long long NH,
                               long long total) {
  for (long long e = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       e < total; e += (long long)gridDim.x * blockDim.x) {
    const long long b = e / NH, i = e % NH;
    hs.p[b * hs.bs + i] = h[e];
    if (h1.p) h1.p[b * h1.bs + i] = h[e];
    if (lh.p) lh.p[b * lh.bs + i] = 0.0f;
    if (lc.p) lc.p[b * lc.bs + i] = 0.0f;
  }
}

constexpr int kR = 8;        // rows of one dialogue per block
constexpr int kTX = 128;     // threads over the hidden axis (H <= 128)
constexpr int kTY = 4;       // thread rows; each covers kR / kTY rows
constexpr int kRT = kR / kTY;
constexpr int kKC = 32;      // K tile of adj @ h1
constexpr int kHMax = kTX;

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

// The designs gcnii_fwd runs (the wrapper picks one by shape).
enum Design { kTiled = 0, kRowwise = 1 };

// F1 at the wide tile.
template <class Epi>
cudaError_t wide(const Operand& A, const Operand& B, int M, int N, int K,
                 int batches, const Epi& e, cudaStream_t st) {
  return gemm::launch<128, 128, 8, true, false, 2>(A, B, M, N, K, batches, 1,
                                                   e, st);
}

// F2 and F3 at the narrow tile: B x N / 64 blocks, one block per SM at
// most at the training shape, so their registers are not capped.
template <class Epi>
cudaError_t narrow100(const Operand& A, const Operand& B, int M, int N,
                      int K, int batches, const Epi& e, cudaStream_t st) {
  return gemm::launch<64, 128, 4, true, false, 1>(A, B, M, N, K, batches, 1,
                                                  e, st);
}

cudaError_t init(const float* h, View hs, View h1, View lh, View lc, int B,
                 long long NH, cudaStream_t st) {
  const long long total = B * NH;
  const long long want = (total + 255) / 256;
  const unsigned blocks = (unsigned)(want < 1024 ? want : 1024);
  gcnii_fwd_init<<<blocks, 256, 0, st>>>(h, hs, h1, lh, lc, NH, total);
  return cudaGetLastError();
}

}  // namespace

// The whole forward on `stream`; see the note at the top.  out (B, N, H)
// gets the stack's output.  wl is [W_ih; W_hh; b] with interleaved gate
// columns, (2H + 1, 4H), read by the tiled design with reason; ih, hh
// (H, 4H) and lb (4H) are read by the row-wise design with reason.  The
// residual pointers are null outside training mode; without reason the
// lh and lc slabs are not written (the caller zeroes them).  scratch:
// (B, N, H) for hi in the tiled design's training mode, else 4 (B, N, H)
// (tiled: hi, the two lh buffers and lc; row-wise: two h1 buffers, lh, lc).
extern "C" int gcnii_fwd(
    const float* adj, const float* h, const float* h0, const float* W,
    const float* theta, float alpha, const float* wl, const float* ih,
    const float* hh, const float* lb, float* out, float* scratch,
    float* res_h, float* res_lh, float* res_lc, float* res_h1, int drop,
    unsigned int thresh, float inv_keep, const long long* seed, int reason,
    int design, int nl, int B, int N, int H, void* stream) {
  if (H > kHMax || B <= 0 || N <= 0 || nl <= 0 ||
      (design != kTiled && design != kRowwise))
    return -(int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const long long NH = (long long)N * H, NN = (long long)N * N;
  const long long RH = (long long)B * NH;
  const bool train = res_h != nullptr;
  int launches = 0;
  cudaError_t err = cudaSuccess;
#define GCNII_LAUNCH(call)                    \
  do {                                        \
    err = (call);                             \
    if (err != cudaSuccess) return -(int)err; \
    ++launches;                               \
  } while (0)

  if (design == kRowwise) {
    float *h1a = scratch, *h1b = scratch + RH;
    float *lh = scratch + 2 * RH, *lc = scratch + 3 * RH;
    const View none{nullptr, 0, H};
    GCNII_LAUNCH(init(h, View{out, NH, H}, none,
                      reason ? View{lh, NH, H} : none,
                      reason ? View{lc, NH, H} : none, B, NH, st));
    const dim3 grid((N + kR - 1) / kR, B), block(kTX, kTY);
    auto layer = [&](int l, const float* h1_in, float* h1_out, int do_conv,
                     int do_lstm) {
      const int lw = l < 0 ? 0 : l;
      const float* w1 = W + (long long)lw * 2 * H * H;
      gcnii_layer_kernel<<<grid, block, 0, st>>>(
          adj, h0, w1, w1 + (long long)H * H, theta + lw, alpha, out, h1_in,
          out, h1_out, lh, lc, ih, hh, lb, do_conv, do_lstm, reason, N, H,
          lw, l + 1, nl, res_h, res_lh, res_lc, res_h1, drop, thresh,
          inv_keep, seed);
      return cudaGetLastError();
    };
    const float* h1_src = h;   // without reason h1_0 = h, read only
    if (reason) {              // layer 0's LSTM step
      GCNII_LAUNCH(layer(-1, h1a, h1a, 0, 1));
      h1_src = h1a;
    }
    for (int l = 0; l < nl; ++l) {
      float* dst = (l + 1) % 2 ? h1b : h1a;
      GCNII_LAUNCH(layer(l, h1_src, dst, 1, reason && l + 1 < nl));
      h1_src = dst;
    }
    return launches;
  }

  const int G = 4 * H;
  const long long sb = train ? nl * NH : NH;   // the state's batch stride
  float* hi = scratch;
  // serve mode only: the lh pair and lc after hi
  float* lh_buf[2] = {scratch + RH, scratch + 2 * RH};
  float* lc_buf = scratch + 3 * RH;
  auto slab = [&](float* p, int l) { return View{p + l * NH, sb, H}; };
  const View none{nullptr, 0, H};
  const View h_0 = train ? slab(res_h, 0) : View{out, NH, H};
  const View lh_0 = train ? slab(res_lh, 0) : View{lh_buf[0], NH, H};
  const View lc_0 = train ? slab(res_lc, 0) : View{lc_buf, NH, H};
  GCNII_LAUNCH(init(h, h_0, train && !reason ? slab(res_h1, 0) : none,
                    reason ? lh_0 : none, reason ? lc_0 : none, B, NH, st));

  for (int l = 0; l < nl; ++l) {
    const bool last = l + 1 == nl;
    const View h_l = train ? slab(res_h, l) : View{out, NH, H};
    const View h_next =
        train && !last ? slab(res_h, l + 1) : View{out, NH, H};
    View h1_l = h_l;
    if (reason) {
      F1Cell f1{};
      f1.bias = wl + 2LL * H * G;
      View lh_l;
      if (train) {
        lh_l = slab(res_lh, l);
        f1.lc = slab(res_lc, l);
        f1.h1 = h1_l = slab(res_h1, l);
        f1.lh_next = last ? none : slab(res_lh, l + 1);
        f1.lc_next = last ? none : slab(res_lc, l + 1);
      } else {   // h1 is the next layer's lh; lc in place
        lh_l = View{lh_buf[l % 2], NH, H};
        f1.h1 = h1_l = View{lh_buf[(l + 1) % 2], NH, H};
        f1.lc = f1.lc_next = View{lc_buf, NH, H};
        f1.lh_next = none;
      }
      const Operand A =
          gemm::cat(h_l.p, h_l.bs, lh_l.p, lh_l.bs, H, 1, H, true);
      const Operand Bw = gemm::dense(wl, 0, 1, G);
      GCNII_LAUNCH(wide(A, Bw, N, G, 2 * H, B, f1, st));
    }
    {   // F2
      const Operand A = gemm::dense(adj, NN, N, 1);
      const Operand Bh = gemm::dense(h1_l.p, h1_l.bs, 1, H);
      const F2Hi f2{hi, N, H};
      GCNII_LAUNCH(narrow100(A, Bh, N, H, N, B, f2, st));
    }
    {   // F3
      const Operand A = gemm::cat(hi, NH, h0, NH, H, 1, H, true);
      const Operand Bw = gemm::dense(W + (long long)l * 2 * H * H, 0, 1, H);
      const F3Update f3{hi, h0, h_l, h_next,
                        train && !reason && !last ? slab(res_h1, l + 1)
                                                  : none,
                        theta + l, alpha, l, N, H, reason, drop, thresh,
                        inv_keep, seed};
      GCNII_LAUNCH(narrow100(A, Bw, N, H, 2 * H, B, f3, st));
    }
  }
#undef GCNII_LAUNCH
  return launches;
}
