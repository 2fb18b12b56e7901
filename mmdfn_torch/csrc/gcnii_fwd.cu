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
// The bf16 mode (use_bf16 = 1; the JAX package's production configuration)
// computes what the TPU kernel computes (pallas_gcnii_train.py, bf16 by
// construction): adj, h0 and W arrive as f32 tensors holding bf16 values
// (:691-697); F2 is adj @ bf16(h1) and F3 [bf16(hi) | h0] @ W[l], both on
// bf16 values with f32 sums (:104-109,141-142; bf16 times bf16 is exact in
// f32, so the f32 products compute them); the carries h, lh, lc, the LSTM
// product and all elementwise work stay f32, kept as in serve mode (h in
// out, lh a ping-pong pair, lc in place); and training mode writes three
// bf16 residual slabs, the pre-layer h, lh, lc (:150-153; 74 MB at the
// training shapes instead of 197), each by the launch that makes the
// carry: layer 0's by the first launch, layer l + 1's lh and lc by F1 and
// its h by F3 of layer l.  The same epilogues (their BF16 instance) round
// F2's and F3's operands in f32 buffers: F1 writes bf16(h1) (without
// reason F3 writes bf16 of the next h, the first launch bf16 of the entry
// h), and F2 writes hi and bf16(hi).  The tiled design only (the resident
// and row-wise designs have no bf16 mode), with the same launches.
//
// The bf16 scan mode (mode 2; the JAX package's bf16 layer scan,
// mmdfn_tpu/nn/gcn.py:229-287, where gcn_compute_dtype='bfloat16' and no
// fused kernel runs) rounds as XLA's bf16 scan does (gcnii_scan.cuh): the
// carries h, lh, lc are bf16 values held in f32 (kept as in serve mode),
// every elementwise op and every product's value is rounded, and the
// training mode's three bf16 slabs hold the carries exactly.  The LSTM's
// gates are ((h W_ih + b_ih) + lh W_hh) + b_hh, so F1 is two products, F1a
// (h W_ih, its value plus b_ih rounded into a (B, N, 4H) scratch) and F1b
// (lh W_hh, the gates and the cell in its epilogue), on the interleaved
// [W_ih; W_hh; b_ih; b_hh].  F2 writes hi rounded (without the variant r,
// the products' operand: F3 is then r W[l], K = H, on W unfolded); F3 the
// update, the dropout scaled by the keep scale rounded to bf16 and the
// skip, each op rounded.  Mode bit 4: the last layer's dropout scales the
// widened output by the f32 keep scale (JAX's post-loop dropout after the
// scan, GF2's wiring); bit 8: variant=False.  The tiled design only.
//
// Bound: at the training shapes the stack does ~31 GFLOP (0.46 ms of the
// card's f32 rate of 67 TFLOP/s, 0.19 ms of 3xTF32's 165), and the four
// residual slabs add 197 MB of writes (~59 us of memory time): bound by
// operations.  At serve (B = 1, N = 3 * 200, 16 layers) it does about 3.1
// GFLOP and moves about 1.8 MB: operations.
//
// Design (the tiled path): each layer is three launches of the tiled f32
// product of gemm_f32.cuh (the one kernel D runs on), batched over the B
// dialogues with rows = the N nodes of one dialogue, the elementwise work
// in each product's epilogue.  In the f32 mode the products run on the
// tensor cores as 3xTF32 (gemm_f32.cuh's launch_tc), in the bf16 modes on
// the CUDA cores (launch); the resident and row-wise designs keep their
// own products on the CUDA cores:
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
// Tiles: as kernel D's (gcnii_bwd.cu): F1 wide 128 x 128 (256 threads, two
// blocks per SM; on the tensor cores a 64 x 32 tile a warp, on the CUDA
// cores 8 x 8 a thread), F2 and F3 narrow 64 x 128 (256 threads; 32 x 32
// a warp, or 4 x 8 a thread).  F2 and F3 are kernel D's P2 and P3 on the
// same operands at the same tiles and core, and F3 forms the
// pre-activation by the same expression as P3, so the backward recomputes
// hi and the ReLU's input bit for bit: its ReLU decisions are the
// forward's.  Why 3xTF32 and not TF32: TF32 keeps ~3 decimal digits, and
// the port holds kernel B to 1e-5 of max |h| against the plain f32
// version; the three products hold each operand to 2^-22 (gemm_f32.cuh),
// as f32 does.  The bf16 modes stay on the CUDA cores: their checks hold
// them to f32 sums of bf16 values in that core's order, and their tensor-
// core path (bf16 mma) is a change of its own.
//
// The row-wise design (gcnii_layer_kernel, one launch per layer): each
// block owns kR rows of one dialogue and computes hi = adj[rows] @ h1 (the
// K axis streamed through shared memory), both support products, the
// update, the dropout, the skip and the NEXT layer's row-local LSTM step,
// with the weights read from global memory one per FMA.  A first launch
// with do_conv = 0 runs layer 0's LSTM step.  At a serve forward (B = 1) the
// tiled products have 1-20 blocks for 132 SMs and each runs latency-bound;
// the row-wise design beats them there, and the resident design beats it
// up to N = 384 (PERF.md); the row-wise design stays for N = 600.
//
// The resident design (gcnii_resident_kernel, one launch per forward): the
// whole stack of each dialogue on one thread-block cluster of 16 CTAs
// (grid (16, B)), as the TPU kernel keeps a dialogue resident in VMEM for
// all its layers.  One SM cannot carry a dialogue (N = 192: 0.74 GFLOP,
// ~1.5 ms at one SM's share of the f32 rate), so the cluster splits the H
// channels: CTA q owns channels [c0, c0 + S), S = 6 or 7 at H = 100 (8 at
// most, the slice pad), and keeps in its shared memory, for all layers,
// its columns of h, lh (a ping-pong pair), lc, hi and h0 (channel-major,
// NP = N rounded up to 4 rows) and of h1 (row-major), its 4S gate columns
// of [W_ih; W_hh; b] (loaded once) and its S columns of W[l] (the next
// layer's fetched by cp.async during this one).  What each phase reads
// fixes the exchanges:
//   F1 gates = [h | lh] [W_ih; W_hh]: row-local, but a row's h and lh are
//      spread over the cluster: read from the owning CTAs' shared memory
//      (distributed shared memory, ld.shared::cluster) in rounds of 16
//      channels into a warp's own buffer, each element once a CTA; the
//      cell writes h1, lh', lc of the CTA's own channels;
//   F2 hi = adj @ h1: the CTA's own columns of h1 over all rows, adj read
//      from global memory (L2): no exchange;
//   F3 [hi | h0] W[l]: hi and h0 read from the owning CTAs as F1 reads h;
//      the update, the dropout and the skip write the CTA's columns of h.
// Two cluster barriers a layer order it: after F2 (F3 reads every CTA's
// hi) and after F3 (the next F1 reads every CTA's h, and no CTA writes hi
// or h while another still reads them).  F1 writes the new lh into the
// other buffer of the pair, since other CTAs may still read the old.
// Where few rows leave warps idle, lanes or warps split k and their sums
// meet in a fixed order (shuffles, or shared memory in warp order), so
// two launches give the same bits.  Pad rows (masked utterances, rows
// N..NP) stay finite: the state starts zeroed, and adj's columns at masked
// nodes are zero.  At N = 600 a CTA holds ~203 KB of shared memory, one
// CTA an SM; the launch is refused where a cluster of that size does not
// fit (cudaOccupancyMaxActiveClusters).  Training mode (dropout, residual
// stores) runs in the same kernel.  What bounds it (PERF.md §6): at N = 192
// the products run at ~20% of the 16 SMs' f32 rate; F1, the LSTM gates
// (80% of the FLOPs), takes about half the time.
//
// Config axis (the grouped sweep's K stacked configurations): the per-
// dialogue arrays hold K blocks of B dialogues, W, [W_ih; W_hh; b] (and
// ih, hh, lb) K contiguous copies, theta and the seed are shared.  Every
// design runs the K B dialogues as one batch: a product's weight operand
// steps to the next configuration's copy every B batches (gemm::grouped),
// the resident design's cluster and the row-wise block find theirs from
// the dialogue index.  Where the rates differ, the dropout's keep
// threshold and keep scale are read from device memory, one per
// configuration (philox::Rate; JAX's `dyn` branch,
// pallas_gcnii_train.py:143-147), else passed by value; a launch with no
// batch past the first configuration runs the products compiled without
// the group term (gemm_f32.cuh).  A keep scale of exactly 1 (rate 0)
// keeps every element without a draw (:160); and Philox's counter takes
// the dialogue's index within its configuration, so that configuration k
// draws its run alone's bits.  K = 1 is a run alone.
//
// C interface: device pointers to contiguous f32 arrays (in the bf16 mode
// the residual slabs bf16); the stream is the caller's.
// gcnii_fwd runs the whole stack and returns the number of kernels it
// launched, or minus the CUDA error of the first launch that failed
// (cudaGetLastError() after each launch).

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include "gcnii_scan.cuh"
#include "gemm_f32.cuh"
#include "philox.cuh"

namespace cg = cooperative_groups;

namespace {

using gemm::Operand;
using gemm::bf16;

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

// A (B, N, H) bf16 state seen through a batch stride, as View; p null: not
// kept.
struct ViewB {
  bf16* p;
  long long bs;
  int H;
  __device__ __forceinline__ void put(long long b, long long i,
                                      float v) const {   // i = r H + c
    if (p) p[b * bs + i] = __float2bfloat16(v);
  }
  __device__ __forceinline__ void put(int b, int r, int c, float v) const {
    put(b, (long long)r * H + c, v);
  }
};

// F1: the chunk at column c holds the gates i, f, g, o of channel c / 4
// (before their bias); the LSTM cell.  BF16 (the bf16 mode): also bf16(h1)
// for F2 and the next layer's bf16 residuals lh = h1 and lc.
template <bool BF16>
struct F1CellT : gemm::Chunk4 {
  const float* bias;   // (4H) a configuration, interleaved as the weights
  long long bias_ks;   // the next configuration's bias: bias_ks further
  int Bc;              // dialogues a configuration
  View lc;             // the pre-layer cell state
  View h1;             // the layer's LSTM output
  View lh_next;        // the next layer's pre-layer lh (= h1)
  View lc_next;        // and lc; in serve mode lc itself
  View h1r;            // BF16: bf16(h1), F2's operand
  ViewB res_lh, res_lc;   // BF16: the next layer's slabs; p null: not kept
  struct In { float bi, bf, bg, bo, lc; };
  __device__ F1CellT for_batch(int b) const {   // dialogue b's bias
    F1CellT e = *this;
    e.bias = bias + (b / Bc) * bias_ks;
    return e;
  }
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
    if constexpr (BF16) {
      *h1r.at(b, r, ch) = gemm::round_bf16(hn);
      res_lh.put(b, r, ch, hn);
      res_lc.put(b, r, ch, cn);
    }
  }
};

// F2: hi = adj h1 into the (B, N, H) scratch; BF16: and bf16(hi), F3's
// operand, into hir.
template <bool BF16>
struct F2HiT {
  float* hi;
  int N, H;
  float* hir;
  using In = gemm::NoIn;
  __device__ In load(int, int, int) const { return {}; }
  __device__ void operator()(int b, int r, int c, float v, In) const {
    const long long o = ((long long)b * N + r) * H + c;
    hi[o] = v;
    if constexpr (BF16) hir[o] = gemm::round_bf16(v);
  }
};

// F3: v = (hi W1 + h0 W2)(r, c); the update, the dropout and the skip.
// BF16: h1_next gets bf16 of the new h, and res_next the next layer's bf16
// h residual.
template <bool BF16>
struct F3UpdateT {
  const float* hi;     // (B, N, H)
  const float* h0;     // (B, N, H)
  View q;              // the pre-layer h (the skip)
  View out;            // the layer's output h
  View h1_next;        // without reason in training mode: the next
                       // layer's h1 residual (= its h); BF16: its bf16(h1)
  const float* theta;  // theta[l]
  float alpha;
  int l, N, H, reason, drop, Bc;
  philox::Rate rate;
  const long long* seed;
  // set by for_batch: the dialogue's configuration's threshold and scale,
  // the step seed, and the configuration's first dialogue (Philox counts
  // the dialogues of a configuration)
  unsigned int thr;
  float ik;
  unsigned long long key;
  int b0;
  ViewB res_next;      // BF16: p null: not kept
  struct In { float hi, h0, q, th; };
  __device__ F3UpdateT for_batch(int b) const {
    F3UpdateT e = *this;
    const int k = b / Bc;
    e.b0 = k * Bc;
    e.ik = drop ? rate.inv_keep_of(k) : 1.0f;
    e.thr = drop ? rate.thresh_of(k) : 0u;
    e.key = drop ? (unsigned long long)*seed : 0ull;
    return e;
  }
  __device__ In load(int b, int r, int c) const {
    const long long o = ((long long)b * N + r) * H + c;
    return {hi[o], h0[o], reason ? *q.at(b, r, c) : 0.0f, *theta};
  }
  __device__ void operator()(int b, int r, int c, float v, In in) const {
    const float th = in.th;
    const float pre =   // as P3Pre (gcnii_bwd.cu) forms it
        th * v + (1.0f - th) * ((1.0f - alpha) * in.hi + alpha * in.h0);
    float hn = fmaxf(pre, 0.0f);
    if (drop && ik != 1.0f)   // a keep scale of 1 (rate 0) keeps all
      hn = philox::keep(key, b - b0, l, r, c, thr) ? hn * ik : 0.0f;
    if (reason) hn += in.q;
    *out.at(b, r, c) = hn;
    if (h1_next.p) *h1_next.at(b, r, c) = BF16 ? gemm::round_bf16(hn) : hn;
    if constexpr (BF16) res_next.put(b, r, c, hn);
  }
};

// h into the layer-0 state (and into h1's when h1.p); lh, lc zeroed.
// BF16: h1 gets bf16(h), and layer 0's bf16 slabs h, lh = 0 and lc = 0.
template <bool BF16>
__global__ void gcnii_fwd_init(const float* __restrict__ h, View hs, View h1,
                               View lh, View lc, ViewB rh, ViewB rlh,
                               ViewB rlc, long long NH, long long total) {
  for (long long e = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       e < total; e += (long long)gridDim.x * blockDim.x) {
    const long long b = e / NH, i = e % NH;
    hs.p[b * hs.bs + i] = h[e];
    if (h1.p) h1.p[b * h1.bs + i] = BF16 ? gemm::round_bf16(h[e]) : h[e];
    if (lh.p) lh.p[b * lh.bs + i] = 0.0f;
    if (lc.p) lc.p[b * lc.bs + i] = 0.0f;
    if constexpr (BF16) {
      rh.put(b, i, h[e]);
      rlh.put(b, i, 0.0f);
      rlc.put(b, i, 0.0f);
    }
  }
}

// The bf16 scan mode's epilogues (gcnii_scan.cuh's arithmetic).

// F1a: the first gate product h W_ih plus b_ih, into g1 (B, N, 4H) at the
// interleaved columns.
struct F1GateS {
  float* g1;
  int N, G;
  const float* bih;    // (4H) a configuration, interleaved
  long long bias_ks;   // the next configuration's: bias_ks further
  int Bc;
  struct In { float b; };
  __device__ F1GateS for_batch(int b) const {
    F1GateS e = *this;
    e.bih = bih + (b / Bc) * bias_ks;
    return e;
  }
  __device__ In load(int, int, int c) const { return {bih[c]}; }
  __device__ void operator()(int b, int r, int c, float v, In in) const {
    g1[((long long)b * N + r) * G + c] = scan::gate1(v, in.b);
  }
};

// F1b: the chunk at column c holds channel c / 4's gates of lh W_hh; with
// g1 and b_hh the gates' pre-activations, then the cell: h1 (the next lh)
// and lc in place, and the next layer's bf16 slabs.
struct F1CellS : gemm::Chunk4 {
  const float* g1;     // (B, N, 4H)
  const float* bhh;    // (4H) a configuration, interleaved
  long long bias_ks;
  int Bc, N, G;
  View lc;             // the cell state, in place
  View h1;             // the layer's LSTM output (the next layer's lh)
  ViewB res_lh, res_lc;   // the next layer's slabs; p null: not kept
  struct In { float4 g; float bi, bf, bg, bo, lc; };
  __device__ F1CellS for_batch(int b) const {
    F1CellS e = *this;
    e.bhh = bhh + (b / Bc) * bias_ks;
    return e;
  }
  __device__ In load(int b, int r, int c) const {
    const float4 g =
        *reinterpret_cast<const float4*>(g1 + ((long long)b * N + r) * G + c);
    return {g, bhh[c], bhh[c + 1], bhh[c + 2], bhh[c + 3],
            *lc.at(b, r, c / 4)};
  }
  __device__ void operator()(int b, int r, int c, float4 v, In in) const {
    const int ch = c / 4;
    const scan::Cell k = scan::cell(
        scan::gate(in.g.x, v.x, in.bi), scan::gate(in.g.y, v.y, in.bf),
        scan::gate(in.g.z, v.z, in.bg), scan::gate(in.g.w, v.w, in.bo),
        in.lc);
    *h1.at(b, r, ch) = k.h;
    *lc.at(b, r, ch) = k.c;
    res_lh.put(b, r, ch, k.h);
    res_lc.put(b, r, ch, k.c);
  }
};

// F2: hi = adj h1 rounded into the (B, N, H) scratch; without the variant
// r = (1-a) hi + a h0 there instead (F3's operand).
struct F2HiS {
  float* hi;
  const float* h0;
  int N, H, variant;
  scan::Consts k;
  using In = gemm::NoIn;
  __device__ In load(int, int, int) const { return {}; }
  __device__ void operator()(int b, int r, int c, float v, In) const {
    const long long o = ((long long)b * N + r) * H + c;
    const float x = scan::R(v);
    hi[o] = variant ? x : scan::r_of(x, h0[o], k);
  }
};

// F3: v = ([hi | h0] W[l])(r, c) (without the variant (r W[l])(r, c)); the
// update, the ReLU, the dropout and the skip, each op rounded; the last
// layer's dropout in f32 where last_f32.
struct F3UpdateS {
  const float* hi;     // (B, N, H); without the variant r
  const float* h0;
  float* h;            // (B, N, H): the layer's input (the skip), then its
                       // output
  const float* theta;  // theta[l]
  scan::Consts k;
  int l, N, H, reason, drop, Bc, variant, last_f32;
  philox::Rate rate;
  const long long* seed;
  ViewB res_next;      // p null: not kept
  // set by for_batch, as F3UpdateT's
  unsigned int thr;
  float ik;
  unsigned long long key;
  int b0;
  struct In { float hi, h0, q, th; };
  __device__ F3UpdateS for_batch(int b) const {
    F3UpdateS e = *this;
    const int kc = b / Bc;
    e.b0 = kc * Bc;
    e.ik = drop ? rate.inv_keep_of(kc) : 1.0f;
    e.thr = drop ? rate.thresh_of(kc) : 0u;
    e.key = drop ? (unsigned long long)*seed : 0ull;
    return e;
  }
  __device__ In load(int b, int r, int c) const {
    const long long o = ((long long)b * N + r) * H + c;
    return {hi[o], h0[o], reason ? h[o] : 0.0f, *theta};
  }
  __device__ void operator()(int b, int r, int c, float v, In in) const {
    const float th = scan::theta(in.th);
    const float rr = variant ? scan::r_of(in.hi, in.h0, k) : in.hi;
    float hn = fmaxf(scan::pre(v, rr, th, scan::omt(th)), 0.0f);
    if (drop && ik != 1.0f) {   // a keep scale of 1 (rate 0) keeps all
      const bool kp = philox::keep(key, b - b0, l, r, c, thr);
      hn = !kp ? 0.0f : last_f32 ? hn * ik : scan::R(hn * scan::R(ik));
    }
    if (reason) hn = scan::R(hn + in.q);
    h[((long long)b * N + r) * H + c] = hn;
    res_next.put(b, r, c, hn);
  }
};

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
    const philox::Rate rate, const long long* __restrict__ seed_ptr,
    int Bc) {
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
  // this dialogue's configuration: its weights, rate and Philox index
  const int kc = b / Bc, bl = b - kc * Bc;
  w1 += (long long)kc * nl * 2 * H * H;
  w2 += (long long)kc * nl * 2 * H * H;
  ih += (long long)kc * H * 4 * H;
  hh += (long long)kc * H * 4 * H;
  lb += (long long)kc * 4 * H;

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
    const float inv_keep = drop ? rate.inv_keep_of(kc) : 1.0f;
    const unsigned int thresh = drop ? rate.thresh_of(kc) : 0u;
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
          if (drop && inv_keep != 1.0f)
            hn = philox::keep(seed, bl, l_conv, row, c, thresh)
                     ? hn * inv_keep
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

// ---------------------------------------------------------------------------
// The resident design: the whole stack of a dialogue in one launch, on one
// thread-block cluster of kCluster CTAs (see the note at the top).

constexpr int kCluster = 16;   // CTAs a dialogue (a non-portable cluster)
constexpr int kSP = 8;         // channels a CTA owns, at most (H <= 128)
constexpr int kThreads = 256;
constexpr int kOwners = 128;   // channels, at most
constexpr int kBufs = 5;       // the gathered buffers: h, lh (2), hi, h0
constexpr int kSmemMax = 232448;   // 227 KB, a block's most on an H100
constexpr int kRound = 16;     // channels F1 reads a round
constexpr int kStage = kThreads / 32 * 2 * kRound * 32;   // F1's staging

__host__ __device__ inline int padded_rows(int N) { return (N + 3) & ~3; }

// Dynamic shared memory of one CTA, in floats: 7 state buffers of kSP x NP
// (h, the lh pair, lc, hi, h0 channel-major; h1 row-major), the gate
// weights' slice with its bias row ((2H + 1) x 4 kSP), W[l]'s slice twice
// (2H x kSP, the next layer's fetched during this one), F1's staging
// (two 16 x 32 buffers a warp) and a table of where each channel of the
// gathered buffers lives in the cluster (32-bit cluster addresses).
inline long long resident_smem_bytes(int N, int H) {
  return 4LL * (7LL * kSP * padded_rows(N) + (2 * H + 1) * 4 * kSP +
                2 * 2 * H * kSP + kStage + kBufs * kOwners);
}

struct ResidentArgs {
  const float *adj, *h, *h0, *W, *theta, *wl;
  float alpha;
  float* out;
  float *res_h, *res_lh, *res_lc, *res_h1;   // null outside training mode
  int drop;
  philox::Rate rate;
  const long long* seed;
  int reason, nl, Bc, N, H;     // Bc: dialogues a configuration
};

// The k splits of a product over R rows: the most (a power of two, up to
// kmax) that keep R rows in one pass of `full` / ks rows.
__device__ __forceinline__ int splits(int R, int full, int kmax) {
  int ks = 1;
  while (ks < kmax && full / (2 * ks) >= R) ks *= 2;
  return ks;
}

// Adds the partial sums of the ks lanes `stride` apart (a split's lanes);
// a fixed butterfly, so the result does not depend on timing.
template <int M>
__device__ __forceinline__ void reduce_splits(float (&acc)[M], int stride,
                                              int ks) {
  for (int o = stride; o < stride * ks; o *= 2)
#pragma unroll
    for (int i = 0; i < M; ++i)
      acc[i] += __shfl_xor_sync(0xffffffffu, acc[i], o);
}

// Distributed shared memory by its 32-bit cluster address: `p` (in this
// CTA's shared memory) as CTA `rank` of the cluster holds it, and loads
// from such an address (ld.shared::cluster; ordered by the cluster
// barriers around the phases that read).
__device__ __forceinline__ unsigned cluster_addr(const float* p, int rank) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  unsigned r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;"
               : "=r"(r)
               : "r"(a), "r"(rank));
  return r;
}
__device__ __forceinline__ float4 ld_cluster4(unsigned addr) {
  float4 v;
  asm volatile("ld.shared::cluster.v4.f32 {%0, %1, %2, %3}, [%4];"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
               : "r"(addr)
               : "memory");
  return v;
}
__device__ __forceinline__ float2 ld_cluster2(unsigned addr) {
  float2 v;
  asm volatile("ld.shared::cluster.v2.f32 {%0, %1}, [%2];"
               : "=f"(v.x), "=f"(v.y)
               : "r"(addr)
               : "memory");
  return v;
}

__device__ __forceinline__ float comp(const float4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

__device__ __forceinline__ void fma4x4(float* acc, float4 a, float4 w) {
  const float av[4] = {a.x, a.y, a.z, a.w}, wv[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      acc[i * 4 + j] = fmaf(av[i], wv[j], acc[i * 4 + j]);
}

__global__ void __launch_bounds__(kThreads, 1)
    gcnii_resident_kernel(ResidentArgs a) {
  extern __shared__ float4 smem4[];
  cg::cluster_group cl = cg::this_cluster();
  const int q = (int)cl.block_rank(), C = (int)cl.num_blocks();
  const int b = blockIdx.y, tid = threadIdx.x, lane = tid % 32;
  const int N = a.N, H = a.H, NP = padded_rows(N), K2 = 2 * H;
  // this dialogue's configuration: its weights, rate and Philox index
  const int kc = b / a.Bc, bl = b - kc * a.Bc;
  const float* Wk = a.W + (long long)kc * a.nl * K2 * H;
  // this CTA's channels [c0, c0 + S): H split as evenly as C allows
  const int base = H / C, extra = H % C;
  const int c0 = q * base + min(q, extra), S = base + (q < extra);

  float* sm = reinterpret_cast<float*>(smem4);
  float* hS = sm;                     // (kSP, NP): h, and the skip q
  float* lhA = hS + kSP * NP;         // lh, a ping-pong pair
  float* lhB = hS + 2 * kSP * NP;
  float* hiS = hS + 3 * kSP * NP;     // adj @ h1
  float* h0S = hS + 4 * kSP * NP;
  float* lcS = hS + 5 * kSP * NP;
  float* h1r = hS + 6 * kSP * NP;     // (NP, kSP): F2's B operand
  float* Wl = hS + 7 * kSP * NP;      // (2H + 1, 4 kSP): [W_ih; W_hh; b]
  float* Wc0 = Wl + (K2 + 1) * 4 * kSP;   // (2H, kSP): W[l] slice, l even
  float* Wc1 = Wc0 + K2 * kSP;            // and l odd
  // F1's staging: two kRound k x 32 row buffers a warp
  float* stage = Wc1 + K2 * kSP;
  // tab[i kOwners + c]: the cluster address of channel c of buffer i (h,
  // lhA, lhB, hi, h0), row 0, in the CTA that owns it
  unsigned* tab = reinterpret_cast<unsigned*>(stage + kStage);
  const long long gb = (long long)b * N * H;
  const bool train = a.res_h != nullptr;
  // W[l]'s slice by cp.async (pad columns zero-filled)
  auto fetch_w = [&](int l) {
    const float* src = Wk + (long long)l * K2 * H + c0;
    float* dst = l % 2 ? Wc1 : Wc0;
    for (int e = tid; e < K2 * kSP; e += kThreads) {
      const int k = e / kSP, j = e % kSP;
      gemm::cp_async4(dst + e, j < S ? src + (long long)k * H + j : src,
                      j < S ? 4 : 0);
    }
    gemm::cp_async_commit();
  };

  // zero state (pad rows and channels stay 0, so every operand is finite)
  for (int e = tid; e < 7 * kSP * NP; e += kThreads) sm[e] = 0.0f;
  for (int c = tid; c < H; c += kThreads) {
    const int big = extra * (base + 1);
    const int o = c < big ? c / (base + 1) : extra + (c - big) / base;
    const int j = c - (o * base + min(o, extra));
    float* bufs[kBufs] = {hS, lhA, lhB, hiS, h0S};
#pragma unroll
    for (int i = 0; i < kBufs; ++i)
      tab[i * kOwners + c] = cluster_addr(bufs[i] + j * NP, o);
  }
  __syncthreads();
  if (a.reason) {   // gate column 4c + u of the interleaved weights
    const float* src = a.wl + (long long)kc * (K2 + 1) * 4 * H + 4 * c0;
    for (int e = tid; e < (K2 + 1) * 4 * kSP; e += kThreads) {
      const int k = e / (4 * kSP), m = e % (4 * kSP);
      gemm::cp_async4(Wl + e, m / 4 < S ? src + (long long)k * 4 * H + m : src,
                      m / 4 < S ? 4 : 0);
    }
  }
  for (int e = tid; e < N * S; e += kThreads) {
    const int r = e / S, j = e % S;
    const long long g = gb + (long long)r * H + c0 + j;
    gemm::cp_async4(hS + j * NP + r, a.h + g, 4);
    gemm::cp_async4(h0S + j * NP + r, a.h0 + g, 4);
    if (!a.reason) gemm::cp_async4(h1r + r * kSP + j, a.h + g, 4);
  }
  fetch_w(0);
  const unsigned long long seed =
      a.drop ? (unsigned long long)*a.seed : 0ull;
  const float inv_keep = a.drop ? a.rate.inv_keep_of(kc) : 1.0f;
  const unsigned int thresh = a.drop ? a.rate.thresh_of(kc) : 0u;
  gemm::cp_async_wait<0>();
  cl.sync();   // every CTA's state is in place before the first gather

  for (int l = 0; l < a.nl; ++l) {
    float* lh = l % 2 ? lhB : lhA;
    float* lh_next = l % 2 ? lhA : lhB;
    const float* Wconv = l % 2 ? Wc1 : Wc0;
    gemm::cp_async_wait<0>();   // W[l] (visible after the next barrier)
    if (l + 1 < a.nl) fetch_w(l + 1);   // lands during this layer
    if (train) {   // layer l's pre-layer state
      for (int e = tid; e < N * S; e += kThreads) {
        const int r = e / S, j = e % S;
        const long long o = (((long long)b * a.nl + l) * N + r) * H + c0 + j;
        a.res_h[o] = hS[j * NP + r];
        if (a.reason) {
          a.res_lh[o] = lh[j * NP + r];
          a.res_lc[o] = lcS[j * NP + r];
        } else {
          a.res_h1[o] = hS[j * NP + r];
        }
      }
      __syncthreads();   // read before F1's cell rewrites lc
    }

    // F1: gates = [h | lh] [W_ih; W_hh] + b and the LSTM cell.  A group
    // of kw warps owns 32 rows (lane: channel lane % 8, rows 8 (lane / 8)
    // .. + 7, all 4 gates); k goes in rounds of kRound, round t taken by warp
    // t % kw of the group.  In a round each lane reads kRound / 4 x 16 bytes
    // of [h | lh] from the owning CTAs (a channel's 32 rows in one 128-byte run)
    // into the warp's ping-pong buffer, the next round's reads in flight
    // while this one is multiplied.  The kw partial sums meet in shared
    // memory in the order of the warps.
    if (a.reason) {
      const unsigned* tx = tab;
      const unsigned* ty = tab + (l % 2 ? 2 : 1) * kOwners;
      const int warp = tid / 32, ch = lane % 8, ro = lane / 8;
      const int groups = min(8, (N + 31) / 32), kw = 8 / groups;
      const int g = warp / kw, sw = warp % kw, rounds = (K2 + kRound - 1) / kRound;
      float* wb = stage + warp * 2 * kRound * 32;
      for (int r0 = 0; r0 < N; r0 += 32 * groups) {
        const int r = r0 + 32 * g;
        const bool act = g < groups && r < N;
        auto fetch = [&](float4(&v)[kRound / 4], int t) {
#pragma unroll
          for (int j = 0; j < kRound / 4; ++j) {
            const int k = kRound * t + 4 * j + lane / 8;
            const int rr = r + 4 * (lane % 8);
            v[j] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
            if (act && t < rounds && k < K2 && rr < NP)
              v[j] = ld_cluster4((k < H ? tx[k] : ty[k - H]) + 4 * rr);
          }
        };
        float acc[32] = {};   // row i, gate u at 4 i + u
        float4 v[kRound / 4];   // the next round's reads, in flight
        fetch(v, sw);
        for (int t = sw, n = 0; t < rounds; t += kw, ++n) {
          float* buf = wb + (n % 2) * kRound * 32;
#pragma unroll
          for (int j = 0; j < kRound / 4; ++j)
            *reinterpret_cast<float4*>(buf + (4 * j + lane / 8) * 32 +
                                       4 * (lane % 8)) = v[j];
          __syncwarp();
          fetch(v, t + kw);
          const int kb = kRound * t, kn = min(kRound, K2 - kb);
          if (act) {
#pragma unroll 4
            for (int kk = 0; kk < kn; ++kk) {
              const float4 w = *reinterpret_cast<const float4*>(
                  Wl + (kb + kk) * 4 * kSP + 4 * ch);
              const float* x = buf + kk * 32 + 8 * ro;
              fma4x4(acc, *reinterpret_cast<const float4*>(x), w);
              fma4x4(acc + 16, *reinterpret_cast<const float4*>(x + 4), w);
            }
          }
        }
        if (kw > 1) {   // the group's sums, in the order of its warps
          float* red = stage;   // (32, 256): value i of thread t at i 256 + t
          __syncthreads();
          if (sw > 0)
#pragma unroll
            for (int i = 0; i < 32; ++i) red[i * kThreads + tid] = acc[i];
          __syncthreads();
          if (sw == 0)
            for (int w2 = 1; w2 < kw; ++w2)
#pragma unroll
              for (int i = 0; i < 32; ++i)
                acc[i] += red[i * kThreads + tid + 32 * w2];
          __syncthreads();   // the buffers are free again
        }
        if (sw == 0 && act) {
          const float* bb = Wl + K2 * 4 * kSP + 4 * ch;
#pragma unroll
          for (int i = 0; i < 8; ++i) {
            const int rr = r + 8 * ro + i;
            if (rr >= N) continue;
            const int e = ch * NP + rr;
            const float ig = sigmoidf_(acc[4 * i] + bb[0]);
            const float fg = sigmoidf_(acc[4 * i + 1] + bb[1]);
            const float gg = tanhf(acc[4 * i + 2] + bb[2]);
            const float og = sigmoidf_(acc[4 * i + 3] + bb[3]);
            const float cn = fg * lcS[e] + ig * gg;
            const float hn = og * tanhf(cn);
            lcS[e] = cn;
            lh_next[e] = hn;
            h1r[rr * kSP + ch] = hn;
            if (train && ch < S)
              a.res_h1[(((long long)b * a.nl + l) * N + rr) * H + c0 + ch] =
                  hn;
          }
        }
      }
      __syncthreads();   // h1 is written
    }

    {   // F2: hi = adj @ h1 over the CTA's channels.  A thread: 4 rows x 8
        // channels, adj read from global memory (L2, L1) 16 bytes a row
        // where N is a multiple of 4, its k range one of ks splits.
      const float* adj = a.adj + (long long)b * N * N;
      const int ks = splits(N, 4 * kThreads, 4);
      // a quarter-warp (8 lanes) shares its split, so its reads of h1 are
      // one broadcast
      const int s = tid / 8 % ks, r = 4 * (tid % 8 + 8 * (tid / (8 * ks)));
      float acc[32] = {};
      if (r < N) {
        const float* A[4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
          A[i] = adj + (long long)min(r + i, N - 1) * N;
        if (N % 4 == 0) {
          const int kq = N / 4, klo = 4 * (kq * s / ks),
                    khi = 4 * (kq * (s + 1) / ks);
#pragma unroll 4
          for (int k = klo; k < khi; k += 4) {
            float4 x[4];
#pragma unroll
            for (int i = 0; i < 4; ++i)
              x[i] = *reinterpret_cast<const float4*>(A[i] + k);
#pragma unroll
            for (int kk = 0; kk < 4; ++kk) {
              const float4 w0 =
                  *reinterpret_cast<const float4*>(h1r + (k + kk) * kSP);
              const float4 w1 =
                  *reinterpret_cast<const float4*>(h1r + (k + kk) * kSP + 4);
              const float4 av = make_float4(comp(x[0], kk), comp(x[1], kk),
                                            comp(x[2], kk), comp(x[3], kk));
              fma4x4(acc, av, w0);
              fma4x4(acc + 16, av, w1);
            }
          }
        } else {
          const int klo = N * s / ks, khi = N * (s + 1) / ks;
#pragma unroll 4
          for (int k = klo; k < khi; ++k) {
            const float4 av = make_float4(A[0][k], A[1][k], A[2][k], A[3][k]);
            fma4x4(acc, av, *reinterpret_cast<const float4*>(h1r + k * kSP));
            fma4x4(acc + 16, av,
                   *reinterpret_cast<const float4*>(h1r + k * kSP + 4));
          }
        }
      }
      reduce_splits(acc, 8, ks);
      if (s == 0) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          if (r + i >= N) continue;
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            hiS[j * NP + r + i] = acc[4 * i + j];
            hiS[(j + 4) * NP + r + i] = acc[16 + 4 * i + j];
          }
        }
      }
    }
    cl.sync();   // every CTA's hi is written

    // F3: [hi | h0] W[l], the update, the dropout, the skip.  A thread: 2
    // rows x 4 channels, hi and h0 read from the owning CTAs (8 bytes a k).
    {
      const float th = a.theta[l], alpha = a.alpha;
      const unsigned* tx = tab + 3 * kOwners;
      const unsigned* ty = tab + 4 * kOwners;
      for (int r0 = 0; r0 < N;) {
        const int ks = splits(N - r0, 256, 16);
        const int cq = lane % 2, s = tid / 2 % ks, r = r0 + 2 * (tid / (2 * ks));
        const int klo = K2 * s / ks, khi = K2 * (s + 1) / ks;
        float acc[8] = {};
        if (r < N) {
          const float* w = Wconv + 4 * cq;
#pragma unroll 16
          for (int k = klo; k < min(khi, H); ++k) {
            const float2 x = ld_cluster2(tx[k] + 4 * r);
            const float4 v = *reinterpret_cast<const float4*>(w + k * kSP);
            const float wv[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              acc[j] = fmaf(x.x, wv[j], acc[j]);
              acc[4 + j] = fmaf(x.y, wv[j], acc[4 + j]);
            }
          }
#pragma unroll 16
          for (int k = max(klo, H); k < khi; ++k) {
            const float2 x = ld_cluster2(ty[k - H] + 4 * r);
            const float4 v = *reinterpret_cast<const float4*>(w + k * kSP);
            const float wv[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              acc[j] = fmaf(x.x, wv[j], acc[j]);
              acc[4 + j] = fmaf(x.y, wv[j], acc[4 + j]);
            }
          }
        }
        reduce_splits(acc, 2, ks);
        if (s == 0) {
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            if (r + i >= N) continue;
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              const int cj = 4 * cq + j, e = cj * NP + r + i;
              const float pre =   // as F3Update forms it
                  th * acc[4 * i + j] +
                  (1.0f - th) * ((1.0f - alpha) * hiS[e] + alpha * h0S[e]);
              float hn = fmaxf(pre, 0.0f);
              if (a.drop && inv_keep != 1.0f && cj < S)
                hn = philox::keep(seed, bl, l, r + i, c0 + cj, thresh)
                         ? hn * inv_keep
                         : 0.0f;
              if (a.reason) hn += hS[e];
              hS[e] = hn;
              if (!a.reason) h1r[(r + i) * kSP + cj] = hn;
            }
          }
        }
        r0 += 256 / ks;
      }
    }
    cl.sync();   // every CTA's h is written; every gather of this layer done
  }
  for (int e = tid; e < N * S; e += kThreads) {
    const int r = e / S, j = e % S;
    a.out[gb + (long long)r * H + c0 + j] = hS[j * NP + r];
  }
}

// The designs gcnii_fwd runs (the wrapper picks one by shape).
enum Design { kTiled = 0, kRowwise = 1, kResident = 2 };

// F1 at the wide tile; TC: on the tensor cores (the f32 mode), else on
// the CUDA cores (the bf16 modes).
template <bool TC, class Epi>
cudaError_t wide(const Operand& A, const Operand& B, int M, int N, int K,
                 int batches, const Epi& e, cudaStream_t st) {
  if constexpr (TC)
    return gemm::launch_tc<128, 128, 64, 32, true, false, 2>(
        A, B, M, N, K, batches, 1, e, st);
  else
    return gemm::launch<128, 128, 8, true, false, 2>(A, B, M, N, K, batches,
                                                     1, e, st);
}

// F2 and F3 at the narrow tile: B x N / 64 blocks, one block per SM at
// most at the training shape, so their registers are not capped.  Kernel
// D's P2 and P3 launch the same.
template <bool TC, class Epi>
cudaError_t narrow100(const Operand& A, const Operand& B, int M, int N,
                      int K, int batches, const Epi& e, cudaStream_t st) {
  if constexpr (TC)
    return gemm::launch_tc<64, 128, 32, 32, true, false, 2>(
        A, B, M, N, K, batches, 1, e, st);
  else
    return gemm::launch<64, 128, 4, true, false, 1>(A, B, M, N, K, batches,
                                                    1, e, st);
}

// One launch of the resident kernel: grid (kCluster, B), one cluster a
// dialogue.  Refused (minus the CUDA error) where the shared memory or the
// cluster does not fit the card.
cudaError_t resident(const ResidentArgs& a, int B, cudaStream_t st) {
  const long long smem = resident_smem_bytes(a.N, a.H);
  if (smem > kSmemMax || a.H > kCluster * kSP) return cudaErrorInvalidValue;
  static bool attrs = false;
  if (!attrs) {
    cudaError_t err = cudaFuncSetAttribute(
        gcnii_resident_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        kSmemMax);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(gcnii_resident_kernel,
                                 cudaFuncAttributeNonPortableClusterSizeAllowed,
                                 1);
    if (err != cudaSuccess) return err;
    attrs = true;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(kCluster, B);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = (size_t)smem;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = kCluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int clusters = 0;
  cudaError_t err = cudaOccupancyMaxActiveClusters(
      &clusters, (void*)gcnii_resident_kernel, &cfg);
  if (err != cudaSuccess) return err;
  if (clusters < 1) return cudaErrorLaunchOutOfResources;
  err = cudaLaunchKernelEx(&cfg, gcnii_resident_kernel, a);
  return err != cudaSuccess ? err : cudaGetLastError();
}

template <bool BF16 = false>
cudaError_t init(const float* h, View hs, View h1, View lh, View lc, int B,
                 long long NH, cudaStream_t st, ViewB rh = {},
                 ViewB rlh = {}, ViewB rlc = {}) {
  const long long total = B * NH;
  const long long want = (total + 255) / 256;
  const unsigned blocks = (unsigned)(want < 1024 ? want : 1024);
  gcnii_fwd_init<BF16><<<blocks, 256, 0, st>>>(h, hs, h1, lh, lc, rh, rlh,
                                               rlc, NH, total);
  return cudaGetLastError();
}

#define GCNII_LAUNCH(call)                    \
  do {                                        \
    err = (call);                             \
    if (err != cudaSuccess) return -(int)err; \
    ++launches;                               \
  } while (0)

// The tiled design's whole stack (see the note at the top).  BF16: the
// bf16 mode, whose carries live as in serve mode with training mode's
// bf16 slabs beside them; its scratch is hi, the lh pair, lc, bf16(hi) and
// bf16(h1), 6 (B, N, H) f32.
template <bool BF16>
int tiled(const float* adj, const float* h, const float* h0, const float* W,
          const float* theta, float alpha, const float* wl, float* out,
          float* scratch, float* res_h, float* res_lh, float* res_lc,
          float* res_h1, int drop, const philox::Rate& rate,
          const long long* seed, int reason, int nl, int Bc, int B, int N,
          int H, cudaStream_t st) {
  const long long NH = (long long)N * H, NN = (long long)N * N;
  const long long RH = (long long)B * NH;
  const int G = 4 * H;
  const bool keep = res_h != nullptr;      // residuals asked for
  const bool train = keep && !BF16;        // the state in the f32 slabs
  const long long sb = train ? nl * NH : NH;   // the state's batch stride
  float* hi = scratch;
  // serve mode only: the lh pair and lc after hi
  float* lh_buf[2] = {scratch + RH, scratch + 2 * RH};
  float* lc_buf = scratch + 3 * RH;
  float* hir = BF16 ? scratch + 4 * RH : nullptr;   // bf16(hi)
  float* h1r = BF16 ? scratch + 5 * RH : nullptr;   // bf16(h1)
  auto slab = [&](float* p, int l) { return View{p + l * NH, sb, H}; };
  const View none{nullptr, 0, H};
  const ViewB noneb{nullptr, 0, H};
  auto bslab = [&](float* p, int l) {   // layer l's bf16 slab, if kept
    return BF16 && keep
               ? ViewB{reinterpret_cast<bf16*>(p) + l * NH, nl * NH, H}
               : noneb;
  };
  int launches = 0;
  cudaError_t err = cudaSuccess;
  const View h_0 = train ? slab(res_h, 0) : View{out, NH, H};
  const View lh_0 = train ? slab(res_lh, 0) : View{lh_buf[0], NH, H};
  const View lc_0 = train ? slab(res_lc, 0) : View{lc_buf, NH, H};
  const View h1_0 = reason ? none
                    : BF16 ? View{h1r, NH, H}
                    : train ? slab(res_h1, 0)
                            : none;
  GCNII_LAUNCH(init<BF16>(h, h_0, h1_0, reason ? lh_0 : none,
                          reason ? lc_0 : none, B, NH, st, bslab(res_h, 0),
                          reason ? bslab(res_lh, 0) : noneb,
                          reason ? bslab(res_lc, 0) : noneb));

  for (int l = 0; l < nl; ++l) {
    const bool last = l + 1 == nl;
    const View h_l = train ? slab(res_h, l) : View{out, NH, H};
    const View h_next =
        train && !last ? slab(res_h, l + 1) : View{out, NH, H};
    View h1_l = h_l;
    if (reason) {
      F1CellT<BF16> f1{};
      f1.bias = wl + 2LL * H * G;
      f1.bias_ks = (2LL * H + 1) * G;
      f1.Bc = Bc;
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
      f1.h1r = View{h1r, NH, H};
      f1.res_lh = last ? noneb : bslab(res_lh, l + 1);
      f1.res_lc = last ? noneb : bslab(res_lc, l + 1);
      const Operand A =
          gemm::cat(h_l.p, h_l.bs, lh_l.p, lh_l.bs, H, 1, H, true);
      const Operand Bw = gemm::grouped(gemm::dense(wl, 0, 1, G), Bc,
                                       (2LL * H + 1) * G, (2LL * H + 1) * G);
      GCNII_LAUNCH(wide<!BF16>(A, Bw, N, G, 2 * H, B, f1, st));
    }
    {   // F2 (BF16: on bf16(h1))
      const Operand A = gemm::dense(adj, NN, N, 1);
      const Operand Bh = BF16 ? gemm::dense(h1r, NH, 1, H)
                              : gemm::dense(h1_l.p, h1_l.bs, 1, H);
      const F2HiT<BF16> f2{hi, N, H, hir};
      GCNII_LAUNCH(narrow100<!BF16>(A, Bh, N, H, N, B, f2, st));
    }
    {   // F3 (BF16: on bf16(hi))
      const Operand A = gemm::cat(BF16 ? hir : hi, NH, h0, NH, H, 1, H, true);
      const long long wk = (long long)nl * 2 * H * H;   // a configuration's W
      const Operand Bw = gemm::grouped(
          gemm::dense(W + (long long)l * 2 * H * H, 0, 1, H), Bc, wk, wk);
      const View h1_next = reason || last ? none
                           : BF16 ? View{h1r, NH, H}
                           : train ? slab(res_h1, l + 1)
                                   : none;
      F3UpdateT<BF16> f3{hi, h0, h_l, h_next, h1_next, theta + l, alpha, l,
                         N, H, reason, drop, Bc, rate, seed};
      f3.res_next = last ? noneb : bslab(res_h, l + 1);
      GCNII_LAUNCH(narrow100<!BF16>(A, Bw, N, H, 2 * H, B, f3, st));
    }
  }
  return launches;
}

// The tiled design in the bf16 scan mode (see the note at the top).  The
// carries live as in serve mode (h in out, the lh pair, lc), bf16 values
// held in f32; scratch: hi (r without the variant), the lh pair, lc and
// the gates' first product g1 (B, N, 4H): 8 (B, N, H) f32.  wl is [W_ih;
// W_hh; b_ih; b_hh] interleaved, (2H + 2, 4H) a configuration; W is (nl,
// 2H, H), or (nl, H, H) without the variant.
int tiled_scan(const float* adj, const float* h, const float* h0,
               const float* W, const float* theta, float alpha,
               const float* wl, float* out, float* scratch, float* res_h,
               float* res_lh, float* res_lc, int drop,
               const philox::Rate& rate, const long long* seed, int reason,
               int variant, int last_f32, int nl, int Bc, int B, int N, int H,
               cudaStream_t st) {
  const long long NH = (long long)N * H, NN = (long long)N * N;
  const long long RH = (long long)B * NH;
  const int G = 4 * H;
  const int WI = variant ? 2 * H : H;          // a layer's weight rows
  const long long WLK = (2LL * H + 2) * G;     // a configuration's wl
  const long long wk = (long long)nl * WI * H;  // a configuration's W
  const bool keep = res_h != nullptr;
  const scan::Consts k = scan::consts(alpha);
  float* hi = scratch;
  float* lh_buf[2] = {scratch + RH, scratch + 2 * RH};
  float* lc_buf = scratch + 3 * RH;
  float* g1 = scratch + 4 * RH;
  const View none{nullptr, 0, H};
  const ViewB noneb{nullptr, 0, H};
  auto bslab = [&](float* p, int l) {   // layer l's bf16 slab, if kept
    return keep ? ViewB{reinterpret_cast<bf16*>(p) + l * NH, nl * NH, H}
                : noneb;
  };
  int launches = 0;
  cudaError_t err = cudaSuccess;
  GCNII_LAUNCH(init<true>(h, View{out, NH, H}, none,
                          reason ? View{lh_buf[0], NH, H} : none,
                          reason ? View{lc_buf, NH, H} : none, B, NH, st,
                          bslab(res_h, 0), reason ? bslab(res_lh, 0) : noneb,
                          reason ? bslab(res_lc, 0) : noneb));

  for (int l = 0; l < nl; ++l) {
    const bool last = l + 1 == nl;
    const float* h1 = out;   // without reason the layer's input h
    if (reason) {
      const Operand Bih = gemm::grouped(gemm::dense(wl, 0, 1, G), Bc, WLK,
                                        WLK);
      const F1GateS f1a{g1, N, G, wl + 2LL * H * G, WLK, Bc};
      GCNII_LAUNCH(wide<false>(
          gemm::dense(static_cast<const float*>(out), NH, H, 1), Bih, N, G,
          H, B, f1a, st));
      F1CellS f1b{};
      f1b.g1 = g1;
      f1b.bhh = wl + (2LL * H + 1) * G;
      f1b.bias_ks = WLK;
      f1b.Bc = Bc;
      f1b.N = N;
      f1b.G = G;
      f1b.lc = View{lc_buf, NH, H};
      f1b.h1 = View{lh_buf[(l + 1) % 2], NH, H};
      f1b.res_lh = last ? noneb : bslab(res_lh, l + 1);
      f1b.res_lc = last ? noneb : bslab(res_lc, l + 1);
      const Operand Bhh = gemm::grouped(
          gemm::dense(wl + (long long)H * G, 0, 1, G), Bc, WLK, WLK);
      GCNII_LAUNCH(wide<false>(
          gemm::dense(static_cast<const float*>(lh_buf[l % 2]), NH, H, 1),
          Bhh, N, G, H, B, f1b, st));
      h1 = lh_buf[(l + 1) % 2];
    }
    {   // F2
      const F2HiS f2{hi, h0, N, H, variant, k};
      GCNII_LAUNCH(narrow100<false>(gemm::dense(adj, NN, N, 1),
                                    gemm::dense(h1, NH, 1, H), N, H, N, B,
                                    f2, st));
    }
    {   // F3
      const Operand A =
          variant ? gemm::cat(static_cast<const float*>(hi), NH, h0, NH, H,
                              1, H, true)
                  : gemm::dense(static_cast<const float*>(hi), NH, H, 1);
      const Operand Bw = gemm::grouped(
          gemm::dense(W + (long long)l * WI * H, 0, 1, H), Bc, wk, wk);
      F3UpdateS f3{};
      f3.hi = hi;
      f3.h0 = h0;
      f3.h = out;
      f3.theta = theta + l;
      f3.k = k;
      f3.l = l;
      f3.N = N;
      f3.H = H;
      f3.reason = reason;
      f3.drop = drop;
      f3.Bc = Bc;
      f3.variant = variant;
      f3.last_f32 = last && last_f32;
      f3.rate = rate;
      f3.seed = seed;
      f3.res_next = last ? noneb : bslab(res_h, l + 1);
      GCNII_LAUNCH(narrow100<false>(A, Bw, N, H, WI, B, f3, st));
    }
  }
  return launches;
}

}  // namespace

// The whole forward on `stream`; see the note at the top.  out (B, N, H)
// gets the stack's output.  wl is [W_ih; W_hh; b] with interleaved gate
// columns, (2H + 1, 4H), read by the tiled and resident designs with
// reason; ih, hh
// (H, 4H) and lb (4H) are read by the row-wise design with reason.  The
// residual pointers are null outside training mode; without reason the
// lh and lc slabs are not written (the caller zeroes them).  scratch:
// (B, N, H) for hi in the tiled design's training mode, else 4 (B, N, H)
// (tiled: hi, the two lh buffers and lc; row-wise: two h1 buffers, lh, lc);
// the resident design keeps its state in shared memory and reads none.
// mode & 3 = 1: the bf16 mode (the tiled design; see the note at the top):
// adj, h0 and W hold bf16 values, the three residual slabs res_h, res_lh,
// res_lc are bf16 (res_h1 unused), and scratch is 6 (B, N, H) f32.
// mode & 3 = 2: the bf16 scan mode (the tiled design): adj, h, h0, W and
// wl hold bf16 values, wl is [W_ih; W_hh; b_ih; b_hh] interleaved, the
// slabs as in the bf16 mode, scratch 8 (B, N, H) f32; mode & 4: the last
// layer's dropout in f32; mode & 8: variant=False, W (nl, H, H).
extern "C" int gcnii_fwd(
    const float* adj, const float* h, const float* h0, const float* W,
    const float* theta, float alpha, const float* wl, const float* ih,
    const float* hh, const float* lb, float* out, float* scratch,
    float* res_h, float* res_lh, float* res_lc, float* res_h1, int drop,
    const unsigned int* thresh_k, const float* inv_keep_k,
    unsigned int thresh, float inv_keep, const long long* seed, int reason,
    int design, int nl, int K, int Bc, int N, int H, int mode,
    void* stream) {
  const int numerics = mode & 3;
  if (H > kHMax || K <= 0 || Bc <= 0 || N <= 0 || nl <= 0 ||
      (design != kTiled && design != kRowwise && design != kResident) ||
      numerics == 3 || (numerics && design != kTiled) ||
      (numerics != 2 && (mode & 12)))
    return -(int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const int B = K * Bc;   // the dialogues of all configurations
  const philox::Rate rate{thresh_k, inv_keep_k, thresh, inv_keep};
  const long long NH = (long long)N * H;
  const long long RH = (long long)B * NH;
  int launches = 0;
  cudaError_t err = cudaSuccess;

  if (design == kResident) {
    const ResidentArgs a{adj,   h,     h0,     W,      theta,  wl,
                         alpha, out,   res_h,  res_lh, res_lc, res_h1,
                         drop,  rate,  seed,   reason, nl,     Bc,
                         N,     H};
    GCNII_LAUNCH(resident(a, B, st));
    return launches;
  }

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
          lw, l + 1, nl, res_h, res_lh, res_lc, res_h1, drop, rate, seed,
          Bc);
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

  if (numerics == 2)
    return tiled_scan(adj, h, h0, W, theta, alpha, wl, out, scratch, res_h,
                      res_lh, res_lc, drop, rate, seed, reason,
                      (mode & 8) == 0, (mode & 4) != 0, nl, Bc, B, N, H, st);
  return numerics ? tiled<true>(adj, h, h0, W, theta, alpha, wl, out,
                                scratch, res_h, res_lh, res_lc, res_h1, drop,
                                rate, seed, reason, nl, Bc, B, N, H, st)
                  : tiled<false>(adj, h, h0, W, theta, alpha, wl, out,
                                 scratch, res_h, res_lh, res_lc, res_h1,
                                 drop, rate, seed, reason, nl, Bc, B, N, H,
                                 st);
#undef GCNII_LAUNCH
}

