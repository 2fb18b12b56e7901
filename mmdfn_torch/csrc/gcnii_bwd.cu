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
//   d_hi = tdpre W1^T + (1-theta)(1-a) dpre;  d_h0 += tdpre W2^T + (1-theta) a dpre
//   d_adj += d_hi h1^T;   d_h1 = adj^T d_hi      (the transposed contraction,
//                                                   adj is not assumed symmetric)
//   reason: the LSTM step's backward from d_h1 + dlh and dlc (gates
//     recomputed from h, lh, lc); dh = dh + dgates W_ih^T;
//     dlh = dgates W_hh^T;  dlc = dlc1 f
//   else: dh = d_h1
// and after the walk, as sums over every row:
//   dW[l] = [hi_l, h0]^T tdpre_l;   [dW_ih; dW_hh; db] = [h, lh, 1]^T dgates
// After layer 0, dh is the gradient of the stack's entry h.
//
// Bound: at the training shapes (B = 32, N = 240, H = 100, 16 layers, R =
// B N rows) the function is nine products a layer: 6 B N^2 H for adj @ h1,
// adj^T d_hi and d_hi h1^T, 60 R H^2 for the gate recompute, the support
// product, both input-gradient pairs and the weight gradients; with ~40 R H
// of elementwise work, ~91 GFLOP, 1.37 ms at the card's 67 TFLOP/s in f32
// (0.55 ms at 3xTF32's 165 on the tensor cores).  Its bytes (the four 49
// MB residual slabs, the adjacency, and the gates, hi, tdpre and dgates
// scratch written and read once) take ~0.4 ms, so it is bound by
// operations.
//
// Design: every product is one launch of the tiled product of
// gemm_f32.cuh, with its elementwise work in the epilogue: in the f32
// mode on the tensor cores as 3xTF32 (launch_tc), in the bf16 modes on
// the CUDA cores (launch).  Per layer, each
// batched over the B dialogues (rows = the N nodes of one dialogue):
//   P1 gates = act([h | lh] [W_ih; W_hh] + b)      wide    -> gates scratch
//   P2 hi = adj h1                                 narrow  -> hi slab[l]
//   P3 [hi | h0] W[l]; pre, the Philox redraw, dpre, tdpre, d_hi, dh0
//                                                  narrow  -> tdpre slab[l]
//   P4 tdpre W[l]^T: d_hi += [:, :H], dh0 += [:, H:] narrow
//   P5 d_adj += d_hi h1^T                          narrow
//   P6 d_h1 = adj^T d_hi; the LSTM step's backward narrow  -> dgates slab[l]
//   P7 dgates [W_ih^T | W_hh^T]: dh += [:, :H], dlh = [:, H:]   narrow
// (without reason P1 and P7 are skipped and P6 writes dh = d_h1).  After
// the walk, two split-K products write partial sums over row splits, and
// two sums add the partials in split order (deterministic, no atomics):
// dW for all layers in one launch (K = R), and [dW_ih; dW_hh; db] in one
// launch over every layer's rows (K = B nl N; the dgates slab is laid out
// (B, nl, N, 4H) like the residual slabs).  No operand is copied to
// transpose it: each is read in place through its strides.
//
// Tiles (BM x BN, 256 threads): wide 128 x 128 for P1 and the
// weight-gradient sums; narrow 64 x 128 for the rest (more blocks where a
// product has 100-240 columns).  Both are capped at 128 registers for two
// blocks per SM, except the three products with H columns (P2, P3, P6),
// which launch at most one block per SM.  On the tensor cores (the f32
// mode) a warp holds a 64 x 32 (wide) or 32 x 32 (narrow) tile of
// m16n8k8 products, and a ring of three 16-deep slices takes 52.2 KB
// (wide, dynamic shared memory) or 39.9 KB; on the CUDA cores (the bf16
// modes) a thread holds an 8 x 8 or 4 x 8 register tile, and three 8-deep
// slices take 25.3 or 19.2 KB (128 columns let the 16 column threads of a
// row read B conflict-free; 112 measured slower).  Registers and spills:
// see `-Xptxas -v` (chip_smoke.py prints them and fails on a spill).
//
// Why 3xTF32 on the tensor cores, and not TF32: TF32 keeps ~3 decimal
// digits, and the port holds kernel D to 1e-4 of each gradient's scale
// against the plain f32 version; split into two TF32 values each operand
// keeps 22 of f32's 24 significand bits, and the three products sum as
// f32 does (gemm_f32.cuh; tests/test_torch_tf32x3.py).  The bf16 modes
// stay on the CUDA cores, whose checks hold them to f32 sums of bf16
// values in that core's order.
//
// Config axis (the grouped sweep's K stacked configurations), as in
// gcnii_fwd.cu: the walk's products run the K B dialogues as one batch,
// their weight operands stepping to the next configuration's copy every B
// batches, and where the rates differ the dropout's keep threshold and
// keep scale are read per configuration (philox::Rate; JAX's `dyn`
// branch, pallas_gcnii_train.py:230-234), with Philox's counter at the
// dialogue's index within its configuration.  The
// weight-gradient sums run one batch per (configuration, layer) over that
// configuration's B N rows only, split as its run alone splits them, so
// each configuration's dW and LSTM gradients are its run alone's sums.
//
// The bf16 mode (use_bf16 = 1; the JAX package's production configuration)
// is _bwd_kernel's own numerics (pallas_gcnii_train.py:236-321, 637-638):
// adj, h0 and W arrive as f32 tensors holding bf16 values, the residuals
// are three bf16 slabs (h, lh, lc; no h1 slab), and each layer is
// recomputed from those bf16 carries, the LSTM step included.  P1 then
// runs on the interleaved [W_ih; W_hh; b] (as kernel B's F1) so that its
// epilogue holds a channel's four gates: it writes the activated gates as
// P1Gates does and the recomputed h1, as it is (for P5) and rounded to
// bf16 (for P2).  P2 is adj @ bf16(h1) and also writes bf16(hi), P3
// [bf16(hi) | h0] W[l] (bf16 values, f32 sums, as in kernel B); the rest,
// and every gradient product, is f32 with hi and h1 unrounded (:283-321).
// The products that read a bf16 slab (P1; P2 and P5 without reason; the
// LSTM weights' gradient) widen it as they stage it (gemm_f32.cuh).  d_adj
// (P5's last layer), d_h0 (P4's) and dW (its sum) are rounded to bf16
// where they are last written (:637-638); d_h_entry and the LSTM gradients
// stay f32.  The same launches.
//
// The bf16 scan mode (mode 2; the JAX package's bf16 layer scan, see
// gcnii_fwd.cu) is the transpose of that scan as ops/gcnii.py:
// _scan_bwd_plain writes it, which equals autograd of the plain scan (and
// JAX's transposed scan) bit for bit on the CPU.  Each layer is recomputed
// from the bf16 slabs through gcnii_scan.cuh, as kernel B computes it: P1a
// (h W_ih + b_ih) and P1b (the gates and the cell: the activated gates and
// h1) at kernel B's F1a and F1b tiles, P2 hi rounded (r without the
// variant), P3 the pre-activation.  Every op of the backward is rounded to
// bf16 where autograd's backward of the plain scan rounds it, and the
// gradients the scan carries or sums are bf16: d_h, d_lh, d_lc between
// layers; d_adj (P5), d_h0 (P3 takes the r path's term, P4 the support
// product's) and the LSTM's weights summed from the last layer down,
// rounded after each layer's add; each layer's dW rounded.  The LSTM
// weights' gradient is one product a dialogue and layer (K = N rows),
// summed over a configuration's dialogues in f32, rounded a layer, and
// the layers' sums added in bf16 from the last layer down (one kernel).
// The products' sums are f32 in the tiles' order, so against the plain
// version on the card they differ where that order rounds a value to the
// neighbouring bf16 number.
//
// C interface: device pointers to contiguous f32 arrays (in the bf16 mode
// the residual slabs bf16); the stream is the caller's.
// gcnii_bwd runs the whole backward and returns the number of kernels it
// launched, or minus the CUDA error of the first launch that failed
// (cudaGetLastError() after each launch).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include "gcnii_scan.cuh"
#include "gemm_f32.cuh"
#include "philox.cuh"

namespace {

using gemm::Operand;
using gemm::bf16;
using gemm::round_bf16;
using gemm::widen;

__device__ __forceinline__ float sigmoidf_(float x) {
  return 1.0f / (1.0f + expf(-x));
}

// The shapes every epilogue needs; o(b, r, c) is the offset of (b, node r,
// channel c) in a (B, N, H) array.
struct Dims {
  int N, H, nl, l;
  __device__ __forceinline__ long long o(int b, int r, int c) const {
    return ((long long)b * N + r) * H + c;
  }
  // (b, layer l, node r, column c) in a (B, nl, N, width) slab
  __device__ __forceinline__ long long slab(int b, int r, int c,
                                            int width) const {
    return (((long long)b * nl + l) * N + r) * width + c;
  }
};

// Each epilogue reads its global inputs in load() and writes in operator()
// (see gemm_f32.cuh); each product has an epilogue type of its own, so that
// a profile names the product.

// P1: the reason-LSTM gates i, f, g, o of layer l, activated.
struct P1Gates {
  Dims d;
  const float* lb;   // (K, 4H)
  int Bc;            // dialogues a configuration
  float* gates;      // (B, N, 4H)
  struct In { float b; };
  __device__ P1Gates for_batch(int b) const {   // dialogue b's bias
    P1Gates e = *this;
    e.lb = lb + (long long)(b / Bc) * 4 * d.H;
    return e;
  }
  __device__ In load(int, int, int c) const { return {lb[c]}; }
  __device__ void operator()(int b, int r, int c, float v, In in) const {
    v += in.b;
    const int u = c / d.H;
    gates[((long long)b * d.N + r) * 4 * d.H + c] =
        u == 2 ? tanhf(v) : sigmoidf_(v);
  }
};

// P1 of the bf16 mode: the chunk at column c holds channel c / 4's gates
// (the interleaved weights, as kernel B's F1Cell); the activated gates in
// P1Gates' layout, and the LSTM step from the bf16 carries: h1, and h1
// rounded to bf16.
struct P1CellB : gemm::Chunk4 {
  Dims d;
  const float* bias;   // (4H) a configuration, interleaved as the weights
  long long bias_ks;   // the next configuration's bias: bias_ks further
  int Bc;
  const bf16* lc;      // (B, nl, N, H)
  float* gates;        // (B, N, 4H)
  float* h1;           // (B, N, H)
  float* h1r;          // (B, N, H)
  struct In { float bi, bf, bg, bo, lc; };
  __device__ P1CellB for_batch(int b) const {
    P1CellB e = *this;
    e.bias = bias + (b / Bc) * bias_ks;
    return e;
  }
  __device__ In load(int b, int r, int c) const {
    return {bias[c], bias[c + 1], bias[c + 2], bias[c + 3],
            widen(lc[d.slab(b, r, c / 4, d.H)])};
  }
  __device__ void operator()(int b, int r, int c, float4 v, In in) const {
    const int ch = c / 4, H = d.H;
    const float ig = sigmoidf_(v.x + in.bi), fg = sigmoidf_(v.y + in.bf);
    const float gg = tanhf(v.z + in.bg), og = sigmoidf_(v.w + in.bo);
    float* g = gates + ((long long)b * d.N + r) * 4 * H + ch;
    g[0] = ig;
    g[H] = fg;
    g[2 * H] = gg;
    g[3 * H] = og;
    const float hn = og * tanhf(fg * in.lc + ig * gg);
    h1[d.o(b, r, ch)] = hn;
    h1r[d.o(b, r, ch)] = round_bf16(hn);
  }
};

// P2: hi = adj h1 into layer l's slab of the (nl, B, N, H) hi store.
struct P2Hi {
  float* out;
  int N, H;
  using In = gemm::NoIn;
  __device__ In load(int, int, int) const { return {}; }
  __device__ void operator()(int b, int r, int c, float v, In) const {
    out[((long long)b * N + r) * H + c] = v;
  }
};

// P2 of the bf16 mode: hi, and bf16(hi) for P3.
struct P2HiB {
  float* out;
  float* hir;
  int N, H;
  using In = gemm::NoIn;
  __device__ In load(int, int, int) const { return {}; }
  __device__ void operator()(int b, int r, int c, float v, In) const {
    const long long o = ((long long)b * N + r) * H + c;
    out[o] = v;
    hir[o] = round_bf16(v);
  }
};

// P3: v = (hi W1 + h0 W2)(r, c); the update's backward up to tdpre.
struct P3Pre {
  Dims d;
  const float* hi;     // layer l's slab
  const float* h0;
  const float* dh;     // the carry: d(layer output)
  const float* theta;  // theta[l]
  float alpha;
  int drop, Bc;
  philox::Rate rate;
  const long long* seed;
  int first;           // l == nl - 1: dh0 starts here
  float* tdpre;        // layer l's slab
  float* d_hi;
  float* dh0;
  // set by for_batch, as F3Update's (gcnii_fwd.cu)
  unsigned int thr;
  float ik;
  unsigned long long key;
  int b0;
  struct In { float hi, h0, dh, dh0, th; };
  __device__ P3Pre for_batch(int b) const {
    P3Pre e = *this;
    const int k = b / Bc;
    e.b0 = k * Bc;
    e.ik = drop ? rate.inv_keep_of(k) : 1.0f;
    e.thr = drop ? rate.thresh_of(k) : 0u;
    e.key = drop ? (unsigned long long)*seed : 0ull;
    return e;
  }
  __device__ In load(int b, int r, int c) const {
    const long long o = d.o(b, r, c);
    return {hi[o], h0[o], dh[o], first ? 0.0f : dh0[o], *theta};
  }
  __device__ void operator()(int b, int r, int c, float v, In in) const {
    const long long o = d.o(b, r, c);
    const float th = in.th;
    const float pre =
        th * v + (1.0f - th) * ((1.0f - alpha) * in.hi + alpha * in.h0);
    float g = in.dh;
    if (drop && ik != 1.0f)   // a keep scale of 1 (rate 0) keeps all
      g = philox::keep(key, b - b0, d.l, r, c, thr) ? g * ik : 0.0f;
    const float dpre = pre > 0.0f ? g : 0.0f;
    tdpre[o] = th * dpre;
    d_hi[o] = (1.0f - th) * (1.0f - alpha) * dpre;
    dh0[o] = in.dh0 + (1.0f - th) * alpha * dpre;
  }
};

// P4 and P7: v = (x [Wa^T | Wb^T])(r, c), c < 2H; lo[c] (+)= v for c < H,
// hi[c - H] (+)= v for the rest.  lo_src is what lo adds to (lo itself, or
// the carry's first value); hi is overwritten when hi_add is 0.
struct SplitCols {
  Dims d;
  const float* lo_src;
  float* lo;
  float* hi;
  int hi_add;
  struct In { float old; };
  __device__ In load(int b, int r, int c) const {
    if (c < d.H) return {lo_src[d.o(b, r, c)]};
    return {hi_add ? hi[d.o(b, r, c - d.H)] : 0.0f};
  }
  __device__ void operator()(int b, int r, int c, float v, In in) const {
    if (c < d.H)
      lo[d.o(b, r, c)] = in.old + v;
    else
      hi[d.o(b, r, c - d.H)] = in.old + v;
  }
};

struct P4DProj : SplitCols {};
struct P7LstmIn : SplitCols {};

// P4 of the bf16 mode: at the last layer (rnd) d_h0 is final, rounded to
// bf16.
struct P4DProjB : SplitCols {
  int rnd;
  __device__ void operator()(int b, int r, int c, float v, In in) const {
    if (c < d.H)
      lo[d.o(b, r, c)] = in.old + v;
    else
      hi[d.o(b, r, c - d.H)] = rnd ? round_bf16(in.old + v) : in.old + v;
  }
};

// P5: d_adj (+)= d_hi h1^T.
struct P5DAdj {
  float* dadj;
  int N, first;
  struct In { float old; };
  __device__ In load(int b, int r, int c) const {
    return {first ? 0.0f : dadj[((long long)b * N + r) * N + c]};
  }
  __device__ void operator()(int b, int r, int c, float v, In in) const {
    dadj[((long long)b * N + r) * N + c] = in.old + v;
  }
};

// P5 of the bf16 mode: at the last layer (rnd) d_adj is final, rounded.
struct P5DAdjB : P5DAdj {
  int rnd;
  __device__ void operator()(int b, int r, int c, float v, In in) const {
    const float x = in.old + v;
    dadj[((long long)b * N + r) * N + c] = rnd ? round_bf16(x) : x;
  }
};

// P6: v = d_h1 = (adj^T d_hi)(r, c).  Without reason dh = d_h1; with it,
// the LSTM step's backward (the gates from P1).  TL: the lc slab's type.
template <class TL>
struct P6LstmT {
  Dims d;
  int reason, first;
  const float* gates;   // (B, N, 4H), activated
  const TL* res_lc;     // (B, nl, N, H)
  float* dh;
  float* dlh;
  float* dlc;
  float* dgates;        // (B, nl, N, 4H)
  struct In { float ig, fg, gg, og, lc, dlh, dlc; };
  __device__ In load(int b, int r, int c) const {
    if (!reason) return {};
    const int H = d.H;
    const long long o = d.o(b, r, c);
    const float* g = gates + ((long long)b * d.N + r) * 4 * H + c;
    return {g[0], g[H], g[2 * H], g[3 * H], widen(res_lc[d.slab(b, r, c, H)]),
            first ? 0.0f : dlh[o], first ? 0.0f : dlc[o]};
  }
  __device__ void operator()(int b, int r, int c, float v, In in) const {
    const long long o = d.o(b, r, c);
    if (!reason) {
      dh[o] = v;
      return;
    }
    const int H = d.H;
    const float ig = in.ig, fg = in.fg, gg = in.gg, og = in.og, lc = in.lc;
    const float tl = tanhf(fg * lc + ig * gg);
    const float dlh1 = v + in.dlh;
    const float dlc1 = in.dlc + dlh1 * og * (1.0f - tl * tl);
    float* dg = dgates + d.slab(b, r, c, 4 * H);
    dg[0] = dlc1 * gg * ig * (1.0f - ig);
    dg[H] = dlc1 * lc * fg * (1.0f - fg);
    dg[2 * H] = dlc1 * ig * (1.0f - gg * gg);
    dg[3 * H] = dlh1 * tl * og * (1.0f - og);
    dlc[o] = dlc1 * fg;
  }
};

using P6Lstm = P6LstmT<float>;

// The bf16 scan mode's epilogues (gcnii_scan.cuh's arithmetic).

// P1a: as kernel B's F1GateS, h W_ih + b_ih into g1 (B, N, 4H).
struct P1GateS {
  float* g1;
  int N, G;
  const float* bih;
  long long bias_ks;
  int Bc;
  struct In { float b; };
  __device__ P1GateS for_batch(int b) const {
    P1GateS e = *this;
    e.bih = bih + (b / Bc) * bias_ks;
    return e;
  }
  __device__ In load(int, int, int c) const { return {bih[c]}; }
  __device__ void operator()(int b, int r, int c, float v, In in) const {
    g1[((long long)b * N + r) * G + c] = scan::gate1(v, in.b);
  }
};

// P1b: as kernel B's F1CellS on the bf16 lc slab: the activated gates in
// P1Gates' layout and h1.
struct P1CellS : gemm::Chunk4 {
  Dims d;
  const float* g1;
  const float* bhh;
  long long bias_ks;
  int Bc;
  const bf16* lc;      // (B, nl, N, H)
  float* gates;        // (B, N, 4H)
  float* h1;           // (B, N, H)
  struct In { float4 g; float bi, bf, bg, bo, lc; };
  __device__ P1CellS for_batch(int b) const {
    P1CellS e = *this;
    e.bhh = bhh + (b / Bc) * bias_ks;
    return e;
  }
  __device__ In load(int b, int r, int c) const {
    const float4 g = *reinterpret_cast<const float4*>(
        g1 + ((long long)b * d.N + r) * 4 * d.H + c);
    return {g, bhh[c], bhh[c + 1], bhh[c + 2], bhh[c + 3],
            widen(lc[d.slab(b, r, c / 4, d.H)])};
  }
  __device__ void operator()(int b, int r, int c, float4 v, In in) const {
    const int ch = c / 4, H = d.H;
    const scan::Cell k = scan::cell(
        scan::gate(in.g.x, v.x, in.bi), scan::gate(in.g.y, v.y, in.bf),
        scan::gate(in.g.z, v.z, in.bg), scan::gate(in.g.w, v.w, in.bo),
        in.lc);
    float* g = gates + ((long long)b * d.N + r) * 4 * H + ch;
    g[0] = k.i;
    g[H] = k.f;
    g[2 * H] = k.g;
    g[3 * H] = k.o;
    h1[d.o(b, r, ch)] = k.h;
  }
};

// P2: as kernel B's F2HiS, into layer l's slab of the hi store.
struct P2HiS {
  float* out;
  const float* h0;
  int N, H, variant;
  scan::Consts k;
  using In = gemm::NoIn;
  __device__ In load(int, int, int) const { return {}; }
  __device__ void operator()(int b, int r, int c, float v, In) const {
    const long long o = ((long long)b * N + r) * H + c;
    const float x = scan::R(v);
    out[o] = variant ? x : scan::r_of(x, h0[o], k);
  }
};

// P3: v = ([hi | h0] W[l])(r, c) (without the variant (r W[l])(r, c)); the
// pre-activation as kernel B's F3UpdateS forms it; the gradient past the
// dropout (the first walked layer's from the unrounded d out: in f32 where
// last_f32), the ReLU; tdpre = theta dpre, and (1 - theta) dpre's terms:
// with the variant d_hi = (1-a) of it and d_h0's first term, else the term
// itself into d_hi, which P4 finishes.
struct P3PreS {
  Dims d;
  const float* hi;     // layer l's slab (r without the variant)
  const float* h0;
  const float* dh;     // d(layer output); the first walked layer: d out
  const float* theta;  // theta[l]
  scan::Consts k;
  int drop, Bc, first, variant, last_f32;
  philox::Rate rate;
  const long long* seed;
  float* tdpre;        // layer l's slab
  float* d_hi;
  float* dh0;
  // set by for_batch, as P3Pre's
  unsigned int thr;
  float ik;
  unsigned long long key;
  int b0;
  struct In { float hi, h0, dh, dh0, th; };
  __device__ P3PreS for_batch(int b) const {
    P3PreS e = *this;
    const int kc = b / Bc;
    e.b0 = kc * Bc;
    e.ik = drop ? rate.inv_keep_of(kc) : 1.0f;
    e.thr = drop ? rate.thresh_of(kc) : 0u;
    e.key = drop ? (unsigned long long)*seed : 0ull;
    return e;
  }
  __device__ In load(int b, int r, int c) const {
    const long long o = d.o(b, r, c);
    return {hi[o], h0[o], dh[o], first || !variant ? 0.0f : dh0[o], *theta};
  }
  __device__ void operator()(int b, int r, int c, float v, In in) const {
    const long long o = d.o(b, r, c);
    const float th = scan::theta(in.th), om = scan::omt(th);
    const float rr = variant ? scan::r_of(in.hi, in.h0, k) : in.hi;
    const float pre = scan::pre(v, rr, th, om);
    float g;
    if (drop && ik != 1.0f) {   // a keep scale of 1 (rate 0) keeps all
      const bool kp = philox::keep(key, b - b0, d.l, r, c, thr);
      g = !kp ? 0.0f
              : first && last_f32 ? scan::R(in.dh * ik)
                                  : scan::R(scan::R(in.dh) * scan::R(ik));
    } else {
      g = scan::R(in.dh);
    }
    const float dpre = pre > 0.0f ? g : 0.0f;
    tdpre[o] = scan::R(th * dpre);
    const float dr = scan::R(om * dpre);
    if (variant) {
      d_hi[o] = scan::R(k.a1 * dr);
      const float t = scan::R(k.a2 * dr);
      dh0[o] = first ? t : scan::R(in.dh0 + t);
    } else {
      d_hi[o] = dr;
    }
  }
};

// P4: v = (tdpre W[l]^T)(r, c), rounded.  With the variant, c < H: d_hi
// += v, else d_h0 += v; without, c < H: d_r = P3's term + v, then d_hi =
// (1-a) d_r and d_h0 += a d_r.
struct P4DProjS {
  Dims d;
  float* d_hi;
  float* dh0;
  scan::Consts k;
  int first, variant;
  struct In { float old, h0; };
  __device__ In load(int b, int r, int c) const {
    if (c >= d.H) return {dh0[d.o(b, r, c - d.H)], 0.0f};
    return {d_hi[d.o(b, r, c)],
            first || variant ? 0.0f : dh0[d.o(b, r, c)]};
  }
  __device__ void operator()(int b, int r, int c, float v, In in) const {
    const float x = scan::R(v);
    if (variant) {
      if (c < d.H)
        d_hi[d.o(b, r, c)] = scan::R(in.old + x);
      else
        dh0[d.o(b, r, c - d.H)] = scan::R(in.old + x);
      return;
    }
    const float dr = scan::R(in.old + x);
    d_hi[d.o(b, r, c)] = scan::R(k.a1 * dr);
    const float t = scan::R(k.a2 * dr);
    dh0[d.o(b, r, c)] = first ? t : scan::R(in.h0 + t);
  }
};

// P5: d_adj (+)= (d_hi h1^T) rounded, the sum rounded.
struct P5DAdjS {
  float* dadj;
  int N, first;
  struct In { float old; };
  __device__ In load(int b, int r, int c) const {
    return {first ? 0.0f : dadj[((long long)b * N + r) * N + c]};
  }
  __device__ void operator()(int b, int r, int c, float v, In in) const {
    const float x = scan::R(v);
    dadj[((long long)b * N + r) * N + c] = first ? x : scan::R(in.old + x);
  }
};

// P6: v = d_h1 = (adj^T d_hi)(r, c), rounded.  Without reason dh = d_h1;
// with it, the LSTM step's backward (the gates from P1b, lc from its slab).
struct P6LstmS {
  Dims d;
  int reason, first;
  const float* gates;   // (B, N, 4H), activated
  const bf16* res_lc;   // (B, nl, N, H)
  float* dh;
  float* dlh;
  float* dlc;
  float* dgates;        // (B, nl, N, 4H)
  struct In { float ig, fg, gg, og, lc, dlh, dlc; };
  __device__ In load(int b, int r, int c) const {
    if (!reason) return {};
    const int H = d.H;
    const long long o = d.o(b, r, c);
    const float* g = gates + ((long long)b * d.N + r) * 4 * H + c;
    return {g[0], g[H], g[2 * H], g[3 * H], widen(res_lc[d.slab(b, r, c, H)]),
            first ? 0.0f : dlh[o], first ? 0.0f : dlc[o]};
  }
  __device__ void operator()(int b, int r, int c, float v, In in) const {
    using scan::R;
    const long long o = d.o(b, r, c);
    const float dh1 = R(v);
    if (!reason) {
      dh[o] = dh1;
      return;
    }
    const int H = d.H;
    const float i = in.ig, f = in.fg, gg = in.gg, og = in.og, lc = in.lc;
    const float t = scan::tanh_(R(R(f * lc) + R(i * gg)));
    const float dlh1 = first ? dh1 : R(in.dlh + dh1);
    const float d_o = R(dlh1 * t), d_t = R(dlh1 * og);
    const float a = scan::dtanh_a(d_t, t);
    const float dlc1 = R((first ? a : R(in.dlc + a)) + R(a * t));
    const float d_i = R(dlc1 * gg), d_g = R(dlc1 * i), d_f = R(dlc1 * lc);
    const float ag = scan::dtanh_a(d_g, gg);
    float* dg = dgates + d.slab(b, r, c, 4 * H);
    dg[0] = scan::dsig(d_i, i);
    dg[H] = scan::dsig(d_f, f);
    dg[2 * H] = R(ag + R(ag * gg));
    dg[3 * H] = scan::dsig(d_o, og);
    dlc[o] = R(dlc1 * f);
  }
};

// P7: v = (dgates [W_ih^T | W_hh^T])(r, c), rounded: c < H, dh = d(layer
// output) + v (the skip and the LSTM input); else dlh = v.
struct P7LstmInS {
  Dims d;
  const float* dh_src;   // d(layer output); the first walked layer: d out
  float* dh;
  float* dlh;
  struct In { float old; };
  __device__ In load(int b, int r, int c) const {
    return {c < d.H ? dh_src[d.o(b, r, c)] : 0.0f};
  }
  __device__ void operator()(int b, int r, int c, float v, In in) const {
    if (c < d.H)
      dh[d.o(b, r, c)] = scan::R(scan::R(in.old) + scan::R(v));
    else
      dlh[d.o(b, r, c - d.H)] = scan::R(v);
  }
};

// A split-K product's partial sums: part[blockIdx.z] is (M, N).
struct Partial {
  float* part;
  int M, N;
  using In = gemm::NoIn;
  __device__ In load(int, int, int) const { return {}; }
  __device__ void operator()(int, int r, int c, float v, In) const {
    part[((long long)blockIdx.z * M + r) * N + c] = v;
  }
};

struct WgradW : Partial {};
struct WgradLstm : Partial {};

// out[g][e] = sum over s of part[g][s][e], in split order; RND: rounded to
// bf16 (the bf16 mode's dW).
template <bool RND>
__global__ void gcnii_reduce_kernel(const float* __restrict__ part,
                                    int splits, long long E,
                                    float* __restrict__ out) {
  const int g = blockIdx.y;
  for (long long e = blockIdx.x * (long long)blockDim.x + threadIdx.x; e < E;
       e += (long long)gridDim.x * blockDim.x) {
    const float* p = part + (long long)g * splits * E + e;
    float acc = 0.0f;
    for (int s = 0; s < splits; ++s) acc += p[s * E];
    out[(long long)g * E + e] = RND ? round_bf16(acc) : acc;
  }
}

// The bf16 scan mode's LSTM weight gradients: part holds one (E) partial
// sum per (dialogue, layer), dialogue-major; out[k][e] sums configuration
// k's Bc dialogues of each layer in f32, rounds the layer's sum, and adds
// the layers from the last down in bf16.
__global__ void gcnii_scan_lstm_reduce_kernel(const float* __restrict__ part,
                                              int Bc, int nl, long long E,
                                              float* __restrict__ out) {
  const int k = blockIdx.y;
  for (long long e = blockIdx.x * (long long)blockDim.x + threadIdx.x; e < E;
       e += (long long)gridDim.x * blockDim.x) {
    float acc = 0.0f;
    for (int l = nl - 1; l >= 0; --l) {
      float v = 0.0f;
      for (int b = 0; b < Bc; ++b)
        v += part[(((long long)k * Bc + b) * nl + l) * E + e];
      v = scan::R(v);
      acc = l == nl - 1 ? v : scan::R(acc + v);
    }
    out[(long long)k * E + e] = acc;
  }
}

// The tile shapes (see the note at the top); wide and narrow leave room
// for two blocks per SM.  TC: on the tensor cores (the f32 mode), else on
// the CUDA cores (the bf16 modes).
template <bool TC, bool AKC, bool BKC, class Epi>
cudaError_t wide(const Operand& A, const Operand& B, int M, int N, int K,
                 int batches, int splits, const Epi& epi, cudaStream_t st) {
  if constexpr (TC)
    return gemm::launch_tc<128, 128, 64, 32, AKC, BKC, 2>(
        A, B, M, N, K, batches, splits, epi, st);
  else
    return gemm::launch<128, 128, 8, AKC, BKC, 2>(A, B, M, N, K, batches,
                                                  splits, epi, st);
}

// The wide tile with its registers not capped: the bf16 mode's products
// whose register-staged operands take a few more.
template <bool AKC, bool BKC, class OA, class OB, class Epi>
cudaError_t wide1(const OA& A, const OB& B, int M, int N, int K, int batches,
                  int splits, const Epi& epi, cudaStream_t st) {
  return gemm::launch<128, 128, 8, AKC, BKC, 1>(A, B, M, N, K, batches,
                                                splits, epi, st);
}

template <bool TC, bool AKC, bool BKC, class Epi>
cudaError_t narrow(const Operand& A, const Operand& B, int M, int N, int K,
                   int batches, const Epi& epi, cudaStream_t st) {
  if constexpr (TC)
    return gemm::launch_tc<64, 128, 32, 32, AKC, BKC, 2>(A, B, M, N, K,
                                                         batches, 1, epi, st);
  else
    return gemm::launch<64, 128, 4, AKC, BKC, 2>(A, B, M, N, K, batches, 1,
                                                 epi, st);
}

// The products with H = 100 columns launch one block per SM at most (B x
// N / 64 blocks): their registers need no cap (nor the bf16 mode's).  P2
// and P3 launch as kernel B's F2 and F3.
template <bool TC, bool AKC, bool BKC, class OA, class OB, class Epi>
cudaError_t narrow100(const OA& A, const OB& B, int M, int N, int K,
                      int batches, const Epi& epi, cudaStream_t st) {
  if constexpr (TC)
    return gemm::launch_tc<64, 128, 32, 32, AKC, BKC, 2>(A, B, M, N, K,
                                                         batches, 1, epi, st);
  else
    return gemm::launch<64, 128, 4, AKC, BKC, 1>(A, B, M, N, K, batches, 1,
                                                 epi, st);
}

// The f32 mode's weight-gradient sums (split K) on the tensor cores, at
// the narrow tile: the wide one spills at two blocks per SM where their
// group strides apply.
template <class Epi>
cudaError_t sums_tc(const Operand& A, const Operand& B, int M, int N, int K,
                    int batches, int splits, const Epi& epi,
                    cudaStream_t st) {
  return gemm::launch_tc<64, 128, 32, 32, false, false, 2>(
      A, B, M, N, K, batches, splits, epi, st);
}

cudaError_t reduce(const float* part, int groups, int splits, long long E,
                   float* out, cudaStream_t st, bool rnd = false) {
  const long long want = (E + 255) / 256;
  const unsigned blocks = (unsigned)(want < 4096 ? want : 4096);
  if (rnd)
    gcnii_reduce_kernel<true><<<dim3(blocks, groups), 256, 0, st>>>(
        part, splits, E, out);
  else
    gcnii_reduce_kernel<false><<<dim3(blocks, groups), 256, 0, st>>>(
        part, splits, E, out);
  return cudaGetLastError();
}

// The bf16 mode's walk and sums (see the note at the top).  h1s: the
// layer's recomputed h1, then bf16(h1) and bf16(hi) held in f32, (B, N, H)
// each.  wl: [W_ih; W_hh; b] interleaved, (2H + 1, 4H) a configuration,
// read with reason.
int backward_bf16(const float* adj, const float* h0, const float* W,
                  const float* theta, float alpha, const bf16* res_h,
                  const bf16* res_lh, const bf16* res_lc, float* h1s,
                  const float* wl, const float* ih, const float* hh,
                  const float* dh_out, float* dh, float* dlh, float* dlc,
                  float* d_hi, float* dh0, float* dadj, float* hi,
                  float* tdpre, float* gates, float* dgates, float* part_w,
                  float* part_l, float* dW, float* dl, int drop,
                  const philox::Rate& rate, const long long* seed, int reason,
                  int nl, int K, int Bc, int N, int H, int splits_w,
                  int splits_l, cudaStream_t st) {
  const int G = 4 * H;
  const int B = K * Bc;
  const long long NH = (long long)N * H, NN = (long long)N * N;
  const long long RH = (long long)B * NH;
  const long long CH = (long long)Bc * NH;
  const long long WK = (long long)nl * 2 * H * H, LK = (long long)H * G;
  const long long WLK = (2LL * H + 1) * G;   // a configuration's wl
  const int R = Bc * N;
  float* h1f = h1s;
  float* h1r = h1s + RH;
  float* hir = h1s + 2 * RH;
  int launches = 0;
  cudaError_t err = cudaSuccess;
#define GCNII_LAUNCH(call)                    \
  do {                                        \
    err = (call);                             \
    if (err != cudaSuccess) return -(int)err; \
    ++launches;                               \
  } while (0)

  for (int l = nl - 1; l >= 0; --l) {
    const Dims d{N, H, nl, l};
    const int first = l == nl - 1, last = l == 0;
    const float* dh_src = first ? dh_out : dh;
    const bf16* h_l = res_h + l * NH;   // (B, nl, N, H) at layer l
    float* hi_l = hi + l * RH;
    float* tdpre_l = tdpre + l * RH;
    const float* W_l = W + (long long)l * 2 * H * H;
    if (reason)   // P1
      GCNII_LAUNCH((wide1<true, false>(
          gemm::cat(h_l, nl * NH, res_lh + l * NH, nl * NH, H, 1, H, true),
          gemm::grouped(gemm::dense(wl, 0, 1, G), Bc, WLK, WLK), N, G, 2 * H,
          B, 1,
          P1CellB{{}, d, wl + 2LL * H * G, WLK, Bc, res_lc, gates, h1f, h1r},
          st)));
    // P2: the layer's bf16 h1 (without reason: its bf16 h, from the slab)
    const P2HiB p2{hi_l, hir, N, H};
    if (reason)
      GCNII_LAUNCH((narrow100<false, true, false>(
          gemm::dense(adj, NN, N, 1),
          gemm::dense(static_cast<const float*>(h1r), NH, 1, H), N, H, N, B,
          p2, st)));
    else
      GCNII_LAUNCH((narrow100<false, true, false>(
          gemm::dense(adj, NN, N, 1), gemm::dense(h_l, nl * NH, 1, H), N, H,
          N, B, p2, st)));
    // P3
    GCNII_LAUNCH((narrow100<false, true, false>(
        gemm::cat(static_cast<const float*>(hir), NH, h0, NH, H, 1, H, true),
        gemm::grouped(gemm::dense(W_l, 0, 1, H), Bc, WK, WK), N, H, 2 * H, B,
        P3Pre{d, hi_l, h0, dh_src, theta + l, alpha, drop, Bc, rate, seed,
              first, tdpre_l, d_hi, dh0},
        st)));
    // P4
    GCNII_LAUNCH((narrow<false, true, true>(
        gemm::dense(static_cast<const float*>(tdpre_l), NH, H, 1),
        gemm::grouped(gemm::dense(W_l, 0, H, 1), Bc, WK, WK), N, 2 * H, H, B,
        P4DProjB{{d, d_hi, d_hi, dh0, 1}, last}, st)));
    // P5: d_adj += d_hi h1^T, h1 unrounded (without reason: the bf16 h)
    const Operand dhi_rows = gemm::dense(static_cast<const float*>(d_hi), NH,
                                         H, 1);
    if (reason)
      GCNII_LAUNCH((narrow<false, true, true>(
          dhi_rows, gemm::dense(static_cast<const float*>(h1f), NH, H, 1), N,
          N, H, B, P5DAdjB{{dadj, N, first}, last}, st)));
    else
      GCNII_LAUNCH((narrow100<false, true, true>(
          dhi_rows, gemm::dense(h_l, nl * NH, H, 1), N, N, H, B,
          P5DAdjB{{dadj, N, first}, last}, st)));
    // P6
    GCNII_LAUNCH((narrow100<false, false, false>(
        gemm::dense(adj, NN, 1, N),
        gemm::dense(static_cast<const float*>(d_hi), NH, 1, H), N, H, N, B,
        P6LstmT<bf16>{d, reason, first, gates, res_lc, dh, dlh, dlc, dgates},
        st)));
    if (reason)   // P7
      GCNII_LAUNCH((narrow<false, true, true>(
          gemm::dense(static_cast<const float*>(dgates) + (long long)l * N * G,
                      (long long)nl * N * G, G, 1),
          gemm::grouped(gemm::cat(ih, 0, hh, 0, G, 1, H, false), Bc, LK, LK),
          N, 2 * H, G, B, P7LstmIn{{d, dh_src, dh, dlh, 0}}, st)));
  }

  // dW as in gcnii_bwd; rounded to bf16 in its sum
  GCNII_LAUNCH((wide<false, false, false>(
      gemm::grouped(gemm::cat(static_cast<const float*>(hi), RH, h0, 0, 1, H,
                              H, false),
                    nl, CH - nl * RH, CH),
      gemm::grouped(gemm::dense(static_cast<const float*>(tdpre), RH, 1, H),
                    nl, CH - nl * RH, CH - nl * RH),
      2 * H, H, R, K * nl, splits_w, WgradW{{part_w, 2 * H, H}}, st)));
  GCNII_LAUNCH(reduce(part_w, K * nl, splits_w, 2LL * H * H, dW, st, true));
  if (reason) {   // on the bf16 h and lh slabs
    auto A = gemm::cat(res_h, nl * CH, res_lh, nl * CH, 1, H, H, false);
    A.one_row = 2 * H;
    GCNII_LAUNCH((wide1<false, false>(
        A,
        gemm::dense(static_cast<const float*>(dgates),
                    (long long)Bc * nl * N * G, 1, G),
        2 * H + 1, G, R * nl, K, splits_l, WgradLstm{{part_l, 2 * H + 1, G}},
        st)));
    GCNII_LAUNCH(reduce(part_l, K, splits_l, (2LL * H + 1) * G, dl, st));
  }
#undef GCNII_LAUNCH
  return launches;
}

cudaError_t scan_lstm_reduce(const float* part, int K, int Bc, int nl,
                             long long E, float* out, cudaStream_t st) {
  const long long want = (E + 255) / 256;
  const unsigned blocks = (unsigned)(want < 4096 ? want : 4096);
  gcnii_scan_lstm_reduce_kernel<<<dim3(blocks, K), 256, 0, st>>>(part, Bc, nl,
                                                                 E, out);
  return cudaGetLastError();
}

// The bf16 scan mode's walk and sums (see the note at the top).  h1s: the
// layer's recomputed h1 (B, N, H), then the gates' first product g1 (B, N,
// 4H).  wl: [W_ih; W_hh; b_ih; b_hh] interleaved, (2H + 2, 4H) a
// configuration; ih, hh (H, 4H) each; all bf16 values.  W is (nl, 2H, H),
// or (nl, H, H) without the variant, and dW the same.  part_l: (K Bc nl,
// 2H + 1, 4H).
int backward_scan(const float* adj, const float* h0, const float* W,
                  const float* theta, float alpha, const bf16* res_h,
                  const bf16* res_lh, const bf16* res_lc, float* h1s,
                  const float* wl, const float* ih, const float* hh,
                  const float* dh_out, float* dh, float* dlh, float* dlc,
                  float* d_hi, float* dh0, float* dadj, float* hi,
                  float* tdpre, float* gates, float* dgates, float* part_w,
                  float* part_l, float* dW, float* dl, int drop,
                  const philox::Rate& rate, const long long* seed, int reason,
                  int variant, int last_f32, int nl, int K, int Bc, int N,
                  int H, int splits_w, cudaStream_t st) {
  const int G = 4 * H;
  const int B = K * Bc;
  const int WI = variant ? 2 * H : H;
  const long long NH = (long long)N * H, NN = (long long)N * N;
  const long long RH = (long long)B * NH;
  const long long CH = (long long)Bc * NH;
  const long long WK = (long long)nl * WI * H, LK = (long long)H * G;
  const long long WLK = (2LL * H + 2) * G;   // a configuration's wl
  const int R = Bc * N;
  const scan::Consts k = scan::consts(alpha);
  float* h1f = h1s;
  float* g1 = h1s + RH;
  int launches = 0;
  cudaError_t err = cudaSuccess;
#define GCNII_LAUNCH(call)                    \
  do {                                        \
    err = (call);                             \
    if (err != cudaSuccess) return -(int)err; \
    ++launches;                               \
  } while (0)

  for (int l = nl - 1; l >= 0; --l) {
    const Dims d{N, H, nl, l};
    const int first = l == nl - 1;
    const float* dh_src = first ? dh_out : dh;
    const bf16* h_l = res_h + l * NH;   // (B, nl, N, H) at layer l
    float* hi_l = hi + l * RH;
    float* tdpre_l = tdpre + l * RH;
    const float* W_l = W + (long long)l * WI * H;
    if (reason) {   // P1a, P1b
      GCNII_LAUNCH((wide1<true, false>(
          gemm::dense(h_l, nl * NH, H, 1),
          gemm::grouped(gemm::dense(wl, 0, 1, G), Bc, WLK, WLK), N, G, H, B,
          1, P1GateS{g1, N, G, wl + 2LL * H * G, WLK, Bc}, st)));
      P1CellS p1b{};
      p1b.d = d;
      p1b.g1 = g1;
      p1b.bhh = wl + (2LL * H + 1) * G;
      p1b.bias_ks = WLK;
      p1b.Bc = Bc;
      p1b.lc = res_lc;
      p1b.gates = gates;
      p1b.h1 = h1f;
      GCNII_LAUNCH((wide1<true, false>(
          gemm::dense(res_lh + l * NH, nl * NH, H, 1),
          gemm::grouped(gemm::dense(wl + (long long)H * G, 0, 1, G), Bc, WLK,
                        WLK),
          N, G, H, B, 1, p1b, st)));
    }
    // P2: adj h1 (without reason: the layer's h, from the slab)
    const P2HiS p2{hi_l, h0, N, H, variant, k};
    if (reason)
      GCNII_LAUNCH((narrow100<false, true, false>(
          gemm::dense(adj, NN, N, 1),
          gemm::dense(static_cast<const float*>(h1f), NH, 1, H), N, H, N, B,
          p2, st)));
    else
      GCNII_LAUNCH((narrow100<false, true, false>(
          gemm::dense(adj, NN, N, 1), gemm::dense(h_l, nl * NH, 1, H), N, H,
          N, B, p2, st)));
    // P3
    {
      P3PreS p3{};
      p3.d = d;
      p3.hi = hi_l;
      p3.h0 = h0;
      p3.dh = dh_src;
      p3.theta = theta + l;
      p3.k = k;
      p3.drop = drop;
      p3.Bc = Bc;
      p3.first = first;
      p3.variant = variant;
      p3.last_f32 = last_f32;
      p3.rate = rate;
      p3.seed = seed;
      p3.tdpre = tdpre_l;
      p3.d_hi = d_hi;
      p3.dh0 = dh0;
      const Operand A =
          variant ? gemm::cat(static_cast<const float*>(hi_l), NH, h0, NH, H,
                              1, H, true)
                  : gemm::dense(static_cast<const float*>(hi_l), NH, H, 1);
      GCNII_LAUNCH((narrow100<false, true, false>(
          A, gemm::grouped(gemm::dense(W_l, 0, 1, H), Bc, WK, WK), N, H, WI,
          B, p3, st)));
    }
    // P4
    GCNII_LAUNCH((narrow<false, true, true>(
        gemm::dense(static_cast<const float*>(tdpre_l), NH, H, 1),
        gemm::grouped(gemm::dense(W_l, 0, H, 1), Bc, WK, WK), N, WI, H, B,
        P4DProjS{d, d_hi, dh0, k, first, variant}, st)));
    // P5: d_adj += d_hi h1^T (without reason: the layer's h, from the slab)
    const Operand dhi_rows = gemm::dense(static_cast<const float*>(d_hi), NH,
                                         H, 1);
    if (reason)
      GCNII_LAUNCH((narrow<false, true, true>(
          dhi_rows, gemm::dense(static_cast<const float*>(h1f), NH, H, 1), N,
          N, H, B, P5DAdjS{dadj, N, first}, st)));
    else
      GCNII_LAUNCH((narrow100<false, true, true>(
          dhi_rows, gemm::dense(h_l, nl * NH, H, 1), N, N, H, B,
          P5DAdjS{dadj, N, first}, st)));
    // P6
    GCNII_LAUNCH((narrow100<false, false, false>(
        gemm::dense(adj, NN, 1, N),
        gemm::dense(static_cast<const float*>(d_hi), NH, 1, H), N, H, N, B,
        P6LstmS{d, reason, first, gates, res_lc, dh, dlh, dlc, dgates}, st)));
    if (reason)   // P7
      GCNII_LAUNCH((narrow<false, true, true>(
          gemm::dense(static_cast<const float*>(dgates) + (long long)l * N * G,
                      (long long)nl * N * G, G, 1),
          gemm::grouped(gemm::cat(ih, 0, hh, 0, G, 1, H, false), Bc, LK, LK),
          N, 2 * H, G, B, P7LstmInS{d, dh_src, dh, dlh}, st)));
  }

  // dW[k][l] = [hi_l | h0]^T tdpre_l (without the variant r_l^T tdpre_l)
  // over configuration k's rows, as in gcnii_bwd; rounded in its sum
  const Operand Aw =
      variant ? gemm::grouped(gemm::cat(static_cast<const float*>(hi), RH, h0,
                                        0, 1, H, H, false),
                              nl, CH - nl * RH, CH)
              : gemm::grouped(gemm::dense(static_cast<const float*>(hi), RH,
                                          1, H),
                              nl, CH - nl * RH, CH - nl * RH);
  GCNII_LAUNCH((wide<false, false, false>(
      Aw,
      gemm::grouped(gemm::dense(static_cast<const float*>(tdpre), RH, 1, H),
                    nl, CH - nl * RH, CH - nl * RH),
      WI, H, R, K * nl, splits_w, WgradW{{part_w, WI, H}}, st)));
  GCNII_LAUNCH(reduce(part_w, K * nl, splits_w, (long long)WI * H, dW, st,
                      true));
  if (reason) {   // one product a dialogue and layer, on the bf16 slabs
    auto A = gemm::cat(res_h, NH, res_lh, NH, 1, H, H, false);
    A.one_row = 2 * H;
    GCNII_LAUNCH((wide1<false, false>(
        A,
        gemm::dense(static_cast<const float*>(dgates), (long long)N * G, 1, G),
        2 * H + 1, G, N, B * nl, 1, WgradLstm{{part_l, 2 * H + 1, G}}, st)));
    GCNII_LAUNCH(scan_lstm_reduce(part_l, K, Bc, nl, (2LL * H + 1) * G, dl,
                                  st));
  }
#undef GCNII_LAUNCH
  return launches;
}

}  // namespace

// The whole backward on `stream`.  K configurations of Bc dialogues (B =
// K Bc in all).  Scratch: hi and tdpre (nl, B, N, H); with reason gates
// (B, N, 4H) and dgates (B, nl, N, 4H); part_w (K, nl, splits_w, 2H, H)
// and part_l (K, splits_l, 2H + 1, 4H).  dh_out is read only; dh, dlh,
// dlc, d_hi, dh0 and dadj need no initial value.  dW is (K, nl, 2H, H);
// dl is [dW_ih; dW_hh; db], (K, 2H + 1, 4H), written only with reason.
// mode & 3 = 1: the bf16 mode (see the note at the top): adj, h0 and W
// hold bf16 values, res_h, res_lh and res_lc are bf16, res_h1 is
// backward_bf16's h1s scratch, and wl its interleaved LSTM weights.
// mode & 3 = 2: the bf16 scan mode: the same, with ih, hh and wl ([W_ih;
// W_hh; b_ih; b_hh] interleaved) bf16 values, res_h1 backward_scan's h1s
// (5 (B, N, H)), part_l (K Bc nl, 2H + 1, 4H); mode & 4: the last layer's
// dropout in f32; mode & 8: variant=False, W and dW (nl, H, H).
extern "C" int gcnii_bwd(
    const float* adj, const float* h0, const float* W, const float* theta,
    float alpha, const float* res_h, const float* res_lh,
    const float* res_lc, const float* res_h1, const float* ih,
    const float* hh, const float* lb, const float* dh_out, float* dh,
    float* dlh, float* dlc, float* d_hi, float* dh0, float* dadj, float* hi,
    float* tdpre, float* gates, float* dgates, float* part_w, float* part_l,
    float* dW, float* dl, int drop, const unsigned int* thresh_k,
    const float* inv_keep_k, unsigned int thresh, float inv_keep,
    const long long* seed, int reason, int nl, int K, int Bc, int N, int H,
    int splits_w, int splits_l, int mode, const float* wl,
    void* stream) {
  const int numerics = mode & 3;
  if (H > 128 || K <= 0 || Bc <= 0 || N <= 0 || nl <= 0 || splits_w <= 0 ||
      splits_l <= 0 || numerics == 3 || (numerics != 2 && (mode & 12)))
    return -(int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const int G = 4 * H;
  const int B = K * Bc;   // the dialogues of all configurations
  const philox::Rate rate{thresh_k, inv_keep_k, thresh, inv_keep};
  auto b16 = [](const float* p) { return reinterpret_cast<const bf16*>(p); };
  if (numerics == 2)
    return backward_scan(adj, h0, W, theta, alpha, b16(res_h), b16(res_lh),
                         b16(res_lc), const_cast<float*>(res_h1), wl, ih, hh,
                         dh_out, dh, dlh, dlc, d_hi, dh0, dadj, hi, tdpre,
                         gates, dgates, part_w, part_l, dW, dl, drop, rate,
                         seed, reason, (mode & 8) == 0, (mode & 4) != 0, nl,
                         K, Bc, N, H, splits_w, st);
  if (numerics) {
    return backward_bf16(adj, h0, W, theta, alpha, b16(res_h),
                         b16(res_lh), b16(res_lc), const_cast<float*>(res_h1),
                         wl, ih, hh, dh_out, dh, dlh, dlc, d_hi, dh0, dadj, hi,
                         tdpre, gates, dgates, part_w, part_l, dW, dl, drop,
                         rate, seed, reason, nl, K, Bc, N, H, splits_w,
                         splits_l, st);
  }
  const long long NH = (long long)N * H, NN = (long long)N * N;
  const long long RH = (long long)B * NH;
  const long long CH = (long long)Bc * NH;   // a configuration's rows
  const long long WK = (long long)nl * 2 * H * H, LK = (long long)H * G;
  const int R = Bc * N;
  int launches = 0;
  cudaError_t err = cudaSuccess;
#define GCNII_LAUNCH(call)                    \
  do {                                        \
    err = (call);                             \
    if (err != cudaSuccess) return -(int)err; \
    ++launches;                               \
  } while (0)

  for (int l = nl - 1; l >= 0; --l) {
    const Dims d{N, H, nl, l};
    const int first = l == nl - 1;
    const float* dh_src = first ? dh_out : dh;
    const float* h1 = res_h1 + l * NH;   // (B, nl, N, H) at layer l
    float* hi_l = hi + l * RH;
    float* tdpre_l = tdpre + l * RH;
    const float* W_l = W + (long long)l * 2 * H * H;
    if (reason)   // P1
      GCNII_LAUNCH((wide<true, true, false>(
          gemm::cat(res_h + l * NH, nl * NH, res_lh + l * NH, nl * NH, H, 1,
                    H, true),
          gemm::grouped(gemm::cat(ih, 0, hh, 0, 1, G, H, true), Bc, LK, LK),
          N, G, 2 * H, B, 1, P1Gates{d, lb, Bc, gates}, st)));
    // P2
    GCNII_LAUNCH((narrow100<true, true, false>(
        gemm::dense(adj, NN, N, 1), gemm::dense(h1, nl * NH, 1, H), N, H, N,
        B, P2Hi{hi_l, N, H}, st)));
    // P3
    GCNII_LAUNCH((narrow100<true, true, false>(
        gemm::cat(hi_l, NH, h0, NH, H, 1, H, true),
        gemm::grouped(gemm::dense(W_l, 0, 1, H), Bc, WK, WK), N, H, 2 * H, B,
        P3Pre{d, hi_l, h0, dh_src, theta + l, alpha, drop, Bc, rate, seed,
               first, tdpre_l, d_hi, dh0},
        st)));
    // P4
    GCNII_LAUNCH((narrow<true, true, true>(
        gemm::dense(tdpre_l, NH, H, 1),
        gemm::grouped(gemm::dense(W_l, 0, H, 1), Bc, WK, WK), N, 2 * H, H, B,
        P4DProj{{d, d_hi, d_hi, dh0, 1}}, st)));
    // P5
    GCNII_LAUNCH((narrow<true, true, true>(
        gemm::dense(d_hi, NH, H, 1), gemm::dense(h1, nl * NH, H, 1), N, N, H,
        B, P5DAdj{dadj, N, first}, st)));
    // P6
    GCNII_LAUNCH((narrow100<true, false, false>(
        gemm::dense(adj, NN, 1, N), gemm::dense(d_hi, NH, 1, H), N, H, N, B,
        P6Lstm{d, reason, first, gates, res_lc, dh, dlh, dlc, dgates}, st)));
    if (reason)   // P7
      GCNII_LAUNCH((narrow<true, true, true>(
          gemm::dense(dgates + (long long)l * N * G, (long long)nl * N * G, G,
                      1),
          gemm::grouped(gemm::cat(ih, 0, hh, 0, G, 1, H, false), Bc, LK, LK),
          N, 2 * H, G, B, P7LstmIn{{d, dh_src, dh, dlh, 0}}, st)));
  }

  // dW[k][l] = [hi_l | h0]^T tdpre_l over configuration k's R = Bc N
  // rows, every (k, l) at once: batch z = k nl + l starts at layer l's
  // slab, row k Bc N (a group stride CH - nl RH every nl batches; h0's
  // CH)
  GCNII_LAUNCH(sums_tc(
      gemm::grouped(gemm::cat(hi, RH, h0, 0, 1, H, H, false), nl,
                    CH - nl * RH, CH),
      gemm::grouped(gemm::dense(tdpre, RH, 1, H), nl, CH - nl * RH,
                    CH - nl * RH),
      2 * H, H, R, K * nl, splits_w, WgradW{{part_w, 2 * H, H}}, st));
  GCNII_LAUNCH(reduce(part_w, K * nl, splits_w, 2LL * H * H, dW, st));
  if (reason) {
    // [dW_ih; dW_hh; db][k] = [h | lh | 1]^T dgates over configuration k's
    // Bc nl N rows
    Operand A = gemm::cat(res_h, nl * CH, res_lh, nl * CH, 1, H, H, false);
    A.one_row = 2 * H;
    GCNII_LAUNCH(sums_tc(
        A, gemm::dense(dgates, (long long)Bc * nl * N * G, 1, G), 2 * H + 1,
        G, R * nl, K, splits_l, WgradLstm{{part_l, 2 * H + 1, G}}, st));
    GCNII_LAUNCH(reduce(part_l, K, splits_l, (2LL * H + 1) * G, dl, st));
  }
#undef GCNII_LAUNCH
  return launches;
}
