// The bf16 scan mode's arithmetic: the JAX package's GCNII layer scan in
// bf16 (mmdfn_tpu/nn/gcn.py:229-287, gcn_compute_dtype='bfloat16' where no
// fused kernel runs) as XLA computes it: every elementwise op rounded to
// bf16, its constants too (1-a, a, theta_l, 1-theta_l, the dropout's keep
// scale), and each product on bf16 values summed in f32 and rounded once
// (the caller's epilogue rounds the product's value).  Kernel B
// (gcnii_fwd.cu) and kernel D (gcnii_bwd.cu) both compute through these
// functions, so that D's recompute of a layer is B's forward bit for bit.
//
// Values are f32 that hold bf16 values; R rounds to the nearest bf16 (ties
// to even).  The products of two bf16 values are exact in f32, so an op
// computed in f32 and rounded once is the bf16 op.  The plain version is
// ops/gcnii.py:_scan_plain (forward) and _scan_bwd_plain (kernel D's walk).

#pragma once

#include <cuda_bf16.h>
#include <math.h>

#include "gemm_f32.cuh"

namespace scan {

// (on the host too: the constants are rounded once, where a launch is set
// up)
__host__ __device__ __forceinline__ float R(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

// JAX's bf16 sigmoid (lax.logistic lowered to 1 / (1 + exp(-x)), each op
// rounded) and tanh
__device__ __forceinline__ float sig(float x) {
  return R(1.0f / R(1.0f + R(expf(-x))));
}
__device__ __forceinline__ float tanh_(float x) { return R(tanhf(x)); }

// 1-a and a as a bf16 product takes them
struct Consts {
  float a1, a2;
};
__host__ __device__ __forceinline__ Consts consts(float alpha) {
  return {R(1.0f - alpha), R(alpha)};
}

// the first gate product's value v plus b_ih: h W_ih + b_ih
__device__ __forceinline__ float gate1(float v, float bih) {
  return R(R(v) + bih);
}

// a gate's pre-activation from g1 = gate1(...), the second product's value
// v and b_hh: ((h W_ih + b_ih) + lh W_hh) + b_hh
__device__ __forceinline__ float gate(float g1, float v, float bhh) {
  return R(R(g1 + R(v)) + bhh);
}

// the LSTM cell: the activated gates, the new cell state c, tanh(c) and
// the output h
struct Cell {
  float i, f, g, o, c, t, h;
};
__device__ __forceinline__ Cell cell(float gi, float gf, float gg, float go,
                                     float lc) {
  Cell k;
  k.i = sig(gi);
  k.f = sig(gf);
  k.g = tanh_(gg);
  k.o = sig(go);
  k.c = R(R(k.f * lc) + R(k.i * k.g));
  k.t = tanh_(k.c);
  k.h = R(k.o * k.t);
  return k;
}

// r = (1-a) hi + a h0
__device__ __forceinline__ float r_of(float hi, float h0, Consts k) {
  return R(R(k.a1 * hi) + R(k.a2 * h0));
}

// theta_l and 1 - theta_l
__device__ __forceinline__ float theta(float t) { return R(t); }
__device__ __forceinline__ float omt(float th) { return R(1.0f - th); }

// the ReLU's input from the support product's value v: theta s + (1-theta) r
__device__ __forceinline__ float pre(float v, float r, float th, float om) {
  return R(R(th * R(v)) + R(om * r));
}

// the transposes of JAX's logistic and tanh JVPs at the output y: d y (1-y)
// and (a + a y), a = d (1 - y); a cotangent the tanh adds to (the cell
// state's carry) takes a first, then a y
__device__ __forceinline__ float dsig(float d, float y) {
  return R(d * R(y * R(1.0f - y)));
}
__device__ __forceinline__ float dtanh_a(float d, float y) {
  return R(d * R(1.0f - y));
}

}  // namespace scan
