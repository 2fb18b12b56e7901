// Philox4x32-10 (Salmon et al., "Parallel random numbers: as easy as 1, 2,
// 3", SC'11), the counter-based generator behind the GCNII kernels' dropout.
//
// Replaces the TPU hardware PRNG that mmdfn_tpu/ops/pallas_gcnii_train.py
// seeds per (seed, batch element, layer) (_fwd_kernel, lines 155-161).  A
// counter-based generator needs no state: the forward kernel draws the keep
// bit of element (b, layer, node, channel) from that counter, and the
// backward kernel draws the same bit again instead of reading a stored mask.
//
// Key = the 64-bit step seed (low word, high word); counter = (b, layer,
// node, channel); the bit is word 0 of the output.  keep <=> bits < thresh,
// thresh = min(int((1 - rate) * 2^32), 2^32 - 1), the formula of
// _stack_fwd (line 481).  mmdfn_torch/ops/philox.py computes the same
// function with torch integer ops, bit for bit.

#pragma once

#include <stdint.h>

namespace philox {

__device__ __forceinline__ uint32_t word0(uint32_t c0, uint32_t c1,
                                          uint32_t c2, uint32_t c3,
                                          uint32_t k0, uint32_t k1) {
  const uint32_t M0 = 0xD2511F53u, M1 = 0xCD9E8D57u;
  const uint32_t W0 = 0x9E3779B9u, W1 = 0xBB67AE85u;
#pragma unroll
  for (int round = 0; round < 10; ++round) {
    const uint32_t lo0 = M0 * c0, hi0 = __umulhi(M0, c0);
    const uint32_t lo1 = M1 * c2, hi1 = __umulhi(M1, c2);
    const uint32_t n0 = hi1 ^ c1 ^ k0, n2 = hi0 ^ c3 ^ k1;
    c0 = n0;
    c1 = lo1;
    c2 = n2;
    c3 = lo0;
    k0 += W0;
    k1 += W1;
  }
  return c0;
}

// The dropout keep bit of element (b, layer, node, channel).
__device__ __forceinline__ bool keep(unsigned long long seed, int b,
                                     int layer, int node, int channel,
                                     uint32_t thresh) {
  return word0((uint32_t)b, (uint32_t)layer, (uint32_t)node,
               (uint32_t)channel, (uint32_t)(seed & 0xffffffffull),
               (uint32_t)(seed >> 32)) < thresh;
}

}  // namespace philox
