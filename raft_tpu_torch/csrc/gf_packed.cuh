// GF(2^8) constant multiply on packed 32-bit words, shared by the RS codec
// kernels (ec.cu) and the in-kernel parity mode of the steady kernels
// (steady.cu).
//
// Multiplication by a constant c is GF(2)-linear in the bits of x, so
// mul(c, x) = XOR over bits i of x of mul(c, 1 << i). On a word holding
// four bytes: XOR over i of ((x >> i) & 0x01010101) * c8[i], where
// c8[i] = mul(c, 1 << i) (raft_tpu/core/step_pallas.py:109
// _mul_const_packed; the per-byte form is raft_tpu/ec/kernels.py:51
// _mul_const_bits). The mask leaves every byte slot 0 or 1, so the integer
// product never carries into the next byte. Unsigned arithmetic
// throughout: the shift is logical and the product wraps by definition.
#pragma once

#include <stdint.h>

__device__ __forceinline__ unsigned gf_mul_packed(unsigned x,
                                                  const uint8_t* c8) {
  unsigned acc = 0;
#pragma unroll
  for (int i = 0; i < 8; ++i)
    acc ^= ((x >> i) & 0x01010101u) * (unsigned)c8[i];
  return acc;
}
