// Host-side Reed-Solomon GF(2^8) codec of raft_tpu_torch (the port's own
// copy of raft_tpu/native/rs_codec.cpp, same algorithm and exports).
//
// The card encodes with kernels K6/K7 (raft_tpu_torch/csrc/ec.cu); this
// library is the *host* data plane: the tiered archive's sealed segments
// (raft_tpu_torch/ckpt/tiered.py) are RS-coded and decoded here without
// paying NumPy's per-op dispatch.
//
// Algorithm: bit decomposition, word-sliced. Multiplying a byte x by a
// constant c over GF(2^8) is GF(2)-linear in x's bits:
//   mul(c, x) = XOR over set bits i of x of mul(c, 1<<i).
// Processing 8 bytes per uint64 lane: for bit i, build a per-byte 0x00/0xFF
// mask from x's bit i and XOR in the broadcast constant mul(c, 1<<i). All
// ops are shift/and/multiply-by-0x01...01/xor on u64 — auto-vectorizable,
// no table gathers in the inner loop.
//
// Build: g++ -O3 -shared -fPIC (raft_tpu_torch/native/__init__.py builds it
// on first use and raises when it cannot).

#include <cstdint>
#include <cstring>

namespace {

constexpr uint32_t kPoly = 0x11d;

// mul(c, 1<<i) for one constant c — the 8 bit-basis products.
void bit_basis(uint8_t c, uint8_t out[8]) {
  uint32_t v = c;
  for (int i = 0; i < 8; ++i) {
    out[i] = static_cast<uint8_t>(v);
    v <<= 1;
    if (v & 0x100) v ^= kPoly;
  }
}

constexpr uint64_t kLsb = 0x0101010101010101ULL;

// dst ^= mul(c, src) over n bytes (word-sliced bit decomposition).
void xor_mul_const(uint8_t* dst, const uint8_t* src, uint8_t c, long n) {
  if (c == 0) return;
  uint8_t basis[8];
  bit_basis(c, basis);
  long w = n / 8;
  for (long j = 0; j < w; ++j) {
    // memcpy the 8-byte lane in and out instead of casting the (possibly
    // unaligned when row_bytes % 8 != 0) byte pointers to uint64_t* —
    // unaligned loads through such casts are UB on strict-alignment
    // targets; memcpy compiles to the same single load/store where legal.
    uint64_t x, d;
    std::memcpy(&x, src + j * 8, 8);
    std::memcpy(&d, dst + j * 8, 8);
    uint64_t acc = 0;
    for (int i = 0; i < 8; ++i) {
      if (basis[i] == 0) continue;
      uint64_t mask = ((x >> i) & kLsb) * 0xFFULL;  // 0x00/0xFF per byte
      acc ^= mask & (kLsb * basis[i]);
    }
    d ^= acc;
    std::memcpy(dst + j * 8, &d, 8);
  }
  for (long j = w * 8; j < n; ++j) {  // tail bytes, scalar
    uint8_t x = src[j], acc = 0;
    for (int i = 0; i < 8; ++i)
      if (x & (1u << i)) acc ^= basis[i];
    dst[j] ^= acc;
  }
}

}  // namespace

extern "C" {

// out[r] = XOR_c mul(matrix[r*in_rows + c], in[c]) for r in [0, out_rows):
// the generic GF(2^8) matrix apply over contiguous byte rows of length
// row_bytes. Parity encode and erasure decode are both this operation
// (with the Cauchy block / the inverted submatrix respectively).
void rs_apply_matrix(const uint8_t* in, uint8_t* out, const uint8_t* matrix,
                     int in_rows, int out_rows, long row_bytes) {
  std::memset(out, 0, static_cast<size_t>(out_rows) * row_bytes);
  for (int r = 0; r < out_rows; ++r) {
    uint8_t* dst = out + static_cast<size_t>(r) * row_bytes;
    for (int c = 0; c < in_rows; ++c) {
      xor_mul_const(dst, in + static_cast<size_t>(c) * row_bytes,
                    matrix[r * in_rows + c], row_bytes);
    }
  }
}

// Scalar GF(2^8) multiply — exported for tests.
uint8_t rs_gf_mul(uint8_t a, uint8_t b) {
  uint8_t basis[8];
  bit_basis(a, basis);
  uint8_t acc = 0;
  for (int i = 0; i < 8; ++i)
    if (b & (1u << i)) acc ^= basis[i];
  return acc;
}

}  // extern "C"
