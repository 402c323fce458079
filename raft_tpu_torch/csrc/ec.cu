// K6 and K7 — the RS(n, k) codec's constant GF(2^8) matrix apply, for
// Hopper (sm_90a).
//
// K6 replaces raft_tpu/ec/kernels.py:77 _parity_pallas (pallas_call :81,
//    body _parity_kernel :66): a constant matrix applied to k shard rows.
//    With the parity matrix's constants it is the parity encode
//    (u8[k, B, Sk] -> u8[m, B, Sk], encode_pallas :90); with a decode
//    matrix's constants it is the reconstruction decode (decode_pallas
//    :240, u8[k, B, Sk] -> u8[B, S]). Both layouts are strided views, so
//    decode writes the entry layout [B, S] directly (the moveaxis of
//    decode_pallas :247-248 costs no pass) and encode reads raw entries
//    u8[B, S] without a shard-major copy.
// K7 replaces ec/kernels.py:161 _encode_fold_pallas (pallas_call :172,
//    body _parity_cols_kernel :145): parity on the raw column blocks of
//    u8[B, k*Sk], then the bitcast fold into the log layout i32[B, n*Wk].
//    The code is systematic, so the k data words pass through unchanged
//    and only the m parity words are computed, from the k data words at
//    the same offset.
//
// Bound: bytes. Every word is read once and written once; the arithmetic
// is 8 multiply-XORs per (input row, output row) pair on a 32-bit word
// (2 x 3 x 8 for RS(5,3) parity), far below the card's integer rate.
//
// Design. The TPU kernels hold the whole tile in VMEM and run 8 select/XOR
// passes per constant over it. Here one thread owns one 4-byte word
// position (entry b, word w) of every row: it loads the k input words once
// into registers and emits every output row from them with the packed
// multiply of gf_packed.cuh. The constant table ([rows][k][8] bytes, at
// most 16 x 16 x 8) travels by value in the launch parameters as a
// __grid_constant__ (its address is taken without a per-thread copy), so
// every thread of a warp reads the same constant from the parameter bank.
#include "gf_packed.cuh"
#include "raft_common.cuh"

// Rows in and out of one matrix apply (k <= 16, rows_out <= 16).
#define RT_GF_MAX 16

struct GfMatrix {
  uint8_t c[RT_GF_MAX * RT_GF_MAX * 8];  // [rows_out][k][8]
};

__global__ void parity_kernel(const uint8_t* __restrict__ src, long src_rs,
                              long src_bs, uint8_t* __restrict__ out,
                              long out_rs, long out_bs, int rows_out, int k,
                              int B, int Wk,
                              const __grid_constant__ GfMatrix g) {
  const long n = (long)B * Wk;
  const long stride = (long)gridDim.x * blockDim.x;
  for (long e = (long)blockIdx.x * blockDim.x + threadIdx.x; e < n;
       e += stride) {
    const int b = (int)(e / Wk);
    const int w = (int)(e - (long)b * Wk);
    unsigned x[RT_GF_MAX];
#pragma unroll
    for (int j = 0; j < RT_GF_MAX; ++j)
      if (j < k)
        x[j] = *reinterpret_cast<const unsigned*>(src + j * src_rs +
                                                  b * src_bs + 4 * w);
    for (int r = 0; r < rows_out; ++r) {
      unsigned acc = 0;
#pragma unroll
      for (int j = 0; j < RT_GF_MAX; ++j)
        if (j < k) acc ^= gf_mul_packed(x[j], g.c + (r * k + j) * 8);
      *reinterpret_cast<unsigned*>(out + r * out_rs + b * out_bs + 4 * w) =
          acc;
    }
  }
}

__global__ void encode_fold_kernel(const uint8_t* __restrict__ data,
                                   int* __restrict__ out, int B, int k,
                                   int m, int Wk,
                                   const __grid_constant__ GfMatrix g) {
  const long n = (long)B * Wk;
  const long stride = (long)gridDim.x * blockDim.x;
  const int row_words = (k + m) * Wk;
  for (long e = (long)blockIdx.x * blockDim.x + threadIdx.x; e < n;
       e += stride) {
    const int b = (int)(e / Wk);
    const int w = (int)(e - (long)b * Wk);
    const unsigned* in =
        reinterpret_cast<const unsigned*>(data + (size_t)b * k * Wk * 4);
    int* o = out + (size_t)b * row_words;
    unsigned x[RT_GF_MAX];
#pragma unroll
    for (int j = 0; j < RT_GF_MAX; ++j)
      if (j < k) {
        x[j] = in[j * Wk + w];
        o[j * Wk + w] = (int)x[j];
      }
    for (int p = 0; p < m; ++p) {
      unsigned acc = 0;
#pragma unroll
      for (int j = 0; j < RT_GF_MAX; ++j)
        if (j < k) acc ^= gf_mul_packed(x[j], g.c + (p * k + j) * 8);
      o[(k + p) * Wk + w] = (int)acc;
    }
  }
}

static const int kGfThreads = 256;

static int gf_blocks(long work) {
  return (int)max(1L, min((work + kGfThreads - 1) / kGfThreads, 8192L));
}

static bool load_matrix(const void* consts_host, int rows, int k,
                        GfMatrix* g) {
  if (rows < 1 || k < 1 || rows > RT_GF_MAX || k > RT_GF_MAX) return false;
  const uint8_t* c = (const uint8_t*)consts_host;
  for (int i = 0; i < rows * k * 8; ++i) g->c[i] = c[i];
  return true;
}

// K6: out row r (r < rows_out), word w of entry b =
//   XOR_j mul(M[r, j], src row j, word w of entry b).
// Strides are in bytes: row r of ``out`` starts at out + r*out_rs and
// entry b of it at + b*out_bs (likewise for ``src``); every stride and
// base must be 4-byte aligned. consts_host: host u8[rows_out, k, 8].
RT_EXPORT int rt_gf_apply(const void* src, long long src_rs,
                          long long src_bs, void* out, long long out_rs,
                          long long out_bs, const void* consts_host,
                          int rows_out, int k, int B, int Wk, void* stream) {
  GfMatrix g;
  if (!load_matrix(consts_host, rows_out, k, &g))
    return (int)cudaErrorInvalidValue;
  parity_kernel<<<gf_blocks((long)B * Wk), kGfThreads, 0,
                  (cudaStream_t)stream>>>(
      (const uint8_t*)src, (long)src_rs, (long)src_bs, (uint8_t*)out,
      (long)out_rs, (long)out_bs, rows_out, k, B, Wk, g);
  return (int)cudaGetLastError();
}

// K7: raw entries u8[B, k*Wk*4] -> the folded shard layout i32[B, n*Wk]
// (data words copied, parity words computed). consts_host: u8[m, k, 8].
RT_EXPORT int rt_encode_fold(const void* data, void* out,
                             const void* consts_host, int B, int k, int m,
                             int Wk, void* stream) {
  GfMatrix g;
  if (!load_matrix(consts_host, m, k, &g)) return (int)cudaErrorInvalidValue;
  encode_fold_kernel<<<gf_blocks((long)B * Wk), kGfThreads, 0,
                       (cudaStream_t)stream>>>(
      (const uint8_t*)data, (int*)out, B, k, m, Wk, g);
  return (int)cudaGetLastError();
}
