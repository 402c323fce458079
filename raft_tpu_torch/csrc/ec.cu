// K6 and K7 — the RS(n, k) codec's constant GF(2^8) matrix apply, for
// Hopper (sm_90a).
//
// K6 replaces raft_tpu/ec/kernels.py:77 _parity_pallas (pallas_call :81,
//    body _parity_kernel :66): a constant matrix applied to k shard rows.
//    With the parity matrix it is the parity encode (u8[k, B, Sk] ->
//    u8[m, B, Sk], encode_pallas :90); with a decode matrix it is the
//    reconstruction decode (decode_pallas :240, u8[k, B, Sk] -> u8[B, S]).
// K7 replaces ec/kernels.py:161 _encode_fold_pallas (pallas_call :172,
//    body _parity_cols_kernel :145): parity on the raw column blocks of
//    u8[B, k*Sk], then the bitcast fold into the log layout i32[B, n*Wk].
//    The code is systematic, so the k data words pass through unchanged
//    and only the m parity words are computed, from the k data words at
//    the same offset.
//
// Bound: bytes. Every input word is read once and every output word
// written once.
//
// K6 design. Multiplying by a constant is a function of one byte, so the
// matrix apply is a table lookup per input byte: table (j, g) holds, at
// entry x, mul(M[4g + q][j], x) for the four output rows q of group g,
// one byte each, in a u32 (built on the host, ec/kernels.py gf_tables).
// A block copies the k * ceil(rows / 4) tables (1 KB each) into shared
// memory; a thread owns one word pair (or one word, for an odd shard
// width) of one entry, loads its k input vectors once, XORs one lookup
// per input byte into four per-byte-position accumulators, which serve
// every output row at once, and regroups them into output words with
// __byte_perm. About 4 instructions per input byte, against the 32 of the
// bit-sliced multiply (gf_packed.cuh) per (input, output) row pair.
// Random bytes make the lookups of a warp meet in shared-memory banks;
// chip_smoke.py's k6_bank_probe times all-zero input bytes (every lookup
// of a warp at one address) beside random ones to show what that costs.
// One copy of the tables per block: a copy per lane (no two lanes in one
// bank) needs 32 times the shared memory, so fewer blocks fit an SM, and
// it was slower on the H100.
// Index arithmetic is 32-bit: a thread's word offset and entry offset in
// the block are fixed, and the block walks entries; the source slot of
// entry i is (start + i) mod cap, one compare per entry.
//
// The source is described, not laid out: row j of entry i lies at word
// slot * entry + row[j] of the source, so one kernel reads the shard-major
// u8[k, B, Sk] operand, raw entries u8[B, S] (encode), and the log ring
// itself (reconstruct on the card: base log_payload, row[j] = rows[j] * W,
// entry = R * W, cap = C, start = (lo - 1) mod C), where a window that
// wraps past slot C - 1 is read in place, with no gather. The output is
// described by a row and an entry stride.
#include "gf_packed.cuh"
#include "raft_common.cuh"

// Rows in and out of one matrix apply (k <= 16, rows_out <= 16).
#define RT_GF_MAX 16

struct GfMatrix {
  uint8_t c[RT_GF_MAX * RT_GF_MAX * 8];  // [rows_out][k][8]
};

// Where K6 reads: row j of entry i at word slot * entry + row[j], slot =
// (start + i) mod cap.
struct GfSource {
  int row[RT_GF_MAX];
  int entry, cap, start;
};

template <int V>
struct GfVec;
template <>
struct GfVec<1> {
  typedef unsigned T;
  static __device__ __forceinline__ unsigned w(const T& x, int i) {
    return x;
  }
  static __device__ __forceinline__ void set(T& x, int i, unsigned v) {
    x = v;
  }
};
template <>
struct GfVec<2> {
  typedef uint2 T;
  static __device__ __forceinline__ unsigned w(const T& x, int i) {
    return i ? x.y : x.x;
  }
  static __device__ __forceinline__ void set(T& x, int i, unsigned v) {
    if (i)
      x.y = v;
    else
      x.x = v;
  }
};

// Byte q of each of a0..a3, as one word (a 4 x 4 byte transpose, row q).
__device__ __forceinline__ void byte_transpose(unsigned a0, unsigned a1,
                                               unsigned a2, unsigned a3,
                                               unsigned o[4]) {
  const unsigned lo01 = __byte_perm(a0, a1, 0x5140);
  const unsigned hi01 = __byte_perm(a0, a1, 0x7362);
  const unsigned lo23 = __byte_perm(a2, a3, 0x5140);
  const unsigned hi23 = __byte_perm(a2, a3, 0x7362);
  o[0] = __byte_perm(lo01, lo23, 0x5410);
  o[1] = __byte_perm(lo01, lo23, 0x7632);
  o[2] = __byte_perm(hi01, hi23, 0x5410);
  o[3] = __byte_perm(hi01, hi23, 0x7632);
}

static const int kGfThreads = 256;

// Words [o, o + V) of every output row of one entry: the k <= KMAX input
// vectors at ``e`` (+ row[j]) in, rows_out vectors at ``dst`` (+ r *
// out_row) out.
template <int V, int KMAX>
__device__ __forceinline__ void gf_entry(const unsigned* e,
                                         const GfSource& s, unsigned* dst,
                                         int out_row, const unsigned* tab,
                                         int k, int groups, int rows_out) {
  typedef GfVec<V> X;
  typedef typename X::T U;
  U x[KMAX];
#pragma unroll
  for (int j = 0; j < KMAX; ++j)
    if (j < k) x[j] = *reinterpret_cast<const U*>(e + s.row[j]);
  for (int g = 0; g < groups; ++g) {
    unsigned acc[4 * V];  // byte q of acc[p]: output row 4g+q, byte p
#pragma unroll
    for (int b = 0; b < 4 * V; ++b) acc[b] = 0;
#pragma unroll
    for (int j = 0; j < KMAX; ++j) {
      if (j >= k) break;
      const unsigned* t = tab + (j * groups + g) * 256;
#pragma unroll
      for (int b = 0; b < 4 * V; ++b)
        acc[b] ^= t[(X::w(x[j], b >> 2) >> (8 * (b & 3))) & 0xffu];
    }
    unsigned words[V][4];
#pragma unroll
    for (int v = 0; v < V; ++v)
      byte_transpose(acc[4 * v], acc[4 * v + 1], acc[4 * v + 2],
                     acc[4 * v + 3], words[v]);
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int r = 4 * g + q;
      if (r >= rows_out) break;
      U y;
#pragma unroll
      for (int v = 0; v < V; ++v) X::set(y, v, words[v][q]);
      *reinterpret_cast<U*>(dst + (size_t)r * out_row) = y;
    }
  }
}

// K6: out row r of entry i, word w =
//   XOR_j mul(M[r, j], source row j of entry i, word w), i < N, w < Wk.
// tables: u32[k][groups][256] (see the header). KMAX bounds k: the input
// vectors stay in registers, KMAX of them, so a small code keeps few. Four
// blocks an SM at least (64 registers a thread): the loads in flight, not
// the instructions, bound the decode; fewer registers spill.
template <int V, int KMAX>
__global__ void __launch_bounds__(kGfThreads, 4)
    gf_table_kernel(const unsigned* __restrict__ src,
                    const __grid_constant__ GfSource s,
                    unsigned* __restrict__ out, int out_row, int out_entry,
                    const unsigned* __restrict__ tables, int k, int groups,
                    int rows_out, int N, int Wk) {
  extern __shared__ unsigned tab[];  // [k * groups][256]
  const int ntab = k * groups * 256;
  for (int i = threadIdx.x; i < ntab; i += blockDim.x)
    tab[i] = __ldg(&tables[i]);
  __syncthreads();
  const int WV = Wk / V;
  // entries a block takes a pass; a shard wider than the block is walked
  // by each thread in steps of the block
  const int per = max(1, (int)blockDim.x / WV);
  const int eo = threadIdx.x / WV;
  if (eo >= per) return;
  const int ov0 = threadIdx.x - eo * WV;
  for (int i = blockIdx.x * per + eo; i < N; i += gridDim.x * per) {
    int slot = s.start + i;
    if (slot >= s.cap) slot = (slot - s.cap) % s.cap;
    for (int ov = ov0; ov < WV; ov += blockDim.x)
      gf_entry<V, KMAX>(src + (size_t)slot * s.entry + ov * V, s,
                        out + (size_t)i * out_entry + ov * V, out_row, tab,
                        k, groups, rows_out);
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

template <int V, int KMAX>
static cudaError_t gf_table_launch(const void* src, const GfSource& s,
                                   void* out, int out_row, int out_entry,
                                   const void* tables, int k, int groups,
                                   int rows_out, int N, int Wk,
                                   cudaStream_t st) {
  auto kern = gf_table_kernel<V, KMAX>;
  const int smem = k * groups * 256 * 4;
  // the occupancy of the last table size, kept per instantiation (the
  // shared memory attribute is raised to the largest size asked so far)
  static int last_smem = -1, per_sm = 0, max_smem = 48 * 1024;
  cudaError_t e = cudaSuccess;
  if (smem > max_smem) {
    e = cudaFuncSetAttribute(kern,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
    if (e == cudaSuccess) max_smem = smem;
  }
  if (e == cudaSuccess && smem != last_smem) {
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern,
                                                      kGfThreads, smem);
    if (e == cudaSuccess) last_smem = smem;
  }
  int sms = 0;
  if (e == cudaSuccess) e = rt_sm_count(&sms);
  if (e != cudaSuccess) return e;
  const int per = max(1, kGfThreads / (Wk / V));  // entries a block pass
  const int blocks =
      (int)max(1L, min(((long)N + per - 1) / per, (long)max(1, per_sm) * sms));
  kern<<<blocks, kGfThreads, smem, st>>>(
      (const unsigned*)src, s, (unsigned*)out, out_row, out_entry,
      (const unsigned*)tables, k, groups, rows_out, N, Wk);
  return cudaGetLastError();
}

// K6 over a described source (see GfSource; every offset in 4-byte words):
// out row r of entry i at out + r*out_row + i*out_entry, for i < N.
// tables (device u32[k][ceil(rows_out/4)][256]); vec: 2 moves word pairs
// (every base 8-byte aligned, every offset and Wk even), 1 single words.
RT_EXPORT int rt_gf_apply(const void* src, const int* rows, int k,
                          int entry, int cap, int start, void* out,
                          int out_row, int out_entry, const void* tables,
                          int rows_out, int N, int Wk, int vec,
                          void* stream) {
  if (rows_out < 1 || k < 1 || rows_out > RT_GF_MAX || k > RT_GF_MAX ||
      Wk < 1 || cap < 1 || (vec != 1 && vec != 2) || Wk % vec)
    return (int)cudaErrorInvalidValue;
  if (N < 1) return (int)cudaSuccess;
  GfSource s;
  for (int j = 0; j < RT_GF_MAX; ++j) s.row[j] = j < k ? rows[j] : 0;
  s.entry = entry;
  s.cap = cap;
  s.start = start;
  const int groups = (rows_out + 3) / 4;
  cudaStream_t st = (cudaStream_t)stream;
#define RT_K6_ARGS \
  src, s, out, out_row, out_entry, tables, k, groups, rows_out, N, Wk, st
  if (k <= 4)
    return (int)(vec == 2 ? gf_table_launch<2, 4>(RT_K6_ARGS)
                          : gf_table_launch<1, 4>(RT_K6_ARGS));
  return (int)(vec == 2 ? gf_table_launch<2, RT_GF_MAX>(RT_K6_ARGS)
                        : gf_table_launch<1, RT_GF_MAX>(RT_K6_ARGS));
#undef RT_K6_ARGS
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
