// K6 and K7 — the RS(n, k) codec's constant GF(2^8) matrix apply, for
// Hopper (sm_90a). One kernel, gf_table_kernel, serves both.
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
//    the same offset. K7 is the PASS instantiation of K6's kernel: the
//    parity encode with the source the raw entries (row j at word j*Wk
//    of entry i, entry stride k*Wk), the output described as out + k*Wk
//    (row stride Wk, entry stride n*Wk), and the k input vectors stored
//    from the same registers at the k rows before the first output row.
//
// Design. Multiplying by a constant is a function of one byte, so the
// matrix apply is a table lookup per input byte: table (j, g) holds, at
// entry x, mul(M[4g + q][j], x) for the four output rows q of group g,
// one byte each, in a u32. A thread owns one word pair (or one word, for
// an odd shard width) of one entry, loads its k input vectors once, XORs
// one lookup per input byte into four per-byte-position accumulators,
// which serve every output row at once, and regroups them into output
// words with __byte_perm. About 4 instructions per input byte, against
// the 32 of the bit-sliced multiply (gf_packed.cuh) per (input, output)
// row pair. The tables live in shared memory, one copy per block.
//
// Bound. K6's decode of a flight's window (C entries) moves bytes enough
// to be bound by them. K7 and K6's encode at a tick batch (B = 1024,
// 88-byte shards: 264 KB in, 440 KB out) have a byte bound of about 0.2
// us, under one launch: they are bound by latency — the launch, one load
// round trip from device memory, the table build and the stores. So:
// - every thread issues its first entry's k loads before the block
//   builds its tables, so the table build hides under the load latency
//   and one barrier follows;
// - the tables are built on chip from the m x k x 8 bit constants (the
//   products of each matrix entry with the eight single-bit bytes, four
//   output rows to a word), passed by value with the launch: entry x is
//   the XOR of the constants of its set bits. A warp builds a table, each
//   lane 8 entries that share its five low bits, so a lane does 9 XORs
//   and 8 shared stores — no second round trip for 1 KB tables (copying
//   host-built tables from global memory instead, after the loads, was
//   slower on the H100);
// - K7's systematic words are stored before the barrier: they need no
//   table;
// - the block covers as few entries as it takes to put a block on every
//   SM (at config 3's tick, 7 entries of 11 word pairs: 147 blocks of 96
//   threads), and a larger apply fills whole 256-thread blocks;
// - index arithmetic is 32-bit and nothing is divided per word: a
//   thread's word offset and entry offset in the block are fixed, and
//   the block walks entries; the source slot of entry i is
//   (start + i) mod cap, one compare per entry.
// Random bytes make the lookups of a warp meet in shared-memory banks;
// chip_smoke.py's k6_bank_probe times all-zero input bytes (every lookup
// of a warp at one address) beside random ones to show what that costs.
//
// The source is described, not laid out: row j of entry i lies at word
// slot * entry + row[j] of the source, so one kernel reads the shard-major
// u8[k, B, Sk] operand, raw entries u8[B, S] (encode, K7), and the log
// ring itself (reconstruct on the card: base log_payload, row[j] = rows[j]
// * W, entry = R * W, cap = C, start = (lo - 1) mod C), where a window
// that wraps past slot C - 1 is read in place, with no gather. The output
// is described by a base, a row and an entry stride.
#include "raft_common.cuh"

// Rows in and out of one matrix apply (k <= 16, rows_out <= 16).
#define RT_GF_MAX 16
// table groups of four output rows
#define RT_GF_GROUPS (RT_GF_MAX / 4)

// Where K6 reads: row j of entry i at word slot * entry + row[j], slot =
// (start + i) mod cap. bits[(j * groups + g) * 8 + b]: byte q is
// mul(M[4g + q][j], 1 << b) — the constants the tables are built from.
// Sized by the instantiation's KMAX, so a small code's launch carries
// 0.5 KB of them, not 2 KB.
template <int KMAX>
struct GfSource {
  int row[KMAX];
  int entry, cap, start;
  unsigned bits[KMAX * RT_GF_GROUPS * 8];
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

// The k <= KMAX input vectors of one work item, at ``e`` (+ row[j]).
template <int V, int KMAX>
__device__ __forceinline__ void gf_load(typename GfVec<V>::T x[KMAX],
                                        const unsigned* e,
                                        const GfSource<KMAX>& s, int k) {
  typedef typename GfVec<V>::T U;
#pragma unroll
  for (int j = 0; j < KMAX; ++j)
    if (j < k) x[j] = *reinterpret_cast<const U*>(e + s.row[j]);
}

// K7's pass-through: input row j of one entry at ``dst`` + (j - k) *
// out_row (the rows before the first output row).
template <int V, int KMAX>
__device__ __forceinline__ void gf_pass(const typename GfVec<V>::T x[KMAX],
                                        unsigned* dst, int out_row, int k) {
  typedef typename GfVec<V>::T U;
#pragma unroll
  for (int j = 0; j < KMAX; ++j)
    if (j < k) *reinterpret_cast<U*>(dst + (j - k) * out_row) = x[j];
}

// Words [o, o + V) of every output row of one entry from its loaded input
// vectors: output row r at ``dst`` + r * out_row.
template <int V, int KMAX>
__device__ __forceinline__ void gf_entry(const typename GfVec<V>::T x[KMAX],
                                         unsigned* dst, int out_row,
                                         const unsigned* tab, int k,
                                         int groups, int rows_out) {
  typedef GfVec<V> X;
  typedef typename X::T U;
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
      *reinterpret_cast<U*>(dst + r * out_row) = y;
    }
  }
}

// K6 / K7: out row r of entry i, word w (at out + r*out_row + i*out_entry
// + w) = XOR_j mul(M[r, j], source row j of entry i, word w), i < N,
// w < Wk; with PASS also source row j at out + (j-k)*out_row + ...
// ``per`` entries a block pass (per * Wk/V threads load and store; every
// warp builds tables). KMAX bounds k: the input vectors stay in
// registers, KMAX of them, so a small code keeps few. Four blocks an SM
// at least (64 registers a thread): the loads in flight, not the
// instructions, bound the decode; fewer registers spill.
template <int V, int KMAX, bool PASS>
__global__ void __launch_bounds__(kGfThreads, 4)
    gf_table_kernel(const unsigned* __restrict__ src,
                    const __grid_constant__ GfSource<KMAX> s,
                    unsigned* __restrict__ out, int out_row, int out_entry,
                    int k, int groups, int rows_out, int N, int Wk,
                    int per) {
  typedef typename GfVec<V>::T U;
  extern __shared__ unsigned tab[];  // [k * groups][256]
  const int WV = Wk / V;
  const int eo = threadIdx.x / WV;
  const int ov0 = threadIdx.x - eo * WV;
  const int stride = gridDim.x * per;
  int i = blockIdx.x * per + eo;
  int ov = ov0;
  auto source = [&](int entry) {
    int slot = s.start + entry;
    if (slot >= s.cap) slot = (slot - s.cap) % s.cap;
    return src + slot * s.entry;
  };
  // 1. the first work item's loads, in flight while the tables build
  bool have = eo < per && i < N;
  U x[KMAX];
  if (have) gf_load<V, KMAX>(x, source(i) + ov * V, s, k);
  // 2. the tables, a warp to a table: lane l writes entries l + 32n,
  //    n < 8 — the XOR of the table's bit constants over the set bits of
  //    the entry: the five low bits' part (lane) once, the three high
  //    bits' eight parts (n) from three constants
  const int lane = threadIdx.x & 31;
  for (int t = threadIdx.x >> 5; t < k * groups; t += blockDim.x >> 5) {
    const unsigned* c = s.bits + t * 8;
    unsigned lo = 0;
#pragma unroll
    for (int b = 0; b < 5; ++b) lo ^= (0u - ((lane >> b) & 1u)) & c[b];
    const unsigned c5 = c[5], c6 = c[6], c7 = c[7];
    unsigned* row = tab + t * 256 + lane;
    row[0] = lo;
    row[32] = lo ^ c5;
    row[64] = lo ^ c6;
    row[96] = lo ^ c5 ^ c6;
    row[128] = lo ^ c7;
    row[160] = lo ^ c7 ^ c5;
    row[192] = lo ^ c7 ^ c6;
    row[224] = lo ^ c7 ^ c6 ^ c5;
  }
  // K7's systematic words leave before the barrier: they need no table
  if (PASS && have) gf_pass<V, KMAX>(x, out + i * out_entry + ov * V,
                                     out_row, k);
  __syncthreads();
  // 3. lookups and stores; then the next work item (a shard wider than
  //    the block is walked in steps of the block)
  while (have) {
    gf_entry<V, KMAX>(x, out + i * out_entry + ov * V, out_row, tab, k,
                      groups, rows_out);
    ov += blockDim.x;
    if (ov >= WV) {
      ov = ov0;
      i += stride;
    }
    have = i < N;
    if (have) {
      gf_load<V, KMAX>(x, source(i) + ov * V, s, k);
      if (PASS) gf_pass<V, KMAX>(x, out + i * out_entry + ov * V, out_row,
                                 k);
    }
  }
}

// Launch shape: ``per`` entries a block pass, as few as put a block on
// every SM, at most a 256-thread block's worth; the threads, a multiple
// of a warp; the blocks, at most the resident ones (a grid stride walks
// the rest).
template <int V, int KMAX, bool PASS>
static cudaError_t gf_table_launch(const void* src, const int* rows,
                                   int entry, int cap, int start,
                                   const unsigned* bits, void* out,
                                   int out_row, int out_entry, int k,
                                   int groups, int rows_out, int N, int Wk,
                                   cudaStream_t st) {
  auto kern = gf_table_kernel<V, KMAX, PASS>;
  GfSource<KMAX> s;
  for (int j = 0; j < KMAX; ++j) s.row[j] = j < k ? rows[j] : 0;
  s.entry = entry;
  s.cap = cap;
  s.start = start;
  for (int i = 0; i < KMAX * RT_GF_GROUPS * 8; ++i)
    s.bits[i] = i < k * groups * 8 ? bits[i] : 0u;
  const int smem = k * groups * 256 * 4;
  // per instantiation: the shared memory attribute, raised to the largest
  // size asked so far, and the occupancy of the last launch shape
  static int max_smem = 48 * 1024, last_smem = -1, last_threads = -1;
  static int per_sm = 0;
  cudaError_t e = cudaSuccess;
  if (smem > max_smem) {
    e = cudaFuncSetAttribute(kern,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
    if (e == cudaSuccess) max_smem = smem;
  }
  int sms = 0;
  if (e == cudaSuccess) e = rt_sm_count(&sms);
  if (e != cudaSuccess) return e;
  const int WV = Wk / V;
  const int fit = max(1, kGfThreads / WV);  // entries a full block takes
  const int per = min(fit, max(1, N / sms));
  const int threads = min(kGfThreads, (per * WV + 31) / 32 * 32);
  if (smem != last_smem || threads != last_threads) {
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern,
                                                      threads, smem);
    if (e != cudaSuccess) return e;
    last_smem = smem;
    last_threads = threads;
  }
  const int blocks =
      (int)max(1L, min(((long)N + per - 1) / per,
                       (long)max(1, per_sm) * sms));
  kern<<<blocks, threads, smem, st>>>((const unsigned*)src, s,
                                      (unsigned*)out, out_row, out_entry, k,
                                      groups, rows_out, N, Wk, per);
  return cudaGetLastError();
}

// K6 over a described source (see GfSource; every offset in 4-byte words):
// out row r of entry i at out + r*out_row + i*out_entry, for i < N;
// pass != 0 also stores source row j at out + (j-k)*out_row + i*out_entry
// (K7). bits (host u32[k][ceil(rows_out/4)][8], see GfSource); vec: 2
// moves word pairs (every base 8-byte aligned, every offset and Wk even),
// 1 single words.
RT_EXPORT int rt_gf_apply(const void* src, const int* rows, int k,
                          int entry, int cap, int start, void* out,
                          int out_row, int out_entry, const void* bits,
                          int rows_out, int N, int Wk, int vec, int pass,
                          void* stream) {
  if (rows_out < 1 || k < 1 || rows_out > RT_GF_MAX || k > RT_GF_MAX ||
      Wk < 1 || cap < 1 || (vec != 1 && vec != 2) || Wk % vec)
    return (int)cudaErrorInvalidValue;
  if (N < 1) return (int)cudaSuccess;
  const int groups = (rows_out + 3) / 4;
  cudaStream_t st = (cudaStream_t)stream;
#define RT_K6_ARGS                                                       \
  src, rows, entry, cap, start, (const unsigned*)bits, out, out_row,     \
      out_entry, k, groups, rows_out, N, Wk, st
#define RT_K6_VEC(KMAX, PASS)                            \
  (vec == 2 ? gf_table_launch<2, KMAX, PASS>(RT_K6_ARGS) \
            : gf_table_launch<1, KMAX, PASS>(RT_K6_ARGS))
  if (pass)
    return (int)(k <= 4 ? RT_K6_VEC(4, true) : RT_K6_VEC(RT_GF_MAX, true));
  return (int)(k <= 4 ? RT_K6_VEC(4, false) : RT_K6_VEC(RT_GF_MAX, false));
#undef RT_K6_VEC
#undef RT_K6_ARGS
}
