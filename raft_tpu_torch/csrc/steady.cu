// K2, K3, K4 — the steady replication data plane, for Hopper (sm_90a).
//
// K2 replaces raft_tpu/core/step_pallas.py:404 _invoke (pallas_call :453,
//    body _steady_kernel :145): one whole steady step — frontier room and
//    backpressure, heard/accept/verified-match masks, the payload and
//    uniform-term window merge with the §5.3 check, then the state advance,
//    term adoption and the k-th-order quorum commit behind the term_floor
//    gate.
// K3 replaces step_pallas.py:1045 _run_pipeline (pallas_call :1095, body
//    _steady_pipeline_kernel :664): T steady steps as one flight.
// K4 replaces step_pallas.py:1189 _run_turnover (pallas_call :1221, body
//    _turnover_kernel :1130): the write-only all-accept flight that turns
//    the whole ring over (T*B >= C).
// K2-4·ec, the in-kernel RS parity mode of all three (step_pallas.py:93
//    _encode_parity_lanes and :109 _mul_const_packed, reached at :231-237,
//    :766-767 and :1152-1153): the windows carry only the k data-lane
//    blocks (Mk = k*W lanes) and the writer computes the m parity lane
//    blocks itself, from the k data words at its own word offset of the
//    WINDOW row (never from the ring), as their GF(2^8) combination
//    (gf_packed.cuh). The [m][k][8] constant table lives in shared memory.
// K2·mesh, K3·mesh (LOCAL = true) and K4·mesh (turnover_mesh_kernel)
//    replace the local=True branches of the same three kernels
//    (step_pallas.py:217, :245, :268, :292, :361 in _steady_kernel; :751,
//    :775, :816 in _steady_pipeline_kernel; :1155 in _turnover_kernel),
//    driven by core/step_mesh.py: one replica row per rank. The (6, R)
//    block is the plane gathered from every rank and the scalar core runs
//    over all R rows of it; the rings hold the rank's own row (payload
//    [C, W], terms [1, C], p.my the row). The merge writes that row where
//    it accepts and reads no old term; the §5.3 conflict bit and the next
//    prev-term column are closed forms (the row's tail is the window end;
//    the next prev term is lterm for accepting rows, -1 for the rest),
//    exact under the engine's steady-program invariants. The prev column
//    comes in as an operand. The mesh decides the turnover branch on the
//    host from the gathered plane, so K3·mesh never decides and K4·mesh
//    takes its start slot from the caller.
//
// Bound: bytes. A step reads its window (count*Mk*4 B), writes the
// accepted payload lanes, and reads (only where a row already holds an
// entry) and writes count*L term slots; the scalar core is O(L) on a
// warp. K4 writes the whole payload and term rings once and reads the T*B
// window rows that survive.
//
// K2 moves well under a megabyte, so below its bytes the launch floor and
// the chains of dependent loads bound it. Its design shortens the chains:
//  - The scalar core runs on warp 0 of every block (lane l = row l,
//    raft_common.cuh): the (6, L) block, the masks and the prev-term column
//    load in parallel, one lane a row (the column from the ring in the
//    resident mode, after the leader's tail; from prev_col on the mesh).
//  - Meanwhile the other threads have already issued their window loads
//    (the window always holds B rows); only the stores wait for count, the
//    start slot and the accept bits. The parity mode prefetches its k data
//    words into L1 instead, since ec_row_write loads them itself.
//  - The merge walks rows: a thread's lane vector (a word pair of every
//    shard in the parity mode) is fixed, and each window row's slot is
//    (s + jj), wrapped once, in 32-bit arithmetic. 16-byte vectors, two
//    rows a thread in flight (one row with the parity writer). The grid is
//    sized by SM count, at most two blocks an SM, so the window spreads
//    over the card (four rows a thread kept it on 52 of the 132 SMs) and a
//    few hundred blocks at most take the ticket.
//  - The term merge is spread over the block, one thread a (row, window
//    row), and reads an old term only where the row already holds an entry
//    (ws + jj <= last[l]), as K3's does; the conflict bits meet through a
//    warp OR and one shared atomic a warp.
//  - The parity mode writes its rows through ec_row_write (the k data words
//    loaded once a word pair, the m parity words in registers).
//  - The ticket: every block adds 1 (and 1 << 16 when it raised a conflict
//    bit, after its atomicOr and a fence); warp 0 of the last block runs
//    the epilogue from the registers its prologue left. It reads the
//    conflict word only when the ticket says a block raised one, and needs
//    no other block's stores: the next prev-term column is lterm for an
//    accepting row and, for the rest, the old term at the window's last
//    slot, which warp 0 loaded right after the prologue (nothing in the
//    step writes it). So a scan is T back-to-back launches with no host
//    work in between.
//
// K3 is two ordinary launches on one stream, a plan and a writer. Within a
// flight nothing reads the payload ring: only the term ring and the (6, L)
// state block carry from one step to the next.
//  - The plan is ONE block. Warp 0 first takes the turnover decision
//    (step_pallas.py:889's launch-feasibility predicate and every row
//    accepting; resident layout only). If it takes it, it publishes the
//    decision and the start slot in the workspace and exits; K4, launched
//    behind it, reads them. Otherwise warp 0 runs the T steps' scalar core
//    with lane l = row l, the (6, L) block, the masks and the prev-term
//    column in registers: ballots for the accept and heard masks, shuffles
//    and a warp max for the k-th-order quorum commit. The block's threads
//    share the term-ring merge: they write lterm into the accepting rows'
//    window slots, and read an old term only where the row already holds
//    an entry (index <= last[l]) for the §5.3 compare; the conflict bits
//    meet in shared memory. The next step's prev term of a row is the term
//    its merge left at the window's last slot — lterm where the row
//    accepted, else the old term that the compare read (a row that holds
//    no entry there cannot pass the next prev check). In steady state no
//    row holds an entry inside the window, so nothing is read: warp 0 then
//    plans up to 64 steps ahead of the block, which writes their terms as
//    one batch (all the same value, so in any order); a step that must
//    read is merged by the block after the batch. Only __syncthreads
//    orders the steps. The plan writes a per-step record {start slot,
//    count, accept mask, first flight position} (windows are
//    consecutive: step t covers flight positions [pos_t, pos_t +
//    count_t), slot (s_0 + position) mod C), the final (6, L) block and
//    out.
//  - The writer is an ordinary grid behind it, two 512-thread blocks an
//    SM: few blocks, so that a writer that finds the flight handed to K4
//    exits cheaply. A thread owns destinations (a slot and a lane vector;
//    a word pair of every shard in EC mode), four a pass with their loads
//    in flight together, and stores the window lane of the LAST step
//    whose window covers the slot and whose accept mask holds the lane's
//    row: it walks the slot's flight positions from the last lap down and
//    looks each position's step up in the record (at once for full
//    windows, else by a binary search). An untouched destination keeps
//    its word. No atomics, no grid sync, 32-bit index arithmetic; each
//    payload word is written at most once a flight.
//  Every step runs at its true start slot, so K3 computes exactly the
//  per-step scan for every input: the TPU's affine-geometry restriction
//  does not apply.
//
// K4 is a copy and a fill: every slot takes the window row of the last
// step that covers it, and every term slot the leader's term. Its T steps'
// bookkeeping collapses into one closed form (turnover_closed_form), which
// one warp of an extra block writes, so nothing in K4 grows with T. The
// rows that reach the ring form a few contiguous runs (they break where
// the slot wraps at C and where the window stack wraps at P*B rows), so a
// persistent grid (two blocks an SM) walks chunks of the flat words, a
// run's ends worked out once in 32-bit arithmetic. A block moves a
// chunk's 16-byte-aligned body as 16-byte vectors, kUnroll loads in
// flight a thread, and the few words around it (all of a run whose source
// and destination sit at different 16-byte phases) one by one, and fills
// its share of the term ring. (On the H100 this loop beat one that moved
// the bodies by the TMA's bulk copies through shared-memory stages: see
// PERF.md §6.)
// When K3's plan keeps the flight, every block exits on its first load.
// K4·ec does it per (slot, word pair) with the source window row worked
// out once per slot, the k data words loaded once and the m parity words
// computed in registers (ec_row_write), and the same closed form.
// K4·mesh is a kernel of its own: the host knows the start slot, so a
// block takes runs of slots whose source rows it works out once each, its
// threads move 16-byte vectors (word pairs, or words, at rows that are not
// 16-byte multiples) several at a time, and one warp of an extra block
// writes the closed form.
#include <type_traits>

#include "raft_common.cuh"

// work[] layout shared by the kernels (int32 words, zero on entry to K2).
// WK_RAN3 / WK_RAN4 count the flights K3 and K4 actually executed (a
// launch that finds the other kernel chosen exits without work), so a
// caller can see which branch its flights took without a host read per
// flight.
enum {
  WK_MM = 0, WK_TICKET = 1, WK_PLAN = 5, WK_S0 = 6, WK_RAN3 = 7,
  WK_RAN4 = 8, WK_N = 9
};

static const int kThreads = 256;
// the plan block: warp 0 runs the scalar core, all of it the term merge
static const int kPlanThreads = 512;
// the writer's grid: this many blocks an SM of kWriteThreads (each thread
// takes kUnroll destinations a pass), few blocks so that a writer that
// finds the flight handed to K4 exits cheaply
static const int kWriteBlocksPerSM = 2;
static const int kWriteThreads = 512;

// ------------------------------------- EC rows (K2·ec, K3·ec, K4·ec)
// The word-pair row routine: lanes (o in units of V2 words) of every shard
// in ``rows`` of one ring row from one data-lane window row. The k data
// vectors are loaded once; data rows store them, parity rows their GF(2^8)
// combination (step_pallas.py:93 _encode_parity_lanes), computed in
// registers from the [m][k][8] table. Codes wider than RT_KMAX data shards
// take the rest from memory.
#define RT_KMAX 8
template <int V2>
struct Lanes;
template <>
struct Lanes<1> {
  typedef int T;
  static __device__ __forceinline__ int mul(int x, const uint8_t* c) {
    return (int)gf_mul_packed((unsigned)x, c);
  }
  static __device__ __forceinline__ int add(int a, int b) { return a ^ b; }
};
template <>
struct Lanes<2> {
  typedef int2 T;
  static __device__ __forceinline__ int2 mul(int2 x, const uint8_t* c) {
    return make_int2((int)gf_mul_packed((unsigned)x.x, c),
                     (int)gf_mul_packed((unsigned)x.y, c));
  }
  static __device__ __forceinline__ int2 add(int2 a, int2 b) {
    return make_int2(a.x ^ b.x, a.y ^ b.y);
  }
};

template <int V2>
__device__ inline void ec_row_write(int* dst_row, const int* src_row, int o,
                                    unsigned rows, const SteadyParams& p,
                                    const uint8_t* tbl) {
  typedef Lanes<V2> X;
  typedef typename X::T U;
  const int W2 = p.W / V2, k = p.Mk / p.W;
  const U* src = reinterpret_cast<const U*>(src_row) + o;
  U* dst = reinterpret_cast<U*>(dst_row) + o;
  U x[RT_KMAX];
#pragma unroll
  for (int j = 0; j < RT_KMAX; ++j) {
    x[j] = U();
    if (j < k) {
      x[j] = src[j * W2];
      if ((rows >> j) & 1u) dst[j * W2] = x[j];
    }
  }
  for (int j = RT_KMAX; j < k; ++j)
    if ((rows >> j) & 1u) dst[j * W2] = src[j * W2];
  for (unsigned par = rows >> k; par; par &= par - 1) {
    const int q = __ffs(par) - 1;
    const uint8_t* c = tbl + q * k * 8;
    U acc = U();
#pragma unroll
    for (int j = 0; j < RT_KMAX; ++j)
      if (j < k) acc = X::add(acc, X::mul(x[j], c + j * 8));
    for (int j = RT_KMAX; j < k; ++j)
      acc = X::add(acc, X::mul(src[j * W2], c + j * 8));
    dst[(k + q) * W2] = acc;
  }
}

// ----------------------------------------------------------------- K2
// Window rows a K2 thread takes per pass, their loads in flight together
// (one row in the parity mode, whose row writer loads its k data words
// itself), and the blocks an SM takes at most.
static const int kStepUnroll = 2;
static const int kStepBlocksPerSM = 2;

// One steady step (see the header). V: the lane-vector width (4 or 1; in
// the parity mode word pairs, 2, or words). A thread owns lane vector ov0
// (a word pair of every shard in the parity mode) of window rows base +
// u*S + so, u < KU, in passes of gridDim.x * S * KU rows.
template <int V, bool EC, bool LOCAL>
__global__ void __launch_bounds__(kThreads)
    steady_step_kernel(int* vec, int* __restrict__ buf_p, int* log_term,
                       const int* __restrict__ win, const int* cnt_ptr,
                       int cnt_val, const uint8_t* alive, const uint8_t* slow,
                       const uint8_t* member, SteadyParams p, int* out,
                       unsigned* work, const uint8_t* ec,
                       const int* prev_col) {
  static_assert(!(EC && LOCAL), "mesh windows arrive pre-encoded");
  typedef typename std::conditional<V == 4, int4, int>::type U;
  constexpr int KU = EC ? 1 : kStepUnroll;
  __shared__ LaneStep sh_st;        // the step's prologue results
  __shared__ int sh_last[RT_LMAX];  // every row's last index at the start
  __shared__ unsigned sh_mm;        // the block's §5.3 conflict bits
  __shared__ unsigned sh_ticket;
  __shared__ uint8_t ec_sh[EC ? RT_EC_BYTES : 1];
  const unsigned full = 0xffffffffu;
  const int L = p.L, C = p.C, B = p.B;
  const int lane = threadIdx.x & 31;
  const bool w0 = threadIdx.x < 32;
  const bool row = lane < L;
  const int WV = (EC ? p.W : p.M) / V;
  const int S = max(1, (int)blockDim.x / WV);
  const int so = threadIdx.x / WV;
  const int ov0 = threadIdx.x - so * WV;
  const bool mover = so < S;
  const int per = S * KU;
  const int stride = gridDim.x * per;
  const int base0 = blockIdx.x * per;

  // the first pass's window loads, before the prologue: the window always
  // holds B rows, and only the stores wait for the step's scalars
  U val[KU];
  if (mover) {
#pragma unroll
    for (int u = 0; u < KU; ++u) {
      const int jj = base0 + u * S + so;
      if (jj >= B) continue;
      const int* src = win + (size_t)jj * p.Mk;
      if constexpr (EC) {
        for (int j = 0; j < p.Mk / p.W; ++j)
          prefetch_l1(src + j * p.W + ov0 * V);
      } else {
        val[u] = reinterpret_cast<const U*>(src)[ov0];
      }
    }
  }
  if (EC) load_ec_table(ec_sh, ec, p);

  // the prologue on warp 0, lane l = row l
  LaneRow r = {0, 0, 0, 0, 0, 0, 0, false, false, false};
  LaneStep st = {0, 0, 0, 0, 0u, 0u, false};
  int q = 0, old_q = 0;
  if (w0) {
    const int cnt = cnt_ptr ? *cnt_ptr : cnt_val;
    const bool mem = lane_load(vec, alive, slow, member, L, lane, r);
    if (LOCAL) {
      if (row) r.prev = prev_col[lane];
    } else {
      // the prev-term column: every row's term at the slot before the
      // leader's frontier
      const int last0 = __shfl_sync(full, r.vl, p.leader);
      if (row)
        r.prev = __ldcg(log_term + (size_t)lane * C +
                        floor_mod(max(last0, 1) - 1, C));
    }
    q = lane_quorum(mem, member, p);
    lane_prologue(r, cnt, p, lane, st);
    // the term a row that does not accept keeps at the window's last slot
    // (its next prev term; the step writes no term of that row)
    if (!LOCAL && row && st.count > 0 && !((st.acc >> lane) & 1u))
      old_q = __ldcg(log_term + (size_t)lane * C +
                     floor_mod(st.s + st.count - 1, C));
    if (row) sh_last[lane] = r.vl;
    if (lane == 0) {
      sh_st = st;
      sh_mm = 0;
    }
  }
  __syncthreads();
  const int count = sh_st.count, s = sh_st.s, ws = sh_st.ws;
  const unsigned acc = sh_st.acc;

  // the payload merge: the accepting rows' lanes of window rows jj < count
  // into slot (s + jj) mod C
  if (mover) {
    bool loaded = true;  // val holds (base0, ov0)
    for (int base = base0, ov = ov0; base < count;) {
      if constexpr (EC) {
        const int jj = base + so;
        if (jj < count) {
          int d = s + jj;
          if (d >= C) d -= C;
          ec_row_write<V>(buf_p + (size_t)d * p.M, win + (size_t)jj * p.Mk,
                          ov, acc, p, ec_sh);
        }
      } else {
        const int l = LOCAL ? p.my : (ov * V) / p.W;
        if ((acc >> l) & 1u) {
          if (!loaded) {
#pragma unroll
            for (int u = 0; u < KU; ++u) {
              const int jj = base + u * S + so;
              if (jj < count)
                val[u] = reinterpret_cast<const U*>(
                    win + (size_t)jj * p.Mk)[ov];
            }
          }
#pragma unroll
          for (int u = 0; u < KU; ++u) {
            const int jj = base + u * S + so;
            if (jj >= count) continue;
            int d = s + jj;
            if (d >= C) d -= C;
            reinterpret_cast<U*>(buf_p + (size_t)d * p.M)[ov] = val[u];
          }
        }
      }
      loaded = false;
      ov += blockDim.x;
      if (ov >= WV) {
        ov = ov0;
        base += stride;
      }
    }
  }

  // the term merge, one thread a (row, window row) of the block's rows:
  // lterm into the accepting rows' slots; an old term is read only where
  // the row holds an entry (LOCAL: no read, one row)
  unsigned bits = 0;
  const int rows = LOCAL ? 1 : L;
  for (int base = base0; base < count; base += stride) {
    for (int i = threadIdx.x; i < per * rows; i += blockDim.x) {
      const int l = i / per;
      const int jj = base + (i - l * per);
      if (jj >= count) continue;
      int d = s + jj;
      if (d >= C) d -= C;
      int* tp = log_term + (size_t)l * C + d;
      if (!LOCAL && ws + jj <= sh_last[l] && __ldcg(tp) != p.lterm)
        bits |= 1u << l;
      if ((acc >> (LOCAL ? p.my : l)) & 1u) *tp = p.lterm;
    }
  }
  if (!LOCAL) {
    bits = __reduce_or_sync(full, bits);
    if (lane == 0 && bits) atomicOr(&sh_mm, bits);
  }
  __syncthreads();

  // the ticket: 1 a block, plus 1 << 16 from a block that raised a
  // conflict bit (published before it)
  if (threadIdx.x == 0) {
    unsigned add = 1;
    if (sh_mm) {
      atomicOr(&work[WK_MM], sh_mm);
      __threadfence();
      add += 1u << 16;
    }
    sh_ticket = atomicAdd(&work[WK_TICKET], add) + add;
  }
  __syncthreads();
  const unsigned ticket = sh_ticket;
  if (!w0 || (ticket & 0xffffu) != gridDim.x) return;

  // the last block's warp 0: the epilogue, from the prologue's registers
  unsigned mm = 0;
  if (ticket >> 16) {
    __threadfence();
    if (lane == 0) mm = atomicExch(&work[WK_MM], 0u);
    mm = __shfl_sync(full, mm, 0);
  }
  int g = 0, max_term = 0;
  const int match = lane_epilogue(r, st, mm, q, p, lane, g, max_term);
  lane_store(vec, r, L, lane);
  if (row) {
    out[lane] = match;
    // the next step's prev-term column: the term now at the window's last
    // slot (LOCAL: its closed form, -1 for a row that did not accept), or
    // the unchanged column after an empty window
    int nxt = r.prev;
    if (st.count > 0)
      nxt = ((st.acc >> lane) & 1u) ? p.lterm : (LOCAL ? -1 : old_q);
    out[L + 5 + lane] = nxt;
  }
  if (lane == 0) {
    out[L + 0] = g;
    out[L + 1] = max_term;
    out[L + 2] = st.count;
    out[L + 3] = floor_mod(st.ws - 1 + st.count, C);
    out[L + 4] = 0;
    work[WK_TICKET] = 0;
  }
}

// ------------------------------------------------------------- K3: plan
// Steps planned ahead of their term writes at most (one batch).
static const int kBatch = 64;

// The plan: warp 0 runs the steps' scalar core; the block writes the
// terms. A step in which no row holds an entry inside its window reads no
// old term, so its conflict bits are 0 and a rejecting row's prev term
// cannot matter (the row cannot pass the next prev check); warp 0 runs
// such steps ahead without the block, and the block then writes their
// terms as one batch — every write is lterm into an accepting row's
// window, so their order does not matter. A step in which some row holds
// entries there (a stale suffix, a §5.3 conflict) is merged by the whole
// block after the batch, reading the old terms as K2 does.
template <bool LOCAL>
__global__ void __launch_bounds__(kPlanThreads)
    flight_plan_kernel(int* vec_g, int* log_term,
                       const int* __restrict__ counts, int T,
                       const uint8_t* alive, const uint8_t* slow,
                       const uint8_t* member, SteadyParams p, int br,
                       int turnover_ok, int* out, unsigned* work, int4* rec,
                       const int* prev0) {
  __shared__ int4 sh_rec[kBatch];   // the batch's records
  __shared__ int sh_last[RT_LMAX];  // every row's last index at the step
  __shared__ int sh_old[RT_LMAX];   // old term at the window's last slot
  __shared__ int sh_ws;             // the merged step's window start index
  __shared__ unsigned sh_mm;        // the merged step's §5.3 conflict bits
  __shared__ int sh_run, sh_stop, sh_merge;
  const int L = p.L, C = p.C;
  const int lane = threadIdx.x & 31;
  const bool w0 = threadIdx.x < 32;
  const bool row = lane < L;
  const unsigned full = 0xffffffffu;
  LaneRow r = {0, 0, 0, 0, 0, 0, 0, false, false, false};
  LaneStep st = {0, 0, 0, 0, 0u, 0u, false};
  int q = 0, pos = 0, match = 0, g = 0, max_term = 0;
  if (w0) {
    // the loads that do not depend on the state first
    bool saturated = true;
    if (!LOCAL && turnover_ok)
      for (int i = lane; i < T; i += 32)
        saturated = saturated && __ldg(counts + i) == p.B;
    const bool mem = lane_load(vec_g, alive, slow, member, L, lane, r);
    if (LOCAL && row) r.prev = prev0[lane];
    q = lane_quorum(mem, member, p);
    const int last0 = __shfl_sync(full, r.vl, p.leader);
    const int ws0 = last0 + 1;
    if (!LOCAL && row)
      r.prev = log_term[(size_t)lane * C + floor_mod(max(ws0 - 1, 1) - 1, C)];
    int turnover = 0;
    if (!LOCAL && turnover_ok) {
      // step_pallas.py:889 _launch_feasibility, and every row accepting
      const int commit0 = __shfl_sync(full, r.vc, p.leader);
      const int term0 = __shfl_sync(full, r.vt, p.leader);
      int prev_term = (ws0 - 1 < p.rfloor)
                          ? p.fpt
                          : __shfl_sync(full, r.prev, p.leader);
      if (ws0 == 1) prev_term = 0;
      const bool a =
          row && ((r.al && !r.sl && r.ack && p.lterm >= r.vt &&
                   r.vl == last0 && (ws0 == 1 || r.prev == prev_term)) ||
                  (lane == p.leader && r.ack));
      const unsigned am = __ballot_sync(full, a);
      const unsigned rows = L == 32 ? full : (1u << L) - 1u;
      turnover = p.lterm >= 1 && term0 <= p.lterm && commit0 == last0 &&
                 floor_mod(ws0 - 1, C) % br == 0 &&
                 __all_sync(full, saturated) && __popc(am) >= q && am == rows;
    }
    if (lane == 0) {
      work[WK_PLAN] = turnover;
      work[WK_S0] = floor_mod(ws0 - 1, C);
      sh_run = !turnover;
      sh_mm = 0;
    }
  }
  __syncthreads();
  if (!sh_run) return;  // the same decision in the whole block: K4 runs it
  int t = 0;     // warp 0: the next step to plan
  int from = 0;  // the first step whose terms are not written yet
  for (;;) {
    if (w0) {
      bool merge = false;
      // the counts of the round's steps, two per lane (kBatch = 64)
      const int c0 = from + lane < T ? __ldg(counts + from + lane) : 0;
      const int c1 = from + 32 + lane < T ? __ldg(counts + from + 32 + lane)
                                          : 0;
      for (; t < T && t - from < kBatch; ++t) {
        const int u = t - from;
        lane_prologue(r, __shfl_sync(full, u < 32 ? c0 : c1, u & 31), p,
                      lane, st);
        const int4 rc = make_int4(st.s, st.count, (int)st.acc, pos);
        if (lane == 0) {
          rec[t] = rc;
          sh_rec[t - from] = rc;
        }
        pos += st.count;
        if (!LOCAL && st.count > 0 &&
            __any_sync(full, row && r.vl >= st.ws)) {
          if (row) sh_last[lane] = r.vl;
          if (lane == 0) sh_ws = st.ws;
          merge = true;  // rows hold entries in the window: read them
          break;
        }
        match = lane_epilogue(r, st, 0u, q, p, lane, g, max_term);
        if (st.count > 0)
          r.prev = ((st.acc >> lane) & 1u) ? p.lterm
                                           : (LOCAL ? -1 : r.prev);
      }
      if (lane == 0) {
        sh_stop = t;
        sh_merge = merge;
      }
    }
    __syncthreads();
    const int stop = sh_stop;
    const bool merge = sh_merge;
    // the batch: lterm into every accepting row's window slots of the
    // steps [from, stop)
    for (int u = from; u < stop; ++u) {
      const int4 rc = sh_rec[u - from];
      const unsigned acc = (unsigned)rc.z;
      for (int l = 0; l < (LOCAL ? 1 : L); ++l) {
        if (!((acc >> (LOCAL ? p.my : l)) & 1u)) continue;
        int* tr = log_term + (size_t)l * C;
        for (int jj = threadIdx.x; jj < rc.y; jj += blockDim.x) {
          int d = rc.x + jj;
          if (d >= C) d -= C;
          tr[d] = p.lterm;
        }
      }
    }
    if (merge) {
      __syncthreads();  // the batch's terms before the step's reads
      const int4 rc = sh_rec[stop - from];
      const int n = rc.y, s = rc.x, wsb = sh_ws;
      const unsigned acc = (unsigned)rc.z;
      unsigned bits = 0;
      for (int l = 0; l < L; ++l) {
        const int last_l = sh_last[l];
        const bool a = (acc >> l) & 1u;
        if (!a && wsb > last_l) continue;  // nothing to read or write
        int* tr = log_term + (size_t)l * C;
        for (int jj = threadIdx.x; jj < n; jj += blockDim.x) {
          int d = s + jj;
          if (d >= C) d -= C;
          if (wsb + jj <= last_l) {  // an existing entry: §5.3 compare
            const int old = tr[d];
            if (old != p.lterm) bits |= 1u << l;
            if (jj == n - 1) sh_old[l] = old;
          }
          if (a) tr[d] = p.lterm;
        }
      }
      bits = __reduce_or_sync(full, bits);
      if (lane == 0 && bits) atomicOr(&sh_mm, bits);
      __syncthreads();
      if (w0) {
        match = lane_epilogue(r, st, sh_mm, q, p, lane, g, max_term);
        // the term the merge left at the window's last slot
        r.prev = ((st.acc >> lane) & 1u) ? p.lterm : sh_old[lane];
        ++t;
      }
    }
    from = merge ? stop + 1 : stop;
    if (from >= T) break;
    __syncthreads();  // the batch is written before warp 0 plans the next
    if (w0 && lane == 0) sh_mm = 0;
  }
  if (w0) {
    lane_store(vec_g, r, L, lane);
    if (row) out[lane] = match;
    if (lane == 0) {
      out[L + 0] = g;
      out[L + 1] = max_term;
      out[L + 2] = st.count;
      out[L + 3] = floor_mod(st.ws - 1 + st.count, C);
      out[L + 4] = 0;
      work[WK_RAN3] += 1;
    }
  }
}

// ----------------------------------------------------------- K3: writer
// The step whose window holds flight position kk: the last step whose
// first position is <= kk (a step with count 0 shares its position with
// the next one, which wins). Full windows give it at once; any other
// record takes a binary search.
__device__ __forceinline__ int step_at(const int4* rec, int T, int B,
                                       int kk) {
  const int g = min(kk / B, T - 1);
  if (__ldg(&rec[g].w) <= kk && (g + 1 == T || __ldg(&rec[g + 1].w) > kk))
    return g;
  int lo = 0, hi = T - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (__ldg(&rec[mid].w) <= kk)
      lo = mid;
    else
      hi = mid - 1;
  }
  return lo;
}

// Destinations a writer thread takes per pass, their loads in flight
// together.
static const int kUnroll = 4;

template <int V, bool LOCAL>
__global__ void __launch_bounds__(kWriteThreads)
    flight_write_kernel(int* __restrict__ buf_p,
                        const int* __restrict__ wins, const int4* rec, int T,
                        int P, SteadyParams p, const unsigned* work) {
  typedef typename std::conditional<V == 4, int4, int>::type U;
  if (__ldcg(&work[WK_PLAN])) return;  // the flight went to K4
  const int4 last = __ldg(&rec[T - 1]);
  const int N = last.w + last.y;       // flight positions written
  const int s0 = __ldg(&rec[0].x);
  const int C = p.C, MV = p.M / V;
  const unsigned items = (unsigned)min(N, C) * MV;
  const unsigned stride = gridDim.x * blockDim.x;
  for (unsigned e0 = blockIdx.x * blockDim.x + threadIdx.x; e0 < items;
       e0 += kUnroll * stride) {
    const U* src[kUnroll];
    U* dst[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      src[u] = nullptr;
      const unsigned e = e0 + u * stride;
      if (e >= items) continue;
      const int k = e / MV;
      const int v = e - k * MV;
      int d = s0 + k;
      if (d >= C) d -= C;
      dst[u] = reinterpret_cast<U*>(buf_p + d * p.M) + v;
      const int l = LOCAL ? p.my : (v * V) / p.W;
      for (int kk = k + (N - 1 - k) / C * C; kk >= 0; kk -= C) {
        const int t = step_at(rec, T, p.B, kk);
        const int4 r = __ldg(&rec[t]);
        if (((unsigned)r.z >> l) & 1u) {
          src[u] = reinterpret_cast<const U*>(
                       wins + ((t % P) * p.B + (kk - r.w)) * p.Mk) + v;
          break;
        }
      }
    }
    U val[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
      if (src[u]) val[u] = *src[u];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
      if (src[u]) *dst[u] = val[u];
  }
}

template <int V2>
__global__ void __launch_bounds__(kWriteThreads)
    flight_write_ec_kernel(int* __restrict__ buf_p,
                           const int* __restrict__ wins, const int4* rec,
                           int T, int P, SteadyParams p, const unsigned* work,
                           const uint8_t* ec) {
  __shared__ uint8_t ec_sh[RT_EC_BYTES];
  if (__ldcg(&work[WK_PLAN])) return;  // the flight went to K4
  load_ec_table(ec_sh, ec, p);
  __syncthreads();
  const int4 last = __ldg(&rec[T - 1]);
  const int N = last.w + last.y;
  const int s0 = __ldg(&rec[0].x);
  const int C = p.C, W2 = p.W / V2;
  const unsigned every = p.L == 32 ? 0xffffffffu : (1u << p.L) - 1u;
  const unsigned items = (unsigned)min(N, C) * W2;
  const unsigned stride = gridDim.x * blockDim.x;
  for (unsigned e0 = blockIdx.x * blockDim.x + threadIdx.x; e0 < items;
       e0 += kUnroll * stride) {
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const unsigned e = e0 + u * stride;
      if (e >= items) break;
      const int k = e / W2;
      const int o = e - k * W2;
      int d = s0 + k;
      if (d >= C) d -= C;
      unsigned left = every;  // rows still to be written
      for (int kk = k + (N - 1 - k) / C * C; kk >= 0 && left; kk -= C) {
        const int t = step_at(rec, T, p.B, kk);
        const int4 r = __ldg(&rec[t]);
        const unsigned take = left & (unsigned)r.z;
        if (take) {
          ec_row_write<V2>(buf_p + d * p.M,
                           wins + ((t % P) * p.B + (kk - r.w)) * p.Mk, o,
                           take, p, ec_sh);
          left &= ~take;
        }
      }
    }
  }
}

// ----------------------------------------------------------------- K4
// The turnover bookkeeping in closed form, on one warp (lane l = row l).
// Every row accepts every step and the commit condition only gets easier
// as the tail grows, so the T steps of the JAX kernel's per-step epilogue
// (step_pallas.py:1161-1186) collapse into one: the tail ends at VL[0] +
// T*B, a row adopts lterm (and drops its vote) iff lterm exceeded its term
// at the start, and the commit moves to the tail iff it may at the last
// step. K4, K4·ec and K4·mesh all run it.
__device__ inline void turnover_closed_form(int* vec_g, int T, int B, int C,
                                            int L, int lterm, int tfloor,
                                            int* out, unsigned* work) {
  const int l = threadIdx.x;
  const int last0 = vec_g[VL * L + 0];
  int v[6] = {0, 0, 0, 0, 0, 0};
  if (l < L)
    for (int i = 0; i < 6; ++i) v[i] = vec_g[i * L + l];
  __syncwarp();  // every lane has read VL[0] before lane 0 rewrites it
  const int we = T > 0 ? last0 + T * B : 0;
  if (T > 0) {
    if (lterm > v[VT]) v[VV] = RT_NO_VOTE;
    v[VT] = max(v[VT], lterm);
    v[VL] = v[VMI] = we;
    v[VMT] = lterm;
    if (lterm >= 1 && we >= 1 && we >= tfloor) v[VC] = we;
  }
  if (l < L) {
    for (int i = 0; i < 6; ++i) vec_g[i * L + l] = v[i];
    out[l] = v[VMI];
  }
  if (l == 0) {
    out[L + 0] = v[VC];
    out[L + 1] = max(v[VT], lterm);
    out[L + 2] = B;
    out[L + 3] = floor_mod(we, C);
    out[L + 4] = 0;
    work[WK_RAN4] += 1;
  }
}

// K4's payload write is a copy. The rows that reach the ring are the
// flight positions [T*B - n, T*B), n = min(T*B, C): position pos is row
// pos mod P*B of the window stack (step t reads wins[t % P]) and lands in
// slot (s0 + pos) mod C. So the n*M words to move break only where the
// slot wraps at C and where the stack wraps at P*B rows: a few contiguous
// runs. TurnGeom holds that geometry from flat row 0: window row r0,
// slot d0.
struct TurnGeom {
  int n, M, C, PB, r0, d0;
};

// f(src word, dst word, len) for each run of the flat words [w0, w1) (w
// = flat row * M + lane): the runs' ends are worked out once a run, in
// 32-bit arithmetic (C*M and P*B*M stay below 2^31).
template <class F>
__device__ inline void for_runs(const TurnGeom& g, int w0, int w1, F f) {
  const int k = w0 / g.M;
  int off = w0 - k * g.M;
  int d = g.d0 + k;
  if (d >= g.C) d -= g.C;
  int r = k % g.PB + g.r0;
  if (r >= g.PB) r -= g.PB;
  for (int w = w0; w < w1;) {
    const int len = min(w1 - w, min(g.C - d, g.PB - r) * g.M - off);
    f(r * g.M + off, d * g.M + off, len);
    w += len;
    const int rows = (off + len) / g.M;
    off += len - rows * g.M;
    d += rows;
    if (d >= g.C) d -= g.C;
    r += rows;
    if (r >= g.PB) r -= g.PB;
  }
}

// A run's words before its first 16-byte-aligned destination word (head)
// and the whole 16-byte vectors after them (body, in words): none where
// source and destination sit at different 16-byte phases (rows that are
// not 16-byte multiples), whose runs move word by word.
__device__ __forceinline__ void split_run(const int* src, const int* dst,
                                          int len, int& head, int& body) {
  const unsigned ps = (unsigned)(uintptr_t)src & 15u;
  const unsigned pd = (unsigned)(uintptr_t)dst & 15u;
  if (ps != pd) {
    head = len;
    body = 0;
    return;
  }
  head = min(len, (int)(((16u - pd) & 15u) >> 2));
  body = (len - head) & ~3;
}

static const int kTurnThreads = 512;
static const int kTurnBlocksPerSM = 2;
// a chunk: kUnroll 16-byte vectors a thread (32 KB)
static const int kTurnChunk = kTurnThreads * kUnroll * 4;

// The term ring: L*C words of lterm, as 16-byte vectors where aligned,
// thread i of n.
__device__ inline void fill_terms(int* log_term, int words, int lterm,
                                  int i, int n) {
  const int w4 = ((uintptr_t)log_term & 15) ? 0 : words / 4;
  const int4 t4 = make_int4(lterm, lterm, lterm, lterm);
  for (int e = i; e < w4; e += n) reinterpret_cast<int4*>(log_term)[e] = t4;
  for (int e = 4 * w4 + i; e < words; e += n) log_term[e] = lterm;
}

// K4: the plan's decision and start slot come in work. The last block's
// warp 0 writes the bookkeeping (turnover_closed_form); every other block
// fills its share of the term ring and copies every gridDim-1-th chunk of
// the flat words, each thread kUnroll vectors of a chunk with their loads
// in flight together.
__global__ void __launch_bounds__(kTurnThreads)
    turnover_kernel(int* vec_g, int* __restrict__ buf_p,
                    int* __restrict__ log_term, const int* __restrict__ wins,
                    int T, SteadyParams p, int* out, unsigned* work,
                    TurnGeom g) {
  if (__ldcg(&work[WK_PLAN]) == 0) return;  // K3 ran the flight
  const int copiers = gridDim.x - 1;
  if ((int)blockIdx.x == copiers) {
    if (threadIdx.x < 32)
      turnover_closed_form(vec_g, T, p.B, p.C, p.L, p.lterm, p.tfloor, out,
                           work);
    return;
  }
  g.d0 += (int)__ldcg(&work[WK_S0]);
  if (g.d0 >= g.C) g.d0 -= g.C;
  const int words = g.n * g.M;
  const int chunks = words / kTurnChunk + (words % kTurnChunk != 0);
  fill_terms(log_term, p.L * p.C, p.lterm,
             blockIdx.x * blockDim.x + threadIdx.x, copiers * blockDim.x);
  const int t = threadIdx.x, nt = blockDim.x;
  for (int c = blockIdx.x; c < chunks; c += copiers)
    for_runs(g, c * kTurnChunk,
             c * kTurnChunk + min(kTurnChunk, words - c * kTurnChunk),
             [&](int so, int dO, int len) {
               const int* s = wins + so;
               int* d = buf_p + dO;
               int head, body;
               split_run(s, d, len, head, body);
               for (int x = t; x < head; x += nt) d[x] = s[x];
               const int4* s4 = reinterpret_cast<const int4*>(s + head);
               int4* d4 = reinterpret_cast<int4*>(d + head);
               const int nv = body / 4;
               for (int v0 = t; v0 < nv; v0 += kUnroll * nt) {
                 int4 val[kUnroll];
#pragma unroll
                 for (int u = 0; u < kUnroll; ++u)
                   if (v0 + u * nt < nv) val[u] = __ldcs(s4 + v0 + u * nt);
#pragma unroll
                 for (int u = 0; u < kUnroll; ++u)
                   if (v0 + u * nt < nv) d4[v0 + u * nt] = val[u];
               }
               for (int x = head + body + t; x < len; x += nt) d[x] = s[x];
             });
}

// K4·mesh: the rank's payload row [C, W] and term row [1, C] from the
// host's start slot s0. The last block runs the closed-form bookkeeping
// on one warp; every other block takes runs of per = S * kUnroll slots
// (S slots of W / V lane vectors a pass of its threads): the source row
// of each slot is worked out once, by one thread, in 32-bit arithmetic,
// into shared memory; then each thread moves kUnroll lane vectors with
// their loads in flight together. A slot no step covers (T*B < C) keeps
// its words, as the step loop leaves it.
// parts (TURNOVER_*) selects what runs, all of it on the main path.
enum { TURNOVER_PAYLOAD = 1, TURNOVER_TERMS = 2, TURNOVER_BOOK = 4 };

template <int V>
__global__ void __launch_bounds__(kWriteThreads)
    turnover_mesh_kernel(int* vec_g, int* __restrict__ buf_p,
                         int* __restrict__ log_term,
                         const int* __restrict__ wins, int T, int P, int B,
                         int C, int W, int L, int lterm, int tfloor, int s0,
                         int* out, unsigned* work, int parts) {
  typedef typename std::conditional<
      V == 4, int4, typename std::conditional<V == 2, int2, int>::type>::type
      U;
  __shared__ int src_row[kWriteThreads * kUnroll];
  const int copiers = gridDim.x - (parts & TURNOVER_BOOK ? 1 : 0);
  if ((int)blockIdx.x == copiers) {
    if (threadIdx.x < 32)
      turnover_closed_form(vec_g, T, B, C, L, lterm, tfloor, out, work);
    return;
  }
  const int WV = W / V;
  const int S = max(1, (int)blockDim.x / WV);  // slots a pass of threads
  const int per = S * kUnroll;                  // slots a block pass
  const int so = threadIdx.x / WV;
  const int ov0 = threadIdx.x - so * WV;
  const int TB = T * B;
  const int copy_end = parts & TURNOVER_PAYLOAD ? C : 0;
  for (int base = blockIdx.x * per; base < copy_end;
       base += copiers * per) {
    __syncthreads();  // the last pass's sources are read
    for (int i = threadIdx.x; i < per; i += blockDim.x) {
      const int d = base + i;
      if (d >= C) break;
      int k = d - s0;
      if (k < 0) k += C;
      int row = -1;  // no step covers the slot
      if (k < TB) {
        const int pos = k + (TB - 1 - k) / C * C;  // the slot's last write
        const int t = pos / B;
        row = ((t % P) * B + (pos - t * B)) * W;
      }
      src_row[i] = row;
    }
    __syncthreads();
    if (so >= S) continue;
    for (int ov = ov0; ov < WV; ov += blockDim.x) {
      U val[kUnroll];
      int row[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int i = u * S + so;
        row[u] = base + i < C ? src_row[i] : -1;
        if (row[u] >= 0) val[u] = reinterpret_cast<const U*>(wins + row[u])[ov];
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u)
        if (row[u] >= 0)
          reinterpret_cast<U*>(buf_p + (size_t)(base + u * S + so) * W)[ov] =
              val[u];
    }
  }
  if (!(parts & TURNOVER_TERMS)) return;
  // the term row, as 16-byte vectors where it is aligned
  const int tid = blockIdx.x * blockDim.x + threadIdx.x;
  const int stride = copiers * blockDim.x;
  const int C4 = ((uintptr_t)log_term & 15) ? 0 : C / 4;
  const int4 t4 = make_int4(lterm, lterm, lterm, lterm);
  for (int e = tid; e < C4; e += stride)
    reinterpret_cast<int4*>(log_term)[e] = t4;
  for (int e = 4 * C4 + tid; e < C; e += stride) log_term[e] = lterm;
}

// K4·ec: one thread per (slot, word pair of the shard); the block's slots
// come from blockIdx, and the source window row of each is worked out
// once, by one thread, in 32-bit arithmetic. Block 0's warp 0 first writes
// the closed-form bookkeeping.
template <int V2>
__global__ void __launch_bounds__(kThreads)
    turnover_ec_kernel(int* vec_g, int* buf_p, int* log_term,
                       const int* __restrict__ wins, int T, int P,
                       SteadyParams p, int* out, unsigned* work,
                       const uint8_t* ec) {
  __shared__ uint8_t ec_sh[RT_EC_BYTES];
  __shared__ int src_row[kThreads];
  if (__ldcg(&work[WK_PLAN]) == 0) return;  // K3 ran the flight
  if (blockIdx.x == 0 && threadIdx.x < 32)
    turnover_closed_form(vec_g, T, p.B, p.C, p.L, p.lterm, p.tfloor, out,
                         work);
  load_ec_table(ec_sh, ec, p);
  const int s0 = (int)__ldcg(&work[WK_S0]);
  const int C = p.C, B = p.B, TB = T * B;
  const int W2 = p.W / V2;
  const int S = max(1, (int)blockDim.x / W2);  // slots per block
  const int slot0 = blockIdx.x * S;
  if ((int)threadIdx.x < S && slot0 + (int)threadIdx.x < C) {
    int k = slot0 + threadIdx.x - s0;
    if (k < 0) k += C;
    const int pos = k + (TB - 1 - k) / C * C;  // the slot's last write
    const int t = pos / B;
    src_row[threadIdx.x] = ((t % P) * B + (pos - t * B)) * p.Mk;
  }
  __syncthreads();
  const unsigned every = p.L == 32 ? 0xffffffffu : (1u << p.L) - 1u;
  for (int x = threadIdx.x; x < S * W2; x += blockDim.x) {
    const int i = x / W2;
    const int d = slot0 + i;
    if (d < C)
      ec_row_write<V2>(buf_p + d * p.M, wins + src_row[i], x - i * W2, every,
                       p, ec_sh);
  }
  for (int e = blockIdx.x * blockDim.x + threadIdx.x; e < p.L * C;
       e += gridDim.x * blockDim.x)
    log_term[e] = p.lterm;
}

static SteadyParams make_params(int leader, int lterm, int tfloor, int rfloor,
                                int fpt, int quorum, int ec_floor, int L,
                                int C, int B, int M, int Mk, int my) {
  SteadyParams p;
  p.leader = leader;
  p.lterm = lterm;
  p.tfloor = tfloor;
  p.rfloor = rfloor;
  p.fpt = fpt;
  p.quorum = quorum;
  p.ec_floor = ec_floor;
  p.L = L;
  p.C = C;
  p.B = B;
  p.M = M;
  p.W = my >= 0 ? M : M / L;
  p.Mk = Mk;
  p.my = my;
  return p;
}

// K2: one steady step in place on vec (6, L), buf_p and log_term.
// out = match[L] | scal[5] | next_prev[L]. cnt_ptr (device) overrides
// cnt_val when not null. work must hold WK_N zeros on the first call;
// the kernel leaves it zeroed. ec (device u8[L-k][k][8], or null) selects
// the in-kernel parity mode, whose windows carry Mk = k*W lanes. vec: the
// lane-vector width, 4 or 1 (the parity mode: 2 or 1, word pairs).
// my_row >= 0 selects K2·mesh: the rings hold that row only and prev
// (device i32[L]) is every row's prev term.
RT_EXPORT int rt_steady_step(void* vec_g, void* buf_p, void* log_term,
                             const void* win, const void* cnt_ptr,
                             int cnt_val, const void* alive, const void* slow,
                             const void* member, int leader, int lterm,
                             int tfloor, int rfloor, int fpt, int quorum,
                             int ec_floor, int L, int C, int B, int M, int Mk,
                             void* out, void* work, const void* ec, int vec,
                             int my_row, const void* prev, void* stream) {
  const SteadyParams p = make_params(leader, lterm, tfloor, rfloor, fpt,
                                     quorum, ec_floor, L, C, B, M, Mk,
                                     my_row);
  if (L < 1 || L > RT_LMAX || B < 1 || (ec ? p.W : M) % vec)
    return (int)cudaErrorInvalidValue;
  int sms = 0;
  const cudaError_t e = rt_sm_count(&sms);
  if (e != cudaSuccess) return (int)e;
  const int WV = (ec ? p.W : M) / vec;
  const int per = max(1, kThreads / WV) * (ec ? 1 : kStepUnroll);
  const int blocks =
      max(1, min((B + per - 1) / per, kStepBlocksPerSM * sms));
  cudaStream_t st = (cudaStream_t)stream;
#define RT_K2_ARGS                                                         \
  (int*)vec_g, (int*)buf_p, (int*)log_term, (const int*)win,               \
      (const int*)cnt_ptr, cnt_val, (const uint8_t*)alive,                 \
      (const uint8_t*)slow, (const uint8_t*)member, p, (int*)out,          \
      (unsigned*)work, (const uint8_t*)ec, (const int*)prev
  if (ec) {
    if (vec == 2)
      steady_step_kernel<2, true, false><<<blocks, kThreads, 0, st>>>(
          RT_K2_ARGS);
    else
      steady_step_kernel<1, true, false><<<blocks, kThreads, 0, st>>>(
          RT_K2_ARGS);
  } else if (my_row >= 0) {
    if (vec == 4)
      steady_step_kernel<4, false, true><<<blocks, kThreads, 0, st>>>(
          RT_K2_ARGS);
    else
      steady_step_kernel<1, false, true><<<blocks, kThreads, 0, st>>>(
          RT_K2_ARGS);
  } else if (vec == 4) {
    steady_step_kernel<4, false, false><<<blocks, kThreads, 0, st>>>(
        RT_K2_ARGS);
  } else {
    steady_step_kernel<1, false, false><<<blocks, kThreads, 0, st>>>(
        RT_K2_ARGS);
  }
#undef RT_K2_ARGS
  return (int)cudaGetLastError();
}

// K3: a T-step flight over wins i32[P, B, Mk] (step t reads wins[t % P])
// and counts i32[T] on device: the plan (one block), then the writer
// behind it on the same stream. out = match[L] | scal[5]; rec (device
// int4[T]) takes the plan's per-step record. With turnover_ok the plan
// first decides whether the flight belongs to K4 (resident layout only).
// vec: the lane-vector width, 4 or 1 (EC: 2 or 1, word pairs). ec,
// my_row and prev (the gathered column at the flight's start) as K2.
RT_EXPORT int rt_steady_pipeline(void* vec_g, void* buf_p, void* log_term,
                                 const void* wins, const void* counts, int T,
                                 int P, const void* alive, const void* slow,
                                 const void* member, int leader, int lterm,
                                 int tfloor, int rfloor, int fpt, int quorum,
                                 int ec_floor, int L, int C, int B, int M,
                                 int Mk, int br, int turnover_ok, void* out,
                                 void* work, const void* ec, int vec,
                                 int my_row, const void* prev, void* rec,
                                 void* stream) {
  const SteadyParams p = make_params(leader, lterm, tfloor, rfloor, fpt,
                                     quorum, ec_floor, L, C, B, M, Mk,
                                     my_row);
  cudaStream_t st = (cudaStream_t)stream;
#define RT_PLAN_ARGS                                                       \
  (int*)vec_g, (int*)log_term, (const int*)counts, T,                      \
      (const uint8_t*)alive, (const uint8_t*)slow, (const uint8_t*)member, \
      p, br, turnover_ok, (int*)out, (unsigned*)work, (int4*)rec,          \
      (const int*)prev
  if (my_row >= 0)
    flight_plan_kernel<true><<<1, kPlanThreads, 0, st>>>(RT_PLAN_ARGS);
  else
    flight_plan_kernel<false><<<1, kPlanThreads, 0, st>>>(RT_PLAN_ARGS);
#undef RT_PLAN_ARGS
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  int sms = 0;
  const cudaError_t e2 = rt_sm_count(&sms);
  if (e2 != cudaSuccess) return (int)e2;
  const long npos = min((long)T * B, (long)C);  // positions at most
  const long per_slot = (ec ? p.W : M) / vec;
  const int blocks =
      (int)max(1L, min((npos * per_slot + kWriteThreads - 1) / kWriteThreads,
                       (long)kWriteBlocksPerSM * sms));
#define RT_WRITE_ARGS                                                      \
  (int*)buf_p, (const int*)wins, (const int4*)rec, T, P, p,                \
      (const unsigned*)work
  if (ec) {
    if (vec == 2)
      flight_write_ec_kernel<2><<<blocks, kWriteThreads, 0, st>>>(
          RT_WRITE_ARGS, (const uint8_t*)ec);
    else
      flight_write_ec_kernel<1><<<blocks, kWriteThreads, 0, st>>>(
          RT_WRITE_ARGS, (const uint8_t*)ec);
  } else if (my_row >= 0) {
    if (vec == 4)
      flight_write_kernel<4, true><<<blocks, kWriteThreads, 0, st>>>(
          RT_WRITE_ARGS);
    else
      flight_write_kernel<1, true><<<blocks, kWriteThreads, 0, st>>>(
          RT_WRITE_ARGS);
  } else if (vec == 4) {
    flight_write_kernel<4, false><<<blocks, kWriteThreads, 0, st>>>(
        RT_WRITE_ARGS);
  } else {
    flight_write_kernel<1, false><<<blocks, kWriteThreads, 0, st>>>(
        RT_WRITE_ARGS);
  }
#undef RT_WRITE_ARGS
  return (int)cudaGetLastError();
}

// K4: the write-only turnover flight. It exits at once unless the
// preceding plan published the turnover decision in work. vec, ec as
// rt_steady_pipeline (vec matters to K4·ec only: K4 finds each run's
// 16-byte phase itself).
RT_EXPORT int rt_turnover(void* vec_g, void* buf_p, void* log_term,
                          const void* wins, int T, int P, int lterm,
                          int tfloor, int L, int C, int B, int M, int Mk,
                          void* out, void* work, const void* ec, int vec,
                          void* stream) {
  const SteadyParams p =
      make_params(0, lterm, tfloor, 0, 0, 0, 0, L, C, B, M, Mk, -1);
  cudaStream_t st = (cudaStream_t)stream;
  if (ec) {
    const int S = max(1, kThreads / (p.W / vec));  // slots per block
    const int blocks = (C + S - 1) / S;
#define RT_K4EC_ARGS                                                       \
  (int*)vec_g, (int*)buf_p, (int*)log_term, (const int*)wins, T, P, p,     \
      (int*)out, (unsigned*)work, (const uint8_t*)ec
    if (vec == 2)
      turnover_ec_kernel<2><<<blocks, kThreads, 0, st>>>(RT_K4EC_ARGS);
    else
      turnover_ec_kernel<1><<<blocks, kThreads, 0, st>>>(RT_K4EC_ARGS);
#undef RT_K4EC_ARGS
    return (int)cudaGetLastError();
  }
  // 32-bit index arithmetic throughout: sums of two slots or two window
  // rows stay below 2^31
  const long PB = (long)P * B;
  if (T < 0 || P < 1 || B < 1 || L < 1 || L > RT_LMAX || M < 1 ||
      Mk != M || C < 1 || C >= (1 << 30) || PB >= (1L << 30) ||
      (long)C * M >= (1L << 31) || PB * M >= (1L << 31))
    return (int)cudaErrorInvalidValue;
  int sms = 0;
  const cudaError_t e = rt_sm_count(&sms);
  if (e != cudaSuccess) return (int)e;
  // the rows that reach the ring: flight positions [TB - n, TB)
  const long TB = (long)T * B;
  const long n = min(TB, (long)C);
  const TurnGeom g = {(int)n, M, C, (int)PB, (int)((TB - n) % PB),
                      (int)((TB - n) % C)};
  const long words = n * M;
  const int chunks = (int)((words + kTurnChunk - 1) / kTurnChunk);
  // a persistent grid: at most kTurnBlocksPerSM copy blocks an SM, and
  // the bookkeeping block
  const int blocks = max(1, min(chunks, kTurnBlocksPerSM * sms)) + 1;
  turnover_kernel<<<blocks, kTurnThreads, 0, st>>>(
      (int*)vec_g, (int*)buf_p, (int*)log_term, (const int*)wins, T, p,
      (int*)out, (unsigned*)work, g);
  return (int)cudaGetLastError();
}

// K4·mesh: the rank's payload row buf_p [C, W] and term row [1, C] from
// the start slot s0 that the host decided, the (6, L) plane vec_g and out
// = match[L] | scal[5]. vec: lane-vector width, 4, 2 or 1 (W a multiple of
// it, every base aligned to it); parts: TURNOVER_* (7 = all).
RT_EXPORT int rt_turnover_mesh(void* vec_g, void* buf_p, void* log_term,
                               const void* wins, int T, int P, int lterm,
                               int tfloor, int L, int C, int B, int W,
                               int s0, void* out, void* work, int vec,
                               int parts, void* stream) {
  if (T < 0 || B < 1 || P < 1 || C < 1 || s0 < 0 || s0 >= C || L < 1 ||
      L > 32 || (vec != 1 && vec != 2 && vec != 4) || W % vec)
    return (int)cudaErrorInvalidValue;
  int sms = 0;
  const cudaError_t e = rt_sm_count(&sms);
  if (e != cudaSuccess) return (int)e;
  const int per = max(1, kWriteThreads / (W / vec)) * kUnroll;
  const int blocks =
      max(1, min((C + per - 1) / per, kWriteBlocksPerSM * sms)) +
      (parts & TURNOVER_BOOK ? 1 : 0);
  cudaStream_t st = (cudaStream_t)stream;
#define RT_K4M_ARGS                                                        \
  (int*)vec_g, (int*)buf_p, (int*)log_term, (const int*)wins, T, P, B, C,  \
      W, L, lterm, tfloor, s0, (int*)out, (unsigned*)work, parts
  if (vec == 4)
    turnover_mesh_kernel<4><<<blocks, kWriteThreads, 0, st>>>(RT_K4M_ARGS);
  else if (vec == 2)
    turnover_mesh_kernel<2><<<blocks, kWriteThreads, 0, st>>>(RT_K4M_ARGS);
  else
    turnover_mesh_kernel<1><<<blocks, kWriteThreads, 0, st>>>(RT_K4M_ARGS);
#undef RT_K4M_ARGS
  return (int)cudaGetLastError();
}
