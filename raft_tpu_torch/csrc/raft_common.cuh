// Shared pieces of the port's Hopper kernels (sm_90a): integer helpers,
// the packed state-vector layout, and the steady step's scalar core
// (prologue, window merge with its optional in-kernel RS parity, epilogue)
// used by both the per-step kernel and the persistent pipeline kernel in
// steady.cu, in the resident layout and in the mesh-local one (LOCAL: the
// scalar core runs over all L = R rows of the gathered plane while the
// rings hold row p.my only).
//
// Index arithmetic follows the JAX package: % floors there and truncates
// in C++, so every modular expression that can go negative uses floor_mod.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "gf_packed.cuh"

// Rows a kernel supports: the conflict bits of one step travel as one
// 32-bit mask (bit l = row l).
#define RT_LMAX 32
// Bytes of the in-kernel parity table [m][k][8] with m + k <= RT_LMAX.
#define RT_EC_BYTES (16 * 16 * 8)

// Rows of the packed (6, L) state-vector block, as in core/step_pallas.py.
enum { VT = 0, VV = 1, VL = 2, VC = 3, VMI = 4, VMT = 5 };
#define RT_NO_VOTE (-1)

__host__ __device__ inline int floor_mod(int a, int m) {
  int r = a % m;
  return r < 0 ? r + m : r;
}

// Per-call constants of a steady step (the JAX kernel's params operand).
struct SteadyParams {
  int leader, lterm, tfloor, rfloor, fpt;
  int quorum;    // commit quorum when no member mask is given
  int ec_floor;  // EC durability floor clamping a member majority (0: none)
  int L, C, B, M, W;
  int Mk;        // window lanes: M, or k*W in the in-kernel parity mode
  int my;        // the ring's row in the mesh-local mode (W = M); -1 when
                 // the rings hold all L rows
};

// What a step's prologue derives; every block computes the same plan.
struct StepPlan {
  int count, ws, s, lcur;
  unsigned acc, heard;
  int meff[RT_LMAX];
  int prev_ts[RT_LMAX];
};

__device__ inline bool ackm_of(const uint8_t* alive, const uint8_t* member,
                               int l) {
  return alive[l] && (member == nullptr || member[l]);
}

__device__ inline int quorum_of(const uint8_t* member, const SteadyParams& p) {
  if (member == nullptr) return p.quorum;
  int n = 0;
  for (int l = 0; l < p.L; ++l) n += member[l] != 0;
  return max(n / 2 + 1, p.ec_floor);
}

// Frontier accounting and per-row masks (step_pallas.py _steady_kernel
// prologue). ``vec`` is the (6, L) block at the start of the step; the
// prev-term column is read from the term ring through L2 (another block
// may have written it during the previous step of a persistent flight),
// or from ``prev_col`` [L] when it is given (the mesh-local mode, whose
// ring holds one row).
__device__ inline void step_prologue(const int* vec, int cnt_in,
                                     const int* log_term,
                                     const int* prev_col,
                                     const uint8_t* alive,
                                     const uint8_t* slow,
                                     const SteadyParams& p, StepPlan& pl) {
  const int L = p.L, C = p.C;
  const int last0 = vec[VL * L + p.leader];
  const int commit0 = vec[VC * L + p.leader];
  const int term0 = vec[VT * L + p.leader];
  const bool legit = p.lterm >= 1;
  const bool lcur = legit && term0 <= p.lterm;
  const int room = C - (last0 - commit0);
  const int clipped = min(max(cnt_in, 0), p.B);
  const int count = lcur ? min(clipped, max(room, 0)) : 0;
  const int ws = last0 + 1;
  const int leader_last = last0 + count;
  const int prev_slot = floor_mod(max(ws - 1, 1) - 1, C);
  for (int l = 0; l < L; ++l)
    pl.prev_ts[l] = prev_col ? prev_col[l]
                             : __ldcg(log_term + (size_t)l * C + prev_slot);
  int prev_term = (ws - 1 < p.rfloor) ? p.fpt : pl.prev_ts[p.leader];
  if (ws == 1) prev_term = 0;
  unsigned acc = 0, heard_bits = 0;
  for (int l = 0; l < L; ++l) {
    const bool has_prev =
        (ws == 1) || (vec[VL * L + l] >= ws - 1 && pl.prev_ts[l] == prev_term);
    const bool heard = alive[l] && legit && p.lterm >= vec[VT * L + l];
    const bool ingest = (p.leader == l) && lcur;
    int m0 = (vec[VMT * L + l] == p.lterm) ? vec[VMI * L + l] : 0;
    if (ingest) m0 = leader_last;
    const bool a = (heard && !slow[l] && has_prev) || ingest;
    acc |= (unsigned)a << l;
    heard_bits |= (unsigned)heard << l;
    pl.meff[l] = m0;
  }
  pl.count = count;
  pl.ws = ws;
  pl.s = floor_mod(ws - 1, C);
  pl.lcur = lcur;
  pl.acc = acc;
  pl.heard = heard_bits;
}

// Lane v of a full-width ring row, taken from window row ``row``: the
// window lane itself or, in the in-kernel parity mode (EC), a data lane of
// the k data-lane blocks the window carries, or a parity lane computed
// from the k data words at its own word offset (step_pallas.py:93
// _encode_parity_lanes). ``ec`` is the [L-k][k][8] constant table.
template <bool EC>
__device__ __forceinline__ int window_lane(const int* row, int v,
                                           const SteadyParams& p,
                                           const uint8_t* ec) {
  if (!EC) return row[v];
  const int l = v / p.W;
  const int k = p.Mk / p.W;
  if (l < k) return row[v];
  return (int)gf_parity_word(row, l - k, k, p.W, v - l * p.W, ec);
}

// Copy the parity table into shared memory (every thread of the block
// takes part; the caller synchronises before use).
__device__ inline void load_ec_table(uint8_t* dst, const uint8_t* ec,
                                     const SteadyParams& p) {
  const int k = p.Mk / p.W;
  const int n = (p.L - k) * k * 8;
  for (int i = threadIdx.x; i < n; i += blockDim.x) dst[i] = ec[i];
}

// The window merge: window row jj lands in slot (s + jj) mod C. Payload
// lanes of accepting rows take the window (with its parity lanes encoded
// here in EC mode); the term ring takes the leader's term; the Raft §5.3
// conflict bit of row l is set where an existing entry (index <= last[l])
// carries another term. Only touched slots are read or written; the
// payload ring is never read. EC mode moves single words (V == 1).
// LOCAL (K2-4·mesh, step_pallas.py:245-250, :268-271): the rings hold row
// p.my only, written where that row accepts; no old term is read and no
// conflict bit is set — the epilogue's closed form stands in for it.
template <int V, bool EC, bool LOCAL>
__device__ inline void step_merge(int* __restrict__ buf_p, int* log_term,
                                  const int* __restrict__ win,
                                  const StepPlan& pl, const int* last,
                                  const SteadyParams& p, const uint8_t* ec,
                                  unsigned* mm, long gtid, long gstride) {
  static_assert(!EC || V == 1, "the parity mode moves single words");
  static_assert(!(EC && LOCAL), "mesh windows arrive pre-encoded");
  const int MV = p.M / V;
  const long n = (long)pl.count * MV;
  for (long e = gtid; e < n; e += gstride) {
    const int jj = (int)(e / MV);
    const int v = (int)(e - (long)jj * MV);
    const int l = LOCAL ? p.my : (v * V) / p.W;
    if (!((pl.acc >> l) & 1u)) continue;
    int d = pl.s + jj;
    if (d >= p.C) d -= p.C;
    if (V == 4) {
      reinterpret_cast<int4*>(buf_p + (size_t)d * p.M)[v] =
          reinterpret_cast<const int4*>(win + (size_t)jj * p.Mk)[v];
    } else {
      buf_p[(size_t)d * p.M + v] =
          window_lane<EC>(win + (size_t)jj * p.Mk, v, p, ec);
    }
  }
  if (LOCAL) {
    if ((pl.acc >> p.my) & 1u) {
      for (long jj = gtid; jj < pl.count; jj += gstride) {
        int d = pl.s + (int)jj;
        if (d >= p.C) d -= p.C;
        log_term[d] = p.lterm;
      }
    }
    return;
  }
  unsigned bits = 0;
  for (long jj = gtid; jj < pl.count; jj += gstride) {
    int d = pl.s + (int)jj;
    if (d >= p.C) d -= p.C;
    const int widx = pl.ws + (int)jj;
    for (int l = 0; l < p.L; ++l) {
      int* tp = log_term + (size_t)l * p.C + d;
      const int old = __ldcg(tp);
      if (widx <= last[l] && old != p.lterm) bits |= 1u << l;
      if ((pl.acc >> l) & 1u) *tp = p.lterm;
    }
  }
  if (bits) atomicOr(mm, bits);
}

// State advance + k-th-order quorum commit (step_pallas.py _steady_kernel
// epilogue), in place on ``vec``. Writes match[L] and
// scal = {commit, max_term, count, next start slot, repair_start = 0}.
// LOCAL: an accepting row's new tail is exactly the window end when the
// window is not empty (step_pallas.py:292-298; mmbits is 0 there).
template <bool LOCAL>
__device__ inline void step_epilogue(int* vec, const StepPlan& pl,
                                     unsigned mmbits, const uint8_t* alive,
                                     const uint8_t* slow,
                                     const uint8_t* member,
                                     const SteadyParams& p, int* match,
                                     int* scal) {
  const int L = p.L;
  const bool legit = p.lterm >= 1;
  const int ws = pl.ws, count = pl.count;
  const int we = ws + count - 1;
  int meffs[RT_LMAX];
  for (int l = 0; l < L; ++l) {
    const bool a = (pl.acc >> l) & 1u;
    const bool mm = (mmbits >> l) & 1u;
    const int last0 = vec[VL * L + l];
    if (LOCAL)
      vec[VL * L + l] = (a && count > 0) ? we : last0;
    else
      vec[VL * L + l] = a ? (mm ? max(we, ws - 1) : max(last0, we)) : last0;
    const int m1 = a ? max(pl.meff[l], we) : pl.meff[l];
    meffs[l] = m1;
    match[l] = ackm_of(alive, member, l) ? m1 : 0;
  }
  const int q = quorum_of(member, p);
  int cand = 0;
  for (int l = 0; l < L; ++l) {
    int cnt = 0;
    for (int j = 0; j < L; ++j) cnt += match[j] >= match[l];
    cand = max(cand, cnt >= q ? match[l] : 0);
  }
  const bool commit_ok = legit && cand >= 1 && cand >= p.tfloor;
  const int lcommit = vec[VC * L + p.leader];
  const int g = commit_ok ? max(lcommit, cand) : lcommit;
  int max_term = 0;
  for (int l = 0; l < L; ++l) {
    const bool heard = (pl.heard >> l) & 1u;
    const bool ingest = (p.leader == l) && pl.lcur;
    const int t0 = vec[VT * L + l];
    const bool adopt = heard && p.lterm > t0;
    const int t1 = heard ? max(t0, p.lterm) : t0;
    vec[VT * L + l] = t1;
    if (adopt) vec[VV * L + l] = RT_NO_VOTE;
    const int my_commit = (p.leader == l) ? g : min(g, meffs[l]);
    if ((heard && !slow[l]) || ingest)
      vec[VC * L + l] = max(vec[VC * L + l], my_commit);
    if (heard || ingest) {
      vec[VMI * L + l] = meffs[l];
      vec[VMT * L + l] = p.lterm;
    }
    max_term = max(max_term, alive[l] ? t1 : 0);
  }
  scal[0] = g;
  scal[1] = max_term;
  scal[2] = count;
  scal[3] = floor_mod(ws - 1 + count, p.C);
  scal[4] = 0;
}

#define RT_EXPORT extern "C" __attribute__((visibility("default")))

// Every library built from these sources names its CUDA errors.
RT_EXPORT const char* rt_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
