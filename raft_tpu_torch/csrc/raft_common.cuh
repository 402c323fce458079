// Shared pieces of the port's Hopper kernels (sm_90a): integer helpers,
// the packed state-vector layout, and the steady step's scalar core on one
// warp (lane l = row l: ballots for the masks, shuffles and a warp max for
// the quorum commit), which K2 (steady_step_kernel) and K3's plan
// (flight_plan_kernel) in steady.cu both run, in the resident layout and
// in the mesh-local one (p.my >= 0: the core runs over all L = R rows of
// the gathered plane while the rings hold row p.my only).
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

// Warp 0's view of a step (K2) or a flight (K3's plan): lane l holds row
// l of the (6, L) block, its masks and its prev term (the term at the slot
// before the leader's frontier); a step's prologue results.
struct LaneRow {
  int vt, vv, vl, vc, vmi, vmt, prev;
  bool al, sl, ack;
};
struct LaneStep {
  int count, ws, s, m0;
  unsigned acc, heard;
  bool lcur;
};

// Lane l loads row l of the (6, L) block and its masks (zeros past L).
// Returns whether the row is a member.
__device__ __forceinline__ bool lane_load(const int* vec,
                                          const uint8_t* alive,
                                          const uint8_t* slow,
                                          const uint8_t* member, int L,
                                          int lane, LaneRow& r) {
  bool mem = false;
  if (lane < L) {
    r.al = alive[lane];
    r.sl = slow[lane];
    mem = member == nullptr || member[lane];
    r.vt = vec[VT * L + lane];
    r.vv = vec[VV * L + lane];
    r.vl = vec[VL * L + lane];
    r.vc = vec[VC * L + lane];
    r.vmi = vec[VMI * L + lane];
    r.vmt = vec[VMT * L + lane];
  }
  r.ack = r.al && mem;
  return mem;
}

// The commit quorum: p.quorum, or with a member mask a majority of the
// members, never under the EC durability floor.
__device__ __forceinline__ int lane_quorum(bool mem, const uint8_t* member,
                                           const SteadyParams& p) {
  if (member == nullptr) return p.quorum;
  return max(__popc(__ballot_sync(0xffffffffu, mem)) / 2 + 1, p.ec_floor);
}

// A step's prologue (step_pallas.py _steady_kernel): frontier room and
// backpressure, the heard/accept masks as ballots, the verified match.
__device__ __forceinline__ void lane_prologue(const LaneRow& r, int cnt_in,
                                              const SteadyParams& p,
                                              int lane, LaneStep& st) {
  const unsigned full = 0xffffffffu;
  const bool legit = p.lterm >= 1;
  const int last0 = __shfl_sync(full, r.vl, p.leader);
  const int commit0 = __shfl_sync(full, r.vc, p.leader);
  const int term0 = __shfl_sync(full, r.vt, p.leader);
  const int lead_prev = __shfl_sync(full, r.prev, p.leader);
  st.lcur = legit && term0 <= p.lterm;
  const int room = p.C - (last0 - commit0);
  const int clipped = min(max(cnt_in, 0), p.B);
  st.count = st.lcur ? min(clipped, max(room, 0)) : 0;
  st.ws = last0 + 1;
  st.s = floor_mod(st.ws - 1, p.C);
  int prev_term = (st.ws - 1 < p.rfloor) ? p.fpt : lead_prev;
  if (st.ws == 1) prev_term = 0;
  const bool has_prev =
      st.ws == 1 || (r.vl >= st.ws - 1 && r.prev == prev_term);
  const bool heard = lane < p.L && r.al && legit && p.lterm >= r.vt;
  const bool ingest = lane == p.leader && st.lcur;
  st.m0 = (r.vmt == p.lterm) ? r.vmi : 0;
  if (ingest) st.m0 = last0 + st.count;
  st.acc = __ballot_sync(full, (heard && !r.sl && has_prev) || ingest);
  st.heard = __ballot_sync(full, heard);
}

// A step's epilogue (step_pallas.py _steady_kernel): the state advance,
// the k-th-order quorum commit as shuffles and a warp max behind the
// term_floor gate, term adoption with the vote reset. ``mm`` holds the
// §5.3 conflict bits. Returns the row's match; g (the leader's commit)
// and max_term come out uniform.
__device__ __forceinline__ int lane_epilogue(LaneRow& r, const LaneStep& st,
                                             unsigned mm, int q,
                                             const SteadyParams& p, int lane,
                                             int& g, int& max_term) {
  const unsigned full = 0xffffffffu;
  const bool row = lane < p.L;
  const bool legit = p.lterm >= 1;
  const bool a = (st.acc >> lane) & 1u;
  const int we = st.ws + st.count - 1;
  if (p.my >= 0)  // LOCAL: the tail is the window end (no conflict bit)
    r.vl = (a && st.count > 0) ? we : r.vl;
  else if (a)
    r.vl = ((mm >> lane) & 1u) ? max(we, st.ws - 1) : max(r.vl, we);
  const int m1 = a ? max(st.m0, we) : st.m0;
  const int match = r.ack ? m1 : 0;
  int n_ge = 0;
  for (int j = 0; j < p.L; ++j)
    n_ge += __shfl_sync(full, match, j) >= match;
  const int cand =
      max(0, __reduce_max_sync(full, (row && n_ge >= q) ? match : 0));
  const bool commit_ok = legit && cand >= 1 && cand >= p.tfloor;
  const int lcommit = __shfl_sync(full, r.vc, p.leader);
  g = commit_ok ? max(lcommit, cand) : lcommit;
  const bool heard = (st.heard >> lane) & 1u;
  const bool ingest = lane == p.leader && st.lcur;
  const int t1 = heard ? max(r.vt, p.lterm) : r.vt;
  if (heard && p.lterm > r.vt) r.vv = RT_NO_VOTE;
  r.vt = t1;
  const int my_commit = lane == p.leader ? g : min(g, m1);
  if ((heard && !r.sl) || ingest) r.vc = max(r.vc, my_commit);
  if (heard || ingest) {
    r.vmi = m1;
    r.vmt = p.lterm;
  }
  max_term = max(0, __reduce_max_sync(full, (row && r.al) ? t1 : 0));
  return match;
}

// Lane l stores row l of the (6, L) block.
__device__ __forceinline__ void lane_store(int* vec, const LaneRow& r, int L,
                                           int lane) {
  if (lane >= L) return;
  vec[VT * L + lane] = r.vt;
  vec[VV * L + lane] = r.vv;
  vec[VL * L + lane] = r.vl;
  vec[VC * L + lane] = r.vc;
  vec[VMI * L + lane] = r.vmi;
  vec[VMT * L + lane] = r.vmt;
}

// Copy the parity table into shared memory (every thread of the block
// takes part; the caller synchronises before use).
__device__ inline void load_ec_table(uint8_t* dst, const uint8_t* ec,
                                     const SteadyParams& p) {
  const int k = p.Mk / p.W;
  const int n = (p.L - k) * k * 8;
  for (int i = threadIdx.x; i < n; i += blockDim.x) dst[i] = ec[i];
}

// A hint that ``ptr``'s line will be read soon, into L1.
__device__ __forceinline__ void prefetch_l1(const void* ptr) {
  asm volatile("prefetch.L1 [%0];" ::"l"(ptr));
}

#define RT_EXPORT extern "C" __attribute__((visibility("default")))

// SMs of the current device, queried once a device.
static inline cudaError_t rt_sm_count(int* n) {
  static int sms[64] = {0};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess && (dev < 0 || dev >= 64)) e = cudaErrorInvalidDevice;
  if (e == cudaSuccess && sms[dev] == 0)
    e = cudaDeviceGetAttribute(&sms[dev], cudaDevAttrMultiProcessorCount,
                               dev);
  if (e == cudaSuccess) *n = sms[dev];
  return e;
}

// Every library built from these sources names its CUDA errors.
RT_EXPORT const char* rt_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
