// K2, K3, K4 — the steady replication data plane, for Hopper (sm_90a).
//
// K2 replaces raft_tpu/core/step_pallas.py:404 _invoke (pallas_call :453,
//    body _steady_kernel :145): one whole steady step — frontier room and
//    backpressure, heard/accept/verified-match masks, the payload and
//    uniform-term window merge with the §5.3 check, then the state advance,
//    term adoption and the k-th-order quorum commit behind the term_floor
//    gate.
// K3 replaces step_pallas.py:1045 _run_pipeline (pallas_call :1095, body
//    _steady_pipeline_kernel :664): T steady steps in one launch.
// K4 replaces step_pallas.py:1189 _run_turnover (pallas_call :1221, body
//    _turnover_kernel :1130): the write-only all-accept flight that turns
//    the whole ring over (T*B >= C).
// K2-4·ec, the in-kernel RS parity mode of all three (step_pallas.py:93
//    _encode_parity_lanes and :109 _mul_const_packed, reached at :231-237,
//    :766-767 and :1152-1153): the windows carry only the k data-lane
//    blocks (Mk = k*W lanes) and the merge computes the m parity lane
//    blocks itself. A thread on a parity lane reads the k data words at its
//    own word offset from the WINDOW (never from the ring) and writes their
//    GF(2^8) combination (gf_packed.cuh); K4's thread, which owns a
//    destination slot, does the same for the window row it takes. The
//    [m][k][8] constant table lives in shared memory. Parity lanes are
//    single words, so this mode always runs the V = 1 instantiation.
//
// Bound: bytes. A step reads its window (count*Mk*4 B), writes the
// accepted payload lanes, and reads and writes count*L term slots; the
// scalar core is O(L^2) integer operations. K4 writes the whole payload
// and term rings once and reads the T*B window rows that survive.
//
// Design. The TPU kernels compute the prologue in grid step 0 and the
// epilogue in the last grid step, carrying masks and conflict bits through
// SMEM from step to step. CUDA blocks run in no order, so:
//  - every block recomputes the prologue (L <= 32 scalars) itself;
//  - each thread owns (window row, 16-byte lane vector) pairs and writes
//    slot (s + jj) mod C directly — the payload ring is never read;
//  - conflict bits meet in one 32-bit word through atomicOr;
//  - K2 runs its epilogue in the last block to finish (threadfence + an
//    atomic ticket that the last block resets), and derives the window
//    start slot and prev-term column from the state itself, so a scan is
//    T back-to-back launches with no host work in between;
//  - K3 is a persistent cooperative kernel (cudaLaunchCooperativeKernel,
//    grid no larger than the co-resident block count). Each block keeps
//    the (6, L) state block in shared memory and runs the same scalar
//    core; one grid-wide sync per step orders the window writes before
//    the epilogue and the next step's prev-term read. Every step runs at
//    its true start slot, so K3 computes exactly the per-step scan for
//    every input: the TPU's affine-geometry restriction does not apply.
//  - K3 first evaluates the launch-feasibility predicate of
//    step_pallas.py:889 on the device. When the flight qualifies for the
//    turnover branch, K3 publishes that decision and exits untouched; K4,
//    launched right behind it on the same stream, reads the decision and
//    either writes the flight or exits. No host read picks the branch.
//
// K2·mesh, K3·mesh, K4·mesh (LOCAL = true) replace the local=True
//    branches of the same three kernels (step_pallas.py:217, :245, :268,
//    :292, :361 in _steady_kernel; :751, :775, :816 in
//    _steady_pipeline_kernel; :1155 in _turnover_kernel), driven by
//    core/step_mesh.py: one replica row per rank. The (6, R) block is the
//    plane gathered from every rank and the scalar core runs over all R
//    rows of it, as above; the rings hold the rank's own row (payload
//    [C, W], terms [1, C], p.my the row). The merge writes that row where
//    it accepts and reads no old term; the §5.3 conflict bit and the next
//    prev-term column are closed forms (the row's tail is the window end;
//    the next prev term is lterm for accepting rows, -1 for the rest),
//    exact under the engine's steady-program invariants. The prev column
//    comes in as an operand: K2·mesh writes the next one to
//    out[L+5 : 2L+5] for the next launch of a scan, K3·mesh carries it in
//    shared memory beside the state block and decides feasibility on the
//    gathered column, so every rank takes the same branch. K4·mesh writes
//    C*W payload words and one term row. Bound: bytes, as above, with the
//    traffic of one row (a step moves count*W*4 B in and out and count
//    term words).
#include <cooperative_groups.h>

#include "raft_common.cuh"

namespace cg = cooperative_groups;

// work[] layout shared by the three kernels (int32 words, zero on entry
// to K2; K3 initialises its own words). WK_RAN3 / WK_RAN4 count the
// flights K3 and K4 actually executed (a launch that finds the other
// kernel chosen exits without work), so a caller can see which branch
// its flights took without a host read per flight.
enum {
  WK_MM = 0, WK_TICKET = 1, WK_MM3 = 2, WK_PLAN = 5, WK_S0 = 6,
  WK_RAN3 = 7, WK_RAN4 = 8, WK_N = 9
};

template <int V, bool EC, bool LOCAL>
__global__ void steady_step_kernel(int* vec, int* buf_p, int* log_term,
                                   const int* __restrict__ win,
                                   const int* cnt_ptr, int cnt_val,
                                   const uint8_t* alive, const uint8_t* slow,
                                   const uint8_t* member, SteadyParams p,
                                   int* out, unsigned* work,
                                   const uint8_t* ec, const int* prev_col) {
  __shared__ StepPlan pl;
  __shared__ int is_last;
  __shared__ uint8_t ec_sh[EC ? RT_EC_BYTES : 1];
  if (EC) load_ec_table(ec_sh, ec, p);
  if (threadIdx.x == 0) {
    const int cnt = cnt_ptr ? *cnt_ptr : cnt_val;
    step_prologue(vec, cnt, log_term, LOCAL ? prev_col : nullptr, alive,
                  slow, p, pl);
  }
  __syncthreads();
  const long gtid = (long)blockIdx.x * blockDim.x + threadIdx.x;
  const long gstride = (long)gridDim.x * blockDim.x;
  step_merge<V, EC, LOCAL>(buf_p, log_term, win, pl, vec + VL * p.L, p,
                           ec_sh, &work[WK_MM], gtid, gstride);
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    const unsigned ticket = atomicAdd(&work[WK_TICKET], 1u);
    is_last = ticket == gridDim.x - 1;
  }
  __syncthreads();
  if (is_last && threadIdx.x == 0) {
    __threadfence();
    const unsigned mm = atomicExch(&work[WK_MM], 0u);
    const int L = p.L;
    step_epilogue<LOCAL>(vec, pl, mm, alive, slow, member, p, out, out + L);
    // the next step's prev-term column: the term now at the window's last
    // slot (LOCAL: its closed form), or the unchanged column after an
    // empty window
    const int q = floor_mod(pl.s + pl.count - 1, p.C);
    for (int l = 0; l < L; ++l) {
      int nxt = pl.prev_ts[l];
      if (pl.count > 0)
        nxt = LOCAL ? (((pl.acc >> l) & 1u) ? p.lterm : -1)
                    : __ldcg(log_term + (size_t)l * p.C + q);
      out[L + 5 + l] = nxt;
    }
    atomicExch(&work[WK_TICKET], 0u);
  }
}

// step_pallas.py:889 _launch_feasibility, restricted to what the
// dispatch needs: whether the flight is feasible AND every row accepts.
// ``prev`` [L] is the gathered prev-term column of the mesh-local mode;
// null reads every row's prev term from the ring.
__device__ bool flight_all_accept(const int* vec, const int* counts, int T,
                                  const int* log_term, const int* prev,
                                  const uint8_t* alive,
                                  const uint8_t* slow, const uint8_t* member,
                                  const SteadyParams& p, int br, int* s0) {
  const int L = p.L, C = p.C;
  const int last0 = vec[VL * L + p.leader];
  const int commit0 = vec[VC * L + p.leader];
  const int term0 = vec[VT * L + p.leader];
  const bool lcur = p.lterm >= 1 && term0 <= p.lterm;
  const int ws0 = last0 + 1;
  *s0 = floor_mod(ws0 - 1, C);
  const int prev_slot = floor_mod(max(ws0 - 1, 1) - 1, C);
  int prev_term = (ws0 - 1 < p.rfloor)
      ? p.fpt
      : (prev ? prev[p.leader]
              : __ldcg(log_term + (size_t)p.leader * C + prev_slot));
  if (ws0 == 1) prev_term = 0;
  int n_acc = 0;
  bool all = true;
  for (int l = 0; l < L; ++l) {
    const bool ack = ackm_of(alive, member, l);
    const bool a =
        (alive[l] && !slow[l] && ack && p.lterm >= vec[VT * L + l] &&
         vec[VL * L + l] == last0 &&
         (ws0 == 1 ||
          (prev ? prev[l] : __ldcg(log_term + (size_t)l * C + prev_slot)) ==
              prev_term)) ||
        (l == p.leader && ack);
    n_acc += a;
    all = all && a;
  }
  bool full = true;
  for (int t = 0; t < T; ++t) full = full && counts[t] == p.B;
  const bool feasible = lcur && commit0 == last0 && (*s0 % br) == 0 &&
                        full && n_acc >= quorum_of(member, p);
  return feasible && all;
}

template <int V, bool EC, bool LOCAL>
__global__ void steady_pipeline_kernel(int* vec_g, int* buf_p, int* log_term,
                                       const int* __restrict__ wins,
                                       const int* counts, int T, int P,
                                       const uint8_t* alive,
                                       const uint8_t* slow,
                                       const uint8_t* member, SteadyParams p,
                                       int br, int turnover_ok, int* out,
                                       unsigned* work, const uint8_t* ec,
                                       const int* prev0) {
  cg::grid_group grid = cg::this_grid();
  __shared__ int vec[6 * RT_LMAX];
  __shared__ int prevc[RT_LMAX];  // LOCAL: the carried prev-term column
  __shared__ StepPlan pl;
  __shared__ int match[RT_LMAX];
  __shared__ int scal[5];
  __shared__ int turnover;
  __shared__ uint8_t ec_sh[EC ? RT_EC_BYTES : 1];
  const int L = p.L;
  if (EC) load_ec_table(ec_sh, ec, p);
  if (threadIdx.x == 0) {
    for (int i = 0; i < 6 * L; ++i) vec[i] = vec_g[i];
    if (LOCAL)
      for (int l = 0; l < L; ++l) prevc[l] = prev0[l];
    int s0 = 0;
    turnover = turnover_ok &&
               flight_all_accept(vec, counts, T, log_term,
                                 LOCAL ? prevc : nullptr, alive, slow,
                                 member, p, br, &s0);
    if (blockIdx.x == 0) {
      work[WK_MM3] = work[WK_MM3 + 1] = work[WK_MM3 + 2] = 0;
      work[WK_PLAN] = turnover;
      work[WK_S0] = s0;
    }
  }
  __syncthreads();
  grid.sync();
  if (turnover) return;  // the same decision in every block: K4 runs it
  const long gtid = (long)blockIdx.x * blockDim.x + threadIdx.x;
  const long gstride = (long)gridDim.x * blockDim.x;
  for (int t = 0; t < T; ++t) {
    if (threadIdx.x == 0)
      step_prologue(vec, counts[t], log_term, LOCAL ? prevc : nullptr, alive,
                    slow, p, pl);
    __syncthreads();
    step_merge<V, EC, LOCAL>(buf_p, log_term,
                             wins + (size_t)(t % P) * p.B * p.Mk, pl,
                             vec + VL * L, p, ec_sh, &work[WK_MM3 + t % 3],
                             gtid, gstride);
    grid.sync();
    if (threadIdx.x == 0) {
      const unsigned mm = __ldcg(&work[WK_MM3 + t % 3]);
      step_epilogue<LOCAL>(vec, pl, mm, alive, slow, member, p, match, scal);
      if (LOCAL && pl.count > 0)  // step_pallas.py:816-820
        for (int l = 0; l < L; ++l)
          prevc[l] = ((pl.acc >> l) & 1u) ? p.lterm : -1;
      // three conflict words rotate: the one cleared here was last read
      // before this step's sync and is next written after the next one
      if (blockIdx.x == 0) work[WK_MM3 + (t + 2) % 3] = 0;
    }
    __syncthreads();
  }
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    work[WK_RAN3] += 1;
    for (int i = 0; i < 6 * L; ++i) vec_g[i] = vec[i];
    for (int l = 0; l < L; ++l) out[l] = match[l];
    for (int i = 0; i < 5; ++i) out[L + i] = scal[i];
  }
}

template <int V, bool EC, bool LOCAL>
__global__ void turnover_kernel(int* vec_g, int* buf_p, int* log_term,
                                const int* __restrict__ wins, int T, int P,
                                SteadyParams p, int* out,
                                unsigned* work, const uint8_t* ec) {
  __shared__ uint8_t ec_sh[EC ? RT_EC_BYTES : 1];
  if (EC) {
    load_ec_table(ec_sh, ec, p);
    __syncthreads();
  }
  if (__ldcg(&work[WK_PLAN]) == 0) return;  // K3 ran the flight
  const int s0 = (int)__ldcg(&work[WK_S0]);
  const int C = p.C, B = p.B, M = p.M, L = p.L;
  const int MV = M / V;
  const long TB = (long)T * B;
  const long gtid = (long)blockIdx.x * blockDim.x + threadIdx.x;
  const long gstride = (long)gridDim.x * blockDim.x;
  // every slot once, from the LAST step of the flight that covers it
  for (long e = gtid; e < (long)C * MV; e += gstride) {
    const int d = (int)(e / MV);
    const int v = (int)(e - (long)d * MV);
    const long k = floor_mod(d - s0, C);
    const long pos = k + ((TB - 1 - k) / C) * C;
    const int t = (int)(pos / B);
    const int jj = (int)(pos - (long)t * B);
    const int* src = wins + ((size_t)(t % P) * B + jj) * p.Mk;
    if (V == 4) {
      reinterpret_cast<int4*>(buf_p + (size_t)d * M)[v] =
          reinterpret_cast<const int4*>(src)[v];
    } else {
      buf_p[(size_t)d * M + v] = window_lane<EC>(src, v, p, ec_sh);
    }
  }
  const long terms = (long)(LOCAL ? 1 : L) * C;  // LOCAL: one term row
  for (long e = gtid; e < terms; e += gstride) log_term[e] = p.lterm;
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    work[WK_RAN4] += 1;
    // closed-form epilogue, step by step (step_pallas.py:1161-1186)
    int we = 0;
    for (int t = 0; t < T; ++t) {
      we = vec_g[VL * L + 0] + B;
      const bool commit_ok = p.lterm >= 1 && we >= 1 && we >= p.tfloor;
      for (int l = 0; l < L; ++l) {
        const int t0 = vec_g[VT * L + l];
        if (p.lterm > t0) vec_g[VV * L + l] = RT_NO_VOTE;
        vec_g[VT * L + l] = max(t0, p.lterm);
        vec_g[VL * L + l] = we;
        vec_g[VMI * L + l] = we;
        vec_g[VMT * L + l] = p.lterm;
        if (commit_ok) vec_g[VC * L + l] = we;
      }
    }
    for (int l = 0; l < L; ++l) out[l] = vec_g[VMI * L + l];
    out[L + 0] = vec_g[VC * L + 0];
    out[L + 1] = max(vec_g[VT * L + 0], p.lterm);
    out[L + 2] = B;
    out[L + 3] = floor_mod(we, C);
    out[L + 4] = 0;
  }
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

static const int kThreads = 256;

static int blocks_for(long work) {
  return (int)max(1L, min((work + kThreads - 1) / kThreads, 8192L));
}

// K2: one steady step in place on vec (6, L), buf_p and log_term.
// out = match[L] | scal[5] | next_prev[L]. cnt_ptr (device) overrides
// cnt_val when not null. work must hold WK_N zeros on the first call;
// the kernel leaves it zeroed. ec (device u8[L-k][k][8], or null) selects
// the in-kernel parity mode, whose windows carry Mk = k*W lanes.
// my_row >= 0 selects K2·mesh: the rings hold that row only and prev
// (device i32[L]) is every row's prev term.
RT_EXPORT int rt_steady_step(void* vec, void* buf_p, void* log_term,
                             const void* win, const void* cnt_ptr,
                             int cnt_val, const void* alive, const void* slow,
                             const void* member, int leader, int lterm,
                             int tfloor, int rfloor, int fpt, int quorum,
                             int ec_floor, int L, int C, int B, int M, int Mk,
                             void* out, void* work, const void* ec, int vec4,
                             int my_row, const void* prev, void* stream) {
  const SteadyParams p = make_params(leader, lterm, tfloor, rfloor, fpt,
                                     quorum, ec_floor, L, C, B, M, Mk,
                                     my_row);
  const bool v4 = vec4 && !ec;
  const int blocks = blocks_for((long)B * (v4 ? M / 4 : M));
  cudaStream_t st = (cudaStream_t)stream;
#define RT_K2_ARGS                                                         \
  (int*)vec, (int*)buf_p, (int*)log_term, (const int*)win,                 \
      (const int*)cnt_ptr, cnt_val, (const uint8_t*)alive,                 \
      (const uint8_t*)slow, (const uint8_t*)member, p, (int*)out,          \
      (unsigned*)work, (const uint8_t*)ec, (const int*)prev
  if (ec) {
    steady_step_kernel<1, true, false><<<blocks, kThreads, 0, st>>>(
        RT_K2_ARGS);
  } else if (my_row >= 0) {
    if (v4)
      steady_step_kernel<4, false, true><<<blocks, kThreads, 0, st>>>(
          RT_K2_ARGS);
    else
      steady_step_kernel<1, false, true><<<blocks, kThreads, 0, st>>>(
          RT_K2_ARGS);
  } else if (v4) {
    steady_step_kernel<4, false, false><<<blocks, kThreads, 0, st>>>(
        RT_K2_ARGS);
  } else {
    steady_step_kernel<1, false, false><<<blocks, kThreads, 0, st>>>(
        RT_K2_ARGS);
  }
#undef RT_K2_ARGS
  return (int)cudaGetLastError();
}

// Co-resident block count of the pipeline kernel, per device (queried
// once: the occupancy calculator is not free on the tick path).
template <int V, bool EC, bool LOCAL>
static cudaError_t resident_blocks(int dev, int* resident) {
  static int cache[64] = {0};
  if (dev < 0 || dev >= 64) return cudaErrorInvalidDevice;
  if (cache[dev] == 0) {
    int sms = 0, per_sm = 0, coop = 0;
    cudaError_t e =
        cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
    if (e == cudaSuccess && !coop) return cudaErrorNotSupported;
    if (e == cudaSuccess)
      e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, steady_pipeline_kernel<V, EC, LOCAL>, kThreads, 0);
    if (e != cudaSuccess) return e;
    if (per_sm * sms < 1) return cudaErrorCooperativeLaunchTooLarge;
    cache[dev] = per_sm * sms;
  }
  *resident = cache[dev];
  return cudaSuccess;
}

template <int V, bool EC, bool LOCAL>
static int launch_pipeline(void** args, long work_items, cudaStream_t st,
                           int* grid_out) {
  auto kern = steady_pipeline_kernel<V, EC, LOCAL>;
  int dev = 0, resident = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = resident_blocks<V, EC, LOCAL>(dev, &resident);
  if (e != cudaSuccess) return (int)e;
  const int grid = min(resident, blocks_for(work_items));
  *grid_out = grid;
  e = cudaLaunchCooperativeKernel((const void*)kern, dim3(grid),
                                  dim3(kThreads), args, 0, st);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// K3 (+ K4 behind it when turnover_ok): a T-step flight over wins
// i32[P, B, Mk] (step t reads wins[t % P]) and counts i32[T] on device.
// out = match[L] | scal[5]. grid_out reports K3's grid size. ec, my_row
// and prev (the gathered column at the flight's start) as K2.
RT_EXPORT int rt_steady_pipeline(void* vec, void* buf_p, void* log_term,
                                 const void* wins, const void* counts, int T,
                                 int P, const void* alive, const void* slow,
                                 const void* member, int leader, int lterm,
                                 int tfloor, int rfloor, int fpt, int quorum,
                                 int ec_floor, int L, int C, int B, int M,
                                 int Mk, int br, int turnover_ok, void* out,
                                 void* work, const void* ec, int vec4,
                                 int my_row, const void* prev, void* stream,
                                 int* grid_out) {
  SteadyParams p = make_params(leader, lterm, tfloor, rfloor, fpt, quorum,
                               ec_floor, L, C, B, M, Mk, my_row);
  void* args[] = {&vec,   &buf_p,  &log_term, &wins, &counts,
                  &T,     &P,      &alive,    &slow, &member,
                  &p,     &br,     &turnover_ok, &out, &work, &ec, &prev};
  const bool v4 = vec4 && !ec;
  const long items = (long)B * (v4 ? M / 4 : M);
  cudaStream_t st = (cudaStream_t)stream;
  if (ec) return launch_pipeline<1, true, false>(args, items, st, grid_out);
  if (my_row >= 0)
    return v4 ? launch_pipeline<4, false, true>(args, items, st, grid_out)
              : launch_pipeline<1, false, true>(args, items, st, grid_out);
  return v4 ? launch_pipeline<4, false, false>(args, items, st, grid_out)
            : launch_pipeline<1, false, false>(args, items, st, grid_out);
}

// K4: the write-only turnover flight; exits at once unless the preceding
// K3 launch published the turnover decision in work. ec and my_row as K2.
RT_EXPORT int rt_turnover(void* vec, void* buf_p, void* log_term,
                          const void* wins, int T, int P, int lterm,
                          int tfloor, int L, int C, int B, int M, int Mk,
                          void* out, void* work, const void* ec, int vec4,
                          int my_row, void* stream) {
  const SteadyParams p =
      make_params(0, lterm, tfloor, 0, 0, 0, 0, L, C, B, M, Mk, my_row);
  const bool v4 = vec4 && !ec;
  const int blocks = blocks_for((long)C * (v4 ? M / 4 : M));
  cudaStream_t st = (cudaStream_t)stream;
#define RT_K4_ARGS                                                         \
  (int*)vec, (int*)buf_p, (int*)log_term, (const int*)wins, T, P, p,       \
      (int*)out, (unsigned*)work, (const uint8_t*)ec
  if (ec) {
    turnover_kernel<1, true, false><<<blocks, kThreads, 0, st>>>(RT_K4_ARGS);
  } else if (my_row >= 0) {
    if (v4)
      turnover_kernel<4, false, true><<<blocks, kThreads, 0, st>>>(
          RT_K4_ARGS);
    else
      turnover_kernel<1, false, true><<<blocks, kThreads, 0, st>>>(
          RT_K4_ARGS);
  } else if (v4) {
    turnover_kernel<4, false, false><<<blocks, kThreads, 0, st>>>(
        RT_K4_ARGS);
  } else {
    turnover_kernel<1, false, false><<<blocks, kThreads, 0, st>>>(
        RT_K4_ARGS);
  }
#undef RT_K4_ARGS
  return (int)cudaGetLastError();
}
