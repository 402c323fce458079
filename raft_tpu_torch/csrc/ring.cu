// K1 — the fused ring-window write, for Hopper (sm_90a).
//
// Replaces raft_tpu/core/ring_pallas.py:145 write_window_both_tpu (the
// pallas_call at :194, body _write_both_kernel :78): an in-place masked
// write of a B-row window into the payload ring buf_p i32[C, M] and the
// term ring buf_t i32[L, C] at slots [s, s+count) mod C, with per-row
// accept expanded to that row's W payload lanes, plus the Raft §5.3
// conflict flag per row (an existing entry ws+j <= last[l] whose term
// differs from the window's) computed from the OLD term content.
//
// Bound: bytes, and below them the launch floor. A call must read count
// window rows (count*M*4 B), write the accepted payload lanes and the
// count*L term slots, and read an old term only where a row already holds
// an entry; at the north star that is under half a microsecond of HBM
// time, less than an empty launch takes. So what a call costs above the
// floor is its chain of dependent loads and the work of its busiest
// thread.
//
// Design: the TPU kernel walks destination blocks in grid order, rotating
// a pair of window blocks into place and carrying the conflict bits from
// one grid step to the next. CUDA blocks run in no order, so here a
// thread owns one lane vector (16 bytes, or a word where a row's lane
// block is not a whole number of them) of a few window rows, and stores
// straight from the window to slot (s + jj) mod C: no rotation, no read of
// the payload ring, no carried state. The chain is one load deep: a
// thread issues its window loads (the window always holds B rows), the
// first term pair's window term and last index, and the window scalars
// (read from device memory, so the caller never syncs with the host) all
// at once; a warp turns the accept bytes into a register mask with one
// ballot. Index arithmetic is 32-bit and a row's slot is s + jj, wrapped
// once. The term work is spread over the block, one thread a (row, window
// row) pair, and reads the old term only where ws + jj <= last[l]; the
// conflict bits meet in a warp OR, and each warp sets its rows' flags
// with one store. The grid is sized by SM count: two rows a thread and at
// most two blocks an SM, so a B = 1024 window spreads over the card (four
// rows a thread kept it on 52 of the 132 SMs).
#include <type_traits>

#include "raft_common.cuh"

static const int kRingThreads = 256;
// window rows a K1 thread takes per pass, their loads in flight together,
// and the blocks an SM takes at most
static const int kRingUnroll = 2;
static const int kRingBlocksPerSM = 2;

template <int V>
__global__ void __launch_bounds__(kRingThreads) write_window_both_kernel(
    int* __restrict__ buf_p, int* __restrict__ buf_t,
    const int* __restrict__ win, const int* __restrict__ win_t,
    const int* s_p, const int* count_p, const int* ws_p,
    const uint8_t* __restrict__ accept, const int* __restrict__ last_index,
    int* __restrict__ mm, int C, int M, int L, int B) {
  typedef typename std::conditional<V == 4, int4, int>::type U;
  const unsigned full = 0xffffffffu;
  const int lane = threadIdx.x & 31;
  const int W = M / L;
  const int WV = M / V;
  const int S = max(1, (int)blockDim.x / WV);
  const int so = threadIdx.x / WV;
  const int ov0 = threadIdx.x - so * WV;
  const bool mover = so < S;
  const int per = S * kRingUnroll;
  const int stride = gridDim.x * per;
  const int base0 = blockIdx.x * per;
  // every load that waits for nothing, issued together: the first pass's
  // window vectors, the first term pair's window term and last index, the
  // window scalars and the accept bytes
  U val[kRingUnroll];
  if (mover) {
#pragma unroll
    for (int u = 0; u < kRingUnroll; ++u) {
      const int jj = base0 + u * S + so;
      if (jj < B) val[u] = reinterpret_cast<const U*>(win + (size_t)jj * M)[ov0];
    }
  }
  int wt0 = 0, lst0 = 0;
  if ((int)threadIdx.x < per * L) {
    const int l = threadIdx.x / per;
    const int jj = base0 + (threadIdx.x - l * per);
    if (jj < B) {
      wt0 = win_t[jj];
      lst0 = last_index[l];
    }
  }
  const int count = min(*count_p, B);
  const int ws = *ws_p;
  const int s = floor_mod(*s_p, C);
  const unsigned acc = __ballot_sync(full, lane < L && accept[lane]);

  // the payload: accepting rows' lanes of window rows jj < count
  if (mover) {
    bool loaded = true;  // val holds (base0, ov0)
    for (int base = base0, ov = ov0; base < count;) {
      if ((acc >> ((ov * V) / W)) & 1u) {
#pragma unroll
        for (int u = 0; u < kRingUnroll; ++u) {
          const int jj = base + u * S + so;
          if (jj >= count) continue;
          if (!loaded)
            val[u] = reinterpret_cast<const U*>(win + (size_t)jj * M)[ov];
          int d = s + jj;
          if (d >= C) d -= C;
          reinterpret_cast<U*>(buf_p + (size_t)d * M)[ov] = val[u];
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

  // the terms, one thread a (row, window row) pair of the block's rows
  unsigned bits = 0;
  for (int base = base0; base < count; base += stride) {
    for (int i = threadIdx.x; i < per * L; i += blockDim.x) {
      const int l = i / per;
      const int jj = base + (i - l * per);
      if (jj >= count) continue;
      const bool first = base == base0 && i == (int)threadIdx.x;
      const int wt = first ? wt0 : win_t[jj];
      const int lst = first ? lst0 : last_index[l];
      int d = s + jj;
      if (d >= C) d -= C;
      int* tp = buf_t + (size_t)l * C + d;
      if (ws + jj <= lst && *tp != wt) bits |= 1u << l;
      if ((acc >> l) & 1u) *tp = wt;
    }
  }
  bits = __reduce_or_sync(full, bits);
  if (lane < L && ((bits >> lane) & 1u)) mm[lane] = 1;
}

// K5 — the masked ring-window write, for Hopper (sm_90a).
//
// Replaces raft_tpu/core/ring_pallas.py:208 write_window_cols_tpu (the
// pallas_call at :241, body _write_kernel :49), which the JAX group
// programs reach under jax.vmap: for every group g, window rows
// jj < min(count[g], B) and lanes where lane_sel[g, lane],
// buf[g, (s[g] + jj) mod C, lane] = win[g, jj, lane]; nothing else moves.
// buf i32[G, C, M], win i32[G, B, M], s/count i32[G], lane_sel u8[G, M].
//
// Bound: bytes — read the selected window lanes once, write them once.
//
// Design: the TPU kernel walks 128-row destination blocks in grid order
// and carries the previous window block in VMEM to rotate the misaligned
// rows into place; vmap adds a grid axis over G. Here, as in K1, one
// thread owns one (group, window row, lane vector) triple and stores
// straight to slot (s[g] + jj) mod C: no ring read, no rotation, nothing
// carried between blocks. The group axis is folded into the thread index,
// and each thread reads its group's s and count from device memory, so
// the caller never syncs with the host and one launch serves all groups.
// The lane mask is per lane: a 16-byte vector whose four lanes are all
// selected moves as one int4, a partly selected one lane by lane.
template <int V>
__global__ void write_window_cols_kernel(
    int* __restrict__ buf, const int* __restrict__ win,
    const int* __restrict__ s_p, const int* __restrict__ count_p,
    const uint8_t* __restrict__ lane_sel, int C, int M, int B, int G) {
  const unsigned MV = M / V;
  const unsigned per_group = (unsigned)B * MV;
  const unsigned n = per_group * (unsigned)G;
  const unsigned stride = gridDim.x * blockDim.x;
  for (unsigned e = blockIdx.x * blockDim.x + threadIdx.x; e < n;
       e += stride) {
    const unsigned g = e / per_group;
    const unsigned r = e - g * per_group;
    const int jj = (int)(r / MV);
    const int v = (int)(r - (unsigned)jj * MV);
    if (jj >= min(count_p[g], B)) continue;
    const uint8_t* sel = lane_sel + (size_t)g * M + (size_t)v * V;
    const int d = floor_mod(s_p[g] + jj, C);
    int* dst = buf + ((size_t)g * C + d) * M + (size_t)v * V;
    const int* src = win + ((size_t)g * B + jj) * M + (size_t)v * V;
    if (V == 4) {
      const int4 w = *reinterpret_cast<const int4*>(src);
      if (sel[0] && sel[1] && sel[2] && sel[3]) {
        *reinterpret_cast<int4*>(dst) = w;
      } else {
        if (sel[0]) dst[0] = w.x;
        if (sel[1]) dst[1] = w.y;
        if (sel[2]) dst[2] = w.z;
        if (sel[3]) dst[3] = w.w;
      }
    } else if (sel[0]) {
      dst[0] = src[0];
    }
  }
}

// G * B * (M / V) must fit in 31 bits (the wrapper checks). vec4: rows are
// 16-byte aligned and M % 4 == 0.
RT_EXPORT int rt_write_window_cols(void* buf, const void* win, const void* s,
                                   const void* count, const void* lane_sel,
                                   int C, int M, int B, int G, int vec4,
                                   void* stream) {
  const int threads = 256;
  const long work = (long)G * B * (vec4 ? M / 4 : M);
  const int blocks = (int)max(1L, min((work + threads - 1) / threads, 16384L));
  cudaStream_t st = (cudaStream_t)stream;
  if (vec4) {
    write_window_cols_kernel<4><<<blocks, threads, 0, st>>>(
        (int*)buf, (const int*)win, (const int*)s, (const int*)count,
        (const uint8_t*)lane_sel, C, M, B, G);
  } else {
    write_window_cols_kernel<1><<<blocks, threads, 0, st>>>(
        (int*)buf, (const int*)win, (const int*)s, (const int*)count,
        (const uint8_t*)lane_sel, C, M, B, G);
  }
  return (int)cudaGetLastError();
}

// mm must hold L zeros on entry; it takes 1 where a row's flag is raised.
// vec4: window and ring rows are 16-byte aligned and W % 4 == 0, so a
// thread moves int4s.
RT_EXPORT int rt_write_window_both(void* buf_p, void* buf_t, const void* win,
                                   const void* win_t, const void* s,
                                   const void* count, const void* ws,
                                   const void* accept, const void* last_index,
                                   void* mm, int C, int M, int L, int B,
                                   int vec4, void* stream) {
  if (L < 1 || L > RT_LMAX || B < 1 || C < 1 || M % L)
    return (int)cudaErrorInvalidValue;
  int sms = 0;
  const cudaError_t e = rt_sm_count(&sms);
  if (e != cudaSuccess) return (int)e;
  const int WV = vec4 ? M / 4 : M;
  const int per = max(1, kRingThreads / WV) * kRingUnroll;
  const int blocks =
      max(1, min((B + per - 1) / per, kRingBlocksPerSM * sms));
  cudaStream_t st = (cudaStream_t)stream;
#define RT_K1_ARGS                                                         \
  (int*)buf_p, (int*)buf_t, (const int*)win, (const int*)win_t,            \
      (const int*)s, (const int*)count, (const int*)ws,                    \
      (const uint8_t*)accept, (const int*)last_index, (int*)mm, C, M, L, B
  if (vec4)
    write_window_both_kernel<4><<<blocks, kRingThreads, 0, st>>>(RT_K1_ARGS);
  else
    write_window_both_kernel<1><<<blocks, kRingThreads, 0, st>>>(RT_K1_ARGS);
#undef RT_K1_ARGS
  return (int)cudaGetLastError();
}
