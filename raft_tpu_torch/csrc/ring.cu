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
// Bound: bytes. Per call it must read count window rows (count*M*4 B),
// read and write the count*L term slots, and write the accepted payload
// lanes; there is no arithmetic to speak of.
//
// Design: the TPU kernel walks destination blocks in grid order, rotating
// a pair of window blocks into place and carrying the conflict bits from
// one grid step to the next. CUDA blocks run in no order, so here every
// thread owns one (window row, 16-byte lane vector) pair, computes its
// destination slot (s + jj) mod C directly, and stores straight from the
// window: no rotation, no read of the payload ring, no carried state. The
// conflict bit is a plain store of 1 into mm[l] (all writers agree). The
// window scalars (s, count, ws) are read from device memory so the
// caller never syncs with the host.
#include "raft_common.cuh"

template <int V>
__global__ void write_window_both_kernel(
    int* __restrict__ buf_p, int* __restrict__ buf_t,
    const int* __restrict__ win, const int* __restrict__ win_t,
    const int* s_p, const int* count_p, const int* ws_p,
    const uint8_t* __restrict__ accept, const int* __restrict__ last_index,
    int* __restrict__ mm, int C, int M, int L, int B) {
  const int s = *s_p;
  const int ws = *ws_p;
  const int count = min(*count_p, B);
  const int W = M / L;
  const int MV = M / V;
  const long gtid = (long)blockIdx.x * blockDim.x + threadIdx.x;
  const long gstride = (long)gridDim.x * blockDim.x;
  const long n = count > 0 ? (long)count * MV : 0;
  for (long e = gtid; e < n; e += gstride) {
    const int jj = (int)(e / MV);
    const int v = (int)(e - (long)jj * MV);
    if (!accept[(v * V) / W]) continue;
    const int d = floor_mod(s + jj, C);
    if (V == 4) {
      reinterpret_cast<int4*>(buf_p + (size_t)d * M)[v] =
          reinterpret_cast<const int4*>(win + (size_t)jj * M)[v];
    } else {
      buf_p[(size_t)d * M + v] = win[(size_t)jj * M + v];
    }
  }
  for (long jj = gtid; jj < count; jj += gstride) {
    const int d = floor_mod(s + (int)jj, C);
    const int wt = win_t[jj];
    for (int l = 0; l < L; ++l) {
      int* tp = buf_t + (size_t)l * C + d;
      const int old = *tp;
      if (ws + (int)jj <= last_index[l] && old != wt) mm[l] = 1;
      if (accept[l]) *tp = wt;
    }
  }
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

// mm must hold L zeros on entry. vec4: window and ring rows are 16-byte
// aligned and W % 4 == 0, so a thread moves one int4.
RT_EXPORT int rt_write_window_both(void* buf_p, void* buf_t, const void* win,
                                   const void* win_t, const void* s,
                                   const void* count, const void* ws,
                                   const void* accept, const void* last_index,
                                   void* mm, int C, int M, int L, int B,
                                   int vec4, void* stream) {
  const int threads = 256;
  const long work = (long)B * (vec4 ? M / 4 : M);
  const int blocks = (int)max(1L, min((work + threads - 1) / threads, 8192L));
  cudaStream_t st = (cudaStream_t)stream;
  if (vec4) {
    write_window_both_kernel<4><<<blocks, threads, 0, st>>>(
        (int*)buf_p, (int*)buf_t, (const int*)win, (const int*)win_t,
        (const int*)s, (const int*)count, (const int*)ws,
        (const uint8_t*)accept, (const int*)last_index, (int*)mm, C, M, L, B);
  } else {
    write_window_both_kernel<1><<<blocks, threads, 0, st>>>(
        (int*)buf_p, (int*)buf_t, (const int*)win, (const int*)win_t,
        (const int*)s, (const int*)count, (const int*)ws,
        (const uint8_t*)accept, (const int*)last_index, (int*)mm, C, M, L, B);
  }
  return (int)cudaGetLastError();
}
