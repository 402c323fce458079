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
