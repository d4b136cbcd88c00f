// Bidirectional LSTM recurrence for Hopper (sm_90a), plain C entry point.
//
// Replaces the Pallas TPU kernel vocal_remover_tpu/nn/lstm_pallas.py
// (`_run_recurrence`, body `_make_cell_kernel`). Contract, unchanged:
//   xg     (T, 2N, 4H) f32  input projections + both biases; rows [0, N) are
//                           the forward direction, rows [N, 2N) the backward
//                           direction already reversed in time
//   w_cols (2, 4H, H)  f32  recurrent weights, one row per gate column:
//                           w_cols[d] = w_hh[d]^T (nn/lstm_kernel.py
//                           `relayout`; torch's own weight_hh layout)
//   hs     (T, 2N, H)  f32  hidden state of every step; state starts at zero
// Each step: gates = xg[t] + h @ w_hh[dir] (gate order i, f, g, o);
// c = sigmoid(f) c + sigmoid(i) tanh(g); h = sigmoid(o) tanh(c).
//
// What bounds it: T serial steps, each a (2N x H) @ (H x 4H) product plus
// the gate math. A flagship launch (T = 128, 2N = 8, H = 64) does about
// 34 MFLOP and moves about 1.4 MB, against 67 TFLOP/s f32 and 3.35 TB/s
// (H100 SXM at 700 W): the roofline bound is under a microsecond, and the
// real limit is the latency of one step times T.
//
// Design, H <= 128: every row is independent, so one block runs one row
// (grid 2N, direction = row / N) and the step's critical path is as short
// as one block can make it.
//  * One thread per gate column j = q*H + u (KS = 2 threads splitting the
//    dot over H when H > 64): for H <= 64 its column of w_hh lives in
//    registers for the whole run, read once from its contiguous row of
//    w_cols (beyond that 4H x H weights exceed the register file, and the
//    thread reads them from L1 every step).
//  * The four gates of a hidden unit sit in neighbouring lanes of one warp:
//    each lane applies its own gate's nonlinearity, and __shfl_sync hands
//    i, f, g, o to every lane of the group, which all update c in
//    registers (the same value in each); one lane writes h.
//  * h is double-buffered in shared memory (read buffer t & 1, write the
//    other): one __syncthreads() a step. The dot reads h as broadcast
//    float4s into four independent FMA chains.
//  * xg is prefetched kPrefetch steps ahead into a register ring, so its
//    device-memory latency is off the critical path.
//  * Numerics: f32 with precise expf, division and tanhf; tanh(g) is
//    computed as 2 sigmoid(2g) - 1 so that the four lanes of a unit run the
//    same instructions (abs error a few 1e-7, well inside the 2e-5
//    tolerance over 128 steps).
// Design, H > 128 (`lstm_recurrence_wide`; the 4H x KS threads above would
// pass the 1024 a block may have): still one block a row, 1024 threads.
//  * Each warp takes gate columns in turn, kCols at a time; its lanes split
//    the dot over H (coalesced float4 reads of the column's contiguous row
//    of w_cols, which is read from device memory every step: 4H x H x 4 B,
//    1 MiB a direction at H = 256, stays in L2), a butterfly of shuffles
//    sums it, and lane 0 adds xg, applies the gate's nonlinearity and
//    writes the gate.
//  * One barrier, then the threads stride over the H units: c = f c + i g,
//    h = o tanh(c), into hs and the state; a second barrier before the
//    next step's products read h.
//  * The state (4H gates, h, c: 6H floats) lives in shared memory when it
//    fits and in a device scratch from the wrapper otherwise, so H has no
//    bound below what device memory holds. (Shared memory is the faster
//    home: the scratch form took 2.8% longer at H = 256 on an H100, PERF.md.)
//  * What bounds it: each step streams the block's 4H x H weights from L2
//    (about 1 MiB at H = 256), so a step takes microseconds, not the
//    fraction of one of the register-resident form.
// Left for later: a persistent kernel that runs all five band nets'
// recurrences in one launch, and for H > 128 the weights split over a
// cluster of blocks (each holding its share in shared memory or
// registers) instead of streamed from L2 every step.

#include <cuda_runtime.h>

namespace {

constexpr int kPrefetch = 4;  // steps of xg in flight ahead of the step

__device__ __forceinline__ float sigmoid(float x) {
  return 1.0f / (1.0f + expf(-x));
}

// KS: threads per gate column, each with WPT = H_pad / KS weights, held in
// registers (kRegW, H <= 64) or read from L1 every step (64 < H <= 128:
// 4H x H weights would take the whole register file).
template <int KS, int WPT, bool kRegW>
__global__ void __launch_bounds__(4 * KS * KS * WPT)
lstm_recurrence_kernel(const float* __restrict__ xg,
                       const float* __restrict__ w_cols,
                       float* __restrict__ hs, int t_len, int n, int hidden) {
  constexpr int kHPad = KS * WPT;
  __shared__ __align__(16) float h_buf[2][kHPad];

  const int row = blockIdx.x;  // in [0, 2N)
  const int dir = row / n;
  const int tid = threadIdx.x;
  const int p = tid % KS;            // which part of the dot over H
  const int q = (tid / KS) % 4;      // gate: i, f, g, o
  const int u = tid / (4 * KS);      // hidden unit
  const bool live = u < hidden;
  const int col = q * hidden + u;
  const int g4 = 4 * hidden;
  const int lane = tid % 32;
  const int base = lane - lane % (4 * KS);  // lane of (u, gate i, part 0)

  // this thread's weights: w_hh[dir][k][col] for k = p*WPT .. p*WPT+WPT-1
  const float* wc = w_cols + ((size_t)dir * g4 + (live ? col : 0)) * hidden;
  float w[kRegW ? WPT : 1];
  auto weight = [&](int i) {
    const int k = p * WPT + i;
    return live && k < hidden ? __ldg(wc + k) : 0.0f;
  };
  if (kRegW) {
#pragma unroll
    for (int i = 0; i < WPT; ++i) w[i] = weight(i);
  }
  for (int i = tid; i < 2 * kHPad; i += blockDim.x) (&h_buf[0][0])[i] = 0.0f;

  const size_t xstride = (size_t)2 * n * g4;  // one time step of xg
  const float* xr = xg + (size_t)row * g4 + col;
  float xq[kPrefetch];
#pragma unroll
  for (int s = 0; s < kPrefetch; ++s) xq[s] = live && s < t_len ? xr[s * xstride] : 0.0f;
  float* hr = hs + (size_t)row * hidden + u;
  const size_t hstride = (size_t)2 * n * hidden;
  // sigmoid(k x): k = 2 for the cell gate, whose tanh is 2 sigmoid(2x) - 1
  const float scale = q == 2 ? 2.0f : 1.0f;
  float c = 0.0f;
  __syncthreads();

  for (int t0 = 0; t0 < t_len; t0 += kPrefetch) {
#pragma unroll
    for (int s = 0; s < kPrefetch; ++s) {
      const int t = t0 + s;
      if (t >= t_len) break;
      const float x_t = xq[s];
      if (live && t + kPrefetch < t_len) xq[s] = xr[(t + kPrefetch) * xstride];

      const float* h = h_buf[t & 1] + p * WPT;
      float acc[4] = {p == 0 ? x_t : 0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
      for (int i = 0; i < WPT; i += 4) {
        const float4 h4 = *reinterpret_cast<const float4*>(h + i);
        acc[0] = fmaf(h4.x, kRegW ? w[i] : weight(i), acc[0]);
        acc[1] = fmaf(h4.y, kRegW ? w[i + 1] : weight(i + 1), acc[1]);
        acc[2] = fmaf(h4.z, kRegW ? w[i + 2] : weight(i + 2), acc[2]);
        acc[3] = fmaf(h4.w, kRegW ? w[i + 3] : weight(i + 3), acc[3]);
      }
      float gate = (acc[0] + acc[1]) + (acc[2] + acc[3]);
#pragma unroll
      for (int o = 1; o < KS; o *= 2) gate += __shfl_xor_sync(0xffffffffu, gate, o);

      float a = sigmoid(scale * gate);
      if (q == 2) a = 2.0f * a - 1.0f;
      const float ig = __shfl_sync(0xffffffffu, a, base);
      const float fg = __shfl_sync(0xffffffffu, a, base + KS);
      const float gg = __shfl_sync(0xffffffffu, a, base + 2 * KS);
      const float og = __shfl_sync(0xffffffffu, a, base + 3 * KS);
      c = fg * c + ig * gg;
      const float hn = og * tanhf(c);
      if (live && q == 0 && p == 0) {
        h_buf[(t + 1) & 1][u] = hn;
        hr[t * hstride] = hn;
      }
      __syncthreads();
    }
  }
}

template <int KS, int WPT, bool kRegW>
cudaError_t launch(const float* xg, const float* w_cols, float* hs, int t_len,
                   int n, int hidden, cudaStream_t stream) {
  const int threads = (4 * KS * hidden + 31) / 32 * 32;
  lstm_recurrence_kernel<KS, WPT, kRegW><<<2 * n, threads, 0, stream>>>(
      xg, w_cols, hs, t_len, n, hidden);
  return cudaGetLastError();
}

// ------------------------------------------------------------ H > 128 --

constexpr int kNarrowMax = 128;     // the largest H of the kernel above
constexpr int kWideThreads = 1024;
constexpr int kCols = 4;            // gate columns a warp sums at once
constexpr size_t kWideSmemMax = 227 * 1024;

// Floats of state a row needs: 4H gates, h, c.
__host__ __device__ inline size_t wide_state(int hidden) { return (size_t)6 * hidden; }

__global__ void __launch_bounds__(kWideThreads)
lstm_recurrence_wide(const float* __restrict__ xg, const float* __restrict__ w_cols,
                     float* __restrict__ hs, float* __restrict__ scratch, int t_len,
                     int n, int hidden) {
  extern __shared__ __align__(16) float smem[];
  const int row = blockIdx.x;  // in [0, 2N)
  const int dir = row / n;
  const int g4 = 4 * hidden;
  // gates [0, 4H), h [4H, 5H), c [5H, 6H): shared memory, or this row's
  // share of the device scratch when they do not fit
  float* st = scratch ? scratch + (size_t)row * wide_state(hidden) : smem;
  float* gates = st;
  float* h = st + g4;
  float* c = h + hidden;
  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  constexpr int kWarps = kWideThreads / 32;
  const bool vec = hidden % 4 == 0;  // rows of w_cols are whole float4s
  const float* wd = w_cols + (size_t)dir * g4 * hidden;
  const size_t xstride = (size_t)2 * n * g4;
  const size_t hstride = (size_t)2 * n * hidden;

  for (int u = threadIdx.x; u < hidden; u += kWideThreads) h[u] = c[u] = 0.0f;
  __syncthreads();

  for (int t = 0; t < t_len; ++t) {
    const float* xr = xg + t * xstride + (size_t)row * g4;
    // 4H is a multiple of kCols: a group of columns is never ragged
    for (int j0 = warp * kCols; j0 < g4; j0 += kWarps * kCols) {
      float acc[kCols];
#pragma unroll
      for (int q = 0; q < kCols; ++q) acc[q] = 0.0f;
      if (vec) {
        for (int k = 4 * lane; k < hidden; k += 128) {
          const float4 h4 = *reinterpret_cast<const float4*>(h + k);
#pragma unroll
          for (int q = 0; q < kCols; ++q) {
            const float4 w4 = __ldg(
                reinterpret_cast<const float4*>(wd + (size_t)(j0 + q) * hidden + k));
            acc[q] = fmaf(h4.x, w4.x, acc[q]);
            acc[q] = fmaf(h4.y, w4.y, acc[q]);
            acc[q] = fmaf(h4.z, w4.z, acc[q]);
            acc[q] = fmaf(h4.w, w4.w, acc[q]);
          }
        }
      } else {
        for (int k = lane; k < hidden; k += 32) {
          const float hk = h[k];
#pragma unroll
          for (int q = 0; q < kCols; ++q) {
            acc[q] = fmaf(hk, __ldg(wd + (size_t)(j0 + q) * hidden + k), acc[q]);
          }
        }
      }
#pragma unroll
      for (int q = 0; q < kCols; ++q) {
#pragma unroll
        for (int o = 16; o > 0; o /= 2) acc[q] += __shfl_xor_sync(0xffffffffu, acc[q], o);
      }
      if (lane < kCols) {
        float v = acc[0];
#pragma unroll
        for (int q = 1; q < kCols; ++q) v = lane == q ? acc[q] : v;
        const int j = j0 + lane;
        v += xr[j];
        // gate order i, f, g, o: the cell gate g takes tanh, the others
        // sigmoid
        gates[j] = j / hidden == 2 ? tanhf(v) : sigmoid(v);
      }
    }
    __syncthreads();  // the gates are written, h is read
    for (int u = threadIdx.x; u < hidden; u += kWideThreads) {
      const float cn = gates[hidden + u] * c[u] + gates[u] * gates[2 * hidden + u];
      const float hn = gates[3 * hidden + u] * tanhf(cn);
      c[u] = cn;
      h[u] = hn;
      hs[t * hstride + (size_t)row * hidden + u] = hn;
    }
    __syncthreads();  // h is written before the next step reads it
  }
}

}  // namespace

// Floats of device scratch a launch needs (the wrapper allocates them):
// 0 unless H > 128 and a row's state does not fit in shared memory.
extern "C" long long lstm_recurrence_scratch(int n, int hidden) {
  if (hidden <= kNarrowMax || wide_state(hidden) * sizeof(float) <= kWideSmemMax) return 0;
  return 2LL * n * (long long)wide_state(hidden);
}

// Launches on `stream`; returns cudaGetLastError() after the launch (0 when
// the launch was accepted). Does not synchronise. `scratch` holds
// lstm_recurrence_scratch(n, hidden) floats (may be null when that is 0).
extern "C" int lstm_recurrence(const float* xg, const float* w_cols, float* hs,
                               float* scratch, int t_len, int n, int hidden,
                               void* stream) {
  if (t_len <= 0 || n <= 0 || hidden <= 0 || 2 * (long long)n > 0x7fffffff ||
      (lstm_recurrence_scratch(n, hidden) > 0 && scratch == nullptr)) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t st = (cudaStream_t)stream;
  if (hidden <= 32) return (int)launch<1, 32, true>(xg, w_cols, hs, t_len, n, hidden, st);
  if (hidden <= 64) return (int)launch<1, 64, true>(xg, w_cols, hs, t_len, n, hidden, st);
  if (hidden <= kNarrowMax) return (int)launch<2, 64, false>(xg, w_cols, hs, t_len, n, hidden, st);
  size_t smem = 0;
  if (lstm_recurrence_scratch(n, hidden) == 0) {
    smem = wide_state(hidden) * sizeof(float);
    const cudaError_t err = cudaFuncSetAttribute(
        lstm_recurrence_wide, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  lstm_recurrence_wide<<<2 * n, kWideThreads, smem, st>>>(
      xg, w_cols, hs, smem ? nullptr : scratch, t_len, n, hidden);
  return (int)cudaGetLastError();
}
