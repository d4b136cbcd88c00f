// Bidirectional LSTM recurrence for Hopper (sm_90a), plain C entry point.
//
// Replaces the Pallas TPU kernel vocal_remover_tpu/nn/lstm_pallas.py
// (`_run_recurrence`, body `_make_cell_kernel`). Contract, unchanged:
//   xg   (T, 2N, 4H) f32  input projections + both biases; rows [0, N) are
//                         the forward direction, rows [N, 2N) the backward
//                         direction already reversed in time
//   w_hh (2, H, 4H)  f32  recurrent weights, w_hh[0] forward, w_hh[1] backward
//   hs   (T, 2N, H)  f32  hidden state of every step; state starts at zero
// Each step: gates = xg[t] + h @ w_hh[dir] (gate order i, f, g, o);
// c = sigmoid(f) c + sigmoid(i) tanh(g); h = sigmoid(o) tanh(c).
//
// What bounds it: T serial steps, each a (2N x H) @ (H x 4H) product plus
// the gate math. A flagship launch (T = 128, 2N = 8, H = 64) does about
// 34 MFLOP and moves about 1.4 MB, against 67 TFLOP/s f32 and 3.35 TB/s
// (H100 SXM at 700 W): the roofline bound is under a microsecond, and the
// real limit is the latency of one step times T.
//
// Design: the TPU kernel's sequential grid over time blocks becomes a loop
// over t inside one block. Blocks split the rows by direction (grid.y) and
// by groups of kRows rows (grid.x); rows are independent, so blocks never
// talk to each other. w_hh[dir] is copied once into shared memory (64 KiB
// at H = 64, so it is dynamic shared memory above the 48 KB default). h, c
// and the step's gates stay in shared memory. One thread per gate column
// does the dot over H for all of the block's rows; after a barrier the
// threads update c and h per (row, unit). expf/tanhf (no fast math) keep
// the result within 2e-5 of the plain PyTorch version over 128 steps.
// Faster forms (mma.sync, the state in registers, a persistent cluster)
// are later work.

#include <cuda_runtime.h>

namespace {

constexpr int kRows = 4;  // rows of one direction handled by one block

__device__ __forceinline__ float sigmoid(float x) {
  return 1.0f / (1.0f + expf(-x));
}

__global__ void lstm_recurrence_kernel(const float* __restrict__ xg,
                                       const float* __restrict__ w_hh,
                                       float* __restrict__ hs, int t_len,
                                       int n, int hidden) {
  extern __shared__ float smem[];
  const int g4 = 4 * hidden;
  float* w = smem;                    // (H, 4H)
  float* h = w + hidden * g4;         // (kRows, H)
  float* c = h + kRows * hidden;      // (kRows, H)
  float* gates = c + kRows * hidden;  // (kRows, 4H)

  const int dir = blockIdx.y;
  const int r0 = blockIdx.x * kRows;
  const int rows = min(kRows, n - r0);
  const int j = threadIdx.x;  // gate column
  const size_t row_base = (size_t)dir * n + r0;
  const size_t two_n = 2 * (size_t)n;

  const float* wd = w_hh + (size_t)dir * hidden * g4;
  for (int i = j; i < hidden * g4; i += blockDim.x) w[i] = wd[i];
  for (int i = j; i < kRows * hidden; i += blockDim.x) {
    h[i] = 0.0f;
    c[i] = 0.0f;
  }
  __syncthreads();

  for (int t = 0; t < t_len; ++t) {
    const float* xt = xg + ((size_t)t * two_n + row_base) * g4;
    float acc[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) acc[r] = r < rows ? xt[(size_t)r * g4 + j] : 0.0f;
    // rows >= `rows` hold h == 0 for the whole run, so their sums are unused
    for (int k = 0; k < hidden; ++k) {
      const float wk = w[k * g4 + j];
#pragma unroll
      for (int r = 0; r < kRows; ++r) acc[r] = fmaf(h[r * hidden + k], wk, acc[r]);
    }
#pragma unroll
    for (int r = 0; r < kRows; ++r) gates[r * g4 + j] = acc[r];
    __syncthreads();

    float* ht = hs + ((size_t)t * two_n + row_base) * hidden;
    for (int i = j; i < rows * hidden; i += blockDim.x) {
      const int r = i / hidden;
      const int u = i - r * hidden;
      const float* g = gates + r * g4;
      const float ig = sigmoid(g[u]);
      const float fg = sigmoid(g[hidden + u]);
      const float gg = tanhf(g[2 * hidden + u]);
      const float og = sigmoid(g[3 * hidden + u]);
      const float cn = fg * c[i] + ig * gg;
      const float hn = og * tanhf(cn);
      c[i] = cn;
      h[i] = hn;
      ht[i] = hn;  // row r of this block is contiguous at ht + r * H
    }
    __syncthreads();
  }
}

}  // namespace

extern "C" size_t lstm_recurrence_smem_bytes(int hidden) {
  return sizeof(float) *
         ((size_t)hidden * 4 * hidden + 2 * kRows * hidden + kRows * 4 * hidden);
}

// Launches on `stream`; returns cudaGetLastError() after the launch (0 when
// the launch was accepted). Does not synchronise.
extern "C" int lstm_recurrence(const float* xg, const float* w_hh, float* hs,
                               int t_len, int n, int hidden, void* stream) {
  if (t_len <= 0 || n <= 0 || hidden <= 0 || 4 * hidden > 1024) {
    return (int)cudaErrorInvalidValue;
  }
  const size_t smem = lstm_recurrence_smem_bytes(hidden);
  cudaError_t err = cudaFuncSetAttribute(
      lstm_recurrence_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((n + kRows - 1) / kRows, 2);
  lstm_recurrence_kernel<<<grid, 4 * hidden, smem, (cudaStream_t)stream>>>(
      xg, w_hh, hs, t_len, n, hidden);
  return (int)cudaGetLastError();
}
