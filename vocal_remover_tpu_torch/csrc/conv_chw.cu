// Channel-major fused convolution ("variant A") for Hopper (sm_90a), plain C
// entry point.
//
// Replaces the Pallas TPU kernel vocal_remover_tpu/nn/conv_pallas.py
// `_conv_call` (body `kernel`). What it computes, unchanged:
//   out[n, co, i, j] = act(b[co] + sum over taps t = (cblk, dy, dx) and ci of
//       w2[t * cin_blk + ci, co] *
//       x[n, cblk * cin_blk + ci, i + dy - pad_top, j + dx - pad_left])
// with x (N, C_total, H, W) f32 or bf16, w2 (taps * cin_blk, Cout) in x's
// type, b (Cout,) f32, out (N, Cout, H, W) f32 or bf16, f32 accumulation,
// act none / relu / leaky_relu(0.01), and x zero outside the image. The tap
// table is an argument: one channel block and kh x kw taps for stride 1;
// four phase blocks and 2x2-window taps (pad on the top / left only) for a
// 3x3 stride-2 conv on the space-to-depth tensor.
//
// What bounds it on an H100 SXM (700 W) at its tool's shapes, (N, C, H, W) =
// (8, 32, 1024, 256) and (8, 64, 512, 128), 3x3, Cout = Cin: 38.65 GFLOP
// each. In f32 the operations bound it (0.58 ms at the 67 TFLOP/s FFMA peak
// against 0.16 / 0.08 ms for 537 / 268 MB at 3.35 TB/s). In bf16 the first
// shape is bound by bytes (268 MB, 0.080 ms, against 0.039 ms at the
// 989 TFLOP/s tensor-core peak) and the second is about even. This first
// kernel multiplies with FFMA in both types (bf16 values are widened to f32
// in shared memory, so each product is exact and the sum is f32), so in bf16
// it sits far above the bound; mma.sync / wgmma and cp.async / TMA
// pipelining are later work.
//
// Design. The TPU kernel walks the row tiles of one image in sequence,
// copies nine shifted views of the resident tile into an im2col matrix in
// VMEM and runs one K = taps * Cin product on it; its input is padded by the
// wrapper and W must fill whole 128-lane groups. On the card the im2col
// matrix never exists:
//  * a block owns 16 rows x 32 columns x 32 output channels of one image;
//    blocks are independent, over (column tiles x channel tiles, row tiles,
//    N), with the channel tile fastest so that blocks that read the same
//    input patch run together and share it in L2;
//  * per chunk of 8 channels (of every channel block) the block stages the
//    input patch with its halo ((16 + reach_h) x (32 + reach_w) pixels) and
//    the chunk's weights (taps x 8 x 32) in shared memory; pixels outside
//    the image, channels beyond cin_blk and output channels beyond Cout are
//    stored as zeros, so x is never padded and any H, W, Cin, Cout go;
//  * the K loop walks (tap, channel) by indexing the staged patch at the
//    tap's (dy, dx): a lane owns one output column, so the 32 lanes of a
//    warp read 32 consecutive words whatever dx is (no bank conflict), and
//    the weights of a step are one address for the whole warp (broadcast);
//  * a thread accumulates 4 rows x 16 output channels in registers (4 input
//    reads + 4 vector weight reads per 64 FMAs), then adds the bias, applies
//    the activation, casts, and stores 32 consecutive columns per warp.
// Loads and products do not overlap inside a block; the two resident blocks
// of an SM hide them from each other. Measured on an H100 (700 W) at the
// first shape in f32: 8 rows x 32 channels a block with 4 x 8 a thread and
// one load at a time in the staging loop, 1.93 ms; this tile with the
// batched staging, 1.42 ms.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kTW = 32;                   // output columns per block (one lane each)
constexpr int kRowGroups = 4;             // warps along the rows
constexpr int kCoGroups = 2;              // warps along the output channels
constexpr int kR = 4;                     // rows per thread
constexpr int kCO = 16;                   // output channels per thread
constexpr int kTH = kRowGroups * kR;      // 16 output rows per block
constexpr int kTCO = kCoGroups * kCO;     // 32 output channels per block
constexpr int kThreads = 32 * kRowGroups * kCoGroups;
constexpr int kCK = 8;                    // channels of each block staged per chunk
constexpr int kMaxTaps = 32;
constexpr int kMaxSmem = 227 * 1024;
static_assert(kCO % 4 == 0, "the weight reads are float4");

struct Params {
  int n, c_total, h, w, cout, cin_blk, n_cblk, n_taps;
  int reach_h, reach_w, pad_top, pad_left, act;
  int tap_cblk[kMaxTaps], tap_dy[kMaxTaps], tap_dx[kMaxTaps];
};

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void store1(float* p, float v) { *p = v; }
__device__ __forceinline__ void store1(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

template <typename TIn, typename TOut>
__global__ void __launch_bounds__(kThreads, 2)
conv_chw_kernel(const TIn* __restrict__ x, const TIn* __restrict__ w2,
                const float* __restrict__ bias, TOut* __restrict__ out,
                const Params p) {
  // Elements a thread stages per batch. On an H100 at the tool's shapes
  // batches of 12 made the f32 kernel faster and the bf16 kernel slower than
  // the plain loop, so bf16 keeps the plain loop.
  constexpr int kBatch = sizeof(TIn) == 4 ? 12 : 1;
  extern __shared__ __align__(16) float smem[];
  const int prows = kTH + p.reach_h;
  const int pcols = kTW + p.reach_w;
  const int plane = prows * pcols;             // one staged channel
  const int n_ws = p.n_taps * kCK * kTCO;
  const int n_patch = p.n_cblk * kCK * plane;
  float* ws = smem;                            // [tap][ck][co]
  float* patch = smem + n_ws;                  // [cblk][ck][row][col]
  int* tap_off = reinterpret_cast<int*>(patch + n_patch);

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int rg = warp / kCoGroups;
  const int cg = warp % kCoGroups;
  const int n_cotiles = (p.cout + kTCO - 1) / kTCO;
  const int co0 = (blockIdx.x % n_cotiles) * kTCO;
  const int c0 = (blockIdx.x / n_cotiles) * kTW;
  const int r0 = blockIdx.y * kTH;
  const TIn* xi = x + (size_t)blockIdx.z * p.c_total * p.h * p.w;

  if (tid < p.n_taps) {
    tap_off[tid] = p.tap_cblk[tid] * kCK * plane + p.tap_dy[tid] * pcols + p.tap_dx[tid];
  }

  float acc[kR][kCO];
#pragma unroll
  for (int i = 0; i < kR; ++i)
#pragma unroll
    for (int j = 0; j < kCO; ++j) acc[i][j] = 0.0f;

  for (int ci0 = 0; ci0 < p.cin_blk; ci0 += kCK) {
    __syncthreads();  // the previous chunk's reads are done
    // the input patch: rows r0 - pad_top ..., columns c0 - pad_left ...
    // in batches of kBatch: every global load of a batch is started before
    // the first store to shared memory, so that their latencies overlap
    for (int i0 = tid; i0 < n_patch; i0 += kThreads * kBatch) {
      float v[kBatch];
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int i = i0 + u * kThreads;
        const int col = i % pcols;
        const int row = (i / pcols) % prows;
        const int ch = i / plane;  // cblk * kCK + ck
        const int ck = ch % kCK;
        const int gr = r0 + row - p.pad_top;
        const int gc = c0 + col - p.pad_left;
        v[u] = 0.0f;
        if (i < n_patch && ci0 + ck < p.cin_blk && gr >= 0 && gr < p.h && gc >= 0 &&
            gc < p.w) {
          v[u] = to_f32(
              xi[((size_t)((ch / kCK) * p.cin_blk + ci0 + ck) * p.h + gr) * p.w + gc]);
        }
      }
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int i = i0 + u * kThreads;
        if (i < n_patch) patch[i] = v[u];
      }
    }
    // the chunk's weights for this block's output channels
    for (int i0 = tid; i0 < n_ws; i0 += kThreads * kBatch) {
      float v[kBatch];
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int i = i0 + u * kThreads;
        const int co = i % kTCO;
        const int ck = (i / kTCO) % kCK;
        const int t = i / (kTCO * kCK);
        v[u] = 0.0f;
        if (i < n_ws && ci0 + ck < p.cin_blk && co0 + co < p.cout) {
          v[u] = to_f32(w2[(size_t)(t * p.cin_blk + ci0 + ck) * p.cout + co0 + co]);
        }
      }
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int i = i0 + u * kThreads;
        if (i < n_ws) ws[i] = v[u];
      }
    }
    __syncthreads();

    for (int t = 0; t < p.n_taps; ++t) {
      const float* pt = patch + tap_off[t] + rg * kR * pcols + lane;
      const float* wt = ws + t * kCK * kTCO + cg * kCO;
#pragma unroll
      for (int ck = 0; ck < kCK; ++ck) {
        float xv[kR];
#pragma unroll
        for (int i = 0; i < kR; ++i) xv[i] = pt[ck * plane + i * pcols];
        float wv[kCO];
#pragma unroll
        for (int j = 0; j < kCO; j += 4) {
          const float4 w4 = *reinterpret_cast<const float4*>(wt + ck * kTCO + j);
          wv[j] = w4.x; wv[j + 1] = w4.y; wv[j + 2] = w4.z; wv[j + 3] = w4.w;
        }
#pragma unroll
        for (int i = 0; i < kR; ++i)
#pragma unroll
          for (int j = 0; j < kCO; ++j) acc[i][j] = fmaf(xv[i], wv[j], acc[i][j]);
      }
    }
  }

  const int col = c0 + lane;
  if (col >= p.w) return;
#pragma unroll
  for (int j = 0; j < kCO; ++j) {
    const int co = co0 + cg * kCO + j;
    if (co >= p.cout) continue;
    const float bv = bias[co];
    TOut* o = out + ((size_t)blockIdx.z * p.cout + co) * p.h * p.w + col;
#pragma unroll
    for (int i = 0; i < kR; ++i) {
      const int r = r0 + rg * kR + i;
      if (r >= p.h) continue;
      float y = acc[i][j] + bv;
      if (p.act == 1) y = fmaxf(y, 0.0f);
      if (p.act == 2) y = y >= 0.0f ? y : 0.01f * y;
      store1(o + (size_t)r * p.w, y);
    }
  }
}

template <typename TIn, typename TOut>
cudaError_t launch(const void* x, const void* w2, const float* bias, void* out,
                   const Params& p, cudaStream_t stream) {
  const int n_cotiles = (p.cout + kTCO - 1) / kTCO;
  const int n_wtiles = (p.w + kTW - 1) / kTW;
  const int n_htiles = (p.h + kTH - 1) / kTH;
  if (n_htiles > 65535 || p.n > 65535) return cudaErrorInvalidValue;
  const size_t floats = (size_t)p.n_taps * kCK * kTCO +
                        (size_t)p.n_cblk * kCK * (kTH + p.reach_h) * (kTW + p.reach_w);
  const size_t bytes = floats * sizeof(float) + p.n_taps * sizeof(int);
  if (bytes > (size_t)kMaxSmem) return cudaErrorInvalidValue;
  auto kernel = conv_chw_kernel<TIn, TOut>;
  if (bytes > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (err != cudaSuccess) return err;
  }
  const dim3 grid(n_wtiles * n_cotiles, n_htiles, p.n);
  kernel<<<grid, kThreads, bytes, stream>>>(static_cast<const TIn*>(x),
                                            static_cast<const TIn*>(w2), bias,
                                            static_cast<TOut*>(out), p);
  return cudaGetLastError();
}

}  // namespace

// Launches on `stream`; returns cudaGetLastError() after the launch (0 when
// the launch was accepted). Does not synchronise. x, w2, bias and out are
// device pointers to contiguous arrays; x and w2 share one type (in_bf16).
// `taps` is a HOST array of n_taps triples (cblk, dy, dx).
extern "C" int conv_chw(const void* x, const void* w2, const void* bias, void* out,
                        int n, int c_total, int h, int w, int cout, int cin_blk,
                        int n_taps, const int* taps, int reach_h, int reach_w,
                        int pad_top, int pad_left, int act, int in_bf16,
                        int out_bf16, void* stream) {
  if (n <= 0 || c_total <= 0 || h <= 0 || w <= 0 || cout <= 0 || cin_blk <= 0 ||
      c_total % cin_blk != 0 || n_taps < 1 || n_taps > kMaxTaps || reach_h < 0 ||
      reach_w < 0 || pad_top < 0 || pad_top > reach_h || pad_left < 0 ||
      pad_left > reach_w || act < 0 || act > 2) {
    return (int)cudaErrorInvalidValue;
  }
  Params p;
  p.n = n; p.c_total = c_total; p.h = h; p.w = w; p.cout = cout;
  p.cin_blk = cin_blk; p.n_cblk = c_total / cin_blk; p.n_taps = n_taps;
  p.reach_h = reach_h; p.reach_w = reach_w; p.pad_top = pad_top;
  p.pad_left = pad_left; p.act = act;
  for (int t = 0; t < kMaxTaps; ++t) {
    const bool live = t < n_taps;
    p.tap_cblk[t] = live ? taps[3 * t] : 0;
    p.tap_dy[t] = live ? taps[3 * t + 1] : 0;
    p.tap_dx[t] = live ? taps[3 * t + 2] : 0;
    if (live && (p.tap_cblk[t] < 0 || p.tap_cblk[t] >= p.n_cblk || p.tap_dy[t] < 0 ||
                 p.tap_dy[t] > reach_h || p.tap_dx[t] < 0 || p.tap_dx[t] > reach_w)) {
      return (int)cudaErrorInvalidValue;
    }
  }
  const float* b = static_cast<const float*>(bias);
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t err;
  if (in_bf16) {
    err = out_bf16 ? launch<__nv_bfloat16, __nv_bfloat16>(x, w2, b, out, p, st)
                   : launch<__nv_bfloat16, float>(x, w2, b, out, p, st);
  } else {
    err = out_bf16 ? launch<float, __nv_bfloat16>(x, w2, b, out, p, st)
                   : launch<float, float>(x, w2, b, out, p, st);
  }
  return (int)err;
}
