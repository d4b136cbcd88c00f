// Tap-dot 3x3 convolution ("variant D" of the conv kernel lab) for Hopper
// (sm_90a), plain C entry point.
//
// Replaces the Pallas TPU kernel scripts/conv_kernel_lab.py `build_call_d`
// (body `kernel`). What it computes, unchanged: the 3x3 stride-1 'SAME' conv
// + bias + act (none / relu / leaky_relu(0.01)) in (N, C, H, W) layout,
//   out[n, co, i, j] = act(b[co] + sum over t = (dy, dx), ci of
//       w2[t * Cin + ci, co] * x[n, ci, i + dy - 1, j + dx - 1])
// with x f32 or bf16 (zero outside the image), w2 (9 * Cin, Cout) in x's
// type with rows ordered [(dy, dx)][ci], b (Cout,) f32, out f32 or bf16, f32
// accumulation. What makes it variant D: nine accumulating K = Cin products,
// each on an OFFSET VIEW of the input, and no copy of the input anywhere.
// The TPU variant asked whether the matrix unit can be fed from offset views
// of the tile resident in VMEM; on the card the question is whether the
// L1 / L2 caches can feed the products straight from device memory.
//
// What bounds it on an H100 SXM (700 W) at the lab's shapes, (8, 32, 1024,
// 256) and (8, 64, 512, 128), Cout = Cin: 38.65 GFLOP each; f32 is bound by
// operations (0.58 ms at the 67 TFLOP/s FFMA peak), bf16 by bytes at the
// first shape (268 MB, 0.080 ms) and about even at the second. As built,
// every product reads its input operand with a global load (4 loads per 32
// FMAs and thread; each input value nine times per 32 output channels). The
// expectation was that the load path would set its pace and make it the
// slowest of the three variants by far. Measured on an H100 (700 W) at the
// first shape in f32 it takes 1.90 ms, level with the first version of
// variant A (1.93 ms, same tile, input staged in shared memory) and ahead of
// variant C: L1 serves the offset re-reads about as fast as shared memory.
//
// Design.
//  * a block owns 8 rows x 32 columns x 32 output channels of one image, a
//    lane one column, a thread 4 rows x 8 output channels (as variant A);
//  * only the weights are staged: per chunk of 16 input channels the block
//    keeps the 9 x 16 x 32 weights of its output channels in shared memory
//    (one address per warp and step: broadcast reads);
//  * per tap (dy, dx) a thread walks the chunk's channels and reads x[ci,
//    i + dy - 1, j + dx - 1] for its four rows straight from device memory,
//    with the bounds masks (image edge = zero padding, ragged tile) worked
//    out once per tap. The 32 lanes of a warp read 32 consecutive elements,
//    shifted by dx - 1: for dx != 1 the run is not aligned, so the loads stay
//    scalar (no 16-byte vectors). The nine taps, the four warps that share a
//    block's pixels, and the blocks of the other output-channel tiles all
//    re-read the same lines: L1 and L2 supply that reuse;
//  * bias, activation and cast in the epilogue; stores are 32 consecutive
//    columns per warp.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kTW = 32;                   // output columns per block (one lane each)
constexpr int kRowGroups = 2;             // warps along the rows
constexpr int kCoGroups = 4;              // warps along the output channels
constexpr int kR = 4;                     // rows per thread
constexpr int kCO = 8;                    // output channels per thread
constexpr int kTH = kRowGroups * kR;      // 8 output rows per block
constexpr int kTCO = kCoGroups * kCO;     // 32 output channels per block
constexpr int kThreads = 32 * kRowGroups * kCoGroups;
constexpr int kCK = 16;                   // input channels of weights per chunk
static_assert(kCO == 8, "the weight reads are two float4");

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void store1(float* p, float v) { *p = v; }
__device__ __forceinline__ void store1(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

template <typename TIn, typename TOut>
__global__ void __launch_bounds__(kThreads, 2)
conv_tapdot_kernel(const TIn* __restrict__ x, const TIn* __restrict__ w2,
                   const float* __restrict__ bias, TOut* __restrict__ out, int cin,
                   int h, int w, int cout, int act) {
  __shared__ __align__(16) float ws[9][kCK][kTCO];  // [tap][ck][co]

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int rg = warp / kCoGroups;
  const int cg = warp % kCoGroups;
  const int n_cotiles = (cout + kTCO - 1) / kTCO;
  const int co0 = (blockIdx.x % n_cotiles) * kTCO;
  const int col = (blockIdx.x / n_cotiles) * kTW + lane;
  const int row0 = blockIdx.y * kTH + rg * kR;
  const size_t plane = (size_t)h * w;
  const TIn* xi = x + (size_t)blockIdx.z * cin * plane;

  float acc[kR][kCO];
#pragma unroll
  for (int i = 0; i < kR; ++i)
#pragma unroll
    for (int j = 0; j < kCO; ++j) acc[i][j] = 0.0f;

  for (int ci0 = 0; ci0 < cin; ci0 += kCK) {
    __syncthreads();  // the previous chunk's reads are done
    float* wflat = &ws[0][0][0];
    for (int i = tid; i < 9 * kCK * kTCO; i += kThreads) {
      const int co = i % kTCO;
      const int ck = (i / kTCO) % kCK;
      const int t = i / (kTCO * kCK);
      float v = 0.0f;
      if (ci0 + ck < cin && co0 + co < cout) {
        v = to_f32(w2[((size_t)t * cin + ci0 + ck) * cout + co0 + co]);
      }
      wflat[i] = v;
    }
    __syncthreads();

    const int nck = min(kCK, cin - ci0);
#pragma unroll 1
    for (int t = 0; t < 9; ++t) {
      const int dy = t / 3;
      const int dx = t - 3 * dy;
      const int gc = col + dx - 1;
      const bool col_ok = gc >= 0 && gc < w;
      // the offset view of this tap: one pointer and one mask per row
      const TIn* px[kR];
      bool ok[kR];
#pragma unroll
      for (int i = 0; i < kR; ++i) {
        const int gr = row0 + i + dy - 1;
        ok[i] = col_ok && gr >= 0 && gr < h;
        px[i] = xi + (size_t)ci0 * plane + (ok[i] ? (size_t)gr * w + gc : 0);
      }
      const float* wt = &ws[t][0][cg * kCO];
#pragma unroll 4
      for (int ck = 0; ck < nck; ++ck) {
        float xv[kR];
#pragma unroll
        for (int i = 0; i < kR; ++i) xv[i] = ok[i] ? to_f32(px[i][ck * plane]) : 0.0f;
        const float4 w0 = *reinterpret_cast<const float4*>(wt + ck * kTCO);
        const float4 w1 = *reinterpret_cast<const float4*>(wt + ck * kTCO + 4);
        const float wv[kCO] = {w0.x, w0.y, w0.z, w0.w, w1.x, w1.y, w1.z, w1.w};
#pragma unroll
        for (int i = 0; i < kR; ++i)
#pragma unroll
          for (int j = 0; j < kCO; ++j) acc[i][j] = fmaf(xv[i], wv[j], acc[i][j]);
      }
    }
  }

  if (col >= w) return;
#pragma unroll
  for (int j = 0; j < kCO; ++j) {
    const int co = co0 + cg * kCO + j;
    if (co >= cout) continue;
    const float bv = bias[co];
    TOut* o = out + ((size_t)blockIdx.z * cout + co) * plane + col;
#pragma unroll
    for (int i = 0; i < kR; ++i) {
      const int r = row0 + i;
      if (r >= h) continue;
      float y = acc[i][j] + bv;
      if (act == 1) y = fmaxf(y, 0.0f);
      if (act == 2) y = y >= 0.0f ? y : 0.01f * y;
      store1(o + (size_t)r * w, y);
    }
  }
}

template <typename TIn, typename TOut>
cudaError_t launch(const void* x, const void* w2, const float* bias, void* out, int n,
                   int cin, int h, int w, int cout, int act, cudaStream_t stream) {
  const int n_cotiles = (cout + kTCO - 1) / kTCO;
  const int n_wtiles = (w + kTW - 1) / kTW;
  const int n_htiles = (h + kTH - 1) / kTH;
  if (n_htiles > 65535 || n > 65535) return cudaErrorInvalidValue;
  const dim3 grid(n_wtiles * n_cotiles, n_htiles, n);
  conv_tapdot_kernel<TIn, TOut><<<grid, kThreads, 0, stream>>>(
      static_cast<const TIn*>(x), static_cast<const TIn*>(w2), bias,
      static_cast<TOut*>(out), cin, h, w, cout, act);
  return cudaGetLastError();
}

}  // namespace

// Launches on `stream`; returns cudaGetLastError() after the launch (0 when
// the launch was accepted). Does not synchronise. Pointers are device
// pointers to contiguous arrays; x and w2 share one type (in_bf16).
extern "C" int conv_tapdot(const void* x, const void* w2, const void* bias, void* out,
                           int n, int cin, int h, int w, int cout, int act,
                           int in_bf16, int out_bf16, void* stream) {
  if (n <= 0 || cin <= 0 || h <= 0 || w <= 0 || cout <= 0 || act < 0 || act > 2) {
    return (int)cudaErrorInvalidValue;
  }
  const float* b = static_cast<const float*>(bias);
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t err;
  if (in_bf16) {
    err = out_bf16
              ? launch<__nv_bfloat16, __nv_bfloat16>(x, w2, b, out, n, cin, h, w, cout, act, st)
              : launch<__nv_bfloat16, float>(x, w2, b, out, n, cin, h, w, cout, act, st);
  } else {
    err = out_bf16 ? launch<float, __nv_bfloat16>(x, w2, b, out, n, cin, h, w, cout, act, st)
                   : launch<float, float>(x, w2, b, out, n, cin, h, w, cout, act, st);
  }
  return (int)err;
}
