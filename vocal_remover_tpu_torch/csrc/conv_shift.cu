// Output-shift 3x3 convolution ("variant C" of the conv kernel lab) for
// Hopper (sm_90a), plain C entry point.
//
// Replaces the Pallas TPU kernel scripts/conv_kernel_lab.py `build_call_c`
// (body `kernel`). What it computes, unchanged: the 3x3 stride-1 'SAME' conv
// + bias + act (none / relu / leaky_relu(0.01)) in (N, C, H, W) layout,
//   out[n, co, i, j] = act(b[co] + sum over dx, dy, ci of
//       w2[(dx * 3 + dy) * Cin + ci, co] * x[n, ci, i + dy - 1, j + dx - 1])
// with x f32 or bf16 (zero outside the image), w2 (9 * Cin, Cout) in x's
// type with rows ordered [dx][dy][ci], b (Cout,) f32, out f32 or bf16, f32
// accumulation. What makes it variant C is WHERE the dx shift happens: the
// input is never read at a column offset. Every input value meets the
// weights of all three dx at its own column, which gives three partial sums
//   P_dx[j'] = sum over dy, ci of w[dx][dy][ci] * x[ci, i + dy - 1, j']
// and the alignment is done on the output side:
//   out[j] = P_0[j - 1] + P_1[j] + P_2[j + 1].
//
// What bounds it on an H100 SXM (700 W) at the lab's shapes, (8, 32, 1024,
// 256) and (8, 64, 512, 128), Cout = Cin: 38.65 GFLOP each; f32 is bound by
// operations (0.58 ms at the 67 TFLOP/s FFMA peak), bf16 by bytes at the
// first shape (268 MB, 0.080 ms) and about even at the second. The kernel
// multiplies with FFMA in both types (bf16 is widened to f32 when staged),
// so it sits far above the bf16 bound; tensor-core products and overlapped
// loads are later work.
//
// Design. On the TPU the unshifted stack of the three dy rows is multiplied
// three times on the matrix unit and the (Cout, rows, W) partials are added
// at lane offsets 0, 1, 2 in VMEM. On the card the partials live in
// registers, so the shift is a warp shuffle:
//  * a lane owns one input column j' (and the output column of the same
//    index), a thread kR rows x 8 output channels x 3 partial sums;
//  * per chunk of 4 channels a block stages its rows (with one halo row
//    above and below, zeros outside the image) in shared memory; each staged
//    value is read ONCE per thread that needs it and multiplied with the 3
//    dx x 8 channel weights of each dy it takes part in (the weights of a
//    step are one address for the warp: broadcast reads);
//  * after the K loop out[j] takes P_0 from lane j - 1 (__shfl_up_sync) and
//    P_2 from lane j + 1 (__shfl_down_sync); the two edge lanes of a warp
//    take them from the neighbouring warp through a small shared array;
//  * a block's warps lie side by side along W and span the whole image
//    width when W <= 256, so the outermost lanes are the image's edge
//    columns, whose missing neighbour is the zero padding. A wider image is
//    cut into tiles of 256 lanes that overlap by two columns: there the
//    first and last lane only feed their neighbours;
//  * the ragged ends (rows, columns, Cin, Cout) are staged as zeros or
//    masked at the store; stores are 32 consecutive columns per warp.
// Three accumulator sets per output make the thread's tile of output
// channels a third of what the registers would otherwise hold (8 here), so
// the input is staged once per 8 output channels; blocks of the same pixels
// run together (channel tile fastest in the grid) and share it in L2. With
// 96 accumulators a thread, one block of 256 threads is resident per SM.
// Measured on an H100 (700 W) at the first shape in f32: held to 128
// registers for two resident blocks, one load at a time in the staging loop,
// 2.51 ms; one resident block and all loads of a chunk in flight at once,
// 2.10 ms.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kR = 4;                // output rows per thread
constexpr int kCO = 8;               // output channels per thread and block
constexpr int kCK = 4;               // input channels staged per chunk
constexpr int kMaxTile = 256;        // lanes along W of the widest block
constexpr int kBatch = 24;           // elements a thread stages at once
static_assert(kCO == 8, "the weight reads are two float4");

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void store1(float* p, float v) { *p = v; }
__device__ __forceinline__ void store1(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// NWX warps lie along W; the other kWarps / NWX take groups of kR rows.
template <typename TIn, typename TOut, int NWX>
__global__ void __launch_bounds__(kThreads, 1)
conv_shift_kernel(const TIn* __restrict__ x, const TIn* __restrict__ w2,
                  const float* __restrict__ bias, TOut* __restrict__ out, int cin,
                  int h, int w, int cout, int act, int n_wtiles) {
  constexpr int G = kWarps / NWX;
  constexpr int TH = G * kR;
  constexpr int TW = 32 * NWX;
  constexpr int PR = TH + 2;
  __shared__ float patch[kCK][PR][TW];                 // rows r0 - 1 ...
  __shared__ __align__(16) float ws[kCK][3][3][kCO];   // [ck][dy][dx][co]
  __shared__ float edge_l[kWarps][kR][kCO];  // P_0 of each warp's lane 31
  __shared__ float edge_r[kWarps][kR][kCO];  // P_2 of each warp's lane 0

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int wx = warp % NWX;
  const int rg = warp / NWX;
  const int n_cotiles = (cout + kCO - 1) / kCO;
  const int co0 = (blockIdx.x % n_cotiles) * kCO;
  const int kx = blockIdx.x / n_cotiles;
  // overlapping tiles: lane 0 of tile kx is the last-but-one column of tile
  // kx - 1
  const int base = n_wtiles > 1 ? kx * (TW - 2) - 1 : 0;
  const int tl = wx * 32 + lane;
  const int col = base + tl;
  const int r0 = blockIdx.y * TH;
  const TIn* xi = x + (size_t)blockIdx.z * cin * h * w;

  float P[3][kR][kCO];
#pragma unroll
  for (int d = 0; d < 3; ++d)
#pragma unroll
    for (int i = 0; i < kR; ++i)
#pragma unroll
      for (int j = 0; j < kCO; ++j) P[d][i][j] = 0.0f;

  for (int ci0 = 0; ci0 < cin; ci0 += kCK) {
    __syncthreads();  // the previous chunk's reads are done
    float* pflat = &patch[0][0][0];
    // every global load of the chunk is started before the first store to
    // shared memory, so that their latencies overlap
    constexpr int kPerThread = kCK * PR * TW / kThreads;
    static_assert(kCK * PR * TW % kThreads == 0, "whole elements per thread");
    for (int u0 = 0; u0 < kPerThread; u0 += kBatch) {
      float v[kBatch];
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int i = tid + (u0 + u) * kThreads;
        const int c = i % TW;
        const int row = (i / TW) % PR;
        const int ck = i / (TW * PR);
        const int gr = r0 - 1 + row;
        const int gc = base + c;
        v[u] = 0.0f;
        if (u0 + u < kPerThread && ci0 + ck < cin && gr >= 0 && gr < h && gc >= 0 &&
            gc < w) {
          v[u] = to_f32(xi[((size_t)(ci0 + ck) * h + gr) * w + gc]);
        }
      }
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        if (u0 + u < kPerThread) pflat[tid + (u0 + u) * kThreads] = v[u];
      }
    }
    float* wflat = &ws[0][0][0][0];
    for (int i = tid; i < kCK * 9 * kCO; i += kThreads) {
      const int co = i % kCO;
      const int dx = (i / kCO) % 3;
      const int dy = (i / (kCO * 3)) % 3;
      const int ck = i / (kCO * 9);
      float v = 0.0f;
      if (ci0 + ck < cin && co0 + co < cout) {
        v = to_f32(w2[((size_t)(dx * 3 + dy) * cin + ci0 + ck) * cout + co0 + co]);
      }
      wflat[i] = v;
    }
    __syncthreads();

#pragma unroll
    for (int ck = 0; ck < kCK; ++ck) {
      float xv[kR + 2];  // this lane's column, rows rg * kR - 1 ... of the tile
#pragma unroll
      for (int i = 0; i < kR + 2; ++i) xv[i] = patch[ck][rg * kR + i][tl];
#pragma unroll
      for (int dy = 0; dy < 3; ++dy) {
#pragma unroll
        for (int dx = 0; dx < 3; ++dx) {
          const float4 w0 = *reinterpret_cast<const float4*>(&ws[ck][dy][dx][0]);
          const float4 w1 = *reinterpret_cast<const float4*>(&ws[ck][dy][dx][4]);
          const float wv[kCO] = {w0.x, w0.y, w0.z, w0.w, w1.x, w1.y, w1.z, w1.w};
#pragma unroll
          for (int i = 0; i < kR; ++i)
#pragma unroll
            for (int j = 0; j < kCO; ++j)
              P[dx][i][j] = fmaf(xv[i + dy], wv[j], P[dx][i][j]);
        }
      }
    }
  }

  // the partial sums that cross a warp's edge go through shared memory
  if (lane == 31) {
#pragma unroll
    for (int i = 0; i < kR; ++i)
#pragma unroll
      for (int j = 0; j < kCO; ++j) edge_l[warp][i][j] = P[0][i][j];
  }
  if (lane == 0) {
#pragma unroll
    for (int i = 0; i < kR; ++i)
#pragma unroll
      for (int j = 0; j < kCO; ++j) edge_r[warp][i][j] = P[2][i][j];
  }
  __syncthreads();

  const bool col_ok =
      col >= 0 && col < w && (n_wtiles == 1 || (tl >= 1 && tl <= TW - 2));
#pragma unroll
  for (int j = 0; j < kCO; ++j) {
    const int co = co0 + j;
    const float bv = co < cout ? bias[co] : 0.0f;
#pragma unroll
    for (int i = 0; i < kR; ++i) {
      // out[j] = P_0[j - 1] + P_1[j] + P_2[j + 1]; every lane takes part in
      // the shuffles
      float left = __shfl_up_sync(0xffffffffu, P[0][i][j], 1);
      float right = __shfl_down_sync(0xffffffffu, P[2][i][j], 1);
      if (lane == 0) left = wx > 0 ? edge_l[warp - 1][i][j] : 0.0f;
      if (lane == 31) right = wx < NWX - 1 ? edge_r[warp + 1][i][j] : 0.0f;
      float y = left + P[1][i][j] + right + bv;
      if (act == 1) y = fmaxf(y, 0.0f);
      if (act == 2) y = y >= 0.0f ? y : 0.01f * y;
      const int r = r0 + rg * kR + i;
      if (col_ok && co < cout && r < h) {
        store1(out + (((size_t)blockIdx.z * cout + co) * h + r) * w + col, y);
      }
    }
  }
}

template <typename TIn, typename TOut, int NWX>
cudaError_t launch_nwx(const void* x, const void* w2, const float* bias, void* out,
                       int n, int cin, int h, int w, int cout, int act,
                       cudaStream_t stream) {
  constexpr int TH = (kWarps / NWX) * kR;
  constexpr int TW = 32 * NWX;
  const int n_wtiles = w <= TW ? 1 : (w + TW - 3) / (TW - 2);
  const int n_cotiles = (cout + kCO - 1) / kCO;
  const int n_htiles = (h + TH - 1) / TH;
  if (n_htiles > 65535 || n > 65535) return cudaErrorInvalidValue;
  const dim3 grid(n_wtiles * n_cotiles, n_htiles, n);
  conv_shift_kernel<TIn, TOut, NWX><<<grid, kThreads, 0, stream>>>(
      static_cast<const TIn*>(x), static_cast<const TIn*>(w2), bias,
      static_cast<TOut*>(out), cin, h, w, cout, act, n_wtiles);
  return cudaGetLastError();
}

template <typename TIn, typename TOut>
cudaError_t launch(const void* x, const void* w2, const float* bias, void* out, int n,
                   int cin, int h, int w, int cout, int act, cudaStream_t stream) {
  if (w <= 32) return launch_nwx<TIn, TOut, 1>(x, w2, bias, out, n, cin, h, w, cout, act, stream);
  if (w <= 64) return launch_nwx<TIn, TOut, 2>(x, w2, bias, out, n, cin, h, w, cout, act, stream);
  if (w <= 128) return launch_nwx<TIn, TOut, 4>(x, w2, bias, out, n, cin, h, w, cout, act, stream);
  static_assert(32 * kWarps == kMaxTile, "the widest block spans kMaxTile columns");
  return launch_nwx<TIn, TOut, 8>(x, w2, bias, out, n, cin, h, w, cout, act, stream);
}

}  // namespace

// Launches on `stream`; returns cudaGetLastError() after the launch (0 when
// the launch was accepted). Does not synchronise. Pointers are device
// pointers to contiguous arrays; x and w2 share one type (in_bf16).
extern "C" int conv_shift(const void* x, const void* w2, const void* bias, void* out,
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
