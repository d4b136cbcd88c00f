// Flat pixel-packed convolution for Hopper (sm_90a), plain C entry point.
//
// Replaces the Pallas TPU kernel vocal_remover_tpu/nn/conv_pack.py
// `_flat_conv_core` (body `kernel`). What it computes, unchanged: one
// BN-folded 'SAME' conv (3x3 stride 1, 3x3 stride 2, or 1x1) + bias +
// relu / leaky_relu(0.01) / none on the flat layout, f32 accumulation:
//   x    (N, H_in*WB, L)        flat input, L = P_in*Cin lanes per row
//   wst  (taps, L, S*NL)        per kernel-row tap one matrix whose S column
//                               blocks (NL = P_out*Cout wide) are the block
//                               shifts s_list = s0 .. s0+S-1 in {-1, 0, +1}
//   bias (NL,) f32
//   out  (N, H_out*WB, NL)
//   acc_s[m] = sum_t x[row_t(m)] @ wst[t][:, block s]
//   out[m]   = act(acc_0[m] + acc_+1[m+1]*[m%WB != WB-1]
//                  + acc_-1[m-1]*[m%WB != 0] + bias)
// where flat row m = a*WB + g of the output reads, for tap t, flat row
// (stride*a + roff[t])*WB + g of the input, and image rows outside
// [0, H_in) are zero: that is the zero padding along frequency, and the two
// masks are the zero padding along time. x and wst are f32 or bf16 (bf16
// values are widened to f32 in shared memory, so each product is exact and
// the sum is f32); out is f32 or bf16.
//
// What bounds it on an H100 SXM (700 W) at the flagship shapes (P*C = 128
// lanes everywhere; the largest launch, stg3_full_band_net enc2_conv2, is
// N = 4, H = 512, W = 128, 64 -> 64 channels): the USEFUL work of that conv
// is 19.3 GFLOP over 134 MB in f32. In f32 the operations bound it: 0.29 ms
// at the 67 TFLOP/s FFMA peak against 0.04 ms at 3.35 TB/s. In bf16 the
// bytes bound it, narrowly: 67 MB is 0.0201 ms against 0.0195 ms at the
// 989 TFLOP/s tensor-core peak (the stride-2 layers, which read four times
// what they write, are bound by bytes more clearly). This first kernel
// multiplies the dense wst (which is block-sparse: P_in times the useful
// work at stride 1, two thirds of that at stride 2) with FFMA in both
// types, skipping only the 32 x 64 slices of wst that are all zero (which
// brings the multiplied work down to about the useful work at the widest
// layers and leaves several times the useful work at the most packed
// ones), so it sits well above either bound; walking the non-zero blocks
// exactly, mma.sync / wgmma for bf16 and cp.async / TMA pipelining are
// later work.
//
// Design. The TPU kernel walks the row tiles of one image in sequence, with
// a double-buffered DMA ring that brings each tile (plus the rows its taps
// reach) into VMEM, keeps m + 8 accumulator rows so that the +-1 shifted
// reads stay inside an (8, 128) tile, and needs every lane dimension padded
// to 128. None of that carries over:
//  * tiles of 64 output rows x 64 output lanes go to independent blocks
//    over (row tiles, lane tiles, N); nothing is carried between blocks;
//  * instead of shifting the accumulator, a block loads its input rows with
//    a one-row halo on each side (66 rows) and the thread that owns output
//    row m accumulates block s from input row m + s: the shift costs one
//    extra shared-memory read, and the +-1 neighbours are never recomputed;
//  * the input is not padded: out-of-range rows (the 'SAME' padding, the
//    halo beyond the image, the ragged last tile) are stored to shared
//    memory as zeros, and ragged L and NL are masked the same way, so no
//    lane padding and no sublane slack exist;
//  * a block of 256 threads loops over taps and 32-deep slices of L: it
//    stages the 66 x 32 input slice (transposed, padded against bank
//    conflicts) and the S 32 x 64 weight slices in shared memory, through
//    registers so that all global loads of a slice are in flight together,
//    and each thread accumulates a 4 x 4 output tile per shift in registers
//    (48 accumulators at S = 3), then applies masks, bias and activation
//    and stores. While it stages a weight slice the block votes on whether
//    the slice holds any non-zero, and skips the products of one that does
//    not. Loads and products do not overlap inside a block; three resident
//    blocks per SM hide them from each other.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kBM = 64;        // output rows per block
constexpr int kBN = 64;        // output lanes per block
constexpr int kBK = 32;        // depth of one staged slice of L
constexpr int kTM = 4;         // rows per thread
constexpr int kTN = 4;         // lanes per thread
constexpr int kThreads = 256;  // (kBM / kTM) * (kBN / kTN)
// Blocks per SM that the register budget is held to (85 registers a
// thread). Loads and products are not overlapped inside a block, so other
// resident blocks hide the loads: measured on an H100 at the flagship
// shapes, 3 blocks beat 2 by 4-18% and 1 block is 60% slower than 2.
constexpr int kMinBlocks = 3;
constexpr int kARows = kBM + 2;        // with the one-row halo on each side
constexpr int kAStride = kARows + 1;   // odd stride: conflict-free stores
// elements of the input slice, and of one weight slice, that one thread
// stages; a thread's weight elements lie kBRows rows apart
constexpr int kALoads = (kARows * kBK + kThreads - 1) / kThreads;
constexpr int kBLoads = kBK * kBN / kThreads;
constexpr int kBRows = kThreads / kBN;
static_assert(kBK * kBN % kThreads == 0 && kThreads % kBN == 0, "weight slice");
static_assert(kThreads == (kBM / kTM) * (kBN / kTN) && kTN == 4, "thread tile");

struct Geometry {
  int h_in, h_out, wb, l_in, nl, stride, n_rt;
  int roff[3];
  int act;  // 0 none, 1 relu, 2 leaky_relu(0.01)
};

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

__device__ __forceinline__ void store4(float* p, const float (&v)[kTN]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, const float (&v)[kTN]) {
  __nv_bfloat162 lo = __floats2bfloat162_rn(v[0], v[1]);
  __nv_bfloat162 hi = __floats2bfloat162_rn(v[2], v[3]);
  uint2 packed;
  packed.x = *reinterpret_cast<unsigned int*>(&lo);
  packed.y = *reinterpret_cast<unsigned int*>(&hi);
  *reinterpret_cast<uint2*>(p) = packed;
}
__device__ __forceinline__ void store1(float* p, float v) { *p = v; }
__device__ __forceinline__ void store1(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// S0 = first block shift, NS = number of shifts: (0, 1) for a 1x1,
// (-1, 3) for 3x3 stride 1, (-1, 2) for 3x3 stride 2.
template <typename TIn, typename TOut, int S0, int NS>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
flat_conv_kernel(const TIn* __restrict__ x, const TIn* __restrict__ wst,
                 const float* __restrict__ bias, TOut* __restrict__ out,
                 Geometry g) {
  __shared__ float As[kBK][kAStride];  // [k][row]: input slice, transposed
  __shared__ __align__(16) float Bs[NS][kBK][kBN];  // [shift][k][lane]

  const int tid = threadIdx.x;
  const int tx = tid % (kBN / kTN);  // lane group
  const int ty = tid / (kBN / kTN);  // row group
  const int m0 = blockIdx.x * kBM;
  const int n0 = blockIdx.y * kBN;
  const int m_out = g.h_out * g.wb;
  const size_t wcols = (size_t)NS * g.nl;
  const TIn* xi = x + (size_t)blockIdx.z * g.h_in * g.wb * g.l_in;

  float acc[NS][kTM][kTN];
#pragma unroll
  for (int js = 0; js < NS; ++js)
#pragma unroll
    for (int i = 0; i < kTM; ++i)
#pragma unroll
      for (int j = 0; j < kTN; ++j) acc[js][i][j] = 0.0f;

  for (int t = 0; t < g.n_rt; ++t) {
    const int roff = g.roff[t];
    for (int k0 = 0; k0 < g.l_in; k0 += kBK) {
      // Both slices go through registers: every global load of the slice
      // is issued before the first store to shared memory, so the loads'
      // latencies overlap instead of adding up.
      // Input rows m0 - 1 .. m0 + kBM of tap t, lanes k0 .. k0 + kBK:
      float areg[kALoads];
#pragma unroll
      for (int u = 0; u < kALoads; ++u) {
        const int i = tid + u * kThreads;
        const int r = i / kBK;
        const int k = i - r * kBK;
        const int mp = m0 - 1 + r;
        float v = 0.0f;
        if (r < kARows && mp >= 0 && mp < m_out && k0 + k < g.l_in) {
          const int a = mp / g.wb;
          const int row = g.stride * a + roff;
          if (row >= 0 && row < g.h_in) {
            v = to_f32(xi[((size_t)row * g.wb + (mp - a * g.wb)) * g.l_in + k0 + k]);
          }
        }
        areg[u] = v;
      }
      // weight slices of tap t for this block's lanes, one per shift:
      // element u of a thread is lane c, row bk + (u % kBLoads) * kBRows of
      // shift u / kBLoads
      const int c = tid % kBN;
      const int bk = tid / kBN;
      float breg[NS * kBLoads];
#pragma unroll
      for (int u = 0; u < NS * kBLoads; ++u) {
        const int js = u / kBLoads;
        const int k = bk + (u % kBLoads) * kBRows;
        float v = 0.0f;
        if (k0 + k < g.l_in && n0 + c < g.nl) {
          v = to_f32(wst[((size_t)t * g.l_in + k0 + k) * wcols +
                         (size_t)js * g.nl + n0 + c]);
        }
        breg[u] = v;
      }
      // nonzero: bit js is set when this thread saw a non-zero of shift js
      int nonzero = 0;
#pragma unroll
      for (int u = 0; u < kALoads; ++u) {
        const int i = tid + u * kThreads;
        if (i < kARows * kBK) As[i % kBK][i / kBK] = areg[u];
      }
#pragma unroll
      for (int u = 0; u < NS * kBLoads; ++u) {
        Bs[u / kBLoads][bk + (u % kBLoads) * kBRows][c] = breg[u];
        nonzero |= (breg[u] != 0.0f) << (u / kBLoads);
      }
      // wst is block-sparse by construction (a shifted block holds one
      // source pixel, the centre block a band of three): a slice that is
      // all zero for the whole block adds nothing and is skipped. The
      // votes are also the barrier between the stores above and the reads
      // below.
      bool live[NS];
#pragma unroll
      for (int js = 0; js < NS; ++js) live[js] = __syncthreads_or(nonzero & (1 << js));

#pragma unroll 4
      for (int kk = 0; kk < kBK; ++kk) {
        // a[j] is input row (ty*kTM + j - 1) of the tile: shift s of output
        // row i reads a[i + s + 1]
        float a[kTM + 2];
#pragma unroll
        for (int j = 0; j < kTM + 2; ++j) a[j] = As[kk][ty * kTM + j];
#pragma unroll
        for (int js = 0; js < NS; ++js) {
          if (!live[js]) continue;
          const float4 b4 = *reinterpret_cast<const float4*>(&Bs[js][kk][tx * kTN]);
          const float b[kTN] = {b4.x, b4.y, b4.z, b4.w};
#pragma unroll
          for (int i = 0; i < kTM; ++i) {
            const float av = a[i + js + S0 + 1];
#pragma unroll
            for (int j = 0; j < kTN; ++j) acc[js][i][j] = fmaf(av, b[j], acc[js][i][j]);
          }
        }
      }
      __syncthreads();
    }
  }

  const int col0 = n0 + tx * kTN;
  const bool vec = (g.nl % kTN == 0) && (col0 + kTN <= g.nl);
#pragma unroll
  for (int i = 0; i < kTM; ++i) {
    const int m = m0 + ty * kTM + i;
    if (m >= m_out) continue;
    const int gpos = m % g.wb;
    float v[kTN];
#pragma unroll
    for (int j = 0; j < kTN; ++j) v[j] = 0.0f;
#pragma unroll
    for (int js = 0; js < NS; ++js) {
      const int s = S0 + js;
      const bool keep = s == 0 || (s == 1 ? gpos != g.wb - 1 : gpos != 0);
#pragma unroll
      for (int j = 0; j < kTN; ++j) v[j] += keep ? acc[js][i][j] : 0.0f;
    }
#pragma unroll
    for (int j = 0; j < kTN; ++j) {
      float y = v[j] + (col0 + j < g.nl ? bias[col0 + j] : 0.0f);
      if (g.act == 1) y = fmaxf(y, 0.0f);
      if (g.act == 2) y = y >= 0.0f ? y : 0.01f * y;
      v[j] = y;
    }
    TOut* o = out + ((size_t)blockIdx.z * m_out + m) * g.nl + col0;
    if (vec) {
      store4(o, v);
    } else {
#pragma unroll
      for (int j = 0; j < kTN; ++j)
        if (col0 + j < g.nl) store1(o + j, v[j]);
    }
  }
}

template <typename TIn, typename TOut>
cudaError_t launch(const void* x, const void* wst, const float* bias, void* out,
                   int n, const Geometry& g, int s0, int ns, cudaStream_t stream) {
  const dim3 grid((g.h_out * g.wb + kBM - 1) / kBM, (g.nl + kBN - 1) / kBN, n);
  const TIn* xi = static_cast<const TIn*>(x);
  const TIn* wi = static_cast<const TIn*>(wst);
  TOut* oi = static_cast<TOut*>(out);
  if (s0 == 0 && ns == 1) {
    flat_conv_kernel<TIn, TOut, 0, 1><<<grid, kThreads, 0, stream>>>(xi, wi, bias, oi, g);
  } else if (s0 == -1 && ns == 3) {
    flat_conv_kernel<TIn, TOut, -1, 3><<<grid, kThreads, 0, stream>>>(xi, wi, bias, oi, g);
  } else if (s0 == -1 && ns == 2) {
    flat_conv_kernel<TIn, TOut, -1, 2><<<grid, kThreads, 0, stream>>>(xi, wi, bias, oi, g);
  } else {
    return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

}  // namespace

// Launches on `stream`; returns cudaGetLastError() after the launch (0 when
// the launch was accepted). Does not synchronise. Pointers are device
// pointers to contiguous arrays; x and wst share one type (in_bf16).
extern "C" int flat_conv(const void* x, const void* wst, const void* bias,
                         void* out, int n, int h_in, int h_out, int wb, int l_in,
                         int nl, int stride, int n_rt, int roff0, int roff1,
                         int roff2, int s0, int ns, int act, int in_bf16,
                         int out_bf16, void* stream) {
  if (n <= 0 || h_in <= 0 || h_out <= 0 || wb <= 0 || l_in <= 0 || nl <= 0 ||
      n_rt < 1 || n_rt > 3 || stride < 1 || stride > 2 || act < 0 || act > 2 ||
      n > 65535 || (nl + kBN - 1) / kBN > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  const Geometry g{h_in, h_out, wb, l_in, nl, stride, n_rt,
                   {roff0, roff1, roff2}, act};
  const float* b = static_cast<const float*>(bias);
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t err;
  if (in_bf16) {
    err = out_bf16
              ? launch<__nv_bfloat16, __nv_bfloat16>(x, wst, b, out, n, g, s0, ns, st)
              : launch<__nv_bfloat16, float>(x, wst, b, out, n, g, s0, ns, st);
  } else {
    err = out_bf16 ? launch<float, __nv_bfloat16>(x, wst, b, out, n, g, s0, ns, st)
                   : launch<float, float>(x, wst, b, out, n, g, s0, ns, st);
  }
  return (int)err;
}
