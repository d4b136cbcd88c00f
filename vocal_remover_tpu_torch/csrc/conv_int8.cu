// int8 x int8 -> int32 convolution for int8 serving, Hopper (sm_90a), plain
// C entry point.
//
// Replaces no TPU kernel. The JAX package's int8 conv
// (vocal_remover_tpu/nn/functional.py `conv2d_int8`) is XLA's
// `lax.conv_general_dilated` of int8 operands with an int32 result; PyTorch
// has no such convolution on CUDA (`conv2d` of int8 tensors returns int8,
// and cuDNN's int8 path is not exposed), so the port writes it. What it
// computes, for NCHW x (f32 or bf16), the int8 kernel prepacked as
// wq (Cout, kh*kw*Cp) (tap major, Cin zero-padded to Cp, a multiple of 16)
// and the f32 per-output-channel scales ws (Cout,):
//   a   = a_scale (static, f32), or max(amax(|x|) / 127, 1e-30) (dynamic)
//   xq  = int8(clamp(rint(float(x) / a), -127, 127))       IEEE division
//   acc = sum over taps and channels of xq * wq             int32, exact
//   out = float(acc) * (a * ws[co])                          product first
// written NCHW in f32 or bf16 (round to nearest even). Any kernel size,
// stride, padding and dilation, each an (h, w) pair. The sums are integers,
// so their order does not matter: the result equals the plain version's
// (nn/conv_int8_kernel.py) bit for bit, which the build keeps by compiling
// without --use_fast_math (IEEE division, no reciprocal).
//
// What bounds it on an H100 SXM (700 W): at the flagship's largest conv
// (stg3_full_band_net dec1, N = 4, 97 -> 32 channels, 1024 x 256, 3x3) the
// useful work is 2 * 1M * 32 * 873 = 58.6 G int8 operations, 0.030 ms at
// the 1,979 TOP/s int8 tensor-core peak, and the bf16 input (203 MB) and
// output (67 MB) once, 0.081 ms at 3.35 TB/s: the bytes bound it, as they
// bound the chunk's 97 convs together (0.637 ms against 0.274 ms of
// operations). Hence the simple design; fusing the quantize into the
// conv's load (one pass over x fewer), wgmma and TMA are later work.
//
// Design: three passes on the caller's stream.
//  1. amax (dynamic scale only): a grid-stride max of |x| per block in
//     16-byte loads, merged with atomicMax on the float's bits (|x| >= 0
//     orders as unsigned).
//  2. quantize: a block takes 32 pixels of an image through a shared-memory
//     tile, reading NCHW x coalesced along W and writing the pixels' rows of
//     NHWC int8 (Cp bytes each, channels past Cin as 0) coalesced.
//  3. conv, an implicit GEMM: M = N*Ho*Wo output pixels, N = Cout, K =
//     kh*kw*Cp. A block owns 128 pixels x 32 output channels (4 warps, each
//     32 x 32: 2 x 4 mma.sync.m16n8k32 s8.s8.s32 tiles). K runs in 64-byte
//     steps through a ring of 3 shared-memory stages filled by cp.async
//     16-byte copies (each a 16-channel chunk of one tap of one pixel); a
//     pixel outside the image, a chunk past K or a channel past Cout is
//     zero-filled by cp.async's src-size operand, which is the zero padding
//     (int8 0 is exact). Rows are 80 bytes apart in shared memory, so the
//     32-bit fragment reads of a warp hit 32 different banks. The epilogue
//     scales in f32 into a shared-memory tile, from which a thread a pixel
//     writes the block's channels, so a warp stores 32 neighbouring pixels
//     of an NCHW row at a time.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kChannelPad = 16;  // Cp is a multiple of this (CHANNEL_PAD)
constexpr int kBM = 128;         // output pixels a block
constexpr int kBN = 32;          // output channels a block
constexpr int kStep = 64;        // K bytes a pipeline step (two k32 mmas)
constexpr int kPitch = 80;       // shared-memory row pitch, bytes
constexpr int kStages = 3;
constexpr int kThreads = 128;
constexpr int kChunks = kStep / 16;  // 16-byte copies a row and step

struct Geometry {
  int n, cin, h, w, cp, cout, ho, wo;
  int kh, kw, sh, sw, ph, pw, dh, dw;
  int k_chunks;  // kh * kw * Cp / 16
};

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

// The activation scale: the static one, or max(amax / 127, 1e-30).
__device__ __forceinline__ float act_scale(const float* a_scale, const unsigned* amax) {
  if (a_scale != nullptr) return *a_scale;
  return fmaxf(__fdiv_rn(__uint_as_float(*amax), 127.0f), 1e-30f);
}

// 16 bytes of x as floats: 8 bf16 or 4 f32
__device__ __forceinline__ float max_abs16(const __nv_bfloat16* p, float m) {
  const uint4 v = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&v);
#pragma unroll
  for (int i = 0; i < 8; ++i) m = fmaxf(m, fabsf(__bfloat162float(e[i])));
  return m;
}
__device__ __forceinline__ float max_abs16(const float* p, float m) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  return fmaxf(fmaxf(m, fmaxf(fabsf(v.x), fabsf(v.y))), fmaxf(fabsf(v.z), fabsf(v.w)));
}

// n / (16 / sizeof(T)) whole 16-byte groups from a 16-byte aligned x, then
// the rest one by one.
template <typename T>
__global__ void __launch_bounds__(256) amax_kernel(const T* __restrict__ x, long long n,
                                                   int vec, unsigned* __restrict__ amax) {
  constexpr int kV = 16 / sizeof(T);
  const long long stride = (long long)gridDim.x * blockDim.x;
  const long long first = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  const long long n_vec = vec ? n / kV : 0;
  float m = 0.0f;
  for (long long i = first; i < n_vec; i += stride) m = max_abs16(x + i * kV, m);
  for (long long i = n_vec * kV + first; i < n; i += stride) m = fmaxf(m, fabsf(to_float(x[i])));
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
  __shared__ float warp_max[8];
  if ((threadIdx.x & 31) == 0) warp_max[threadIdx.x >> 5] = m;
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int i = 1; i < (int)(blockDim.x >> 5); ++i) m = fmaxf(m, warp_max[i]);
    atomicMax(amax, __float_as_uint(m));
  }
}

// A block quantizes 32 pixels of one image, kQGroup channels at a time,
// through shared memory: the reads (a lane a pixel) are coalesced along W,
// the writes (consecutive lanes, consecutive words of a pixel's row) along
// the NHWC rows; the tile's pitch of an odd number of words keeps both
// sides free of bank conflicts.
constexpr int kQPix = 32;
constexpr int kQGroup = 256;                // channels a pass, a multiple of 16
constexpr int kQPitch = kQGroup / 4 + 1;    // 32-bit words a tile row

template <typename T>
__global__ void __launch_bounds__(256) quantize_kernel(const T* __restrict__ x,
                                                       const float* a_scale,
                                                       const unsigned* amax,
                                                       int8_t* __restrict__ xq, Geometry g) {
  __shared__ uint32_t tile[kQPix * kQPitch];
  const long long hw = (long long)g.h * g.w;
  const long long pix0 = blockIdx.x * (long long)kQPix;
  const int n_pix = (int)(hw - pix0 < kQPix ? hw - pix0 : kQPix);
  const T* xb = x + (long long)blockIdx.y * g.cin * hw + pix0;
  int8_t* ob = xq + ((long long)blockIdx.y * hw + pix0) * g.cp;
  const float s = act_scale(a_scale, amax);
  const int t = threadIdx.x, p = t & 31;
  for (int c0 = 0; c0 < g.cp; c0 += kQGroup) {
    const int words = (g.cp - c0 < kQGroup ? g.cp - c0 : kQGroup) / 4;
    for (int wd = t >> 5; wd < words; wd += 8) {
      uint32_t packed = 0;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = c0 + wd * 4 + e;
        if (p < n_pix && c < g.cin) {
          const float v = to_float(xb[c * hw + p]);
          const int q = (int)fminf(fmaxf(rintf(__fdiv_rn(v, s)), -127.0f), 127.0f);
          packed |= (uint32_t)(q & 0xff) << (8 * e);
        }
      }
      tile[p * kQPitch + wd] = packed;
    }
    __syncthreads();
    for (int i = t; i < n_pix * words; i += blockDim.x) {
      const int pp = i / words, wd = i - pp * words;
      *reinterpret_cast<uint32_t*>(ob + (long long)pp * g.cp + c0 + wd * 4) =
          tile[pp * kQPitch + wd];
    }
    __syncthreads();
  }
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(ok ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void mma_s8(int (&d)[4], const unsigned (&a)[4], unsigned b0,
                                       unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

template <typename TO>
__global__ void __launch_bounds__(kThreads) conv_int8_mma(
    const int8_t* __restrict__ xq, const int8_t* __restrict__ wq, const float* __restrict__ ws,
    const float* a_scale, const unsigned* amax, TO* __restrict__ out, Geometry g) {
  __shared__ __align__(16) int8_t sa[kStages][kBM][kPitch];
  __shared__ __align__(16) int8_t sb[kStages][kBN][kPitch];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int grp = lane >> 2, tig = lane & 3;
  const long long hwo = (long long)g.ho * g.wo;
  const long long m_total = g.n * hwo;
  const long long m0 = blockIdx.x * (long long)kBM;
  const int n0 = blockIdx.y * kBN;
  const int cpc = g.cp / 16;
  const long long k_bytes = (long long)g.k_chunks * 16;

  // this thread's copies: A rows tid/4 + 32j (j < 4), B row tid/4, one
  // 16-byte chunk (tid % 4) of each row a step
  const int cc = tid & 3;
  long long a_base[4];
  int a_h[4], a_w[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const long long m = m0 + (tid >> 2) + 32 * j;
    if (m < m_total) {
      const int nb = (int)(m / hwo);
      const int r = (int)(m - nb * hwo);
      const int ho = r / g.wo, wo = r - (r / g.wo) * g.wo;
      a_base[j] = (long long)nb * g.h * g.w * g.cp;
      a_h[j] = ho * g.sh - g.ph;
      a_w[j] = wo * g.sw - g.pw;
    } else {
      a_base[j] = 0;
      a_h[j] = -(1 << 29);  // never inside the image
      a_w[j] = 0;
    }
  }
  const int b_co = n0 + (tid >> 2);

  auto load = [&](int step, int slot) {
    const int c16 = step * kChunks + cc;
    const bool in_k = c16 < g.k_chunks;
    const int tap = in_k ? c16 / cpc : 0;
    const int ch = c16 - tap * cpc;
    const int dy = tap / g.kw, dx = tap - (tap / g.kw) * g.kw;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int hi = a_h[j] + dy * g.dh, wi = a_w[j] + dx * g.dw;
      const bool ok = in_k && hi >= 0 && hi < g.h && wi >= 0 && wi < g.w;
      const int8_t* src = ok ? xq + a_base[j] + ((long long)hi * g.w + wi) * g.cp + ch * 16 : xq;
      cp_async16(&sa[slot][(tid >> 2) + 32 * j][cc * 16], src, ok);
    }
    const bool okb = in_k && b_co < g.cout;
    cp_async16(&sb[slot][tid >> 2][cc * 16], okb ? wq + b_co * k_bytes + c16 * 16 : wq, okb);
  };

  int acc[2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0;

  const int n_steps = (g.k_chunks + kChunks - 1) / kChunks;
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < n_steps) load(s, s);
    cp_async_commit();
  }
  for (int s = 0; s < n_steps; ++s) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // step s is in; every warp is done with step s - 1's slot
    if (s + kStages - 1 < n_steps) load(s + kStages - 1, (s + kStages - 1) % kStages);
    cp_async_commit();
    const int slot = s % kStages;
#pragma unroll
    for (int ks = 0; ks < kStep / 32; ++ks) {
      unsigned a[2][4], b[4][2];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
        const int row = warp * 32 + mi * 16 + grp;
        const int8_t* p = &sa[slot][row][ks * 32 + tig * 4];
        a[mi][0] = *reinterpret_cast<const unsigned*>(p);
        a[mi][1] = *reinterpret_cast<const unsigned*>(p + 8 * kPitch);
        a[mi][2] = *reinterpret_cast<const unsigned*>(p + 16);
        a[mi][3] = *reinterpret_cast<const unsigned*>(p + 8 * kPitch + 16);
      }
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        const int8_t* p = &sb[slot][ni * 8 + grp][ks * 32 + tig * 4];
        b[ni][0] = *reinterpret_cast<const unsigned*>(p);
        b[ni][1] = *reinterpret_cast<const unsigned*>(p + 16);
      }
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) mma_s8(acc[mi][ni], a[mi], b[ni][0], b[ni][1]);
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // every warp is done with the ring: reuse it for the tile

  // the scaled tile goes out through shared memory: ct[co][pixel], then each
  // channel's 128 pixels are written by consecutive threads (an NCHW row)
  float* ct = reinterpret_cast<float*>(&sa[0][0][0]);
  constexpr int kCPitch = kBM + 4;
  static_assert(kBN * kCPitch * sizeof(float) <= sizeof(sa), "tile fits the ring");
  const float s = act_scale(a_scale, amax);
#pragma unroll
  for (int ni = 0; ni < 4; ++ni) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int col = ni * 8 + tig * 2 + e;
      const float sc = n0 + col < g.cout ? __fmul_rn(s, ws[n0 + col]) : 0.0f;
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int half = 0; half < 2; ++half)
          ct[col * kCPitch + warp * 32 + mi * 16 + grp + 8 * half] =
              __fmul_rn(__int2float_rn(acc[mi][ni][2 * half + e]), sc);
    }
  }
  __syncthreads();
  const int row = tid;  // one output pixel a thread
  const long long m = m0 + row;
  if (m < m_total) {
    const int nb = (int)(m / hwo);
    TO* o = out + (long long)nb * g.cout * hwo + (m - nb * hwo);
    const int n_co = g.cout - n0 < kBN ? g.cout - n0 : kBN;
    for (int col = 0; col < n_co; ++col) store(o + (long long)(n0 + col) * hwo, ct[col * kCPitch + row]);
  }
}

template <typename T>
cudaError_t quantize(const void* x, const float* a_scale, unsigned* amax, int8_t* xq,
                     const Geometry& g, cudaStream_t st) {
  const T* xt = static_cast<const T*>(x);
  if (a_scale == nullptr) {
    cudaError_t err = cudaMemsetAsync(amax, 0, sizeof(unsigned), st);
    if (err != cudaSuccess) return err;
    const long long n = (long long)g.n * g.cin * g.h * g.w;
    const int vec = (reinterpret_cast<uintptr_t>(x) & 15) == 0;
    const long long blocks = (n / (16 / sizeof(T)) + 255) / 256 + 1;
    amax_kernel<T><<<(unsigned)(blocks < 132 * 32 ? blocks : 132 * 32), 256, 0, st>>>(xt, n, vec,
                                                                                      amax);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  const dim3 grid((unsigned)(((long long)g.h * g.w + kQPix - 1) / kQPix), g.n);
  quantize_kernel<T><<<grid, 256, 0, st>>>(xt, a_scale, amax, xq, g);
  return cudaGetLastError();
}

}  // namespace

// Cin is zero-padded to a multiple of this (CHANNEL_PAD of
// nn/conv_int8_kernel.py).
extern "C" int conv_int8_channel_pad() { return kChannelPad; }

// Launches the passes on `stream`; returns the first cudaGetLastError() that
// is not 0, else 0. Does not synchronise. Pointers are device pointers to
// contiguous arrays: x (N, Cin, H, W) f32 or bf16 (x_bf16), wq (Cout,
// kh*kw*Cp) int8, ws (Cout,) f32, a_scale one f32 or null (dynamic), the
// scratch xq (N*H*W*Cp int8) and amax (one 32-bit word), out (N, Cout, Ho,
// Wo) f32 or bf16 (out_bf16).
extern "C" int conv_int8(const void* x, int x_bf16, const void* wq, const void* ws,
                         const void* a_scale, void* xq, void* amax, void* out, int out_bf16,
                         int n, int cin, int h, int w, int cp, int cout, int ho, int wo, int kh,
                         int kw, int sh, int sw, int ph, int pw, int dh, int dw, void* stream) {
  if (n <= 0 || cin <= 0 || h <= 0 || w <= 0 || cp < cin || cp % kChannelPad != 0 ||
      cout <= 0 || ho <= 0 || wo <= 0 || kh <= 0 || kw <= 0 || sh <= 0 || sw <= 0 ||
      ph < 0 || pw < 0 || dh <= 0 || dw <= 0 || (cout + kBN - 1) / kBN > 65535 ||
      ((long long)n * ho * wo + kBM - 1) / kBM > 0x7fffffffLL ||
      (reinterpret_cast<uintptr_t>(wq) & 15) != 0 || (reinterpret_cast<uintptr_t>(xq) & 15) != 0) {
    return (int)cudaErrorInvalidValue;
  }
  const Geometry g{n, cin, h, w, cp, cout, ho, wo, kh, kw, sh, sw, ph, pw, dh, dw,
                   kh * kw * cp / 16};
  cudaStream_t st = (cudaStream_t)stream;
  const float* as = static_cast<const float*>(a_scale);
  unsigned* am = static_cast<unsigned*>(amax);
  int8_t* q = static_cast<int8_t*>(xq);
  cudaError_t err = x_bf16 ? quantize<__nv_bfloat16>(x, as, am, q, g, st)
                           : quantize<float>(x, as, am, q, g, st);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)(((long long)n * ho * wo + kBM - 1) / kBM), (cout + kBN - 1) / kBN);
  const int8_t* w8 = static_cast<const int8_t*>(wq);
  const float* wsf = static_cast<const float*>(ws);
  if (out_bf16) {
    conv_int8_mma<__nv_bfloat16><<<grid, kThreads, 0, st>>>(
        q, w8, wsf, as, am, static_cast<__nv_bfloat16*>(out), g);
  } else {
    conv_int8_mma<float><<<grid, kThreads, 0, st>>>(q, w8, wsf, as, am,
                                                    static_cast<float*>(out), g);
  }
  return (int)cudaGetLastError();
}
