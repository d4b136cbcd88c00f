// int8 x int8 -> int32 convolution for int8 serving, Hopper (sm_90a), plain
// C entry point.
//
// Replaces no TPU kernel. The JAX package's int8 conv
// (vocal_remover_tpu/nn/functional.py `conv2d_int8`) is XLA's
// `lax.conv_general_dilated` of int8 operands with an int32 result; PyTorch
// has no such convolution on CUDA (`conv2d` of int8 tensors returns int8,
// and cuDNN's int8 path is not exposed), so the port writes it. What it
// computes, for NCHW x (f32 or bf16), the int8 kernel prepacked as
// wq (Cout, Cp/32, kh*kw, 32) (channel chunk major, then tap, Cin
// zero-padded to Cp, a multiple of 32) and the f32 per-output-channel
// scales ws (Cout,):
//   a   = a_scale (static, f32), or max(amax(|x|) / 127, 1e-30) (dynamic)
//   xq  = int8(clamp(rint(float(x) / a), -127, 127))       IEEE division
//   acc = sum over taps and channels of xq * wq             int32, exact
//   out = float(acc) * (a * ws[co])                          product first
// written NCHW in f32 or bf16 (round to nearest even). Any kernel size,
// stride, padding and dilation, each an (h, w) pair. The sums are integers,
// so their order does not matter: the result equals the plain version's
// (nn/conv_int8_kernel.py) bit for bit, which the build keeps by compiling
// without --use_fast_math.
//
// What bounds it on an H100 SXM (700 W): the work is bound by bytes. A
// flagship chunk's 97 convs (crop 256, batch 4) must read 1.33 GB of bf16
// activations and write their outputs, 0.64 ms at 3.35 TB/s, against 0.27
// ms of useful int8 operations at 1,979 TOP/s. So the design reads x once,
// in its own NCHW layout, and writes nothing but the output. Measured, the
// kernel reaches 10-15% of that bound: it is bound by instruction issue
// (the quantize of each element, the copies' and products' address work)
// and by stalls at its barriers, not by bytes (PERF.md).
//
//  1. amax (dynamic scale only): a grid-stride max of |x| in 16-byte loads
//     (the unaligned head and tail one by one), one partial maximum a block
//     into a scratch array. Nothing is reset and nothing is atomic: the
//     conv's blocks fold the partials themselves.
//  2. conv, an implicit GEMM on int8 tensor cores (mma.sync m16n8k32
//     s8.s8.s32): M = output pixels, N = Cout, K = taps x Cp. A block of 8
//     warps owns a TH x TW tile of one image's output pixels (BM = 32 to
//     256) and BN = up to 128 output channels, so the activation is read
//     once for every Cout <= 128. K runs in steps of `cps` chunks of 32
//     input channels. For each step the block copies the input rows and
//     columns its taps reach (the halo tile, clipped to the image) from
//     NCHW x with 16-byte cp.async copies of the aligned granules that
//     cover each row (a granule that holds a byte of x cannot fault,
//     whatever x's alignment), and the step's weights for all taps. It then
//     quantizes this raw tile in shared memory into an int8 tile,
//     pixel-major with the step's channels contiguous (a pitch of an odd
//     number of 16-byte units: the 8 rows an ldmatrix phase reads hit 8
//     different bank groups; at stride 2 the columns are stored even ones
//     first, so that a tap's pixels stay one pitch apart). Every tap's A
//     fragment is then an ldmatrix of shifted rows of that tile; a pixel
//     outside the image reads a zero row (zero padding is int8 0, which is
//     exact). The next step's copies (raw tile, and weights into the other
//     of two stages) fly over this step's products. Where no halo tile
//     fits shared memory (large kernels or dilations on large maps), the
//     same kernel takes the gather route: a K step is one tap of one
//     chunk, whose BM pixels are loaded straight from x and quantized into
//     the A tile. The epilogue
//     scales in f32 into a shared-memory tile, from which consecutive
//     threads write neighbouring pixels of an NCHW row, two at a time where
//     Wo is even.
//     The plan (tile configuration, tile shape, chunks a step, route,
//     shared memory) is the wrapper's (nn/conv_int8_kernel.py
//     `tile_plan`, by a cost model fitted on the card); this file checks
//     what its indexing relies on.
//
// The quantize is exact and cheap: y = x * (1/a) is within 2.3e-5 of the
// IEEE quotient fl(x / a) whenever |y| < 128 (the roundings of the product,
// the reciprocal and the quotient are each within 2^-24 relative, and
// |x / a| < 128.0001), so rint(y) equals rint(fl(x / a)) unless y lies
// within 1e-4 of a half-integer; there the kernel divides (__fdiv_rn).
// Where |y| >= 127 both give +-127 after the clamp. A reciprocal outside
// the normal range turns the shortcut off.
//
// Launches: one (static scale) or two (dynamic: amax, conv), no memset.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <float.h>
#include <stdint.h>

namespace {

constexpr int kChannelPad = 32;  // Cp is a multiple of this (CHANNEL_PAD)
constexpr int kKC = 32;          // input channels a K chunk (one k32 mma)
constexpr int kThreads = 256;
constexpr int kAmaxThreads = 256;
constexpr int kSmemMax = 232448;

// The launch plan, made by the wrapper (PLAN_FIELDS of
// nn/conv_int8_kernel.py, in this order).
struct Plan {
  int n, cin, h, w, cp, cout, ho, wo;
  int kh, kw, sh, sw, ph, pw, dh, dw;
  int x_bf16, out_bf16;
  int cfg;          // tile configuration (kConfigs)
  int gather;       // 0: halo route, 1: gather route
  int th, tw, tw_log2;
  int tiles_h, tiles_w, n_blocks;  // output tiles of an image, Cout blocks
  int halo_h, halo_w;              // input rows / columns a tile's taps reach
  int a_rows, a_cols;              // A tile pixels allocated (halo route)
  int raw_g;                       // raw tile granules a row
  int cps;                         // 32-channel chunks a K step (halo route)
  int smem;                        // dynamic shared memory bytes
  int amax_blocks;                 // partial maxima (dynamic scale)
};

// (MI, NI, WN): a warp computes 16*MI x 8*NI, warps 8/WN x WN, so a block
// BM = 16*MI*(8/WN) pixels x BN = 8*NI*WN channels. Index = Plan::cfg
// (TILE_CONFIGS of the wrapper).
#define CONV_INT8_CONFIGS(X) \
  X(0, 2, 8, 2)              \
  X(1, 2, 6, 2)              \
  X(2, 2, 4, 2)              \
  X(3, 2, 3, 2)              \
  X(4, 2, 4, 1)              \
  X(5, 2, 2, 1)              \
  X(6, 2, 1, 1)              \
  X(7, 1, 4, 4)              \
  X(8, 1, 2, 4)              \
  X(9, 1, 4, 1)              \
  X(10, 1, 2, 1)             \
  X(11, 4, 4, 2)
constexpr int kConfigs = 12;
constexpr int kConfigMI[kConfigs] = {2, 2, 2, 2, 2, 2, 2, 1, 1, 1, 1, 4};
constexpr int kConfigNI[kConfigs] = {8, 6, 4, 3, 4, 2, 1, 4, 2, 4, 2, 4};
constexpr int kConfigWN[kConfigs] = {2, 2, 2, 2, 1, 1, 1, 4, 4, 1, 1, 2};

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void cp_async16(unsigned dst, const void* src, bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(ok ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}
__device__ __forceinline__ void ldmatrix_x4(unsigned (&r)[4], unsigned addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}
__device__ __forceinline__ void ldmatrix_x2(unsigned& r0, unsigned& r1, unsigned addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(r0), "=r"(r1)
               : "r"(addr));
}
__device__ __forceinline__ void mma_s8(int (&d)[4], const unsigned (&a)[4], unsigned b0,
                                       unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

constexpr float kMagic = 12582912.0f;  // 1.5 * 2^23: y + kMagic rounds y to an integer

// clamp(rint(fl(v / s)), -127, 127) by IEEE division, for the few values
// the shortcut leaves (header); out of line, so that the hot loop stays
// small
__device__ __noinline__ float quantize_exact(float v, float s) {
  return fminf(fmaxf(rintf(__fdiv_rn(v, s)), -127.0f), 127.0f);
}
// 16 values -> int8(clamp(rint(fl(v / s)), -127, 127)) packed little-endian
// into 4 words; load(j) gives value j. `r` = 1/s and `fast` = r is a
// normal float (header). The clamp comes first, which changes nothing (its
// bounds are integers), so that y + kMagic is exact: its low byte is
// rint(y) as a two's-complement byte, and subtracting kMagic again gives
// rint(y) to test against y. A word with a value the shortcut leaves (or a
// NaN, whose bits exceed 0.4999's) is loaded again and divided, so that no
// value stays live past its word.
template <typename Load>
__device__ __forceinline__ uint4 quantize16(Load load, float s, float r, bool fast) {
  unsigned wd[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    float u[4];
    unsigned d_max = 0;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float y = fminf(fmaxf(__fmul_rn(load(4 * k + e), r), -127.0f), 127.0f);
      u[e] = __fadd_rn(y, kMagic);
      d_max = max(d_max, __float_as_uint(fabsf(__fsub_rn(y, __fsub_rn(u[e], kMagic)))));
    }
    if (!fast || d_max >= __float_as_uint(0.4999f)) {  // rare: near a half-integer
#pragma unroll
      for (int e = 0; e < 4; ++e) u[e] = __fadd_rn(quantize_exact(load(4 * k + e), s), kMagic);
    }
    wd[k] = __byte_perm(__byte_perm(__float_as_uint(u[0]), __float_as_uint(u[1]), 0x0040),
                        __byte_perm(__float_as_uint(u[2]), __float_as_uint(u[3]), 0x0040),
                        0x5410);
  }
  return make_uint4(wd[0], wd[1], wd[2], wd[3]);
}

// Partial max |x| of a block's grid-stride share: the elements before the
// first 16-byte boundary and after the last one singly, the rest in 16-byte
// loads.
template <typename T>
__global__ void __launch_bounds__(kAmaxThreads) amax_partial(const T* __restrict__ x,
                                                             long long n,
                                                             float* __restrict__ partial) {
  constexpr int kV = 16 / sizeof(T);
  const long long stride = (long long)gridDim.x * blockDim.x;
  const long long first = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  const long long mis = (reinterpret_cast<uintptr_t>(x) & 15) / sizeof(T);
  long long head = mis ? kV - mis : 0;
  if (head > n) head = n;
  const long long n_vec = (n - head) / kV;
  const T* body = x + head;
  float m = 0.0f;
  const uint4* vb = reinterpret_cast<const uint4*>(body);
  long long i = first;
  for (; i + 3 * stride < n_vec; i += 4 * stride) {  // four loads in flight
    uint4 u[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) u[k] = __ldg(vb + i + k * stride);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const T* e = reinterpret_cast<const T*>(&u[k]);
#pragma unroll
      for (int j = 0; j < kV; ++j) m = fmaxf(m, fabsf(to_float(e[j])));
    }
  }
  for (; i < n_vec; i += stride) {
    const uint4 u = __ldg(vb + i);
    const T* e = reinterpret_cast<const T*>(&u);
#pragma unroll
    for (int k = 0; k < kV; ++k) m = fmaxf(m, fabsf(to_float(e[k])));
  }
  if (first < head) m = fmaxf(m, fabsf(to_float(x[first])));
  for (long long i = head + n_vec * kV + first; i < n; i += stride)
    m = fmaxf(m, fabsf(to_float(x[i])));
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
  __shared__ float warp_max[kAmaxThreads / 32];
  if ((threadIdx.x & 31) == 0) warp_max[threadIdx.x >> 5] = m;
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int i = 1; i < kAmaxThreads / 32; ++i) m = fmaxf(m, warp_max[i]);
    partial[blockIdx.x] = m;
  }
}

// Shared memory of a plan: two weight stages, the A tile (a zero row, then
// the pixels) and, on the halo route, the raw tile; the epilogue's f32 tile
// reuses it from the start.
__host__ __device__ inline int plan_smem(const Plan& p, int bm, int bn) {
  const int nt = p.gather ? 1 : p.kh * p.kw;
  const int kstep = p.cps * kKC;  // input channels a K step
  const int b = 2 * bn * (nt * kstep + 16);
  const int a_px = p.gather ? bm : p.a_rows * p.a_cols;
  const int a = (a_px + 1) * (kstep + 16);
  const int raw = p.gather ? 0 : kstep * p.a_rows * p.raw_g * 16;
  const int pipe = b + a + raw;
  const int epi = bn * (bm + 4) * 4;
  return pipe > epi ? pipe : epi;
}

// blocks an SM the registers allow: three (85 registers a thread) where a
// warp's tile is small, two (128) where it holds 48 or more accumulators
__host__ __device__ constexpr int min_blocks(int mi, int ni) { return mi * ni >= 12 ? 2 : 3; }

template <typename T, int MI, int NI, int WN>
__global__ void __launch_bounds__(kThreads, min_blocks(MI, NI)) conv_int8_tile(
    const Plan p, const T* __restrict__ x, const int8_t* __restrict__ wq,
    const float* __restrict__ ws, const float* a_scale, const float* partial,
    void* __restrict__ out) {
  constexpr int WMW = 8 / WN;
  constexpr int BM = 16 * MI * WMW, BN = 8 * NI * WN;
  constexpr int WM = 16 * MI, WNC = 8 * NI;
  constexpr int ESZ = sizeof(T);
  extern __shared__ __align__(16) uint8_t smem[];
  __shared__ float red[kThreads / 32];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp / WN, wn = warp % WN;

  // this block's tile: Cout block fastest, then tile column, row, image
  long long bid = blockIdx.x;
  const int nb = (int)(bid % p.n_blocks);
  bid /= p.n_blocks;
  const int tx = (int)(bid % p.tiles_w);
  bid /= p.tiles_w;
  const int ty = (int)(bid % p.tiles_h);
  const int img = (int)(bid / p.tiles_h);
  const int oy0 = ty * p.th, ox0 = tx * p.tw;
  const int n0 = nb * BN;
  const int taps = p.kh * p.kw;
  const int nc = p.cp / kKC;
  const bool gather = p.gather != 0;
  // a K step: `cps` chunks of 32 channels and every tap (halo route), or
  // one tap of one chunk (gather route)
  const int cps = p.cps, kstep = cps * kKC;
  const int nt = gather ? 1 : taps;
  const int steps = gather ? nc * taps : (nc + cps - 1) / cps;
  const int pb = nt * kstep + 16;      // weight row pitch (odd 16-byte units)
  const int a_pitch = kstep + 16;      // A tile pixel pitch (odd 16-byte units)
  const long long hw = (long long)p.h * p.w;
  const T* xb = x + (long long)img * p.cin * hw;

  uint8_t* s_b = smem;               // two weight stages
  uint8_t* s_a = s_b + 2 * BN * pb;  // the A tile: a zero row, then pixels
  const int a_px = gather ? BM : p.a_rows * p.a_cols;
  uint8_t* s_raw = s_a + (a_px + 1) * a_pitch;  // the raw tile
  const unsigned a_base = smem_addr(s_a), b_base = smem_addr(s_b);

  // the halo tile, clipped to the image
  const int r_lo = oy0 * p.sh - p.ph, c_lo = ox0 * p.sw - p.pw;
  const int r0 = max(r_lo, 0), c0 = max(c_lo, 0);
  const int cr = max(min(r_lo + p.halo_h, p.h) - r0, 0);
  const int cw = max(min(c_lo + p.halo_w, p.w) - c0, 0);
  const bool sw2 = p.sw == 2;  // columns stored even ones first
  const int half_cw = sw2 ? (cw + 1) >> 1 : cw;
  const int cwp = sw2 ? 2 * half_cw : cw;
  // raw tile copies: thread tid takes granule g of rows row0, row0 + rpp,
  // ... (row = channel * cr + r); the rest of 256 / raw_g idles
  const int rpp = kThreads / p.raw_g;
  const int g_mine = tid % p.raw_g, row0 = tid / p.raw_g;
  const int ch0_mine = cr > 0 ? row0 / cr : 0, r0_mine = cr > 0 ? row0 - ch0_mine * cr : 0;
  const int dch = cr > 0 ? rpp / cr : 0, dr = cr > 0 ? rpp - dch * cr : 0;

  // weights of K step `st` into stage `stage`: per output channel the
  // step's contiguous bytes of wq (Cout, Cp/32, taps, 32)
  auto issue_b = [&](int st, int stage) {
    const int c = gather ? st / taps : st * cps, t0 = gather ? st - c * taps : 0;
    const int pieces = (gather ? 1 : min(cps, nc - c) * taps) * 2;
    const unsigned dst0 = b_base + stage * BN * pb;
    const int8_t* src0 = wq + (((long long)n0 * nc + c) * taps + t0) * kKC;
    const long long co_bytes = (long long)nc * taps * kKC;
    int col = tid / pieces, pc = tid - col * pieces;
    const int dcol = kThreads / pieces, dpc = kThreads - dcol * pieces;
    for (; col < BN; col += dcol) {
      const bool ok = n0 + col < p.cout;
      cp_async16(dst0 + col * pb + pc * 16, ok ? src0 + col * co_bytes + pc * 16 : wq, ok);
      pc += dpc;
      if (pc >= pieces) {
        pc -= pieces;
        ++col;
      }
    }
  };
  // raw tile of step st: [channel][row][granule], each row the aligned
  // 16-byte granules that cover x[ch][r0 + r][c0 .. c0 + cw)
  auto issue_raw = [&](int st) {
    const int ch0 = st * kstep;
    const int rows = min(kstep, p.cin - ch0) * cr;
    const unsigned dst0 = smem_addr(s_raw);
    if (row0 >= rpp) return;
    int ch = ch0_mine, r = r0_mine;
    for (int row = row0; row < rows; row += rpp) {
      const char* first = reinterpret_cast<const char*>(
          xb + ((long long)(ch0 + ch) * p.h + r0 + r) * p.w + c0);
      const uintptr_t lo = reinterpret_cast<uintptr_t>(first) & ~(uintptr_t)15;
      const uintptr_t hi = (reinterpret_cast<uintptr_t>(first) + cw * ESZ + 15) & ~(uintptr_t)15;
      const uintptr_t src = lo + 16 * (uintptr_t)g_mine;
      if (src < hi)
        cp_async16(dst0 + (row * p.raw_g + g_mine) * 16, reinterpret_cast<const void*>(src), true);
      ch += dch;
      r += dr;
      if (r >= cr) {
        r -= cr;
        ++ch;
      }
    }
  };
  if (!gather) issue_raw(0);
  cp_async_commit();
  for (int i = tid; i < a_pitch / 16; i += kThreads)
    *reinterpret_cast<uint4*>(s_a + i * 16) = make_uint4(0, 0, 0, 0);

  // the activation scale: static, or folded from the amax partials
  float s;
  if (a_scale != nullptr) {
    s = *a_scale;
  } else {
    float m = 0.0f;
    for (int i = tid; i < p.amax_blocks; i += kThreads) m = fmaxf(m, partial[i]);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
    if (lane == 0) red[warp] = m;
    __syncthreads();
    m = red[0];
#pragma unroll
    for (int i = 1; i < kThreads / 32; ++i) m = fmaxf(m, red[i]);
    s = fmaxf(__fdiv_rn(m, 127.0f), 1e-30f);
  }
  const float rs = __fdiv_rn(1.0f, s);
  const bool fast = rs >= FLT_MIN && rs <= FLT_MAX;

  // quantize the raw tile of step st into the A tile: a thread takes 16
  // channels of one pixel, the step's first 16 channels for every pixel of
  // A, then the next 16, ... (consecutive threads, consecutive pixels)
  auto quantize_raw = [&](int st) {
    const int ch0 = st * kstep;
    const int npx = cr * cwp;
    if (npx == 0) return;
    const unsigned hwe = (unsigned)(hw * ESZ);
    const int row_bytes = p.raw_g * 16, ch_bytes = cr * row_bytes;
    const int n_ch = min(kstep, p.cin - ch0);
    // the byte offset of x[ch0][r0][c0] in its granule; a row moves it by
    // W*esz and a channel by H*W*esz (mod 16)
    const unsigned phase0 = (unsigned)reinterpret_cast<uintptr_t>(xb) +
                            (unsigned)((ch0 * hw + (long long)r0 * p.w + c0) * ESZ);
    int px = tid, hf = 0;
    while (px >= npx) {
      px -= npx;
      ++hf;
    }
    for (int i = tid; i < 2 * cps * npx; i += kThreads) {
      const int r = px / cwp, pos = px - r * cwp;
      const int cc = sw2 ? (pos >= half_cw ? 2 * (pos - half_cw) + 1 : 2 * pos) : pos;
      const int c16 = hf * 16;
      uint4 packed = make_uint4(0, 0, 0, 0);
      if (cc < cw && c16 < n_ch) {
        const uint8_t* sl = s_raw + (c16 * cr + r) * row_bytes + cc * ESZ;
        const unsigned ph = phase0 + (unsigned)(r * p.w * ESZ) + c16 * hwe;
        const int left = n_ch - c16;
        if (left >= 16 && (hwe & 15) == 0) {  // 16 channels at one granule phase
          const uint8_t* sp = sl + (ph & 15);
          packed = quantize16(
              [&](int j) { return to_float(*reinterpret_cast<const T*>(sp + j * ch_bytes)); },
              s, rs, fast);
        } else {
          packed = quantize16(
              [&](int j) {
                return j < left ? to_float(*reinterpret_cast<const T*>(
                                      sl + j * ch_bytes + ((ph + j * hwe) & 15)))
                                : 0.0f;
              },
              s, rs, fast);
        }
      }
      *reinterpret_cast<uint4*>(s_a + (1 + px) * a_pitch + c16) = packed;
      px += kThreads;
      while (px >= npx) {
        px -= npx;
        ++hf;
      }
    }
  };
  // gather route: step st, tap t of chunk c, for the BM pixels, straight
  // from x
  auto gather_load = [&](int st) {
    const int c = st / taps, t = st - c * taps;
    const int ch0 = c * kKC;
    const int dy = t / p.kw, dx = t - dy * p.kw;
    for (int i = tid; i < 2 * BM; i += kThreads) {
      const int hf = i >= BM;
      const int m = i - hf * BM;
      const int oy = oy0 + (m >> p.tw_log2), ox = ox0 + (m & (p.tw - 1));
      const int gy = oy * p.sh - p.ph + dy * p.dh, gx = ox * p.sw - p.pw + dx * p.dw;
      uint4 packed = make_uint4(0, 0, 0, 0);
      if (oy < p.ho && ox < p.wo && gy >= 0 && gy < p.h && gx >= 0 && gx < p.w) {
        const T* src = xb + (long long)(ch0 + hf * 16) * hw + (long long)gy * p.w + gx;
        const int left = p.cin - ch0 - hf * 16;
        packed = quantize16(
            [&](int j) { return j < left ? to_float(src[j * hw]) : 0.0f; }, s, rs, fast);
      }
      *reinterpret_cast<uint4*>(s_a + (1 + m) * a_pitch + hf * 16) = packed;
    }
  };

  int acc[MI][NI][4];
#pragma unroll
  for (int i = 0; i < MI; ++i)
#pragma unroll
    for (int j = 0; j < NI; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0;

  // this lane's ldmatrix rows: A row m of each m16 tile, relative to the
  // halo tile at tap (0, 0); B rows and k offsets
  const int a_koff = (lane >> 4) * 16;
  int a_m[MI], by[MI], bx[MI];
#pragma unroll
  for (int mi = 0; mi < MI; ++mi) {
    const int m = wm * WM + mi * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
    a_m[mi] = m;
    by[mi] = (oy0 + (m >> p.tw_log2)) * p.sh - p.ph - r0;
    bx[mi] = (ox0 + (m & (p.tw - 1))) * p.sw - p.pw - c0;
  }
  const unsigned b_lane = (unsigned)((wn * WNC + (lane >> 4) * 8 + (lane & 7)) * pb +
                                     ((lane >> 3) & 1) * 16);

  // one k32 product of this warp's tile: A rows at aaddr, B at bst
  auto mma_k32 = [&](const unsigned (&aaddr)[MI], unsigned bst) {
    unsigned a[MI][4], b[NI][2];
#pragma unroll
    for (int mi = 0; mi < MI; ++mi) ldmatrix_x4(a[mi], aaddr[mi]);
#pragma unroll
    for (int nj = 0; nj + 1 < NI; nj += 2) {
      unsigned r[4];
      ldmatrix_x4(r, bst + nj * 8 * pb);
      b[nj][0] = r[0];
      b[nj][1] = r[1];
      b[nj + 1][0] = r[2];
      b[nj + 1][1] = r[3];
    }
    if (NI & 1) ldmatrix_x2(b[NI - 1][0], b[NI - 1][1], bst + (NI - 1) * 8 * pb);
#pragma unroll
    for (int mi = 0; mi < MI; ++mi)
#pragma unroll
      for (int ni = 0; ni < NI; ++ni) mma_s8(acc[mi][ni], a[mi], b[ni][0], b[ni][1]);
  };

  // the products of step st: every tap (halo route) or one (gather route)
  auto multiply = [&](int st) {
    const unsigned bst = b_base + (st & 1) * BN * pb + b_lane;

    if (gather) {
      unsigned aaddr[MI];
#pragma unroll
      for (int mi = 0; mi < MI; ++mi) aaddr[mi] = a_base + (1 + a_m[mi]) * a_pitch + a_koff;
      mma_k32(aaddr, bst);
      return;
    }
    const int chunks = min(cps, nc - st * cps);
    int tap = 0;
    for (int dy = 0; dy < p.kh; ++dy) {
      for (int dx = 0; dx < p.kw; ++dx, ++tap) {
        unsigned aaddr[MI];
#pragma unroll
        for (int mi = 0; mi < MI; ++mi) {
          const int ry = by[mi] + dy * p.dh, rx = bx[mi] + dx * p.dw;
          const bool ok = (unsigned)ry < (unsigned)cr && (unsigned)rx < (unsigned)cw;
          const int pos = sw2 ? (rx & 1) * half_cw + (rx >> 1) : rx;
          aaddr[mi] = a_base + (ok ? (1 + ry * cwp + pos) * a_pitch : 0) + a_koff;
        }
        for (int j = 0; j < chunks; ++j) {
          unsigned aj[MI];
#pragma unroll
          for (int mi = 0; mi < MI; ++mi) aj[mi] = aaddr[mi] + j * kKC;
          mma_k32(aj, bst + (j * taps + tap) * kKC);
        }
      }
    }
  };
  auto load_a = [&](int st) {
    if (gather)
      gather_load(st);
    else
      quantize_raw(st);
  };

  // per step: quantize (or gather) into the A tile, then the next step's
  // copies fly over this step's products
  issue_b(0, 0);
  cp_async_commit();
  for (int st = 0; st < steps; ++st) {
    cp_async_wait_all();
    __syncthreads();  // this step's copies are in; every warp is done with the last step
    load_a(st);
    __syncthreads();  // the A tile is ready; the raw tile is free
    if (st + 1 < steps) {
      if (!gather) issue_raw(st + 1);
      issue_b(st + 1, (st + 1) & 1);
    }
    cp_async_commit();
    multiply(st);
  }
  cp_async_wait_all();
  __syncthreads();  // every warp is done with the tiles: reuse them

  // scaled tile ct[channel][pixel] in f32, then a thread a pixel per pass
  constexpr int kCPitch = BM + 4;
  float* ct = reinterpret_cast<float*>(smem);
  const int grp = lane >> 2, tig = lane & 3;
#pragma unroll
  for (int ni = 0; ni < NI; ++ni) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int col = wn * WNC + ni * 8 + tig * 2 + e;
      const float sc = n0 + col < p.cout ? __fmul_rn(s, ws[n0 + col]) : 0.0f;
#pragma unroll
      for (int mi = 0; mi < MI; ++mi)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh)
          ct[col * kCPitch + wm * WM + mi * 16 + grp + 8 * hh] =
              __fmul_rn(__int2float_rn(acc[mi][ni][2 * hh + e]), sc);
    }
  }
  __syncthreads();
  const long long hwo = (long long)p.ho * p.wo;
  const int n_co = min(BN, p.cout - n0);
  const long long o0 = ((long long)img * p.cout + n0) * hwo;
  if ((p.wo & 1) == 0 && p.tw >= 2) {
    // two neighbouring pixels a thread (ox even, so ox + 1 < Wo too)
    for (int i = tid; i < n_co * BM / 2; i += kThreads) {
      const int col = (2 * i) / BM, m = (2 * i) % BM;
      const int oy = oy0 + (m >> p.tw_log2), ox = ox0 + (m & (p.tw - 1));
      if (oy < p.ho && ox < p.wo) {
        const long long o = o0 + col * hwo + (long long)oy * p.wo + ox;
        const float v0 = ct[col * kCPitch + m], v1 = ct[col * kCPitch + m + 1];
        if (p.out_bf16)
          *reinterpret_cast<__nv_bfloat162*>(static_cast<__nv_bfloat16*>(out) + o) =
              __floats2bfloat162_rn(v0, v1);
        else
          *reinterpret_cast<float2*>(static_cast<float*>(out) + o) = make_float2(v0, v1);
      }
    }
  } else {
    for (int i = tid; i < n_co * BM; i += kThreads) {
      const int col = i / BM, m = i % BM;
      const int oy = oy0 + (m >> p.tw_log2), ox = ox0 + (m & (p.tw - 1));
      if (oy < p.ho && ox < p.wo) {
        const long long o = o0 + col * hwo + (long long)oy * p.wo + ox;
        const float v = ct[col * kCPitch + m];
        if (p.out_bf16)
          static_cast<__nv_bfloat16*>(out)[o] = __float2bfloat16_rn(v);
        else
          static_cast<float*>(out)[o] = v;
      }
    }
  }
}

template <typename T>
using ConvFn = void (*)(const Plan, const T*, const int8_t*, const float*, const float*,
                        const float*, void*);

template <typename T>
ConvFn<T> conv_kernel(int cfg) {
#define CONV_INT8_CASE(id, mi, ni, wn) \
  case id:                             \
    return conv_int8_tile<T, mi, ni, wn>;
  switch (cfg) { CONV_INT8_CONFIGS(CONV_INT8_CASE) }
#undef CONV_INT8_CASE
  return nullptr;
}

template <typename T>
cudaError_t launch(const Plan& p, const void* x, const void* wq, const void* ws,
                   const void* a_scale, void* partial, void* out, cudaStream_t st) {
  const T* xt = static_cast<const T*>(x);
  float* part = static_cast<float*>(partial);
  if (a_scale == nullptr) {
    const long long n = (long long)p.n * p.cin * p.h * p.w;
    amax_partial<T><<<p.amax_blocks, kAmaxThreads, 0, st>>>(xt, n, part);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  ConvFn<T> kernel = conv_kernel<T>(p.cfg);
  if (p.smem > 40 * 1024) {  // 48 KB less the static shared memory
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, p.smem);
    if (err != cudaSuccess) return err;
  }
  const long long blocks = (long long)p.n * p.tiles_h * p.tiles_w * p.n_blocks;
  kernel<<<(unsigned)blocks, kThreads, p.smem, st>>>(
      p, xt, static_cast<const int8_t*>(wq), static_cast<const float*>(ws),
      static_cast<const float*>(a_scale), part, out);
  return cudaGetLastError();
}

bool pow2(int v) { return v > 0 && (v & (v - 1)) == 0; }

// The plan's shape checks: what the kernel's indexing relies on.
bool plan_ok(const Plan& p) {
  if (p.n <= 0 || p.cin <= 0 || p.h <= 0 || p.w <= 0 || p.cp < p.cin ||
      p.cp % kChannelPad != 0 || p.cout <= 0 || p.ho <= 0 || p.wo <= 0 || p.kh <= 0 ||
      p.kw <= 0 || p.sh <= 0 || p.sw <= 0 || p.ph < 0 || p.pw < 0 || p.dh <= 0 || p.dw <= 0 ||
      p.cfg < 0 || p.cfg >= kConfigs || p.amax_blocks <= 0 || p.amax_blocks > 65535)
    return false;
  const int bm = 16 * kConfigMI[p.cfg] * (8 / kConfigWN[p.cfg]);
  const int bn = 8 * kConfigNI[p.cfg] * kConfigWN[p.cfg];
  if (!pow2(p.tw) || (1 << p.tw_log2) != p.tw || p.tw > bm || p.th * p.tw != bm ||
      (long long)p.tiles_h * p.th < p.ho || (long long)p.tiles_w * p.tw < p.wo ||
      (long long)p.n_blocks * bn < p.cout)
    return false;
  if (p.cps < 1 || (p.gather && p.cps != 1)) return false;
  if (!p.gather) {
    const int esz = p.x_bf16 ? 2 : 4;
    const int cols = p.halo_w < p.w ? p.halo_w : p.w;
    if (p.halo_h != (p.th - 1) * p.sh + (p.kh - 1) * p.dh + 1 ||
        p.halo_w != (p.tw - 1) * p.sw + (p.kw - 1) * p.dw + 1 ||
        p.a_rows < (p.halo_h < p.h ? p.halo_h : p.h) ||
        p.a_cols < (p.sw == 2 ? cols + (cols & 1) : cols) || p.raw_g > kThreads ||
        p.raw_g < (cols * esz + 15) / 16 + 1)
      return false;
  }
  const long long blocks = (long long)p.n * p.tiles_h * p.tiles_w * p.n_blocks;
  return blocks <= 0x7fffffffLL && p.smem >= plan_smem(p, bm, bn) && p.smem <= kSmemMax;
}

}  // namespace

// Cin is zero-padded to a multiple of this (CHANNEL_PAD of
// nn/conv_int8_kernel.py).
extern "C" int conv_int8_channel_pad() { return kChannelPad; }
// sizeof(Plan) / sizeof(int): the wrapper's PLAN_FIELDS must match.
extern "C" int conv_int8_plan_fields() { return (int)(sizeof(Plan) / sizeof(int)); }
// Shared memory the kernel needs for `plan` (the wrapper's figure is
// checked against it).
extern "C" int conv_int8_plan_smem(const void* plan) {
  const Plan& p = *static_cast<const Plan*>(plan);
  if (p.cfg < 0 || p.cfg >= kConfigs) return -1;
  return plan_smem(p, 16 * kConfigMI[p.cfg] * (8 / kConfigWN[p.cfg]),
                   8 * kConfigNI[p.cfg] * kConfigWN[p.cfg]);
}

// Launches the conv of `plan` on `stream` of card `device` (amax first for
// a dynamic scale; the calling thread's current card is restored after);
// returns the first cudaGetLastError() that is not 0, else 0. Does not
// synchronise. Pointers are device pointers: x (N, Cin, H, W) f32 or bf16,
// contiguous, any alignment of its element type; wq (Cout, Cp/32, kh*kw,
// 32) int8, 16-byte aligned; ws (Cout,) f32; a_scale one f32 or null
// (dynamic); partial plan.amax_blocks floats of scratch (dynamic only); out
// (N, Cout, Ho, Wo) f32 or bf16.
extern "C" int conv_int8(const void* plan, const void* x, const void* wq, const void* ws,
                         const void* a_scale, void* partial, void* out, void* stream,
                         int device) {
  const Plan& p = *static_cast<const Plan*>(plan);
  if (!plan_ok(p) || (reinterpret_cast<uintptr_t>(wq) & 15) != 0 ||
      (reinterpret_cast<uintptr_t>(x) & (p.x_bf16 ? 1 : 3)) != 0 ||
      (a_scale == nullptr && partial == nullptr))
    return (int)cudaErrorInvalidValue;
  int current;
  cudaError_t err = cudaGetDevice(&current);
  if (err == cudaSuccess && current != device) err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t st = (cudaStream_t)stream;
  err = p.x_bf16 ? launch<__nv_bfloat16>(p, x, wq, ws, a_scale, partial, out, st)
                 : launch<float>(p, x, wq, ws, a_scale, partial, out, st);
  if (current != device) cudaSetDevice(current);
  return (int)err;
}
