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
//   out[m] = act(bias + sum_{t,s} A_{t,s}[m] @ wst[t][:, block s])
//   A_{t,s}[m] = x[row_t(m + s)] unless s = -1 and m % WB == 0, or
//                s = +1 and m % WB == WB - 1 (then zero)
// where flat row m = a*WB + g of the output reads, for tap t, flat row
// (stride*a + roff[t])*WB + g of the input, and image rows outside
// [0, H_in) are zero: that is the zero padding along frequency, and the
// masked rows are the zero padding along time. x and wst are f32 or bf16;
// out is f32 or bf16.
//
// What bounds it on an H100 SXM (700 W) at the flagship shapes (L = NL =
// 128 everywhere; the largest launch, stg3_full_band_net enc2_conv2, is
// N = 4, H = 512, W = 128, 64 -> 64 channels): the USEFUL work is 19.3
// GFLOP over 134 MB in f32, 67 MB in bf16. In bf16 the bytes bound it,
// narrowly: 0.0201 ms at 3.35 TB/s against 0.0195 ms at the 989 TFLOP/s
// tensor-core peak, so only the tensor cores come near it. In f32 the
// products run as three TF32 products each (below), so the operations bound
// it at that rate: 3 x 19.3 GFLOP over 495 TFLOP/s = 0.117 ms (0.29 ms if
// it were FFMA at 67 TFLOP/s).
//
// Design. Blocks own 128 output rows x BN output lanes (grid: row tiles,
// lane tiles, N) and nothing is carried between them; 4 warps per 64
// lanes, each warp 32 rows x 64 lanes. Tiles: bf16 BK = 32, BN = 128;
// f32 BK = 16, BN = 64 (chosen on the card among 16/32 x 64/128, 2 to 6
// stages, and 32 or 64 rows a warp).
//  * Exact walk of the non-zero blocks: wst is block-sparse by construction
//    (a shifted block holds one source pixel, the centre block a band of
//    three). The host lists, for each lane tile, the (tap, BK-deep K slice)
//    steps of wst that hold a non-zero, each with a mask of the shifts that
//    do (nn/flat_conv_kernel.py `block_table`, built once per packed
//    layer). A block walks only its tile's list; nothing is loaded or
//    multiplied for a zero slice. The table's header names the tile and
//    wst shape it was made for; the wrapper refuses another, and a block
//    that finds one all the same traps.
//  * Shift on the input side: a step stages its input slice once, 130 rows
//    (the tile with a one-row halo each side) x BK lanes, for all shifts;
//    shift s reads it from row offset s + 1 (ldmatrix takes a row address
//    per lane). The m % WB masks zero the masked A rows in registers, so one
//    accumulator set serves all shifts and the epilogue is bias +
//    activation + store.
//  * Staging overlaps the products: a ring of 3 shared-memory stages filled
//    by cp.async 16-byte copies with commit_group / wait_group, the next two
//    steps' copies in flight while the current one is multiplied; one
//    barrier a step. Rows outside the image and the ragged edges of L and
//    NL are zero-filled by cp.async's src-size operand. Widths that are not
//    whole 16-byte chunks (L or NL not a multiple of 8 in bf16, of 4 in
//    f32) take the same ring filled by plain loads.
//  * bf16: mma.sync.m16n8k16 (bf16 in, f32 accumulate), A by ldmatrix, B by
//    ldmatrix.trans. Products of two bf16 values are exact in f32, so only
//    the order of the f32 sum differs from the plain version.
//  * f32: no TF32 rounding of the result: each operand is split into a
//    TF32 high part and a TF32 remainder and mma.sync.m16n8k8 adds hi*hi +
//    hi*lo + lo*hi in f32 (3xTF32). What is lost is lo*lo and the rounding
//    of lo, about 2^-21 of each product: within 1e-4 of the FFMA plain
//    version at the flagship shapes (5.4e-5 at most seen), and the
//    --flat_conv stems stay within 1 LSB of the plain path's. A 3xTF32
//    product costs 1.5x a bf16 one.
// Left for later: wgmma with TMA and a producer warp, a persistent grid,
// and a K tile that follows the band (the packed stg1 layers still
// multiply two to three times their useful work at this granularity).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kBM = 128;         // output rows per block
constexpr int kARows = kBM + 2;  // with the one-row halo on each side

// One stage in shared memory: the input slice [row][k] and three weight
// slices [shift + 1][k][lane], rows padded so that ldmatrix / the fragment
// reads are free of bank conflicts and every row starts on 16 bytes.
// A warp owns 16*kMI = 32 rows x 64 lanes of the tile (64 rows measured
// slower in bf16 and mixed in f32).
template <typename T, int BK, int BN, int STAGES, int CHUNK, int APAD, int BPAD>
struct TileOf {
  static_assert((BN == 64 || BN == 128) && (BK == 16 || BK == 32), "tile");
  static constexpr int MI = 2;
  static constexpr int kBK = BK, kBN = BN, kStages = STAGES, kMI = MI;
  static constexpr int kChunk = CHUNK;  // elements of one 16-byte copy
  static constexpr int kWarpsM = kBM / (16 * MI);
  static constexpr int kThreads = 32 * kWarpsM * (BN / 64);
  static constexpr int kAStride = BK + APAD, kBStride = BN + BPAD;
  static constexpr int kAElems = kARows * kAStride;
  static constexpr int kStageElems = kAElems + 3 * BK * kBStride;
  static constexpr size_t kSmemBytes = sizeof(T) * kStageElems * STAGES;
  // input chunks a thread stages per step, and weight chunks of one shift
  static constexpr int kALoads = (kARows * (BK / CHUNK) + kThreads - 1) / kThreads;
  static constexpr int kBLoads = BK * (BN / CHUNK) / kThreads;
  static_assert(BK * (BN / CHUNK) % kThreads == 0, "weight slice");
};
template <typename T> struct Tile;
// The tiles per input type (BK, BN, stages), measured best on the card;
// nn/flat_conv_kernel.py TILES must equal them (its loader checks).
template <>
struct Tile<__nv_bfloat16> : TileOf<__nv_bfloat16, 32, 128, 3, 8, 8, 8> {};
// B rows 8 words past a multiple of 32 for the TF32 fragment reads
template <>
struct Tile<float> : TileOf<float, 16, 64, 3, 4, 4, 8> {};

struct Geometry {
  int h_in, h_out, wb, l_in, nl, stride, ns, s0, n_tiles, n_rt;
  int roff0, roff1, roff2;
  int act;  // 0 none, 1 relu, 2 leaky_relu(0.01)
  int vec;  // L and NL are whole 16-byte chunks: stage with cp.async
};

// A step of the walk: tap (2 bits), K slice, shift mask (bit b: shift b-1)
__device__ __forceinline__ int step_tap(int code) { return code & 3; }
__device__ __forceinline__ int step_ks(int code) { return (code >> 2) & 0x7ffffff; }
__device__ __forceinline__ int step_mask(int code) { return (code >> 29) & 7; }

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(ok ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ float activate(float y, int act) {
  if (act == 1) y = fmaxf(y, 0.0f);
  if (act == 2) y = y >= 0.0f ? y : 0.01f * y;
  return y;
}
__device__ __forceinline__ void store1(float* p, float v) { *p = v; }
__device__ __forceinline__ void store1(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}
__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// Per-thread staging state: the source of each input chunk the thread
// copies (its halo row's image row a and position g are fixed for the
// block; the tap only moves the image row).
template <typename T>
struct Stager {
  static constexpr int kC = Tile<T>::kChunk;
  static constexpr int kCpr = Tile<T>::kBK / kC;  // chunks per staged row
  int a[Tile<T>::kALoads];
  int g[Tile<T>::kALoads];

  __device__ void init(int m0, int m_out, int wb) {
#pragma unroll
    for (int u = 0; u < Tile<T>::kALoads; ++u) {
      const int i = threadIdx.x + u * Tile<T>::kThreads;
      const int r = i / kCpr;
      const int mp = m0 - 1 + r;
      a[u] = -1 << 20;  // no such row: reads as zero
      g[u] = 0;
      if (r < kARows && mp >= 0 && mp < m_out) {
        a[u] = mp / wb;
        g[u] = mp - a[u] * wb;
      }
    }
  }

  // Stage step `code` into stage buffer `st`.
  __device__ void load(T* st, int code, const T* __restrict__ xi,
                       const T* __restrict__ wst, int n0, const Geometry& q) const {
    const int t = step_tap(code);
    const int k0 = step_ks(code) * Tile<T>::kBK;
    const int mask = step_mask(code);
    const int roff = t == 0 ? q.roff0 : (t == 1 ? q.roff1 : q.roff2);
    T* as = st;
    T* bs = st + Tile<T>::kAElems;
#pragma unroll
    for (int u = 0; u < Tile<T>::kALoads; ++u) {
      const int i = threadIdx.x + u * Tile<T>::kThreads;
      const int r = i / kCpr;
      const int c = (i - r * kCpr) * kC;
      if (r >= kARows) continue;
      const int row = q.stride * a[u] + roff;
      const bool in = row >= 0 && row < q.h_in;
      const size_t off = in ? ((size_t)row * q.wb + g[u]) * q.l_in + k0 + c : 0;
      T* dst = as + r * Tile<T>::kAStride + c;
      if (q.vec) {
        const bool ok = in && k0 + c < q.l_in;
        cp_async16(dst, ok ? xi + off : xi, ok);
      } else {
#pragma unroll
        for (int e = 0; e < kC; ++e)
          dst[e] = in && k0 + c + e < q.l_in ? xi[off + e] : T(0.0f);
      }
    }
    const size_t wcols = (size_t)q.ns * q.nl;
#pragma unroll
    for (int b = 0; b < 3; ++b) {
      if (!(mask & (1 << b))) continue;
      const int js = b - 1 - q.s0;  // column block of shift b - 1 in wst
#pragma unroll
      for (int u = 0; u < Tile<T>::kBLoads; ++u) {
        const int i = threadIdx.x + u * Tile<T>::kThreads;
        const int kr = i / (Tile<T>::kBN / kC);
        const int c = (i - kr * (Tile<T>::kBN / kC)) * kC;
        const int k = k0 + kr;
        const size_t off =
            ((size_t)t * q.l_in + k) * wcols + (size_t)js * q.nl + n0 + c;
        T* dst = bs + (b * Tile<T>::kBK + kr) * Tile<T>::kBStride + c;
        if (q.vec) {
          const bool ok = k < q.l_in && n0 + c < q.nl;
          cp_async16(dst, ok ? wst + off : wst, ok);
        } else {
#pragma unroll
          for (int e = 0; e < kC; ++e)
            dst[e] = k < q.l_in && n0 + c + e < q.nl ? wst[off + e] : T(0.0f);
        }
      }
    }
  }
};

// A walk table opens with kHeader ints: the tile (BK, BN) and wst's shape
// (taps, L, S*NL) it was made for (nn/flat_conv_kernel.py HEADER).
constexpr int kHeader = 5;

// The block's walk: its lane tile's list of steps in `tbl` (the header,
// then n_tiles + 1 offsets, then the step codes).
struct Walk {
  const int* codes;
  int n;
  __device__ Walk(const int* tbl, int n_tiles, int tile) {
    const int* off = tbl + kHeader;
    const int lo = __ldg(off + tile), hi = __ldg(off + tile + 1);
    codes = off + n_tiles + 1 + lo;
    n = hi - lo;
  }
  __device__ int operator[](int i) const { return __ldg(codes + i); }
};

// The wrapper refuses a table made for another tile or wst; a table that
// gets here all the same stops the kernel rather than walk wrong blocks.
template <typename T>
__device__ __forceinline__ void check_table(const int* tbl, const Geometry& q) {
  if (__ldg(tbl) != Tile<T>::kBK || __ldg(tbl + 1) != Tile<T>::kBN ||
      __ldg(tbl + 2) != q.n_rt || __ldg(tbl + 3) != q.l_in ||
      __ldg(tbl + 4) != q.ns * q.nl) {
    __trap();
  }
}

// ----------------------------------------------- tensor-core products --

__device__ __forceinline__ void ldmatrix_x4(unsigned (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}
__device__ __forceinline__ void ldmatrix_x4_trans(unsigned (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}
__device__ __forceinline__ void mma_bf16(float (&d)[4], const unsigned (&a)[4],
                                         unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
__device__ __forceinline__ void mma_tf32(float (&d)[4], const unsigned (&a)[4],
                                         unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
// x = hi + lo with both parts TF32 (10-bit mantissas): hi*hi + hi*lo +
// lo*hi recovers the f32 product but for the lo*lo term and the rounding of
// lo, about 2^-21 of it
__device__ __forceinline__ void split_tf32(float x, unsigned& hi, unsigned& lo) {
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(hi) : "f"(x));
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(lo) : "f"(x - __uint_as_float(hi)));
}

// Zero the A rows of shift b - 1 that the m % WB masks drop. Fragment
// registers 0 and 2 hold row lane/4 of the m16 tile, 1 and 3 row lane/4 + 8;
// keep bit 2*mi + h (shift -1) or 8 + 2*mi + h (shift +1) says a row stays.
template <int MI>
__device__ __forceinline__ void mask_rows(unsigned (&af)[MI][4], int b, unsigned keep) {
  if (b == 1) return;
  const unsigned k = keep >> (b == 0 ? 0 : 8);
#pragma unroll
  for (int mi = 0; mi < MI; ++mi) {
    if (!((k >> (2 * mi)) & 1)) af[mi][0] = af[mi][2] = 0u;
    if (!((k >> (2 * mi + 1)) & 1)) af[mi][1] = af[mi][3] = 0u;
  }
}

// One shift's products of one staged step, bf16: m16n8k16, A by ldmatrix
// from staged row (row of the warp) + b, B by ldmatrix.trans.
__device__ __forceinline__ void mma_step(float (&acc)[Tile<__nv_bfloat16>::kMI][8][4],
                                         const __nv_bfloat16* as,
                                         const __nv_bfloat16* bs, int b, int wm,
                                         int wn, int lane, unsigned keep) {
  using TL = Tile<__nv_bfloat16>;
  constexpr int MI = TL::kMI;
#pragma unroll
  for (int k16 = 0; k16 < TL::kBK; k16 += 16) {
    unsigned af[MI][4];
#pragma unroll
    for (int mi = 0; mi < MI; ++mi)
      ldmatrix_x4(af[mi], as + (wm * 16 * MI + mi * 16 + lane % 16 + b) * TL::kAStride +
                              k16 + (lane / 16) * 8);
    mask_rows(af, b, keep);
#pragma unroll
    for (int np = 0; np < 4; ++np) {
      unsigned bf[4];
      ldmatrix_x4_trans(bf, bs + (b * TL::kBK + k16 + lane % 16) * TL::kBStride +
                                wn * 64 + np * 16 + (lane / 16) * 8);
#pragma unroll
      for (int mi = 0; mi < MI; ++mi) {
        mma_bf16(acc[mi][2 * np], af[mi], bf[0], bf[1]);
        mma_bf16(acc[mi][2 * np + 1], af[mi], bf[2], bf[3]);
      }
    }
  }
}

// f32 as three TF32 products: m16n8k8; A by ldmatrix (a 16-byte row of
// 8x8 b16 is 4 f32), B fragments (k = lane%4 (+4), n = lane/4) read one
// word each, conflict-free at a row stride of 8 words past a multiple of 32.
__device__ __forceinline__ void mma_step(float (&acc)[Tile<float>::kMI][8][4],
                                         const float* as, const float* bs, int b,
                                         int wm, int wn, int lane, unsigned keep) {
  using TL = Tile<float>;
  constexpr int MI = TL::kMI;
#pragma unroll
  for (int k8 = 0; k8 < TL::kBK; k8 += 8) {
    unsigned af[MI][4], ah[MI][4], al[MI][4];
#pragma unroll
    for (int mi = 0; mi < MI; ++mi)
      ldmatrix_x4(af[mi], as + (wm * 16 * MI + mi * 16 + lane % 16 + b) * TL::kAStride +
                              k8 + (lane / 16) * 4);
    mask_rows(af, b, keep);
#pragma unroll
    for (int mi = 0; mi < MI; ++mi)
#pragma unroll
      for (int e = 0; e < 4; ++e) split_tf32(__uint_as_float(af[mi][e]), ah[mi][e], al[mi][e]);
    const float* bp = bs + (b * TL::kBK + k8 + lane % 4) * TL::kBStride + wn * 64 + lane / 4;
#pragma unroll
    for (int ni = 0; ni < 8; ++ni) {
      unsigned bh0, bl0, bh1, bl1;
      split_tf32(bp[ni * 8], bh0, bl0);
      split_tf32(bp[4 * TL::kBStride + ni * 8], bh1, bl1);
#pragma unroll
      for (int mi = 0; mi < MI; ++mi) {
        mma_tf32(acc[mi][ni], al[mi], bh0, bh1);
        mma_tf32(acc[mi][ni], ah[mi], bl0, bl1);
        mma_tf32(acc[mi][ni], ah[mi], bh0, bh1);
      }
    }
  }
}

template <typename T, typename TOut>
__global__ void __launch_bounds__(Tile<T>::kThreads)
flat_conv_mma(const T* __restrict__ x, const T* __restrict__ wst,
              const float* __restrict__ bias, const int* __restrict__ tbl,
              TOut* __restrict__ out, Geometry q) {
  using TL = Tile<T>;
  constexpr int MI = TL::kMI;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* smem = reinterpret_cast<T*>(smem_raw);

  const int lane = threadIdx.x % 32;
  const int wm = threadIdx.x / 32 % TL::kWarpsM;  // 16*MI-row slab of the tile
  const int wn = threadIdx.x / 32 / TL::kWarpsM;  // 64-lane slab of the tile
  const int m0 = blockIdx.x * kBM;
  const int n0 = blockIdx.y * TL::kBN;
  const int m_out = q.h_out * q.wb;
  const T* xi = x + (size_t)blockIdx.z * q.h_in * q.wb * q.l_in;
  check_table<T>(tbl, q);
  const Walk walk(tbl, q.n_tiles, blockIdx.y);

  // keep bits of this thread's 2*MI A rows (m16 tile mi, half h: row
  // wm*16*MI + mi*16 + h*8 + lane/4) for shift -1 (bits 0..) and +1 (8..)
  unsigned keep = 0;
#pragma unroll
  for (int j = 0; j < 2 * MI; ++j) {
    const int m = m0 + wm * 16 * MI + (j / 2) * 16 + (j % 2) * 8 + lane / 4;
    const int gpos = m % q.wb;
    keep |= (unsigned)(gpos != 0) << j;
    keep |= (unsigned)(gpos != q.wb - 1) << (8 + j);
  }

  float acc[MI][8][4];
#pragma unroll
  for (int mi = 0; mi < MI; ++mi)
#pragma unroll
    for (int ni = 0; ni < 8; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0.0f;

  Stager<T> stager;
  stager.init(m0, m_out, q.wb);
#pragma unroll
  for (int s = 0; s < TL::kStages - 1; ++s) {
    if (s < walk.n) stager.load(smem + s * TL::kStageElems, walk[s], xi, wst, n0, q);
    cp_async_commit();
  }
  for (int i = 0; i < walk.n; ++i) {
    cp_async_wait<TL::kStages - 2>();
    __syncthreads();
    const int nxt = i + TL::kStages - 1;
    if (nxt < walk.n)
      stager.load(smem + (nxt % TL::kStages) * TL::kStageElems, walk[nxt], xi, wst,
                  n0, q);
    cp_async_commit();

    const T* as = smem + (i % TL::kStages) * TL::kStageElems;
    const T* bs = as + TL::kAElems;
    const int mask = step_mask(walk[i]);
#pragma unroll
    for (int b = 0; b < 3; ++b)
      if (mask & (1 << b)) mma_step(acc, as, bs, b, wm, wn, lane, keep);
  }
  cp_async_wait<0>();

  // accumulator e of (mi, ni): row lane/4 (+8 for e >= 2), lanes
  // (lane%4)*2 + e%2 of the n8 tile
  const bool pairs = q.nl % 2 == 0;
#pragma unroll
  for (int mi = 0; mi < MI; ++mi) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = m0 + wm * 16 * MI + mi * 16 + h * 8 + lane / 4;
      if (m >= m_out) continue;
      TOut* o = out + ((size_t)blockIdx.z * m_out + m) * q.nl;
#pragma unroll
      for (int ni = 0; ni < 8; ++ni) {
        const int col = n0 + wn * 64 + ni * 8 + (lane % 4) * 2;
        if (col >= q.nl) continue;
        const float v0 = activate(acc[mi][ni][2 * h] + bias[col], q.act);
        if (col + 1 < q.nl) {
          const float v1 = activate(acc[mi][ni][2 * h + 1] + bias[col + 1], q.act);
          if (pairs) {
            store2(o + col, v0, v1);
          } else {
            store1(o + col, v0);
            store1(o + col + 1, v1);
          }
        } else {
          store1(o + col, v0);
        }
      }
    }
  }
}

template <typename TIn, typename TOut>
cudaError_t launch(void (*kernel)(const TIn*, const TIn*, const float*, const int*, TOut*,
                                  Geometry),
                   dim3 grid, cudaStream_t stream, const void* x, const void* wst,
                   const float* bias, const int* tbl, void* out, const Geometry& q) {
  constexpr size_t smem = Tile<TIn>::kSmemBytes;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kernel<<<grid, Tile<TIn>::kThreads, smem, stream>>>(
      static_cast<const TIn*>(x), static_cast<const TIn*>(wst), bias, tbl,
      static_cast<TOut*>(out), q);
  return cudaGetLastError();
}

}  // namespace

// The tile the kernel walks for an input type (TILES of
// nn/flat_conv_kernel.py).
extern "C" int flat_conv_block_k(int in_bf16) {
  return in_bf16 ? Tile<__nv_bfloat16>::kBK : Tile<float>::kBK;
}
extern "C" int flat_conv_block_n(int in_bf16) {
  return in_bf16 ? Tile<__nv_bfloat16>::kBN : Tile<float>::kBN;
}

// Ints of a walk table's header (HEADER of nn/flat_conv_kernel.py).
extern "C" int flat_conv_table_header() { return kHeader; }

// Launches on `stream`; returns cudaGetLastError() after the launch (0 when
// the launch was accepted). Does not synchronise. Pointers are device
// pointers to contiguous arrays; x and wst share one type (in_bf16). `tbl`
// is the walk (header, n_tiles + 1 offsets, then the step codes) that
// nn/flat_conv_kernel.py `block_table` builds for this wst.
extern "C" int flat_conv(const void* x, const void* wst, const void* bias,
                         const int* tbl, void* out, int n, int h_in, int h_out,
                         int wb, int l_in, int nl, int stride, int n_rt, int roff0,
                         int roff1, int roff2, int s0, int ns, int act, int in_bf16,
                         int out_bf16, void* stream) {
  const int bn = flat_conv_block_n(in_bf16);
  const int n_tiles = (nl + bn - 1) / bn;
  if (n <= 0 || h_in <= 0 || h_out <= 0 || wb <= 0 || l_in <= 0 || nl <= 0 ||
      n_rt < 1 || n_rt > 3 || stride < 1 || stride > 2 || act < 0 || act > 2 ||
      ns < 1 || ns > 3 || s0 < -1 || s0 > 0 || s0 + ns - 1 > 1 || n > 65535 ||
      n_tiles > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  const int chunk = in_bf16 ? 8 : 4;
  const int vec = l_in % chunk == 0 && nl % chunk == 0;
  const Geometry q{h_in, h_out, wb, l_in, nl, stride, ns, s0, n_tiles, n_rt,
                   roff0, roff1, roff2, act, vec};
  const dim3 grid((h_out * wb + kBM - 1) / kBM, n_tiles, n);
  const float* b = static_cast<const float*>(bias);
  cudaStream_t st = (cudaStream_t)stream;
  using bf16 = __nv_bfloat16;
  cudaError_t err;
  if (in_bf16) {
    err = out_bf16 ? launch(flat_conv_mma<bf16, bf16>, grid, st, x, wst, b, tbl, out, q)
                   : launch(flat_conv_mma<bf16, float>, grid, st, x, wst, b, tbl, out, q);
  } else {
    err = out_bf16 ? launch(flat_conv_mma<float, bf16>, grid, st, x, wst, b, tbl, out, q)
                   : launch(flat_conv_mma<float, float>, grid, st, x, wst, b, tbl, out, q);
  }
  return (int)err;
}
