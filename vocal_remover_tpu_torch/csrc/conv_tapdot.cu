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
// accumulation. What makes it variant D: the block stages ONE copy of its
// input tile (with a 1-pixel halo), the counterpart of the TPU kernel's `xt`,
// and runs nine accumulating K = Cin products, one per tap, each reading its
// B operand from that tile at the tap's (dy, dx) offset. No im2col (variant
// A), no output-side alignment (variant C), no per-tap or per-dx copy.
//
// What bounds it on an H100 SXM (700 W) at the lab's shapes, (8, 32, 1024,
// 256) and (8, 64, 512, 128), Cout = Cin: 38.655 GFLOP each. bf16 is bound by
// bytes (268.45 / 134.29 MB: 0.0801 / 0.0401 ms at 3.35 TB/s; the operations
// take 0.0391 ms at the 989 TFLOP/s tensor-core peak); only the tensor cores
// come near either. f32 multiplies as three TF32 products (below), so its
// operations bound it at that rate: 3 x 38.655 GFLOP over 495 TFLOP/s =
// 0.2343 ms (0.5769 ms at the 67 TFLOP/s FFMA rate).
//
// Design: per tap one GEMM on the tensor cores, Cout the M dimension, output
// pixels the N dimension, K = Cin.
//  * A block owns kBM = 32 output channels x kTH = 8 rows x kTW = 64 columns
//    of one image and walks a strip of row tiles (the strip that ends the
//    grid in the fewest waves); 8 warps, each two output rows x 32 columns
//    (four n8 tiles) x all 32 channels (two m16 tiles). Nothing is carried
//    between blocks.
//  * The alignment trap. NCHW keeps columns innermost, and ldmatrix takes
//    16-byte row addresses: a B view shifted by dx - 1 = +-1 column of a
//    [ci][column] tile is 2 bytes off in bf16. So the input is staged
//    CHANNEL-INNERMOST, [row][column][channel] (64 bytes of channels a pixel:
//    32 bf16 or 16 f32, padded to 80 bytes): a tap's (dy, dx) offset is then
//    a whole-pixel offset, at any dx, and each ldmatrix row (one pixel, 8
//    channels) stays 16-byte aligned. The 80-byte pixel stride (an odd number
//    of 16-byte units) keeps the ldmatrix phases and the f32 word reads free
//    of bank conflicts. One layout serves both types: a tile is 67.2 KB.
//  * cp.async cannot transpose, so the input goes through registers: each
//    thread loads half its items of the NEXT step's tile (kV channels x kV
//    columns, one 16-byte load a channel row) before the products of half
//    the current step's channels and writes them after them, transposed
//    (byte permutes in bf16, a register reorder in f32), one 16-byte store a
//    pixel, into the other of two shared-memory buffers: the loads are in
//    flight while the tensor cores run. The staged window starts kHalo = 8
//    columns left of the block, so every load is a whole aligned chunk, zero
//    outside the image and past Cin; widths that are not whole chunks, or an
//    input whose address is not 16-byte aligned, take plain loads into the
//    same registers.
//  * Weights as in variant C: [tap][ci][co] straight from w2's rows (16-byte
//    cp.async copies, plain loads when Cout is not whole chunks or w2 not
//    aligned), A fragments by ldmatrix.trans; resident across the strip when
//    all chunks fit beside the two input buffers (the lab's shapes), else
//    streamed with the input, chunk by chunk (chosen at run time).
//  * Products: bf16 on mma.sync.m16n8k16, B fragments by (non-transposed)
//    ldmatrix from the [pixel][channel] tile. Per k16 and dx a warp holds the
//    A fragments of the three dy and reads each of its four staged rows
//    once: staged row sr feeds output row sr - dy for every dy, so a warp
//    loads 14 fragments for 48 products. f32 as 3xTF32 on m16n8k8 (hi*hi +
//    hi*lo + lo*hi in f32, as csrc/conv_shift.cu), fragments read as words;
//    each k8's three products are summed apart and added to the accumulator
//    by an f32 add, since the tensor cores' own additions truncate.
//  * Epilogue: bias, activation and the cast into an output tile in shared
//    memory (the step's input buffer, read by then), then one bulk copy
//    (cp.async.bulk, the TMA's 1-D form) a channel row to device memory,
//    which runs on while the block computes the next row tile; plain stores
//    where the row is ragged or not aligned. Cout below the tile and rows
//    past H are masked there.
// Left for later: warp specialisation, so that the staging and the epilogue
// overlap the products instead of running between barriers; wgmma.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

namespace {

constexpr int kWR = 4;   // warps along rows (two output rows each)
constexpr int kWC = 2;   // warps along columns
constexpr int kRW = 2;   // output rows a warp
constexpr int kNT = 4;   // output n8 tiles a warp
constexpr int kMT = 2;   // m16 tiles a warp: all of the block's channels
constexpr int kStrip = 16;  // most row tiles a block walks
constexpr int kWarps = kWR * kWC;
constexpr int kThreads = 32 * kWarps;
constexpr int kBM = 16 * kMT;        // output channels a block
constexpr int kTH = kRW * kWR;       // output rows a row tile
constexpr int kTW = 8 * kNT * kWC;   // output columns a block
constexpr int kHalo = 8;             // staged columns left and right of the block
constexpr int kSR = kTH + 2;         // staged rows
constexpr int kSW = kTW + 2 * kHalo; // staged columns
constexpr int kSC = kSW + 4;         // pixels a staged row (see store_x)
constexpr int kPW = 20;              // words a staged pixel: 16 of channels, 80 bytes
constexpr int kWS = kBM + 8;         // elements a weight row (80 bytes in bf16)
constexpr int kXWords = kSR * kSC * kPW;
static_assert(kNT % 2 == 0, "B fragments are loaded two n8 tiles at a time");
static_assert(kSR % 2 == 0, "staging items pair the staged rows");
constexpr size_t kSmemMax = 227 * 1024;  // dynamic shared memory of a block

template <typename T> struct Cfg {
  static constexpr int kKC = 64 / sizeof(T);          // channels a chunk (64 bytes a pixel)
  static constexpr int kV = 16 / sizeof(T);           // elements of one 16-byte load or copy
  static constexpr int kWElems = 9 * kKC * kWS;       // [tap][ci][co] of a chunk
  static constexpr int kXElems = kXWords * 4 / sizeof(T);
  // staging items: (staged row, kV-column chunk, group of kV channels)
  static constexpr int kItems = kSR * (kSW / kV) * (kKC / kV);
  static constexpr int kPerThread = (kItems + kThreads - 1) / kThreads;
  static constexpr int kHalf = kPerThread / 2;  // items in flight beside half the products
  static_assert(kPerThread % 2 == 0, "the staging splits into two halves");
};

struct Shape {
  int cin, h, w, cout, act;
  int n_ct, n_rt, strip;  // Cout tiles, row tiles, row tiles a block
  int xvec, wvec, ovec;   // rows of x / w2 / out in aligned 16-byte chunks
};

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
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::);
}
// Bulk copy (the Tensor Memory Accelerator's 1-D form) of `bytes` (a
// multiple of 16, both ends 16-byte aligned) from shared to device memory,
// in the thread's bulk group; the fence makes the block's earlier shared
// stores visible to it.
__device__ __forceinline__ void bulk_store(void* dst, const void* src, int bytes) {
  asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n" ::"l"(dst),
               "r"(smem_addr(src)), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void bulk_wait_read() {  // its sources may be overwritten
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}
__device__ __forceinline__ void bulk_wait_all() {
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}
__device__ __forceinline__ void fence_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
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

__device__ __forceinline__ float activate(float y, int act) {
  if (act == 1) y = fmaxf(y, 0.0f);
  if (act == 2) y = y >= 0.0f ? y : 0.01f * y;
  return y;
}
__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}
__device__ __forceinline__ unsigned word(const uint4& u, int k) {
  return k == 0 ? u.x : k == 1 ? u.y : k == 2 ? u.z : u.w;
}
__device__ __forceinline__ unsigned short bits(__nv_bfloat16 v) { return __bfloat16_as_ushort(v); }
__device__ __forceinline__ unsigned bits(float v) { return __float_as_uint(v); }

// Half of a thread's share of the next step's input tile, in registers
// between the load from device memory and the store to shared memory: per
// item, kV channels x kV columns (one 16-byte row of NCHW per channel).
template <typename T>
struct XRegs {
  uint4 v[Cfg<T>::kHalf][Cfg<T>::kV];
};

// Item i of a step's staging: channel group i % 4, staged row parity (i / 4)
// % 2, column chunk, row pair. The eight lanes of a 16-byte shared store
// phase then cover four channel groups of two rows of one chunk.
template <typename T>
struct Item {
  int grp, sr, cc;
  __device__ __forceinline__ explicit Item(int i) {
    constexpr int kChunks = kSW / Cfg<T>::kV;
    grp = i % 4;
    cc = i / 8 % kChunks;
    sr = i / (8 * kChunks) * 2 + i / 4 % 2;
  }
};

// Load half `half` of the thread's items of the step's input (row tile
// starting at r0, channels ci0 ..., staged columns c0 - kHalo ...) into
// registers.
template <typename T>
__device__ __forceinline__ void load_x(XRegs<T>& rg, int half, const T* __restrict__ xi, int r0,
                                       int ci0, int c0, const Shape& q) {
  using C = Cfg<T>;
  constexpr int V = C::kV;
#pragma unroll
  for (int it = 0; it < C::kHalf; ++it) {
    const int i = threadIdx.x + (half * C::kHalf + it) * kThreads;
    const Item<T> m(i);
    const int gr = r0 - 1 + m.sr, gc = c0 - kHalo + m.cc * V, ch = ci0 + m.grp * V;
    const bool row_ok = i < C::kItems && gr >= 0 && gr < q.h;
    const T* row = xi + (row_ok ? ((size_t)ch * q.h + gr) * q.w : 0);
    const size_t plane = (size_t)q.h * q.w;
    if (q.xvec) {  // a chunk lies all inside the image or all out
      const bool in = row_ok && gc >= 0 && gc < q.w;
#pragma unroll
      for (int c = 0; c < V; ++c)
        rg.v[it][c] = in && ch + c < q.cin
                          ? __ldg(reinterpret_cast<const uint4*>(row + c * plane + gc))
                          : make_uint4(0u, 0u, 0u, 0u);
    } else {
#pragma unroll
      for (int c = 0; c < V; ++c) {
        unsigned e[4] = {0u, 0u, 0u, 0u};
#pragma unroll
        for (int k = 0; k < V; ++k) {
          const int col = gc + k;
          const unsigned b = row_ok && ch + c < q.cin && col >= 0 && col < q.w
                                 ? bits(row[c * plane + col]) : 0u;
          e[k * (int)sizeof(T) / 4] |= b << (8 * (k * (int)sizeof(T) % 4));
        }
        rg.v[it][c] = make_uint4(e[0], e[1], e[2], e[3]);
      }
    }
  }
}

// Column k of the kV channels of an item as one 16-byte pixel word group:
// bf16 pairs channels (2m, 2m + 1) into word m, f32 takes channel m's word.
__device__ __forceinline__ uint4 pixel(const uint4 (&v)[8], int k) {
  const int sel = k % 2 ? 0x7632 : 0x5410;
  uint4 r;
  r.x = __byte_perm(word(v[0], k / 2), word(v[1], k / 2), sel);
  r.y = __byte_perm(word(v[2], k / 2), word(v[3], k / 2), sel);
  r.z = __byte_perm(word(v[4], k / 2), word(v[5], k / 2), sel);
  r.w = __byte_perm(word(v[6], k / 2), word(v[7], k / 2), sel);
  return r;
}
__device__ __forceinline__ uint4 pixel(const uint4 (&v)[4], int k) {
  return make_uint4(word(v[0], k), word(v[1], k), word(v[2], k), word(v[3], k));
}

// Write the registers of `load_x` into the [row][pixel][channel] tile `xs`,
// one 16-byte store a pixel. A store phase's eight lanes hit 16-byte units
// 5 * pixel + group + 4 * row (mod 8: kSC = 84 pixels make a row 4 units
// past a multiple of 8): all eight differ, free of bank conflicts.
template <typename T>
__device__ __forceinline__ void store_x(unsigned* xs, const XRegs<T>& rg, int half) {
  using C = Cfg<T>;
  constexpr int V = C::kV;
#pragma unroll
  for (int it = 0; it < C::kHalf; ++it) {
    const int i = threadIdx.x + (half * C::kHalf + it) * kThreads;
    if (i >= C::kItems) break;
    const Item<T> m(i);
    unsigned* dst = xs + (m.sr * kSC + m.cc * V) * kPW + m.grp * 4;
#pragma unroll
    for (int k = 0; k < V; ++k)
      *reinterpret_cast<uint4*>(dst + k * kPW) = pixel(rg.v[it], k);
  }
}

// Stage the weights of channels ci0 ... (all nine taps) into `ws`.
template <typename T>
__device__ void stage_w(T* ws, const T* __restrict__ w2, int ci0, int m0, const Shape& q) {
  constexpr int CH = Cfg<T>::kV;
  constexpr int KC = Cfg<T>::kKC;
  constexpr int kWRow = kBM / CH;
  for (int i = threadIdx.x; i < 9 * KC * kWRow; i += kThreads) {
    const int cc = i % kWRow;
    const int k = (i / kWRow) % KC;
    const int tap = i / (kWRow * KC);  // dy * 3 + dx, w2's row block
    const int ci = ci0 + k, co = m0 + cc * CH;
    const T* src = w2 + ((size_t)tap * q.cin + (ci < q.cin ? ci : 0)) * q.cout;
    T* dst = ws + (tap * KC + k) * kWS + cc * CH;
    if (q.wvec) {
      const bool ok = ci < q.cin && co < q.cout;
      cp_async16(dst, ok ? src + co : w2, ok);
    } else {
#pragma unroll
      for (int e = 0; e < CH; ++e)
        dst[e] = ci < q.cin && co + e < q.cout ? src[co + e] : T(0.0f);
    }
  }
}

using Acc = float[kRW][kMT][kNT][4];

// The nine tap products of one half of a staged step's channels (one k16),
// bf16. Per dx the A fragments of the three dy (two m16 tiles each, ldmatrix.trans from
// [k][co]) are held, and each of the warp's kRW + 2 staged rows is read
// once at the tap's column offset (ldmatrix, two n8 tiles x 16 channels at
// a time): staged row sr serves output row sr - dy for every dy that lands
// in the warp's rows.
__device__ __forceinline__ void half_products(Acc& acc, const __nv_bfloat16* xs,
                                              const __nv_bfloat16* ws, int half, int wr, int wc,
                                              int lane) {
  using T = __nv_bfloat16;
  constexpr int KC = Cfg<T>::kKC;
  constexpr int PS = kPW * 2;  // elements a staged pixel
  static_assert(KC == 32, "a half of the chunk is one k16");
  const int k16 = half * 16;
#pragma unroll
  for (int dx = 0; dx < 3; ++dx) {
    unsigned af[3][kMT][4];
#pragma unroll
    for (int dy = 0; dy < 3; ++dy)
#pragma unroll
      for (int mi = 0; mi < kMT; ++mi)
        ldmatrix_x4_trans(af[dy][mi], ws + ((dy * 3 + dx) * KC + k16 + (lane / 16) * 8 +
                                            lane % 8) * kWS + mi * 16 + (lane / 8 % 2) * 8);
    const T* xb = xs + ((kRW * wr) * kSC + kHalo - 1 + dx + wc * kNT * 8 + (lane / 16) * 8 +
                        lane % 8) * PS + k16 + (lane / 8 % 2) * 8;
#pragma unroll
    for (int sr = 0; sr < kRW + 2; ++sr) {
#pragma unroll
      for (int pc = 0; pc < kNT / 2; ++pc) {
        unsigned bf[4];
        ldmatrix_x4(bf, xb + (sr * kSC + pc * 16) * PS);
#pragma unroll
        for (int dy = 0; dy < 3; ++dy) {
          const int r = sr - dy;  // the output row this tap feeds
          if (r < 0 || r >= kRW) continue;
#pragma unroll
          for (int mi = 0; mi < kMT; ++mi) {
            mma_bf16(acc[r][mi][2 * pc], af[dy][mi], bf[0], bf[1]);
            mma_bf16(acc[r][mi][2 * pc + 1], af[dy][mi], bf[2], bf[3]);
          }
        }
      }
    }
  }
}

// f32, the nine tap products of one half of a staged step's channels (one
// k8), as three TF32 products: per tap, A fragments (row co, column k) read
// as words from [k][co], B fragments (k = t (+4), column g) as words from
// the tile at the tap's offset, split into TF32 high and low parts.
__device__ __forceinline__ void half_products(Acc& acc, const float* xs, const float* ws,
                                              int half, int wr, int wc, int lane) {
  constexpr int KC = Cfg<float>::kKC;
  static_assert(KC == 16, "a half of the chunk is one k8");
  const int g = lane / 4, tq = lane % 4;
  const int k8 = half * 8;
#pragma unroll 1  // unrolled, the taps' loads crowd out the registers and spill
  for (int t = 0; t < 9; ++t) {
    const int dy = t / 3, dx = t % 3;
    unsigned ahi[kMT][4], alo[kMT][4];
#pragma unroll
    for (int mi = 0; mi < kMT; ++mi) {
      const float* wp = ws + (t * KC + k8 + tq) * kWS + mi * 16 + g;
      split_tf32(wp[0], ahi[mi][0], alo[mi][0]);
      split_tf32(wp[8], ahi[mi][1], alo[mi][1]);
      split_tf32(wp[4 * kWS], ahi[mi][2], alo[mi][2]);
      split_tf32(wp[4 * kWS + 8], ahi[mi][3], alo[mi][3]);
    }
#pragma unroll
    for (int r = 0; r < kRW; ++r) {
      const float* xb =
          xs + ((kRW * wr + r + dy) * kSC + kHalo - 1 + dx + wc * kNT * 8 + g) * kPW + k8 + tq;
#pragma unroll
      for (int j = 0; j < kNT; ++j) {
        unsigned bh0, bl0, bh1, bl1;
        split_tf32(xb[j * 8 * kPW], bh0, bl0);
        split_tf32(xb[j * 8 * kPW + 4], bh1, bl1);
#pragma unroll
        for (int mi = 0; mi < kMT; ++mi) {
          // the tensor cores add with truncation: summed straight into
          // acc, its bias grows with Cin past the 1e-4 of the plain
          // version; a k8's three products go to a fresh partial sum,
          // added to acc in f32
          float part[4] = {0.0f, 0.0f, 0.0f, 0.0f};
          mma_tf32(part, alo[mi], bh0, bh1);
          mma_tf32(part, ahi[mi], bl0, bl1);
          mma_tf32(part, ahi[mi], bh0, bh1);
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[r][mi][j][e] += part[e];
        }
      }
    }
  }
}

// The output tile [co][row][column] in shared memory (it takes the place of
// the step's input tile once that is read), kOS words a channel: a row is
// kTW columns, and a channel kTH rows plus 2 * sizeof(TOut) words, so that
// the fragment stores of a warp (one 4-byte pair a lane in bf16, one 8-byte
// pair in f32) are free of bank conflicts.
template <typename TOut> struct Out {
  static constexpr int kRowW = kTW * (int)sizeof(TOut) / 4;  // words a row
  static constexpr int kOS = kTH * kRowW + 2 * (int)sizeof(TOut);
  static constexpr int kV = 16 / (int)sizeof(TOut);          // elements a 16-byte store
  static_assert(kBM * kOS <= kXWords, "the output tile fits in an input tile");
  static_assert(kOS % 4 == 0, "channels start on 16-byte boundaries");
};

// Bias, activation and the cast of the warp's kRW output rows into the
// output tile `os`; the accumulators are zeroed for the next row tile.
// Fragment element e of an m16n8 tile: row (channel) g + 8 (e / 2), column
// 2t + e % 2; bv[mi][half] is the bias of the lane's channel there.
template <typename TOut>
__device__ __forceinline__ void stage_out(Acc& acc, unsigned* os, const float (&bv)[kMT][2],
                                          int wr, int wc, int lane, int act) {
  using O = Out<TOut>;
  const int g = lane / 4, tq = lane % 4;
#pragma unroll
  for (int mi = 0; mi < kMT; ++mi) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int co = mi * 16 + g + 8 * half;
#pragma unroll
      for (int rl = 0; rl < kRW; ++rl) {
        TOut* row = reinterpret_cast<TOut*>(os + co * O::kOS + (kRW * wr + rl) * O::kRowW);
#pragma unroll
        for (int j = 0; j < kNT; ++j) {
          float* a = acc[rl][mi][j];
          store2(row + wc * kNT * 8 + j * 8 + 2 * tq, activate(a[2 * half] + bv[mi][half], act),
                 activate(a[2 * half + 1] + bv[mi][half], act));
          a[2 * half] = a[2 * half + 1] = 0.0f;
        }
      }
    }
  }
}

// The output tile to device memory, one row of one channel a thread: a bulk
// copy that runs on while the block goes on (its source stays untouched
// until bulk_wait_read), or plain stores where the row's end is ragged or
// not aligned.
template <typename TOut>
__device__ __forceinline__ void store_out(const unsigned* os, TOut* __restrict__ out, int n,
                                          int r0, int c0, int m0, const Shape& q) {
  using O = Out<TOut>;
  static_assert(kBM * kTH % kThreads == 0, "whole rounds of rows");
#pragma unroll
  for (int i = threadIdx.x; i < kBM * kTH; i += kThreads) {
    const int rl = i % kTH, co = i / kTH;
    const int r = r0 + rl, cols = min(kTW, q.w - c0);
    if (m0 + co >= q.cout || r >= q.h) continue;
    const unsigned* src = os + co * O::kOS + rl * O::kRowW;
    TOut* dst = out + (((size_t)n * q.cout + m0 + co) * q.h + r) * q.w + c0;
    if (q.ovec) {  // cols is then whole 16-byte chunks
      bulk_store(dst, src, cols * (int)sizeof(TOut));
    } else {
      const TOut* e = reinterpret_cast<const TOut*>(src);
      for (int k = 0; k < cols; ++k) dst[k] = e[k];
    }
  }
}

// kResident: the block's weights (all channel chunks) are staged once, in
// front of the two input buffers; otherwise each buffer carries its step's
// chunk of weights beside its input.
template <typename T, typename TOut, bool kResident>
__global__ void __launch_bounds__(kThreads, 1)
conv_tapdot_mma(const T* __restrict__ x, const T* __restrict__ w2,
                const float* __restrict__ bias, TOut* __restrict__ out, Shape q) {
  constexpr int KC = Cfg<T>::kKC;
  constexpr int kWE = Cfg<T>::kWElems;
  constexpr int kXE = Cfg<T>::kXElems;
  constexpr int kBuf = kResident ? kXE : kXE + kWE;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* smem = reinterpret_cast<T*>(smem_raw);

  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  const int wr = warp % kWR;
  const int wc = warp / kWR;
  // Cout tile fastest in the grid: blocks of the same pixels run together
  // and share their input in L2
  const int m0 = (blockIdx.x % q.n_ct) * kBM;
  const int c0 = (blockIdx.x / q.n_ct) * kTW;
  const int rt0 = blockIdx.y * q.strip;
  const int n_rt = min(q.strip, q.n_rt - rt0);
  const T* xi = x + (size_t)blockIdx.z * q.cin * q.h * q.w;
  const int n_ck = (q.cin + KC - 1) / KC;
  const int n_steps = n_rt * n_ck;
  T* bufs = smem + (kResident ? n_ck * kWE : 0);
  auto buf = [&](int step) { return bufs + (step & 1) * kBuf; };
  auto row0 = [&](int step) { return (rt0 + step / n_ck) * kTH; };
  auto ci0 = [&](int step) { return step % n_ck * KC; };

  // the weights' copies (all chunks, or step 0's), then step 0's input
  if (kResident) {
    for (int ck = 0; ck < n_ck; ++ck) stage_w(smem + ck * kWE, w2, ck * KC, m0, q);
  } else {
    stage_w(buf(0) + kXE, w2, 0, m0, q);
  }
  cp_async_commit();
  XRegs<T> rg;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    load_x(rg, half, xi, row0(0), 0, c0, q);
    store_x(reinterpret_cast<unsigned*>(buf(0)), rg, half);
  }
  cp_async_wait_all();
  __syncthreads();

  Acc acc;
#pragma unroll
  for (int r = 0; r < kRW; ++r)
#pragma unroll
    for (int mi = 0; mi < kMT; ++mi)
#pragma unroll
      for (int j = 0; j < kNT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[r][mi][j][e] = 0.0f;
  float bv[kMT][2];  // the bias of the lane's output channels
#pragma unroll
  for (int mi = 0; mi < kMT; ++mi)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int co = m0 + mi * 16 + lane / 4 + 8 * half;
      bv[mi][half] = co < q.cout ? __ldg(bias + co) : 0.0f;
    }
  auto last_chunk = [&](int step) { return step % n_ck == n_ck - 1; };
  for (int s = 0; s < n_steps; ++s) {
    // the next step's input, half at a time, is in flight in registers
    // during half of this step's products; its buffer was last read in step
    // s - 1, before the barrier that ended it
    const bool next = s + 1 < n_steps;
    if (next && !kResident) {
      stage_w(buf(s + 1) + kXE, w2, ci0(s + 1), m0, q);
      cp_async_commit();
    }
    const T* xs = buf(s);
    const T* ws = kResident ? smem + (s % n_ck) * kWE : xs + kXE;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      if (next) load_x(rg, half, xi, row0(s + 1), ci0(s + 1), c0, q);
      half_products(acc, xs, ws, half, wr, wc, lane);
      // buf(s + 1) held the output tile of step s - 1 if that ended a row
      // tile: its bulk copies must have read it before the next input goes in
      if (half == 0 && next && s > 0 && last_chunk(s - 1)) {
        bulk_wait_read();
        __syncthreads();
      }
      if (next) store_x(reinterpret_cast<unsigned*>(buf(s + 1)), rg, half);
    }
    if (last_chunk(s)) {  // the row tile's output, through buf(s), to device memory
      __syncthreads();    // every warp has read buf(s)
      unsigned* os = reinterpret_cast<unsigned*>(buf(s));
      stage_out<TOut>(acc, os, bv, wr, wc, lane, q.act);
      fence_async_shared();
      __syncthreads();
      store_out(os, out, blockIdx.z, row0(s), c0, m0, q);
      bulk_commit();
    }
    cp_async_wait_all();
    __syncthreads();
  }
  bulk_wait_all();
}

template <typename T, typename TOut, bool kResident>
cudaError_t launch_as(const void* x, const void* w2, const float* bias, void* out,
                      const Shape& q, dim3 grid, size_t smem, cudaStream_t stream) {
  auto kernel = conv_tapdot_mma<T, TOut, kResident>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kernel<<<grid, kThreads, smem, stream>>>(static_cast<const T*>(x), static_cast<const T*>(w2),
                                           bias, static_cast<TOut*>(out), q);
  return cudaGetLastError();
}

template <typename T, typename TOut>
cudaError_t launch(const void* x, const void* w2, const float* bias, void* out, int n,
                   int cin, int h, int w, int cout, int act, cudaStream_t stream) {
  constexpr size_t kWE = Cfg<T>::kWElems, kXE = Cfg<T>::kXElems;
  Shape q{};
  q.cin = cin, q.h = h, q.w = w, q.cout = cout, q.act = act;
  q.n_ct = (cout + kBM - 1) / kBM;
  q.n_rt = (h + kTH - 1) / kTH;
  const int n_wt = (w + kTW - 1) / kTW;
  const int n_ck = (cin + Cfg<T>::kKC - 1) / Cfg<T>::kKC;
  // row tiles a block (at most kStrip): the strip that ends the grid
  // soonest, in waves of one block an SM (a block's shared memory takes
  // more than half an SM's) times the steps of a block, one more for its
  // set-up (the weights and the first tile, not overlapped)
  int dev = 0, sms = 132;
  if (cudaGetDevice(&dev) == cudaSuccess)
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const long long others = (long long)q.n_ct * n_wt * n;
  long long best = -1;
  for (int strip = 1; strip <= kStrip; ++strip) {
    const long long waves = (others * ((q.n_rt + strip - 1) / strip) + sms - 1) / sms;
    const long long cost = waves * (strip * n_ck + 1);
    if (best < 0 || cost < best) best = cost, q.strip = strip;
  }
  constexpr int V = Cfg<T>::kV;
  q.xvec = w % V == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  q.wvec = cout % V == 0 && reinterpret_cast<uintptr_t>(w2) % 16 == 0;
  q.ovec = w % Out<TOut>::kV == 0 && reinterpret_cast<uintptr_t>(out) % 16 == 0;
  const long long gx = (long long)q.n_ct * n_wt;
  const int gy = (q.n_rt + q.strip - 1) / q.strip;
  if (gx > 0x7fffffffLL || gy > 65535 || n > 65535) return cudaErrorInvalidValue;
  const dim3 grid((unsigned)gx, gy, n);
  // the weights stay resident when they fit beside the two input buffers
  const size_t resident = sizeof(T) * ((size_t)n_ck * kWE + 2 * kXE);
  if (resident <= kSmemMax)
    return launch_as<T, TOut, true>(x, w2, bias, out, q, grid, resident, stream);
  return launch_as<T, TOut, false>(x, w2, bias, out, q, grid, sizeof(T) * 2 * (kXE + kWE),
                                   stream);
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
  using bf16 = __nv_bfloat16;
  cudaError_t err;
  if (in_bf16) {
    err = out_bf16 ? launch<bf16, bf16>(x, w2, b, out, n, cin, h, w, cout, act, st)
                   : launch<bf16, float>(x, w2, b, out, n, cin, h, w, cout, act, st);
  } else {
    err = out_bf16 ? launch<float, bf16>(x, w2, b, out, n, cin, h, w, cout, act, st)
                   : launch<float, float>(x, w2, b, out, n, cin, h, w, cout, act, st);
  }
  return (int)err;
}
