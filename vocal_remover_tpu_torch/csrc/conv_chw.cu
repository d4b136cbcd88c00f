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
// table is any list of (cblk, dy, dx): one channel block and kh x kw taps
// for stride 1 (any kh, kw); four phase blocks and 2x2-window taps (pad on
// the top / left only) for a 3x3 stride-2 conv on the space-to-depth tensor.
//
// What bounds it on an H100 SXM (700 W) at its tools' shapes, (N, C, H, W) =
// (8, 32, 1024, 256) and (8, 64, 512, 128), 3x3, Cout = Cin: 38.655 GFLOP
// each. bf16 is bound by bytes (268.45 / 134.29 MB: 0.0801 / 0.0401 ms at
// 3.35 TB/s; the operations take 0.0391 ms at the 989 TFLOP/s tensor-core
// peak). f32 multiplies as three TF32 products (below), so its operations
// bound it at that rate: 3 x 38.655 GFLOP over 495 TFLOP/s = 0.2343 ms
// (0.5769 ms at the 67 TFLOP/s FFMA rate).
//
// Design: variant D's (csrc/conv_tapdot.cu) on a tap table. Per tap one GEMM
// on the tensor cores, Cout the M dimension, output pixels the N dimension,
// K = the channels of the tap's block.
//  * Tap groups. The wrapper cuts the table into groups
//    (nn/conv_chw_kernel.py `tap_groups`): the taps of one channel block
//    whose dy lie in a band of kGH rows and whose dx lie in a band of kGW
//    columns, each at its slot (dy - dy0, dx - dx0). A group is a record of
//    kRec ints in a device table (see read_group): the block, the offset of
//    its staged box from the output tile (dy0 - pad_top, dx0 - pad_left),
//    its rows and columns of taps, its first weight slab and the table
//    index of the tap at each slot (-1 for none). So any number of taps and
//    any reach run on one fixed staged box of at most (kTH + kGH - 1) x kSW
//    pixels: 3x3 is one group, 7x7 six, the stride-2 table four (one per
//    phase block, of 1, 2, 2 and 4 taps). Each step's record is copied into
//    a ring in shared memory two steps ahead (cp.async): read from device
//    memory at the step's start, it held every warp before its first load.
//  * A block owns kBM = 32 output channels x kTH = 8 rows x kTW = 64 columns
//    of one image and walks a strip of row tiles; a step is one (row tile,
//    channel chunk, group). 8 warps, each two output rows x 32 columns (four
//    n8 tiles) x all 32 channels (two m16 tiles). Nothing is carried between
//    blocks.
//  * The alignment trap. NCHW keeps columns innermost, and ldmatrix takes
//    16-byte row addresses: a view shifted by one column is 2 bytes off in
//    bf16. So a step's box is staged CHANNEL-INNERMOST, [row][column]
//    [channel] (64 bytes of channels a pixel: 32 bf16 or 16 f32, padded to
//    80 bytes): a tap's offset is a whole-pixel offset at any dx, and each
//    ldmatrix row (one pixel, 8 channels) stays 16-byte aligned. The box's
//    first column is the group's first read column rounded down to a whole
//    16-byte chunk (8 columns), so every load is a whole aligned chunk; it
//    spans only the rows and chunks its taps read (a 1x1 stages 8 x 64
//    pixels, no halo). Channels past the block's cin_blk, pixels outside the
//    image and output channels past Cout are staged as zeros: a chunk never
//    reads the next channel block.
//  * cp.async cannot transpose, so the input goes through registers: each
//    thread loads its items of the NEXT step's box (kV channels x kV
//    columns, one 16-byte load a channel row) before the current step's
//    products and writes them after them, transposed (byte permutes in bf16,
//    a register reorder in f32), one 16-byte store a pixel, into the other
//    of two shared-memory buffers. bf16 keeps the whole box in flight; f32,
//    short of registers, half of it beside half the products. Widths that
//    are not whole chunks, or an input whose address is not 16-byte
//    aligned, take plain loads into the same registers.
//  * Weights: [slab][ci][co] slabs of one tap and one channel chunk, straight
//    from w2's rows (16-byte cp.async copies, plain loads when Cout is not
//    whole chunks or w2 not aligned), A fragments by ldmatrix.trans. All
//    slabs stay resident across the strip when they fit beside the two input
//    buffers (up to 37 slabs, the tools' shapes); otherwise each buffer
//    carries the slabs of its step's group (a 7x7, deep Cin; chosen at run
//    time). A group's gh x gw slabs lie one after another in slot order, a
//    slot without a tap a slab of zeros, so each tap's slab is a fixed
//    offset from one base a step.
//  * Products: one loop unrolled at compile time for each group shape
//    (1..kGH rows x 1..kGW columns of taps, chosen per step), so a 3x3 runs
//    variant D's loop (a rolled loop over the slots, with a branch a tap,
//    kept the compiler from overlapping the fragment loads with the
//    products). bf16 on mma.sync.m16n8k16, B fragments by
//    (non-transposed) ldmatrix from the [pixel][channel] box. Per k16 and dx
//    a warp holds the A fragments of the group's dy and reads each of its
//    staged rows once: staged row sr feeds output row sr - dy for every dy.
//    f32 as 3xTF32 on
//    m16n8k8 (hi*hi + hi*lo + lo*hi in f32, as csrc/conv_shift.cu),
//    fragments read as words; each k8's three products are summed apart and
//    added to the accumulator by an f32 add, since the tensor cores' own
//    additions truncate.
//  * Epilogue: bias, activation and the cast into an output tile in shared
//    memory (the step's input buffer, read by then), then one bulk copy
//    (cp.async.bulk, the TMA's 1-D form) a channel row to device memory,
//    which runs on while the block computes the next row tile; plain stores
//    where the row is ragged or not aligned. Cout below the tile and rows
//    past H are masked there.
// Left for later: warp specialisation, so that the staging and the epilogue
// overlap the products instead of running between barriers; wgmma; a split
// over Cin for small grids; a stride-2 form that stages its four phase
// blocks in fewer steps.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

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
constexpr int kGH = 3;               // most tap rows a group
constexpr int kGW = 4;               // most tap columns a group
constexpr int kSlots = kGH * kGW;
constexpr int kRec = 20;             // ints of a group record (see read_group)
constexpr int kSR = kTH + kGH - 1;   // most staged rows
// most staged columns: up to 7 columns of the box's first chunk lie left of
// the first read, and a group reads kTW + kGW - 1 columns: 74, in whole
// 8-column chunks
constexpr int kSW = kTW + 16;
constexpr int kSC = kSW + 4;         // pixels a staged row (see store_x)
constexpr int kPW = 20;              // words a staged pixel: 16 of channels, 80 bytes
constexpr int kWS = kBM + 8;         // elements a weight row (80 bytes in bf16)
constexpr int kXWords = kSR * kSC * kPW;
static_assert(kNT % 2 == 0, "B fragments are loaded two n8 tiles at a time");
static_assert(7 + kTW + kGW - 1 <= kSW, "a group's reads fit the staged box");
static_assert(6 + kSlots <= kRec, "a record holds its slots");
// dynamic shared memory of a block: the SM's 227 KB less room for the
// static record ring
constexpr size_t kSmemMax = 227 * 1024 - 1024;

template <typename T> struct Cfg {
  static constexpr int kKC = 64 / sizeof(T);          // channels a chunk (64 bytes a pixel)
  static constexpr int kV = 16 / sizeof(T);           // elements of one 16-byte load or copy
  static constexpr int kSlab = kKC * kWS;             // [ci][co] of one tap and chunk
  static constexpr int kXElems = kXWords * 4 / sizeof(T);
  // staging items: (staged row, kV-column chunk, group of kV channels)
  static constexpr int kItems = kSR * (kSW / kV) * (kKC / kV);
  static constexpr int kPerThread = (kItems + kThreads - 1) / kThreads;
  static constexpr int kHalf = kPerThread / 2;  // a thread's items of one half of a box
  static_assert(kPerThread % 2 == 0, "the staging splits into two halves");
  static_assert(kKC / kV == 4, "four channel groups a staged pixel");
};

struct Shape {
  int c_total, cin_blk, h, w, cout, act, n_taps, n_groups, n_slabs;
  int n_ct, n_rt, strip, n_ck;  // Cout tiles, row tiles, row tiles a block, channel chunks
  int xvec, wvec, ovec;         // rows of x / w2 / out in aligned 16-byte chunks
};

// One step's group, from its record: [0] channel block, [1] first staged row
// from the output tile's first row (dy0 - pad_top), [2] first read column
// from the tile's first column (dx0 - pad_left), [3] rows and [4] columns of
// taps, [5] its first weight slab in a channel chunk's slabs (the groups'
// gh x gw slabs lie one after another, slot (dy - dy0) * gw + dx - dx0 of
// each), [6 + (dy - dy0) * kGW + dx - dx0] the table index of the tap at
// that slot or -1. Derived: the box starts `coff` (a multiple of 8) columns
// from the tile, `e` columns before the first read; it spans `rows` rows and
// `chunks` kV-column chunks.
struct Group {
  int cblk, row0, coff, e, gh, gw, slab0, rows, chunks;
};

template <typename T>
__device__ __forceinline__ Group read_group(const int* rec) {
  constexpr int V = Cfg<T>::kV;
  Group g;
  g.cblk = rec[0];
  g.row0 = rec[1];
  const int col0 = rec[2];
  g.coff = col0 & ~7;  // rounded down to a multiple of 8, also below 0
  g.e = col0 - g.coff;
  g.gh = rec[3];
  g.gw = rec[4];
  g.slab0 = rec[5];
  g.rows = kTH + g.gh - 1;
  g.chunks = (kTW + g.e + g.gw - 1 + V - 1) / V;
  return g;
}

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

// Half of a thread's share of the next step's box, in registers between the
// load from device memory and the store to shared memory: per item, kV
// channels x kV columns (one 16-byte row of NCHW per channel).
template <typename T>
struct XRegs {
  uint4 v[Cfg<T>::kHalf][Cfg<T>::kV];
};

// Item i of a step's staging: channel group i % 4, staged row parity (i / 4)
// % 2, column chunk, row pair, over the largest box; a step stages the items
// that lie in its group's box. The eight lanes of a 16-byte shared store
// phase cover four channel groups of two rows of one chunk.
template <typename T>
struct Item {
  int grp, sr, cc;
  __device__ __forceinline__ Item(int i, const Group& g, bool& live) {
    constexpr int kChunks = kSW / Cfg<T>::kV;
    grp = i % 4;
    cc = i / 8 % kChunks;
    sr = i / (8 * kChunks) * 2 + i / 4 % 2;
    live = i < Cfg<T>::kItems && sr < g.rows && cc < g.chunks;
  }
};

// Load half `half` of the thread's items of a step's box (group g, row tile
// starting at r0, channels ci0 ... of block g.cblk, tile column c0) into
// registers.
template <typename T>
__device__ __forceinline__ void load_x(XRegs<T>& rg, int half, const T* __restrict__ xi,
                                       const Group& g, int r0, int ci0, int c0, const Shape& q) {
  using C = Cfg<T>;
  constexpr int V = C::kV;
  const size_t plane = (size_t)q.h * q.w;
#pragma unroll
  for (int it = 0; it < C::kHalf; ++it) {
    const int i = threadIdx.x + (half * C::kHalf + it) * kThreads;
    bool live;
    const Item<T> m(i, g, live);
    const int gr = r0 + g.row0 + m.sr, gc = c0 + g.coff + m.cc * V, ch = ci0 + m.grp * V;
    const bool row_ok = live && gr >= 0 && gr < q.h;
    const T* row = xi + (row_ok ? ((size_t)(g.cblk * q.cin_blk + ch) * q.h + gr) * q.w : 0);
    if (q.xvec) {  // a chunk lies all inside the image or all out
      const bool in = row_ok && gc >= 0 && gc < q.w;
#pragma unroll
      for (int c = 0; c < V; ++c)
        rg.v[it][c] = in && ch + c < q.cin_blk
                          ? __ldg(reinterpret_cast<const uint4*>(row + c * plane + gc))
                          : make_uint4(0u, 0u, 0u, 0u);
    } else {
#pragma unroll
      for (int c = 0; c < V; ++c) {
        unsigned e[4] = {0u, 0u, 0u, 0u};
#pragma unroll
        for (int k = 0; k < V; ++k) {
          const int col = gc + k;
          const unsigned b = row_ok && ch + c < q.cin_blk && col >= 0 && col < q.w
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

// Write the registers of `load_x` into the [row][pixel][channel] box `xs`,
// one 16-byte store a pixel. A store phase's eight lanes hit 16-byte units
// 5 * pixel + group + 4 * row (mod 8: kSC = 84 pixels make a row 4 units
// past a multiple of 8): all eight differ, free of bank conflicts.
template <typename T>
__device__ __forceinline__ void store_x(unsigned* xs, const XRegs<T>& rg, int half,
                                        const Group& g) {
  using C = Cfg<T>;
  constexpr int V = C::kV;
#pragma unroll
  for (int it = 0; it < C::kHalf; ++it) {
    const int i = threadIdx.x + (half * C::kHalf + it) * kThreads;
    bool live;
    const Item<T> m(i, g, live);
    if (!live) continue;
    unsigned* dst = xs + (m.sr * kSC + m.cc * V) * kPW + m.grp * 4;
#pragma unroll
    for (int k = 0; k < V; ++k)
      *reinterpret_cast<uint4*>(dst + k * kPW) = pixel(rg.v[it], k);
  }
}

// Stage `n_slabs` weight slabs ([ci][co] of one tap and one channel chunk)
// at `ws`; slab(s, t, ci0) names slab s's tap and first channel (t < 0: a
// slab of zeros; a tap past the table traps).
template <typename T, typename Slab>
__device__ void stage_w(T* ws, const T* __restrict__ w2, int n_slabs, Slab slab, int m0,
                        const Shape& q) {
  constexpr int CH = Cfg<T>::kV;
  constexpr int KC = Cfg<T>::kKC;
  constexpr int kWRow = kBM / CH;
  for (int i = threadIdx.x; i < n_slabs * KC * kWRow; i += kThreads) {
    const int cc = i % kWRow;
    const int k = (i / kWRow) % KC;
    const int s = i / (kWRow * KC);
    int t, ci0;
    slab(s, t, ci0);
    if (t < -1 || t >= q.n_taps) __trap();
    const int ci = ci0 + k, co = m0 + cc * CH;
    const bool row_ok = t >= 0 && ci < q.cin_blk;
    const T* src = w2 + (row_ok ? ((size_t)t * q.cin_blk + ci) * q.cout : 0);
    T* dst = ws + s * Cfg<T>::kSlab + k * kWS + cc * CH;
    if (q.wvec) {
      const bool ok = row_ok && co < q.cout;
      cp_async16(dst, ok ? src + co : w2, ok);
    } else {
#pragma unroll
      for (int e = 0; e < CH; ++e) dst[e] = row_ok && co + e < q.cout ? src[co + e] : T(0.0f);
    }
  }
}

using Acc = float[kRW][kMT][kNT][4];

// The products of a GH x GW group on one half of a staged step's channels
// (one k16), bf16. `ws` holds the group's slabs, slot dy * GW + dx (a slab
// of zeros where the table has no tap). Per dx the A fragments of the
// group's dy (two m16 tiles each, ldmatrix.trans from [k][co]) are held, and
// each of the warp's kRW + GH - 1 staged rows is read once at the tap's
// column offset (ldmatrix, two n8 tiles x 16 channels at a time): staged row
// sr serves output row sr - dy for every dy that lands in the warp's rows. A
// 3x3 group is variant D's loop.
template <int GH, int GW>
__device__ __forceinline__ void half_products(Acc& acc, const __nv_bfloat16* xs,
                                              const __nv_bfloat16* ws, int e,
                                              int half, int wr, int wc, int lane) {
  using T = __nv_bfloat16;
  constexpr int PS = kPW * 2;  // elements a staged pixel
  static_assert(Cfg<T>::kKC == 32, "a half of the chunk is one k16");
  const int k16 = half * 16;
  const int a_lane = (k16 + (lane / 16) * 8 + lane % 8) * kWS + (lane / 8 % 2) * 8;
#pragma unroll
  for (int dx = 0; dx < GW; ++dx) {
    unsigned af[GH][kMT][4];
#pragma unroll
    for (int dy = 0; dy < GH; ++dy)
#pragma unroll
      for (int mi = 0; mi < kMT; ++mi)
        ldmatrix_x4_trans(af[dy][mi],
                          ws + (dy * GW + dx) * Cfg<T>::kSlab + a_lane + mi * 16);
    const T* xb = xs + ((kRW * wr) * kSC + e + dx + wc * kNT * 8 + (lane / 16) * 8 + lane % 8) *
                           PS + k16 + (lane / 8 % 2) * 8;
#pragma unroll
    for (int sr = 0; sr < kRW + GH - 1; ++sr) {
#pragma unroll
      for (int pc = 0; pc < kNT / 2; ++pc) {
        unsigned bf[4];
        ldmatrix_x4(bf, xb + (sr * kSC + pc * 16) * PS);
#pragma unroll
        for (int dy = 0; dy < GH; ++dy) {
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

// f32, the products of a GH x GW group on one half of a staged step's
// channels (one k8), as three TF32 products: per tap, A fragments (row co,
// column k) read as words from [k][co], B fragments (k = t (+4), column g)
// as words from the box at the tap's offset, split into TF32 high and low
// parts.
template <int GH, int GW>
__device__ __forceinline__ void half_products(Acc& acc, const float* xs, const float* ws,
                                              int e, int half, int wr, int wc, int lane) {
  static_assert(Cfg<float>::kKC == 16, "a half of the chunk is one k8");
  const int gq = lane / 4, tq = lane % 4;
  const int k8 = half * 8;
#pragma unroll 1  // unrolled, the taps' loads crowd out the registers and spill
  for (int t = 0; t < GH * GW; ++t) {
    const int dy = t / GW, dx = t % GW;
    unsigned ahi[kMT][4], alo[kMT][4];
#pragma unroll
    for (int mi = 0; mi < kMT; ++mi) {
      const float* wp = ws + t * Cfg<float>::kSlab + (k8 + tq) * kWS + mi * 16 + gq;
      split_tf32(wp[0], ahi[mi][0], alo[mi][0]);
      split_tf32(wp[8], ahi[mi][1], alo[mi][1]);
      split_tf32(wp[4 * kWS], ahi[mi][2], alo[mi][2]);
      split_tf32(wp[4 * kWS + 8], ahi[mi][3], alo[mi][3]);
    }
#pragma unroll
    for (int r = 0; r < kRW; ++r) {
      const float* xb =
          xs + ((kRW * wr + r + dy) * kSC + e + dx + wc * kNT * 8 + gq) * kPW + k8 + tq;
#pragma unroll
      for (int j = 0; j < kNT; ++j) {
        unsigned bh0, bl0, bh1, bl1;
        split_tf32(xb[j * 8 * kPW], bh0, bl0);
        split_tf32(xb[j * 8 * kPW + 4], bh1, bl1);
#pragma unroll
        for (int mi = 0; mi < kMT; ++mi) {
          // the tensor cores add with truncation: summed straight into
          // acc, its bias grows with the length of the sum; a k8's three
          // products go to a fresh partial sum, added to acc in f32
          float part[4] = {0.0f, 0.0f, 0.0f, 0.0f};
          mma_tf32(part, alo[mi], bh0, bh1);
          mma_tf32(part, ahi[mi], bl0, bl1);
          mma_tf32(part, ahi[mi], bh0, bh1);
#pragma unroll
          for (int e4 = 0; e4 < 4; ++e4) acc[r][mi][j][e4] += part[e4];
        }
      }
    }
  }
}

// The step's products at its group's shape: one unrolled loop for each
// (rows, columns) of taps.
template <typename T>
__device__ __forceinline__ void group_products(Acc& acc, const T* xs, const T* ws,
                                               const Group& g, int half, int wr, int wc,
                                               int lane) {
  static_assert(kGH == 3 && kGW == 4, "one case for each group shape");
#define CONV_CHW_CASE(GH, GW)                                  \
  case GH * 8 + GW:                                            \
    half_products<GH, GW>(acc, xs, ws, g.e, half, wr, wc, lane); \
    break;
  switch (g.gh * 8 + g.gw) {
    CONV_CHW_CASE(1, 1) CONV_CHW_CASE(1, 2) CONV_CHW_CASE(1, 3) CONV_CHW_CASE(1, 4)
    CONV_CHW_CASE(2, 1) CONV_CHW_CASE(2, 2) CONV_CHW_CASE(2, 3) CONV_CHW_CASE(2, 4)
    CONV_CHW_CASE(3, 1) CONV_CHW_CASE(3, 2) CONV_CHW_CASE(3, 3) CONV_CHW_CASE(3, 4)
  }
#undef CONV_CHW_CASE
}

// The output tile [co][row][column] in shared memory (it takes the place of
// the step's input box once that is read), kOS words a channel: a row is
// kTW columns, and a channel kTH rows plus 2 * sizeof(TOut) words, so that
// the fragment stores of a warp (one 4-byte pair a lane in bf16, one 8-byte
// pair in f32) are free of bank conflicts.
template <typename TOut> struct Out {
  static constexpr int kRowW = kTW * (int)sizeof(TOut) / 4;  // words a row
  static constexpr int kOS = kTH * kRowW + 2 * (int)sizeof(TOut);
  static constexpr int kV = 16 / (int)sizeof(TOut);          // elements a 16-byte store
  static_assert(kBM * kOS <= kXWords, "the output tile fits in an input box");
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

// kResident: every channel chunk's slabs (each group's gh x gw of them,
// n_slabs a chunk) are staged once, in front of the two input buffers;
// otherwise each buffer carries the slabs of its step's group beside its
// box. A slot without a tap is a slab of zeros.
template <typename T, typename TOut, bool kResident>
__global__ void __launch_bounds__(kThreads, 1)
conv_chw_mma(const T* __restrict__ x, const T* __restrict__ w2, const float* __restrict__ bias,
             TOut* __restrict__ out, const int* __restrict__ groups, Shape q) {
  constexpr int KC = Cfg<T>::kKC;
  constexpr int kSlab = Cfg<T>::kSlab;
  constexpr int kXE = Cfg<T>::kXElems;
  constexpr int kBuf = kResident ? kXE : kXE + kSlots * kSlab;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  // the records of steps s, s + 1 and s + 2 at recs[step % 3]: each is
  // copied in two steps ahead, so that no step waits on device memory for
  // its record
  __shared__ __align__(16) int recs[3][kRec];
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
  const T* xi = x + (size_t)blockIdx.z * q.c_total * q.h * q.w;
  // steps: (row tile, channel chunk, group), the group fastest
  const int per_tile = q.n_ck * q.n_groups;
  const int n_steps = n_rt * per_tile;
  T* bufs = smem + (kResident ? q.n_ck * q.n_slabs * kSlab : 0);
  auto buf = [&](int step) { return bufs + (step & 1) * kBuf; };
  auto row0 = [&](int step) { return (rt0 + step / per_tile) * kTH; };
  auto ci0 = [&](int step) { return step % per_tile / q.n_groups * KC; };
  auto rec = [&](int step) { return &recs[step % 3][0]; };
  auto fetch_rec = [&](int step) {
    static_assert(kRec % 4 == 0, "a record is whole 16-byte copies");
    if (threadIdx.x < kRec / 4)
      cp_async16(&recs[step % 3][threadIdx.x * 4],
                 groups + (step % q.n_groups) * kRec + threadIdx.x * 4, true);
  };
  auto last_of_tile = [&](int step) { return step % per_tile == per_tile - 1; };
  // a malformed record traps
  auto check = [&](const Group& g) {
    if (threadIdx.x == 0 &&
        (g.cblk < 0 || g.cblk * q.cin_blk >= q.c_total || g.gh < 1 || g.gh > kGH || g.gw < 1 ||
         g.gw > kGW || g.slab0 < 0 || g.slab0 + g.gh * g.gw > q.n_slabs))
      __trap();
  };
  // the gh x gw slabs of group g (record r) for channels c ..., at ws
  auto stage_group_w = [&](T* ws, const int* r, const Group& g, int c) {
    const int gw = g.gw;
    stage_w(ws, w2, g.gh * gw,
            [&](int s, int& t, int& ci) { t = r[6 + s / gw * kGW + s % gw]; ci = c; }, m0, q);
  };
  // a step's slabs, slot (dy - dy0) * gw + dx - dx0 of its group g
  auto slabs = [&](int step, const Group& g) -> const T* {
    return kResident ? smem + (ci0(step) / KC * q.n_slabs + g.slab0) * kSlab : buf(step) + kXE;
  };

  // the first two records, the weights' copies (all slabs, or step 0's),
  // then step 0's box
  fetch_rec(0);
  if (n_steps > 1) fetch_rec(1);
  cp_async_commit();
  cp_async_wait_all();
  __syncthreads();
  Group cur = read_group<T>(rec(0));
  check(cur);
  if (kResident) {
    for (int gi = 0; gi < q.n_groups; ++gi) {
      const int* r = groups + gi * kRec;
      const Group g = read_group<T>(r);
      check(g);
      for (int ck = 0; ck < q.n_ck; ++ck)
        stage_group_w(smem + (ck * q.n_slabs + g.slab0) * kSlab, r, g, ck * KC);
    }
  } else {
    stage_group_w(buf(0) + kXE, rec(0), cur, 0);
  }
  cp_async_commit();
  // bf16: the whole next box is in flight beside a step's products (its
  // registers fit); f32: half of it beside half the products
  constexpr bool kWhole = sizeof(T) == 2;
  XRegs<T> rg[kWhole ? 2 : 1];
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    load_x(rg[0], half, xi, cur, row0(0), 0, c0, q);
    store_x(reinterpret_cast<unsigned*>(buf(0)), rg[0], half, cur);
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
  for (int s = 0; s < n_steps; ++s) {
    // the next step's box, half at a time, is in flight in registers during
    // half of this step's products; its buffer was last read in step s - 1,
    // before the barrier that ended it
    const bool next = s + 1 < n_steps;
    const Group nxt = read_group<T>(rec(next ? s + 1 : s));
    if (s + 2 < n_steps) fetch_rec(s + 2);  // its ring entry was step s - 1's
    if (next) {
      check(nxt);
      if (!kResident) stage_group_w(buf(s + 1) + kXE, rec(s + 1), nxt, ci0(s + 1));
    }
    cp_async_commit();
    const T* xs = buf(s);
    const T* ws = slabs(s, cur);
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      if (next && (!kWhole || half == 0)) {
#pragma unroll
        for (int h = half; h < (kWhole ? 2 : half + 1); ++h)
          load_x(rg[kWhole ? h : 0], h, xi, nxt, row0(s + 1), ci0(s + 1), c0, q);
      }
      group_products(acc, xs, ws, cur, half, wr, wc, lane);
      // buf(s + 1) held the output tile of step s - 1 if that ended a row
      // tile: its bulk copies must have read it before the next box goes in
      if (half == 0 && next && s > 0 && last_of_tile(s - 1)) {
        bulk_wait_read();
        __syncthreads();
      }
      if (next && (!kWhole || half == 1)) {
#pragma unroll
        for (int h = kWhole ? 0 : half; h <= half; ++h)
          store_x(reinterpret_cast<unsigned*>(buf(s + 1)), rg[kWhole ? h : 0], h, nxt);
      }
    }
    if (last_of_tile(s)) {  // the row tile's output, through buf(s), to device memory
      __syncthreads();      // every warp has read buf(s)
      unsigned* os = reinterpret_cast<unsigned*>(buf(s));
      stage_out<TOut>(acc, os, bv, wr, wc, lane, q.act);
      fence_async_shared();
      __syncthreads();
      store_out(os, out, blockIdx.z, row0(s), c0, m0, q);
      bulk_commit();
    }
    cp_async_wait_all();
    __syncthreads();
    cur = nxt;
  }
  bulk_wait_all();
}

template <typename T, typename TOut, bool kResident>
cudaError_t launch_as(const void* x, const void* w2, const float* bias, void* out,
                      const int* groups, const Shape& q, dim3 grid, size_t smem,
                      cudaStream_t stream) {
  auto kernel = conv_chw_mma<T, TOut, kResident>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kernel<<<grid, kThreads, smem, stream>>>(static_cast<const T*>(x), static_cast<const T*>(w2),
                                           bias, static_cast<TOut*>(out), groups, q);
  return cudaGetLastError();
}

template <typename T, typename TOut>
cudaError_t launch(const void* x, const void* w2, const float* bias, void* out,
                   const int* groups, int n, Shape q, cudaStream_t stream) {
  constexpr size_t kSlab = Cfg<T>::kSlab, kXE = Cfg<T>::kXElems;
  q.n_ct = (q.cout + kBM - 1) / kBM;
  q.n_rt = (q.h + kTH - 1) / kTH;
  q.n_ck = (q.cin_blk + Cfg<T>::kKC - 1) / Cfg<T>::kKC;
  const int n_wt = (q.w + kTW - 1) / kTW;
  const long long per_tile = (long long)q.n_ck * q.n_groups;
  // row tiles a block (at most kStrip): the strip that ends the grid
  // soonest, in waves of one block an SM (a block's shared memory takes
  // more than half an SM's) times the steps of a block, one more for its
  // set-up (the weights and the first box, not overlapped)
  int dev = 0, sms = 132;
  if (cudaGetDevice(&dev) == cudaSuccess)
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const long long others = (long long)q.n_ct * n_wt * n;
  long long best = -1;
  for (int strip = 1; strip <= kStrip; ++strip) {
    const long long waves = (others * ((q.n_rt + strip - 1) / strip) + sms - 1) / sms;
    const long long cost = waves * (strip * per_tile + 1);
    if (best < 0 || cost < best) best = cost, q.strip = strip;
  }
  constexpr int V = Cfg<T>::kV;
  q.xvec = q.w % V == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  q.wvec = q.cout % V == 0 && reinterpret_cast<uintptr_t>(w2) % 16 == 0;
  q.ovec = q.w % Out<TOut>::kV == 0 && reinterpret_cast<uintptr_t>(out) % 16 == 0;
  const long long gx = (long long)q.n_ct * n_wt;
  const int gy = (q.n_rt + q.strip - 1) / q.strip;
  if (gx > 0x7fffffffLL || gy > 65535 || n > 65535 || per_tile * kStrip > 0x7fffffffLL)
    return cudaErrorInvalidValue;
  const dim3 grid((unsigned)gx, gy, n);
  // the weights stay resident when they fit beside the two input buffers
  const size_t resident = sizeof(T) * ((size_t)q.n_ck * q.n_slabs * kSlab + 2 * kXE);
  if (resident <= kSmemMax)
    return launch_as<T, TOut, true>(x, w2, bias, out, groups, q, grid, resident, stream);
  return launch_as<T, TOut, false>(x, w2, bias, out, groups, q, grid,
                                   sizeof(T) * 2 * (kXE + kSlots * kSlab), stream);
}

}  // namespace

// The wrapper's group records must match this file: taps a group spans in
// rows (dy) and columns (dx), and ints a record.
extern "C" int conv_chw_group_rows() { return kGH; }
extern "C" int conv_chw_group_cols() { return kGW; }
extern "C" int conv_chw_group_ints() { return kRec; }

// Launches on `stream`; returns cudaGetLastError() after the launch (0 when
// the launch was accepted). Does not synchronise. x, w2, bias, out and
// `groups` are device pointers to contiguous arrays; x and w2 share one type
// (in_bf16). `groups` holds n_groups records of conv_chw_group_ints() ints
// that cover the n_taps taps of w2 in n_slabs slots (nn/conv_chw_kernel.py
// `tap_groups`); the kernel traps on a malformed one.
extern "C" int conv_chw(const void* x, const void* w2, const void* bias, void* out,
                        const void* groups, int n, int c_total, int h, int w, int cout,
                        int cin_blk, int n_taps, int n_groups, int n_slabs, int act,
                        int in_bf16, int out_bf16, void* stream) {
  if (n <= 0 || c_total <= 0 || h <= 0 || w <= 0 || cout <= 0 || cin_blk <= 0 ||
      c_total % cin_blk != 0 || n_taps < 1 || n_groups < 1 || n_slabs < n_taps || act < 0 ||
      act > 2) {
    return (int)cudaErrorInvalidValue;
  }
  Shape q{};
  q.c_total = c_total, q.cin_blk = cin_blk, q.h = h, q.w = w, q.cout = cout, q.act = act;
  q.n_taps = n_taps, q.n_groups = n_groups, q.n_slabs = n_slabs;
  const float* b = static_cast<const float*>(bias);
  const int* g = static_cast<const int*>(groups);
  cudaStream_t st = (cudaStream_t)stream;
  using bf16 = __nv_bfloat16;
  cudaError_t err;
  if (in_bf16) {
    err = out_bf16 ? launch<bf16, bf16>(x, w2, b, out, g, n, q, st)
                   : launch<bf16, float>(x, w2, b, out, g, n, q, st);
  } else {
    err = out_bf16 ? launch<float, bf16>(x, w2, b, out, g, n, q, st)
                   : launch<float, float>(x, w2, b, out, g, n, q, st);
  }
  return (int)err;
}
