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
// input is never read at a column offset. Every staged input column meets
// the weights of all three dx at its own column, which gives three partial
// sums over the unshifted dy-stack (K = 3 * Cin)
//   P_dx[j'] = sum over dy, ci of w[dx][dy][ci] * x[ci, i + dy - 1, j']
// and the alignment is done on the output side:
//   out[j] = P_0[j - 1] + P_1[j] + P_2[j + 1].
//
// What bounds it on an H100 SXM (700 W) at the lab's shapes, (8, 32, 1024,
// 256) and (8, 64, 512, 128), Cout = Cin: 38.65 GFLOP each. bf16 is bound by
// bytes at the first shape (268 MB, 0.080 ms; the operations take 0.039 ms
// at the 989 TFLOP/s tensor-core peak) and about even at the second; only
// the tensor cores come near either. f32 multiplies as three TF32 products
// (below), so its operations bound it at that rate: 3 x 38.65 GFLOP over
// 495 TFLOP/s = 0.234 ms (0.577 ms at the 67 TFLOP/s FFMA rate).
//
// Design: the conv as three GEMMs per output row on the tensor cores, Cout
// the M dimension, output columns the N dimension, K = (dy, ci).
//  * A block owns kBM output channels x kTW output columns of one image and
//    walks a strip of row tiles of kTH rows; warps split the tile kWM along
//    Cout (16 channels each), kWR along rows (one row each), kWC along
//    columns (kNT n8 tiles each). Nothing is carried between blocks.
//  * A = the weights of one dx, (Cout x 3 Cin), staged as [dx][dy][ci][co]
//    straight from w2's rows: once per block for the whole strip when all
//    its chunks of kKC input channels fit beside the input's ring (the
//    lab's shapes), else chunk by chunk in the ring with their input.
//    B = the dy-stack: per chunk the block stages kTH + 2 input rows x kKC
//    channels x (kTW + 16) columns, from an aligned column 8 left of the
//    tile, each row a contiguous run of NCHW (16-byte cp.async copies,
//    zero-filled outside the image and past Cin). Output row r takes its
//    dy part of K from staged row r + dy: the rows are staged once for the
//    three dy, and each staged column meets all three dx.
//  * Products: bf16 on mma.sync.m16n8k16 (A and B by ldmatrix.trans from
//    the [k][co] and [k][column] tiles); f32 as 3xTF32 on m16n8k8 (hi*hi +
//    hi*lo + lo*hi in f32, as csrc/flat_conv.cu), fragments read as words.
//    Row strides are padded so that every fragment read is free of bank
//    conflicts.
//  * Three accumulator sets per warp, one per dx, over the warp's kNT
//    output n8 tiles; the n8 tile left of them carries only P_0 and the one
//    right of them only P_2 (the halo columns j - 1 and j + 1 of the
//    warp's first and last output column).
//  * Output-side alignment in registers: an m16n8 fragment holds columns
//    2t, 2t + 1 in lane t of each quad, so out[2t] takes P_0[2t - 1] from
//    the lane to its left (the right lane of the quad of the n8 tile to its
//    left for t = 0) and P_2[2t + 2] from the lane to its right, by warp
//    shuffles; the image edge's missing neighbour is the staged zero
//    padding. Then bias, activation and the store (pairs of columns).
//  * Staging overlaps the products: a ring of kStages shared-memory stages
//    over the (row tile, channel chunk) steps of the strip, the next steps'
//    cp.async copies in flight while the current one is multiplied, one
//    barrier a step. Widths that are not whole 16-byte chunks (W or Cout
//    not a multiple of 8 in bf16, of 4 in f32) fill the same ring with
//    plain loads.
// Left for later: wgmma with TMA and a producer warp, a persistent grid.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

namespace {

// 16 warps: 2 along Cout x 4 rows x 2 column groups of 4 n8 tiles (the
// fastest at the lab's shapes of the layouts tried on an H100, PERF.md)
constexpr int kWM = 2;   // warps along Cout
constexpr int kWR = 4;   // warps along rows
constexpr int kWC = 2;   // warps along columns
constexpr int kNT = 4;   // output n8 tiles a warp
constexpr int kStrip = 16;  // most row tiles a block walks
constexpr int kWarps = kWM * kWR * kWC;
constexpr int kThreads = 32 * kWarps;
constexpr int kBM = 16 * kWM;      // output channels a block
constexpr int kTH = kWR;           // output rows a row tile
constexpr int kTW = 8 * kNT * kWC; // output columns a block
constexpr int kSR = kTH + 2;       // staged input rows
constexpr int kSC = kTW + 16;      // staged columns: one n8 halo each side
// Row strides (elements): bf16 rows an odd number of 16-byte units apart
// (ldmatrix), f32 rows 8 or 24 words past a multiple of 32 (word reads).
constexpr int kXS = kSC + 8;
constexpr int kWS = kBM + 8;
static_assert(kNT % 2 == 0, "B fragments are loaded two n8 tiles at a time");
static_assert(kThreads <= 1024, "block size");
constexpr size_t kSmemMax = 227 * 1024;  // dynamic shared memory of a block

template <typename T> struct Cfg;
template <> struct Cfg<__nv_bfloat16> {
  static constexpr int kKC = 32, kStages = 3;
  static constexpr int kChunk = 8;  // elements of one 16-byte copy
};
template <> struct Cfg<float> {
  static constexpr int kKC = 16, kStages = 3;
  static constexpr int kChunk = 4;
};
template <typename T> struct Layout {
  static constexpr int kKC = Cfg<T>::kKC;
  static_assert(kKC % (std::is_same<T, float>::value ? 8 : 16) == 0,
                "a chunk is whole k-steps of the type's mma");
  static constexpr int kXElems = kSR * kKC * kXS;  // [row][ci][column]
  static constexpr int kWElems = 9 * kKC * kWS;    // [dx][dy][ci][co]
  static constexpr int kStageElems = kXElems + kWElems;
  static constexpr size_t kSmemBytes = sizeof(T) * kStageElems * Cfg<T>::kStages;
};

struct Shape {
  int cin, h, w, cout, act;
  int n_ct, n_rt, strip;  // Cout tiles, row tiles, row tiles a block
  int xvec, wvec;         // rows of x / of w2 are whole 16-byte chunks
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
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
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

// A warp's accumulators: P[dx][output n8 tile], and the halo tiles: P_0 of
// the n8 tile left of the warp's columns, P_2 of the one right of them.
struct Acc {
  float p[3][kNT][4];
  float left[4], right[4];
  __device__ void zero() {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      left[e] = right[e] = 0.0f;
#pragma unroll
      for (int d = 0; d < 3; ++d)
#pragma unroll
        for (int i = 0; i < kNT; ++i) p[d][i][e] = 0.0f;
    }
  }
};

// Stage the input of the (row tile starting at r0, channels ci0 ...) step
// into `xs`.
template <typename T>
__device__ void stage_x(T* xs, const T* __restrict__ xi, int r0, int ci0, int c0,
                        const Shape& q) {
  constexpr int CH = Cfg<T>::kChunk;
  constexpr int KC = Cfg<T>::kKC;
  constexpr int kXRow = kSC / CH;  // chunks of one staged row
  for (int i = threadIdx.x; i < kSR * KC * kXRow; i += kThreads) {
    const int cc = i % kXRow;
    const int k = (i / kXRow) % KC;
    const int rr = i / (kXRow * KC);
    const int gr = r0 - 1 + rr, gc = c0 - 8 + cc * CH, ci = ci0 + k;
    const bool row_ok = gr >= 0 && gr < q.h && ci < q.cin;
    const T* src = xi + ((size_t)(row_ok ? ci : 0) * q.h + (row_ok ? gr : 0)) * q.w;
    T* dst = xs + (rr * KC + k) * kXS + cc * CH;
    if (q.xvec) {  // a 16-byte chunk lies all inside the image or all out
      const bool ok = row_ok && gc >= 0 && gc < q.w;
      cp_async16(dst, ok ? src + gc : xi, ok);
    } else {
#pragma unroll
      for (int e = 0; e < CH; ++e)
        dst[e] = row_ok && gc + e >= 0 && gc + e < q.w ? src[gc + e] : T(0.0f);
    }
  }
}

// Stage the weights of channels ci0 ... (all nine taps) into `ws`.
template <typename T>
__device__ void stage_w(T* ws, const T* __restrict__ w2, int ci0, int m0, const Shape& q) {
  constexpr int CH = Cfg<T>::kChunk;
  constexpr int KC = Cfg<T>::kKC;
  constexpr int kWRow = kBM / CH;
  for (int i = threadIdx.x; i < 9 * KC * kWRow; i += kThreads) {
    const int cc = i % kWRow;
    const int k = (i / kWRow) % KC;
    const int tap = i / (kWRow * KC);  // dx * 3 + dy, w2's row block
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

// Calls f(std::integral_constant<int, j>) for j = 0 .. J - 1, unrolled.
template <int J>
struct Tiles {
  template <typename F>
  __device__ __forceinline__ static void each(F f) {
    Tiles<J - 1>::each(f);
    f(std::integral_constant<int, J - 1>());
  }
};
template <>
struct Tiles<0> {
  template <typename F>
  __device__ __forceinline__ static void each(F) {}
};

// The products of one n8 tile, J of the warp's kNT + 2 (0: the left halo,
// P_0 only; kNT + 1: the right halo, P_2 only); mma(acc, A of dx) holds the
// tile's B fragments.
template <int J, typename AF, typename F>
__device__ __forceinline__ void tile_products(Acc& acc, const AF (&af)[3], F mma) {
  if constexpr (J == 0) {
    mma(acc.left, af[0]);
  } else if constexpr (J == kNT + 1) {
    mma(acc.right, af[2]);
  } else {
#pragma unroll
    for (int dx = 0; dx < 3; ++dx) mma(acc.p[dx][J - 1], af[dx]);
  }
}

// The products of one staged step, bf16: per dy and k16, the A fragments of
// the three dx by ldmatrix.trans from [k][co], the B fragments of the warp's
// kNT + 2 n8 tiles from staged row (warp row + dy), two tiles an ldmatrix.
__device__ __forceinline__ void step_products(Acc& acc, const __nv_bfloat16* xs,
                                              const __nv_bfloat16* ws, int wm, int wr,
                                              int wc, int lane) {
  using T = __nv_bfloat16;
  constexpr int KC = Cfg<T>::kKC;
  struct A4 {
    unsigned r[4];
  };
#pragma unroll
  for (int dy = 0; dy < 3; ++dy) {
#pragma unroll
    for (int k16 = 0; k16 < KC; k16 += 16) {
      A4 af[3];
#pragma unroll
      for (int dx = 0; dx < 3; ++dx)
        ldmatrix_x4_trans(af[dx].r, ws + ((dx * 3 + dy) * KC + k16 + (lane / 16) * 8 +
                                          lane % 8) * kWS +
                                         wm * 16 + (lane / 8 % 2) * 8);
      const T* xb = xs + ((wr + dy) * KC + k16 + lane % 16) * kXS + wc * kNT * 8 +
                    (lane / 16) * 8;
      Tiles<(kNT + 2) / 2>::each([&](auto pc) {
        constexpr int P = decltype(pc)::value;
        unsigned bf[4];
        ldmatrix_x4_trans(bf, xb + P * 16);
        tile_products<2 * P>(acc, af, [&](float (&d)[4], const A4& a) {
          mma_bf16(d, a.r, bf[0], bf[1]);
        });
        tile_products<2 * P + 1>(acc, af, [&](float (&d)[4], const A4& a) {
          mma_bf16(d, a.r, bf[2], bf[3]);
        });
      });
    }
  }
}

// f32 as three TF32 products: per dy and k8, A fragments (row co, column k)
// and B fragments (k = t (+4), column g) read as words from [k][co] and
// [k][column], split into TF32 high and low parts.
__device__ __forceinline__ void step_products(Acc& acc, const float* xs, const float* ws,
                                              int wm, int wr, int wc, int lane) {
  constexpr int KC = Cfg<float>::kKC;
  const int g = lane / 4, t = lane % 4;
  struct A4 {
    unsigned hi[4], lo[4];
  };
#pragma unroll
  for (int dy = 0; dy < 3; ++dy) {
#pragma unroll
    for (int k8 = 0; k8 < KC; k8 += 8) {
      A4 af[3];
#pragma unroll
      for (int dx = 0; dx < 3; ++dx) {
        const float* wp = ws + ((dx * 3 + dy) * KC + k8 + t) * kWS + wm * 16 + g;
        split_tf32(wp[0], af[dx].hi[0], af[dx].lo[0]);
        split_tf32(wp[8], af[dx].hi[1], af[dx].lo[1]);
        split_tf32(wp[4 * kWS], af[dx].hi[2], af[dx].lo[2]);
        split_tf32(wp[4 * kWS + 8], af[dx].hi[3], af[dx].lo[3]);
      }
      const float* xb = xs + ((wr + dy) * KC + k8 + t) * kXS + wc * kNT * 8 + g;
      Tiles<kNT + 2>::each([&](auto jc) {
        constexpr int J = decltype(jc)::value;
        unsigned bh0, bl0, bh1, bl1;
        split_tf32(xb[J * 8], bh0, bl0);
        split_tf32(xb[4 * kXS + J * 8], bh1, bl1);
        tile_products<J>(acc, af, [&](float (&d)[4], const A4& a) {
          mma_tf32(d, a.lo, bh0, bh1);
          mma_tf32(d, a.hi, bl0, bl1);
          mma_tf32(d, a.hi, bh0, bh1);
        });
      });
    }
  }
}

// out[j] = P_0[j - 1] + P_1[j] + P_2[j + 1] for the warp's kNT n8 tiles of
// output row r, then bias, activation and the store. Fragment element e of
// an m16n8 tile: row (channel) g + 8 (e / 2), column 2t + e % 2.
template <typename TOut>
__device__ __forceinline__ void epilogue(const Acc& acc, TOut* __restrict__ out,
                                         const float* __restrict__ bias, int n, int r,
                                         int col0, int co0, int lane, const Shape& q) {
  const int g = lane / 4, t = lane % 4;
  const bool pairs = q.w % 2 == 0;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int co = co0 + g + 8 * half;
    const bool row_ok = co < q.cout && r < q.h;
    const float bv = row_ok ? __ldg(bias + co) : 0.0f;
    TOut* o = out + (((size_t)n * q.cout + (row_ok ? co : 0)) * q.h + (row_ok ? r : 0)) * q.w;
    const int e0 = 2 * half, e1 = 2 * half + 1;
#pragma unroll
    for (int i = 0; i < kNT; ++i) {
      const float prev = i == 0 ? acc.left[e1] : acc.p[0][i == 0 ? 0 : i - 1][e1];
      const float next = i == kNT - 1 ? acc.right[e0] : acc.p[2][i == kNT - 1 ? 0 : i + 1][e0];
      // every lane takes part in the shuffles
      const float up = __shfl_up_sync(0xffffffffu, acc.p[0][i][e1], 1);
      const float wrap_l = __shfl_down_sync(0xffffffffu, prev, 3);
      const float down = __shfl_down_sync(0xffffffffu, acc.p[2][i][e0], 1);
      const float wrap_r = __shfl_up_sync(0xffffffffu, next, 3);
      const float y0 = (t == 0 ? wrap_l : up) + acc.p[1][i][e0] + acc.p[2][i][e1];
      const float y1 = acc.p[0][i][e0] + acc.p[1][i][e1] + (t == 3 ? wrap_r : down);
      const int col = col0 + i * 8 + 2 * t;
      if (!row_ok || col >= q.w) continue;
      const float v0 = activate(y0 + bv, q.act);
      if (col + 1 < q.w) {
        const float v1 = activate(y1 + bv, q.act);
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

// kResident: the block's weights (all channel chunks) are staged once, in
// front of a ring that then carries only the input; otherwise each ring
// stage carries its chunk's weights beside its input.
template <typename T, typename TOut, bool kResident>
__global__ void __launch_bounds__(kThreads, 1)
conv_shift_mma(const T* __restrict__ x, const T* __restrict__ w2,
               const float* __restrict__ bias, TOut* __restrict__ out, Shape q) {
  using L = Layout<T>;
  constexpr int KC = Cfg<T>::kKC;
  constexpr int S = Cfg<T>::kStages;
  constexpr int kSlot = kResident ? L::kXElems : L::kStageElems;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* smem = reinterpret_cast<T*>(smem_raw);

  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  const int wm = warp % kWM;
  const int wr = warp / kWM % kWR;
  const int wc = warp / (kWM * kWR);
  // Cout tile fastest in the grid: blocks of the same pixels run together
  // and share their input in L2
  const int m0 = (blockIdx.x % q.n_ct) * kBM;
  const int c0 = (blockIdx.x / q.n_ct) * kTW;
  const int rt0 = blockIdx.y * q.strip;
  const int n_rt = min(q.strip, q.n_rt - rt0);
  const T* xi = x + (size_t)blockIdx.z * q.cin * q.h * q.w;
  const int n_ck = (q.cin + KC - 1) / KC;
  const int n_steps = n_rt * n_ck;
  T* ring = smem + (kResident ? n_ck * L::kWElems : 0);
  auto load = [&](int step) {
    T* slot = ring + (step % S) * kSlot;
    const int ck = step % n_ck;
    stage_x(slot, xi, (rt0 + step / n_ck) * kTH, ck * KC, c0, q);
    if (!kResident) stage_w(slot + L::kXElems, w2, ck * KC, m0, q);
  };

  Acc acc;
  acc.zero();
  if (kResident) {  // in the first commit group, with step 0's input
    for (int ck = 0; ck < n_ck; ++ck) stage_w(smem + ck * L::kWElems, w2, ck * KC, m0, q);
  }
#pragma unroll
  for (int s = 0; s < S - 1; ++s) {
    if (s < n_steps) load(s);
    cp_async_commit();
  }
  for (int s = 0; s < n_steps; ++s) {
    cp_async_wait<S - 2>();
    __syncthreads();
    if (s + S - 1 < n_steps) load(s + S - 1);
    cp_async_commit();

    const T* xs = ring + (s % S) * kSlot;
    const T* ws = kResident ? smem + (s % n_ck) * L::kWElems : xs + L::kXElems;
    step_products(acc, xs, ws, wm, wr, wc, lane);
    if (s % n_ck == n_ck - 1) {  // the row tile's last channel chunk
      epilogue(acc, out, bias, blockIdx.z, (rt0 + s / n_ck) * kTH + wr,
               c0 + wc * kNT * 8, m0 + wm * 16, lane, q);
      acc.zero();
    }
  }
  cp_async_wait<0>();
}

template <typename T, typename TOut, bool kResident>
cudaError_t launch_as(const void* x, const void* w2, const float* bias, void* out, int n,
                      const Shape& q, dim3 grid, size_t smem, cudaStream_t stream) {
  auto kernel = conv_shift_mma<T, TOut, kResident>;
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
  using L = Layout<T>;
  constexpr int CH = Cfg<T>::kChunk;
  constexpr int S = Cfg<T>::kStages;
  Shape q{};
  q.cin = cin, q.h = h, q.w = w, q.cout = cout, q.act = act;
  q.n_ct = (cout + kBM - 1) / kBM;
  q.n_rt = (h + kTH - 1) / kTH;
  const int n_wt = (w + kTW - 1) / kTW;
  // row tiles a block: enough blocks for several waves, at most kStrip
  const long long blocks = (long long)q.n_ct * n_wt * n * q.n_rt;
  q.strip = (int)max(1LL, min((long long)kStrip, blocks / (132 * 8)));
  q.xvec = w % CH == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  q.wvec = cout % CH == 0 && reinterpret_cast<uintptr_t>(w2) % 16 == 0;
  const long long gx = (long long)q.n_ct * n_wt;
  const int gy = (q.n_rt + q.strip - 1) / q.strip;
  if (gx > 0x7fffffffLL || gy > 65535 || n > 65535) return cudaErrorInvalidValue;
  const dim3 grid((unsigned)gx, gy, n);
  // the weights stay resident when they fit beside the input's ring
  const long long n_ck = (cin + Cfg<T>::kKC - 1) / Cfg<T>::kKC;
  const size_t resident =
      sizeof(T) * (size_t)(n_ck * L::kWElems + (long long)S * L::kXElems);
  if (resident <= kSmemMax)
    return launch_as<T, TOut, true>(x, w2, bias, out, n, q, grid, resident, stream);
  return launch_as<T, TOut, false>(x, w2, bias, out, n, q, grid, L::kSmemBytes, stream);
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
