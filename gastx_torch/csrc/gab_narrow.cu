// The eval graph-attention block (GAB) at narrow widths in one pass, for
// sm_90a.
//
// Replaces gastx/ops/pallas/fused_gab.py:959 `fused_gab_pbatch`, the TPU's
// whole-block kernel for C < 128 (it packs 128 // C frames into the lanes so
// that a narrow level runs the block in one pass without padding waste).
// For rows r = frame * J + q of x (rows, C) it computes, with every BN
// folded on the host into scale/shift (the tables of `gab_tables`):
//
//   P      = x @ w_proj * proj_scale + proj_shift      (rows, 4C + 2KI + KG)
//   ab     = relu(BN(sem_graph(P[:, :4C])))            (rows, 2C)  sym | con
//   local  = relu(BN(ab @ lcat_w))                     (rows, C)
//   heads  = per frame and head k: softmax_m(LeakyReLU_0.2(theta_k[q] .
//            p_theta[k] + phi_k[m] . p_phi[k])) + C_k[k, q, m], applied to
//            g_k; head-major                           (rows, KG)
//   global = relu(BN(heads @ acat_w))                  (rows, C)
//   out    = relu(BN([x | local | global] @ gcat_w))   (rows, 2C)
//
// the same function as the chain of gemm_epilogue / sem_graph /
// joint_attention launches in gastx_torch/ops/cuda/fused_gab.py. Shapes:
// C in {16, 32, 48, 64, 80, 96}, K <= 4 heads with K*I = K*G = C, J <= 32
// joints, D <= 8 neighbour slots (kernels.narrow_shape_ok, the same rule).
//
// Bound on this card: the block reads x (C floats a row) and writes 2C, and
// does 2 * 16 * C^2 FLOPs a row in its products (33 kFLOP at C=32, 131
// kFLOP at C=64), some 90 to 180 FLOPs per byte of device memory, far above
// the float32 ridge of ~20: the SMs' float32 FMA rate bounds it, so the
// design is about keeping the FMA pipes busy. The earlier one-pass design
// ran at 4.3-5.3x that bound, for four reasons, and this one answers each:
//
// 1. Few FMAs between barriers. It staged 16-row weight slabs of one
//    32-lane column strip, so a thread did 160-560 FMAs a barrier, and its
//    ring drained at every product's end. Here a slab holds all N columns
//    of a product, 32 rows where C allows (16 at C = 16, 48, 80), and a
//    thread owns 4 rows x 4 columns of each C-wide output group, so it does
//    512-1024 FMAs a barrier; the slabs of all seven products of every
//    tile run as one cp.async stream (2 slabs of 32 rows in the ring, or 3
//    of 16) that never drains: the next product's first slab is in flight
//    during the semantic graph and attention.
// 2. Scalar shared loads. Every activation lives in shared memory
//    column-major (a group's column k is BMP floats from column k+1), which
//    is k-major for the products, so both operands come in as 16-byte
//    loads: per k a thread loads one float4 of A and N/C float4 of W for 16
//    N/C FMAs (8:1 and 10.7:1), and a warp of 4 x 8 threads reads 64
//    distinct bytes of A and 128 of each W group.
// 3. Weights read again for every small tile. A tile is BM = 256 rows at
//    C <= 32 (15 frames of J = 17), 128 at C = 48..64 (7 frames), 64 at C
//    >= 80, against 34 rows at C=64 before, so the weights stream from L2
//    3.5x less often. Blocks are persistent (as many as fit, each walking
//    tiles) with 512 threads at C = 32 and 64, so the score vectors, C_k and
//    the neighbour table load once a block, and the next tile's x and
//    semantic-graph weights come in by cp.async during the block concat.
// 4. A 7C-wide P. No more than five C-wide column groups are live a row:
//    the semantic columns are projected and aggregated one branch at a
//    time, the graph writing ab over its self columns, and theta/phi and g
//    come after the local branch, into groups it no longer needs (the
//    group plan is at the kernel). A group also stages a branch's graph
//    weights, so the graph reads them from shared memory.
//
// Attention runs one warp per (frame, head), one lane per query joint; the
// key scores come from the other lanes by shuffle, so no J x J score
// matrix is stored, and g is row-major so that every lane reads the same
// float4. Float32 FMAs only: no tensor cores. At C = 80 and 96 the tile of
// 64 rows holds 3 frames and the kernel loses to the chain on the card;
// kernels.gab_route sends those widths to the chain.
//
// bf16 I/O (bf16 storage, as the TPU kernel reads and writes its block in
// the input's dtype): with x_bf16, x is bf16 and is upcast exactly as it
// is staged into shared memory (plain loads in place of the 4-byte
// cp.async copies, which cannot convert); with out_bf16, the block
// concat's output is rounded to bf16 (nearest even) as it is stored, 8
// bytes for 4 values. Everything between stays float32 in shared memory.
// The flags are read at run time, in a library of their own (below).
//
// Built with GASTX_TIERED_FORM, the file holds the tiered form alone
// (gab_narrow_tiered, below: a design of its own for the tensor cores) in
// libraries of its own (kernels.py, TIERED_SOURCES), so that the two forms
// compile side by side.
//
// Each form also has a fold instantiation (FoldCfg; the C functions' fold
// flag): the function of fused_gab_pbatch(..., form="fold") on the tables
// of gab_tables(..., "fold"), whose projection holds each head's scores
// already folded with its score vectors (the note at gab_narrow_kernel);
// C <= 64, I = 1 and K = 2 or 4.
#include <cuda_bf16.h>
#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

// GASTX_BF16_IO builds the bf16-I/O library (kernels.py, IO_SOURCES), whose
// code reads the dtype bits; the float32 library's has no dtype branch.
#ifdef GASTX_BF16_IO
constexpr bool BF16_IO = true;
#else
constexpr bool BF16_IO = false;
#endif

// GASTX_NARROW_PART builds one part of a library (kernels.py, NARROW_PARTS:
// two nvcc processes whose objects are linked into one library): 1 the v1
// instantiations and the C functions, 2 the fold instantiations. Without
// it the file builds whole.
#if !defined(GASTX_NARROW_PART) || GASTX_NARROW_PART == 1
#define NARROW_V1 1
#else
#define NARROW_V1 0
#endif
#if !defined(GASTX_NARROW_PART) || GASTX_NARROW_PART == 2
#define NARROW_FOLD 1
#else
#define NARROW_FOLD 0
#endif

namespace {

constexpr int MAX_J = 32;    // joints a frame may have (one lane each)
constexpr int MAX_D = 8;     // neighbour slots of a joint in sem_graph
constexpr int MAX_HEADS = 4;
constexpr unsigned FULL = 0xffffffffu;

struct Tables {
  const float *w_proj, *proj_scale, *proj_shift;
  const float *w_self, *w_nbr;
  const int* col;
  const float *sem_scale, *sem_shift;
  const float *lcat_w, *lcat_scale, *lcat_shift;
  const float *proj_t, *proj_p, *c_k;
  const float *acat_w, *acat_scale, *acat_shift;
  const float *gcat_w, *gcat_scale, *gcat_shift;
};

// A width's tiling: RTH x C/4 threads, each holding TM rows (TM/4 groups of
// 4, RTH * 4 rows apart) of every C-wide column group (4 columns each), and
// a ring of STAGES weight slabs of BK rows. The tile's activations are five
// groups of C columns of BMP floats (group 0 holds x; see the kernel).
template <int C_, int RTH_, int TM_, int MINB_, int BK_, int STAGES_>
struct Cfg {
  static constexpr int C = C_;
  static constexpr int RTH = RTH_;
  static constexpr int CTH = C_ / 4;
  static constexpr int NT = RTH_ * CTH;
  static constexpr int TM = TM_;
  static constexpr int BM = RTH_ * TM_;
  static constexpr int BMP = BM + 4;
  static constexpr int GROUP = C_ * BMP;     // floats of a column group
  static constexpr int MINB = MINB_;
  static constexpr int BK = BK_;
  static constexpr int STAGES = STAGES_;
  static constexpr int SLAB = BK_ * 2 * C_;  // the widest product's slab
  static constexpr int S = C_ / BK_;         // slabs of C rows of K
  static constexpr int SPT = 10 * S;         // slabs a tile
  static constexpr bool FOLD = false;
  static_assert(C_ % BK_ == 0 && TM_ % 4 == 0 && RTH_ % 4 == 0 &&
                    NT % 32 == 0 && STAGES_ >= 2, "tiling");
};

// The fold form of a tiling (the note at gab_narrow_kernel): the same
// tiles, and a tile's stream without P4, 9S slabs.
template <class G_>
struct FoldCfg : G_ {
  static constexpr int SPT = 9 * G_::S;
  static constexpr bool FOLD = true;
};

// The widest C of the fold form (kernels.NARROW_FOLD_WIDTHS), in both
// forms: the v1 kernel loses to the chain above C = 64.
constexpr int MAX_FOLD_C = 64;

// Stages slab i of the block's stream into its ring slot: slab i % SPT of
// a tile, whose seven products take S, S, 2S, S, S, S and 3S slabs (the
// fold form's six, without P4: S, S, 2S, S, S and 3S; its w_proj rows are
// 4C + 2K + C floats, K = nh heads, and g starts at column 4C + 2K).
template <class G>
__device__ __forceinline__ void stage(const Tables& t, float* ring,
                                      long long i, long long total, int nh) {
  constexpr int C = G::C, S = G::S;
  if (i < total) {
    const int s = (int)(i % G::SPT);
    const float* w;
    int ld, n, k0;
    if constexpr (G::FOLD) {
      const int lp = 5 * C + 2 * nh;
      if (s < S) {  // P1
        w = t.w_proj; ld = lp; n = 2 * C; k0 = s;
      } else if (s < 2 * S) {  // P2
        w = t.w_proj + 2 * C; ld = lp; n = 2 * C; k0 = s - S;
      } else if (s < 4 * S) {  // P3
        w = t.lcat_w; ld = C; n = C; k0 = s - 2 * S;
      } else if (s < 5 * S) {  // P5: g
        w = t.w_proj + 4 * C + 2 * nh; ld = lp; n = C; k0 = s - 4 * S;
      } else if (s < 6 * S) {  // P6
        w = t.acat_w; ld = C; n = C; k0 = s - 5 * S;
      } else {  // P7
        w = t.gcat_w; ld = 2 * C; n = 2 * C; k0 = s - 6 * S;
      }
    } else if (s < S) {         // P1: sym semantic columns
      w = t.w_proj; ld = 7 * C; n = 2 * C; k0 = s;
    } else if (s < 2 * S) {  // P2: con
      w = t.w_proj + 2 * C; ld = 7 * C; n = 2 * C; k0 = s - S;
    } else if (s < 4 * S) {  // P3: local cat
      w = t.lcat_w; ld = C; n = C; k0 = s - 2 * S;
    } else if (s < 5 * S) {  // P4: theta | phi
      w = t.w_proj + 4 * C; ld = 7 * C; n = 2 * C; k0 = s - 4 * S;
    } else if (s < 6 * S) {  // P5: g
      w = t.w_proj + 6 * C; ld = 7 * C; n = C; k0 = s - 5 * S;
    } else if (s < 7 * S) {  // P6: global cat
      w = t.acat_w; ld = C; n = C; k0 = s - 6 * S;
    } else {                 // P7: block concat
      w = t.gcat_w; ld = 2 * C; n = 2 * C; k0 = s - 7 * S;
    }
    k0 *= G::BK;
    float* buf = ring + (int)(i % G::STAGES) * G::SLAB;
    const int q = n / 4;  // 16-byte chunks a slab row
    for (int e = threadIdx.x; e < G::BK * q; e += G::NT) {
      const int kl = e / q, cl = (e - kl * q) * 4;
      __pipeline_memcpy_async(buf + kl * n + cl,
                              w + (size_t)(k0 + kl) * ld + cl, 16);
    }
  }
  __pipeline_commit();
}

// Copies n floats, by 4-byte cp.async copies if ASYNC.
template <class G, bool ASYNC>
__device__ __forceinline__ void copy_floats(float* dst, const float* src,
                                            int n) {
  for (int e = threadIdx.x; e < n; e += G::NT) {
    if (ASYNC)
      __pipeline_memcpy_async(dst + e, src + e, 4);
    else
      dst[e] = __ldg(src + e);
  }
}

// x rows of the tile (row-major, `rows` of them, float32 or, with bf,
// bf16) into activation group 0, column-major; the rows past them zero.
template <class G, bool ASYNC>
__device__ __forceinline__ void load_x(const void* __restrict__ xg, bool bf,
                                       float* xs, int rows) {
  constexpr int C = G::C;
  const float* xf = static_cast<const float*>(xg);
  const unsigned short* xb = static_cast<const unsigned short*>(xg);
  for (int e = threadIdx.x; e < G::BM * C; e += G::NT) {
    const int r = e / C, c = e - r * C;
    float* dst = xs + c * G::BMP + r;
    if (r >= rows)
      *dst = 0.f;
    else if (bf)
      *dst = __uint_as_float(static_cast<uint32_t>(__ldg(xb + e)) << 16);
    else if (ASYNC)
      __pipeline_memcpy_async(dst, xf + e, 4);
    else
      *dst = __ldg(xf + e);
  }
}

// float32 to bf16 bits, rounded to nearest even (finite values).
__device__ __forceinline__ uint32_t float_to_bf16(float f) {
  const uint32_t u = __float_as_uint(f);
  return (u + 0x7fffu + ((u >> 16) & 1u)) >> 16;
}

// The element at index i of a float32 (bf false) or bf16 array.
__device__ __forceinline__ const void* elem_ptr(const void* p, long long i,
                                                bool bf) {
  return static_cast<const char*>(p) + i * (bf ? 2 : 4);
}

// The semantic-graph weights of branch b in their order in a staged group:
// w_self (J, C) | w_nbr (J, D, C) | scale (C) | shift (C).
template <class G, bool ASYNC>
__device__ __forceinline__ void load_sem(const Tables& t, float* dst, int j,
                                         int d, int b) {
  constexpr int C = G::C;
  copy_floats<G, ASYNC>(dst, t.w_self + b * j * C, j * C);
  copy_floats<G, ASYNC>(dst + j * C, t.w_nbr + b * j * d * C, j * d * C);
  copy_floats<G, ASYNC>(dst + j * (1 + d) * C, t.sem_scale + b * C, C);
  copy_floats<G, ASYNC>(dst + j * (1 + d) * C + C, t.sem_shift + b * C, C);
}

// What P7 brings in for the next tile, past the reads of each group: the
// semantic-graph weights of both branches (into groups 4 and 3, if staged)
// and x (into group 0).
struct Prefetch {
  const void* x;
  bool x_bf;
  int rows, j, d;
  bool sem;
};

__device__ __forceinline__ float comp(const float4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

// The thread's place in the RTH x CTH grid. Where CTH is a multiple of 8 a
// warp is 4 x 8 threads (16 rows by 32 columns of a group), so a k step's
// A and W loads are 64 and 128 distinct bytes; else a warp runs along CTH.
template <class G>
__device__ __forceinline__ void thread_tile(int& rt, int& ct) {
  if (G::CTH % 8 == 0) {
    constexpr int WC = G::CTH / 8;
    const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
    ct = (warp % WC) * 8 + lane % 8;
    rt = (warp / WC) * 4 + lane / 8;
  } else {
    ct = threadIdx.x % G::CTH;
    rt = threadIdx.x / G::CTH;
  }
}

// One product over the tile's BM rows: out[r, n] = epi(sum_k A[r, k]
// W[k, n]), N = MM * C, K = NS * BK. Column k of A is column k % C of group
// a[k / C]; W streams through the ring (slab counter g). epi = * scale +
// shift, then ReLU if RELU. Output column group j goes to group o[j]
// (column-major, or row-major with C floats a row if ROW_MAJOR), or, if
// TO_GLOBAL, to rows < rows_valid of the row-major (rows, N) `out`, while
// `pre` brings in the next tile. With `on` false only the weights stream.
// nh: the block's heads (the fold form's stream reads it).
template <class G, int MM, int NS, bool RELU, bool TO_GLOBAL,
          bool ROW_MAJOR = false>
__device__ __forceinline__ void product(
    bool on, const Tables& t, float* ring, long long& g, long long total,
    int nh, float* acts, int a0, int a1, int a2, const float* scale,
    const float* shift, int o0, int o1, void* out = nullptr,
    int rows_valid = 0, const Prefetch* pre = nullptr, bool out_bf = false) {
  constexpr int C = G::C, N = MM * C, TM = G::TM, BMP = G::BMP;
  constexpr int BK = G::BK, S = G::S;
  int rt, ct;
  thread_tile<G>(rt, ct);
  float acc[TM][4 * MM];
#pragma unroll
  for (int m = 0; m < TM; ++m)
#pragma unroll
    for (int n = 0; n < 4 * MM; ++n) acc[m][n] = 0.f;
  for (int s = 0; s < NS; ++s) {
    __pipeline_wait_prior(G::STAGES - 2);
    __syncthreads();  // slab g has landed; slab g - 1 is read
    if (pre != nullptr) {
      // Groups 4 and 1 are free; group 0 from slab S, group 3 from 2S on
      // (each lands with this slab's copies, before the next tile needs
      // it).
      if (s == 0 && pre->sem)
        load_sem<G, true>(t, acts + 4 * G::GROUP, pre->j, pre->d, 0);
      if (s == S && pre->x != nullptr)
        load_x<G, true>(pre->x, pre->x_bf, acts, pre->rows);
      if (s == 2 * S && pre->sem)
        load_sem<G, true>(t, acts + 3 * G::GROUP, pre->j, pre->d, 1);
    }
    stage<G>(t, ring, g + G::STAGES - 1, total, nh);
    const float* w = ring + (int)(g % G::STAGES) * G::SLAB + 4 * ct;
    ++g;
    if (!on) continue;
    const int k0 = s * BK, piece = k0 / C;
    const float* a =
        acts + (size_t)(piece == 0 ? a0 : piece == 1 ? a1 : a2) * G::GROUP +
        (size_t)(k0 - piece * C) * BMP + 4 * rt;
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      float4 av[TM / 4], wv[MM];
#pragma unroll
      for (int i = 0; i < TM / 4; ++i)
        av[i] = *reinterpret_cast<const float4*>(a + kk * BMP +
                                                 i * 4 * G::RTH);
#pragma unroll
      for (int j = 0; j < MM; ++j)
        wv[j] = *reinterpret_cast<const float4*>(w + kk * N + j * C);
#pragma unroll
      for (int m = 0; m < TM; ++m)
#pragma unroll
        for (int n = 0; n < 4 * MM; ++n)
          acc[m][n] = fmaf(comp(av[m / 4], m % 4), comp(wv[n / 4], n % 4),
                           acc[m][n]);
    }
  }
  if (!on) return;
#pragma unroll
  for (int j = 0; j < MM; ++j) {
    const int c0 = 4 * ct + j * C;
    float sc[4], sh[4];
#pragma unroll
    for (int v = 0; v < 4; ++v) {
      sc[v] = __ldg(scale + c0 + v);
      sh[v] = __ldg(shift + c0 + v);
    }
#pragma unroll
    for (int m = 0; m < TM; ++m)
#pragma unroll
      for (int v = 0; v < 4; ++v) {
        float y = acc[m][4 * j + v] * sc[v] + sh[v];
        acc[m][4 * j + v] = RELU ? fmaxf(y, 0.f) : y;
      }
    if (TO_GLOBAL && out_bf) {
      unsigned short* base = static_cast<unsigned short*>(out) + c0;
#pragma unroll
      for (int m = 0; m < TM; ++m) {
        const int r = 4 * rt + (m / 4) * 4 * G::RTH + m % 4;
        if (r < rows_valid)
          *reinterpret_cast<uint2*>(base + (size_t)r * N) = make_uint2(
              float_to_bf16(acc[m][4 * j]) |
                  float_to_bf16(acc[m][4 * j + 1]) << 16,
              float_to_bf16(acc[m][4 * j + 2]) |
                  float_to_bf16(acc[m][4 * j + 3]) << 16);
      }
    } else if (TO_GLOBAL || ROW_MAJOR) {
      float* base = TO_GLOBAL ? static_cast<float*>(out) + c0
                              : acts + (size_t)(j ? o1 : o0) * G::GROUP +
                                    4 * ct;
      const int ld = TO_GLOBAL ? N : C;
#pragma unroll
      for (int m = 0; m < TM; ++m) {
        const int r = 4 * rt + (m / 4) * 4 * G::RTH + m % 4;
        if (!TO_GLOBAL || r < rows_valid)
          *reinterpret_cast<float4*>(base + (size_t)r * ld) =
              make_float4(acc[m][4 * j], acc[m][4 * j + 1],
                          acc[m][4 * j + 2], acc[m][4 * j + 3]);
      }
    } else {
      float* base = acts + (size_t)(j ? o1 : o0) * G::GROUP +
                    (size_t)(4 * ct) * BMP + 4 * rt;
#pragma unroll
      for (int i = 0; i < TM / 4; ++i)
#pragma unroll
        for (int v = 0; v < 4; ++v)
          *reinterpret_cast<float4*>(base + v * BMP + i * 4 * G::RTH) =
              make_float4(acc[4 * i][4 * j + v], acc[4 * i + 1][4 * j + v],
                          acc[4 * i + 2][4 * j + v],
                          acc[4 * i + 3][4 * j + v]);
    }
  }
}

// One (joint, channel) pair of the semantic graph: its weights and
// neighbours, and its self column, in place of which it writes.
struct SemPair {
  float w_self, sc, sh, wn[MAX_D];
  int nb[MAX_D];
  float* h0;
  const float* h1;
};

// Where a branch's semantic-graph weights are read from: a staged group,
// or the tables at the branch's offsets.
struct SemSrc {
  const float *w_self, *w_nbr, *sc, *sh;
};

template <class G>
__device__ __forceinline__ SemSrc sem_src(const Tables& t, const float* staged,
                                          int j, int d, int b) {
  constexpr int C = G::C;
  if (staged != nullptr)
    return {staged, staged + j * C, staged + j * (1 + d) * C,
            staged + j * (1 + d) * C + C};
  return {t.w_self + b * j * C, t.w_nbr + b * j * d * C,
          t.sem_scale + b * C, t.sem_shift + b * C};
}

template <class G>
__device__ __forceinline__ SemPair sem_pair(const SemSrc& w, const int* col,
                                            float* self, const float* nbr,
                                            int ch, int q, int j, int d,
                                            int b) {
  constexpr int C = G::C, BMP = G::BMP;
  const int bq = b * j + q;
  SemPair p;
#pragma unroll
  for (int dd = 0; dd < MAX_D; ++dd) {
    p.wn[dd] = dd < d ? w.w_nbr[(q * d + dd) * C + ch] : 0.f;
    p.nb[dd] = dd < d ? col[bq * d + dd] : 0;
  }
  p.w_self = w.w_self[q * C + ch];
  p.sc = w.sc[ch];
  p.sh = w.sh[ch];
  p.h0 = self + ch * BMP + q;
  p.h1 = nbr + ch * BMP;
  return p;
}

__device__ __forceinline__ void sem_row(const SemPair& p, int r0, int d) {
  float acc = p.h0[r0] * p.w_self;
#pragma unroll
  for (int dd = 0; dd < MAX_D; ++dd) {
    if (dd >= d) break;
    acc = fmaf(p.h1[r0 + p.nb[dd]], p.wn[dd], acc);
  }
  p.h0[r0] = fmaxf(acc * p.sc + p.sh, 0.f);
}

// Semantic graph aggregation of branch b (0 sym, 1 con) from its self and
// neighbour columns: ab = relu(BN(h0 * w_self + sum_d h1[nbr_d] * w_nbr_d)),
// written over h0 (each value is read by the thread that writes it alone).
// A thread takes two (joint, channel) pairs at a time and their weights
// once, for every frame of the tile. A warp's lanes are 8 channels x 4
// joints, so its shared loads and stores fall in 32 distinct banks (and
// weight loads from device memory, where they are not staged, are 32-byte
// runs).
template <class G>
__device__ __forceinline__ void sem_graph(const SemSrc& w, const int* col,
                                          float* self, const float* nbr,
                                          int nf, int j, int d, int b) {
  constexpr int C = G::C, CB = C / 8;
  const int pairs = ((j + 3) / 4) * 4 * C;
  const int lane = threadIdx.x % 32;
  for (int idx = threadIdx.x; idx < pairs; idx += 2 * G::NT) {
    const int blk0 = idx / 32, blk1 = (idx + G::NT) / 32;
    const int ch0 = (blk0 % CB) * 8 + lane % 8;
    const int q0 = (blk0 / CB) * 4 + lane / 8;
    const int ch1 = (blk1 % CB) * 8 + lane % 8;
    const int q1 = (blk1 / CB) * 4 + lane / 8;
    const bool on0 = q0 < j, on1 = idx + G::NT < pairs && q1 < j;
    const SemPair p0 = sem_pair<G>(w, col, self, nbr, ch0, on0 ? q0 : 0, j,
                                   d, b);
    const SemPair p1 = sem_pair<G>(w, col, self, nbr, ch1, on1 ? q1 : 0, j,
                                   d, b);
    for (int r0 = 0; r0 < nf * j; r0 += j) {
      if (on0) sem_row(p0, r0, d);
      if (on1) sem_row(p1, r0, d);
    }
  }
}

__device__ __forceinline__ float leaky(float f) {
  return f > 0.f ? f : 0.2f * f;
}

// The fold form's score columns in shared memory: column kk of w_proj's
// [sa | sb] (4C + kk, kk < 2K) as C floats from kk * C, then their 2K
// scales and 2K shifts (fold_floats of them).
__host__ __device__ constexpr int fold_floats(int c, int nh) {
  return 2 * nh * c + 4 * nh;
}

template <class G>
__device__ __forceinline__ void load_fold(const Tables& t, float* dst,
                                          int nh) {
  constexpr int C = G::C;
  const int ld = 5 * C + 2 * nh, n = 2 * nh * C;
  for (int e = threadIdx.x; e < n; e += G::NT) {
    const int kk = e / C, c = e - kk * C;
    dst[e] = __ldg(t.w_proj + (size_t)c * ld + 4 * C + kk);
  }
  for (int e = threadIdx.x; e < 2 * nh; e += G::NT) {
    dst[n + e] = __ldg(t.proj_scale + 4 * C + e);
    dst[n + 2 * nh + e] = __ldg(t.proj_shift + 4 * C + e);
  }
}

// Per-frame multi-head attention over the joints of the tile's nf frames:
// theta and phi column-major, g row-major (C floats a row; head-major, I =
// G = C / K columns a head; I is a multiple of 4). Each head's outputs go
// over its theta columns. proj_t/proj_p (K, I) and c_k (K, J, J) are the
// block's copies. The fold form (G::FOLD) takes no theta or phi: each
// lane's scores are its row of x (xs, column-major) against the head's
// folded columns, which proj_t then holds (load_fold), and the heads go
// to `theta`'s group, G = C / K columns a head.
template <class G>
__device__ __forceinline__ void attention(float* theta, const float* phi,
                                          const float* gv, int nf, int j,
                                          int nheads, const float* proj_t,
                                          const float* proj_p,
                                          const float* c_k,
                                          const float* xs) {
  constexpr int C = G::C, BMP = G::BMP;
  const int warp = threadIdx.x / 32, q = threadIdx.x % 32;
  const int inter = C / nheads;
  for (int pair = warp; pair < nf * nheads; pair += G::NT / 32) {
    const int fr = pair / nheads, k = pair - fr * nheads;
    const int row0 = fr * j;
    float sa = 0.f, sb = 0.f;
    if constexpr (G::FOLD) {
      if (q < j) {
        const float* xr = xs + row0 + q;
        const float* wa = proj_t + k * C;
        const float* wb = proj_t + (nheads + k) * C;
#pragma unroll 4
        for (int c = 0; c < C; ++c) {
          const float v = xr[c * BMP];
          sa = fmaf(v, wa[c], sa);
          sb = fmaf(v, wb[c], sb);
        }
        const float* ss = proj_t + 2 * nheads * C;
        sa = sa * ss[k] + ss[2 * nheads + k];
        sb = sb * ss[nheads + k] + ss[3 * nheads + k];
      }
    } else if (q < j) {
#pragma unroll 4
      for (int i = 0; i < inter; ++i) {
        const int cc = k * inter + i;
        sa = fmaf(theta[cc * BMP + row0 + q], proj_t[cc], sa);
        sb = fmaf(phi[cc * BMP + row0 + q], proj_p[cc], sb);
      }
    }
    // Lane q's attention row, softmaxed with its max subtracted, + C_k.
    // (The loops run to MAX_J so that w stays in registers, and leave at J.)
    float w[MAX_J];
    float mx = -INFINITY;
#pragma unroll
    for (int m = 0; m < MAX_J; ++m) {
      if (m >= j) break;
      w[m] = leaky(sa + __shfl_sync(FULL, sb, m));
      mx = fmaxf(mx, w[m]);
    }
    float sum = 0.f;
#pragma unroll
    for (int m = 0; m < MAX_J; ++m) {
      if (m >= j) break;
      w[m] = expf(w[m] - mx);
      sum += w[m];
    }
    const float inv = 1.f / sum;
    const float* ck = c_k + (k * j + (q < j ? q : 0)) * j;
#pragma unroll
    for (int m = 0; m < MAX_J; ++m) {
      if (m >= j) break;
      w[m] = w[m] * inv + ck[m];
    }
    // Every lane reads the same float4 of g (a broadcast). Lane q reads
    // theta of its own row alone, so it may write there.
    const float* gk = gv + (size_t)row0 * C + k * inter;
    for (int g0 = 0; g0 < inter; g0 += 8) {
      const bool hi = g0 + 4 < inter;
      float4 lo4 = make_float4(0.f, 0.f, 0.f, 0.f), hi4 = lo4;
#pragma unroll
      for (int m = 0; m < MAX_J; ++m) {
        if (m >= j) break;
        const float4 a = *reinterpret_cast<const float4*>(gk + m * C + g0);
        lo4.x = fmaf(w[m], a.x, lo4.x);
        lo4.y = fmaf(w[m], a.y, lo4.y);
        lo4.z = fmaf(w[m], a.z, lo4.z);
        lo4.w = fmaf(w[m], a.w, lo4.w);
        if (hi) {
          const float4 h =
              *reinterpret_cast<const float4*>(gk + m * C + g0 + 4);
          hi4.x = fmaf(w[m], h.x, hi4.x);
          hi4.y = fmaf(w[m], h.y, hi4.y);
          hi4.z = fmaf(w[m], h.z, hi4.z);
          hi4.w = fmaf(w[m], h.w, hi4.w);
        }
      }
      if (q < j) {
        float* o = theta + (size_t)(k * inter + g0) * BMP + row0 + q;
        o[0] = lo4.x;
        o[BMP] = lo4.y;
        o[2 * BMP] = lo4.z;
        o[3 * BMP] = lo4.w;
        if (hi) {
          o[4 * BMP] = hi4.x;
          o[5 * BMP] = hi4.y;
          o[6 * BMP] = hi4.z;
          o[7 * BMP] = hi4.w;
        }
      }
    }
  }
}

#ifndef GASTX_TIERED_FORM
// Persistent blocks: block b takes tiles b, b + gridDim.x, ... of fpt whole
// frames each. The five activation groups of a tile, in order of use:
//   0: x
//   P1 x @ [W0_sym | W1_sym] -> 1 (self), 2 (neighbours); the graph
//      writes ab_sym over 1, its weights staged in 4
//   P2 x @ [W0_con | W1_con] -> 2, 4; ab_con over 2, weights staged in 3
//   P3 [ab_sym | ab_con] @ lcat_w -> local, 3
//   P4 x @ [theta | phi] -> 1, 2; P5 x @ g -> 4 (row-major); attention
//      writes the heads over theta, 1
//   P6 heads @ acat_w -> global, 2
//   P7 [x | local | global] @ gcat_w -> out, while the next tile's
//      semantic weights (4, 3) and x (0) come in.
// The weights of a branch are staged when they fit in a group; else the
// graph reads them from device memory.
//
// The fold form (FoldCfg; gastx/ops/pallas/fused_gab.py:370
// `_global_branch_fold`, the tables of gab_tables(..., "fold")): w_proj's
// columns are [sem | sa | sb | g], the scores already folded with their
// score vectors, K of each (I = 1). P4 leaves the stream; the attention
// takes each (row, head)'s sa and sb as two C-long dots of x, still in
// group 0, against the folded columns, staged once a block where v1 keeps
// p_theta and p_phi (2KC floats, 1 KB at C = 32; 2KC FMAs a row in place
// of P4's 2C^2), and writes the heads into group 1, which P4 no longer
// fills. The local branch still needs all five groups.
template <class G>
__global__ void __launch_bounds__(G::NT, G::MINB)
gab_narrow_kernel(const void* __restrict__ x, void* __restrict__ out,
                  long long frames, int fpt, long long tiles, int j, int d,
                  int nheads, const Tables t, bool x_bf, bool out_bf) {
  x_bf = BF16_IO && x_bf;
  out_bf = BF16_IO && out_bf;
  extern __shared__ float4 smem4[];
  constexpr int C = G::C, S = G::S, GR = G::GROUP;
  float* acts = reinterpret_cast<float*>(smem4);
  float* ring = acts + 5 * GR;
  float* ck = ring + G::STAGES * G::SLAB;
  float* pt = ck + nheads * j * j;
  float* pp = pt + C;
  int* col = reinterpret_cast<int*>(G::FOLD ? pt + fold_floats(C, nheads)
                                            : pp + C);
  for (int i = threadIdx.x; i < nheads * j * j; i += G::NT)
    ck[i] = __ldg(t.c_k + i);
  if constexpr (G::FOLD) {
    load_fold<G>(t, pt, nheads);
  } else {
    for (int i = threadIdx.x; i < C; i += G::NT) {
      pt[i] = __ldg(t.proj_t + i);
      pp[i] = __ldg(t.proj_p + i);
    }
  }
  for (int i = threadIdx.x; i < 2 * j * d; i += G::NT)
    col[i] = __ldg(t.col + i);
  const bool staged = j * (1 + d) * C + 2 * C <= GR;
  const SemSrc sem_w0 = sem_src<G>(t, staged ? acts + 4 * GR : nullptr, j,
                                   d, 0);
  const SemSrc sem_w1 = sem_src<G>(t, staged ? acts + 3 * GR : nullptr, j,
                                   d, 1);

  // The ring runs over every slab of the block's tiles (a product's first
  // barrier also publishes the tables, x and the staged weights).
  const long long total =
      ((tiles - 1 - blockIdx.x) / gridDim.x + 1) * G::SPT;
  long long g = 0;
  for (int i = 0; i < G::STAGES - 1; ++i)
    stage<G>(t, ring, i, total, nheads);
  // The g columns' first (v1: after theta | phi).
  const int gcol = G::FOLD ? 4 * C + 2 * nheads : 6 * C;
  for (long long tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const long long f0 = tile * fpt;
    const int nf = (int)min((long long)fpt, frames - f0);
    const int rows = nf * j;
    if (tile == blockIdx.x) {  // the first tile's; P7 brings the next ones
      if (/*XLOAD*/true)
        load_x<G, false>(elem_ptr(x, f0 * j * C, x_bf), x_bf, acts, rows);
      if (staged) {
        load_sem<G, false>(t, acts + 4 * GR, j, d, 0);
        load_sem<G, false>(t, acts + 3 * GR, j, d, 1);
      }
    }
    product<G, 2, S, false, false>(/*P1*/true, t, ring, g, total, nheads,
                                   acts, 0, 0, 0, t.proj_scale,
                                   t.proj_shift, 1, 2);
    __syncthreads();
    if (/*SEM*/true)
      sem_graph<G>(sem_w0, col, acts + GR, acts + 2 * GR, nf, j, d, 0);
    product<G, 2, S, false, false>(/*P2*/true, t, ring, g, total, nheads,
                                   acts, 0, 0, 0, t.proj_scale + 2 * C,
                                   t.proj_shift + 2 * C, 2, 4);
    __syncthreads();
    if (/*SEM*/true)
      sem_graph<G>(sem_w1, col, acts + 2 * GR, acts + 4 * GR, nf, j, d, 1);
    product<G, 1, 2 * S, true, false>(/*P3*/true, t, ring, g, total, nheads,
                                      acts, 1, 2, 0, t.lcat_scale,
                                      t.lcat_shift, 3, 0);
    if constexpr (!G::FOLD)
      product<G, 2, S, false, false>(/*P4*/true, t, ring, g, total, nheads,
                                     acts, 0, 0, 0, t.proj_scale + 4 * C,
                                     t.proj_shift + 4 * C, 1, 2);
    product<G, 1, S, false, false, true>(/*P5*/true, t, ring, g, total,
                                         nheads, acts, 0, 0, 0,
                                         t.proj_scale + gcol,
                                         t.proj_shift + gcol, 4, 0);
    __syncthreads();
    if (/*ATTN*/true)
      attention<G>(acts + GR, acts + 2 * GR, acts + 4 * GR, nf, j, nheads,
                   pt, pp, ck, acts);
    product<G, 1, S, true, false>(/*P6*/true, t, ring, g, total, nheads,
                                  acts, 1, 0, 0, t.acat_scale, t.acat_shift,
                                  2, 0);
    const long long f1 = (tile + gridDim.x) * fpt;
    const bool more = tile + gridDim.x < tiles;
    const Prefetch pre{more && /*XLOAD*/true ? elem_ptr(x, f1 * j * C, x_bf)
                                             : nullptr,
                       x_bf,
                       more ? (int)min((long long)fpt, frames - f1) * j : 0,
                       j, d, more && staged};
    product<G, 2, 3 * S, true, true>(
        /*P7*/true, t, ring, g, total, nheads, acts, 0, 3, 2, t.gcat_scale,
        t.gcat_shift, 0, 0,
        const_cast<void*>(elem_ptr(out, f0 * j * 2 * C, out_bf)), rows, &pre,
        out_bf);
  }
}

// As many persistent blocks as fit on the card, but no more than tiles.
template <class G>
int launch(const void* x, void* out, long long frames, int j, int d,
           int nheads, const Tables& t, cudaStream_t stream, bool x_bf,
           bool out_bf) {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e == cudaSuccess)
      e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const size_t smem =
      sizeof(float) * ((size_t)5 * G::GROUP + G::STAGES * G::SLAB +
                       nheads * j * j +
                       (G::FOLD ? fold_floats(G::C, nheads) : 2 * G::C)) +
      sizeof(int) * 2 * j * d;
  cudaError_t e = cudaFuncSetAttribute(
      gab_narrow_kernel<G>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  int per_sm = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, gab_narrow_kernel<G>, G::NT, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (per_sm < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  const int fpt = G::BM / j;
  const long long tiles = (frames + fpt - 1) / fpt;
  if (tiles > 0) {
    const long long blocks =
        tiles < (long long)per_sm * sms ? tiles : (long long)per_sm * sms;
    gab_narrow_kernel<G><<<(unsigned)blocks, G::NT, smem, stream>>>(
        x, out, frames, fpt, tiles, j, d, nheads, t, x_bf, out_bf);
  }
  return static_cast<int>(cudaGetLastError());
}

#endif  // GASTX_TIERED_FORM

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

#ifdef GASTX_TIERED_FORM
// ---------------------------------------------------------------------------
// The tiered form: the same block at the precision tiers below "highest"
// (gastx_torch/ops/precision.py), its own __global__, so that the float32
// kernel above keeps its code.
//
// Its products (the projection, local cat, global cat and block concat)
// run as bf16 mma.sync.m16n8k16 passes with float32 accumulation, by
// tier: one pass (ah bh) at default and kdefault, two at high_lhs (+ al bh)
// and high_rhs (+ ah bl), three at high, with a = ah + al, ah = bf16(a),
// al = bf16(a - ah) rounded to nearest even (precision.split_bf16). The
// projection's sem columns take local_sem's tier and its attention columns
// attn_proj's (apart products here: P1, P2 and P4, P5). The attention
// rounds its score and apply operands as joint_attention.cu's tiered
// instantiations do (q1 = bf16, q2 = q1 + q1 of the rest; high: q2(a)
// q1(b) + q1(a) lo(b)), its sums float32 FMAs.
//
// Bound: the float32 kernel's bytes (x in, 2C out a row) against 2 * 16 *
// C^2 FLOPs a row a pass at the bf16 tensor-core rate, 2.7 C FLOPs a byte
// a pass against the card's ~295: bytes bound it at one and two passes at
// every width, and at three up to C = 32.
//
// Its first design (the float32 kernel's tiles and group plan with a bf16
// split in them) ran at 13-16x that bound. This one answers each cause:
//
// 1. The weights were split again on every tile: each float32 slab,
//    streamed from L2, was split by the whole block into bf16 words
//    between two block barriers. Here a launch splits them once: every
//    block splits its share of a tile's slab stream (SPT slabs, all seven
//    products) into bf16 k-pair words, hi and lo, in the ring's own layout,
//    into the wrapper's scratch buffer, and one barrier across the grid
//    (blocks are persistent and all resident) publishes them. A tile's
//    slabs then stream from L2 by 16-byte cp.async straight into the words
//    the B fragments load, the lo half only where the product's tier reads
//    it: no split pass, one block barrier a slab.
// 2. A fragments: a warp splits each A fragment (hi and lo) once as it
//    loads it, for all of its column tiles and passes; the activations
//    stay float32 (the semantic graph and the attention read them).
//    mma.sync and not wgmma: the passes are the smaller part of a tile's
//    time (the cut builds, PERF.md), and wgmma's A operand would need a
//    bf16 copy of each product's input groups beside the float32 ones,
//    which the shared memory does not hold at C = 48, 64.
// 3. The attention ran one warp a (frame, head) and one lane a query (17
//    of 32 lanes at J = 17), its weights in a register array, rounded
//    again for every 8 output columns. Here one thread takes a (row,
//    head): its softmax row by passes over the frame's key scores in
//    shared memory (no shuffle, no array), then each weight rounded once
//    against g rounded once in place (lo(g) beside it at high), up to 16
//    output columns a pass; every lane works.
// 4. Nothing overlapped: one block an SM, its phases between block
//    barriers. At C = 16 and 32 a block is now 256 threads and two share
//    an SM (TieredCfg), so that one block's semantic graph and attention
//    can run under the other's products and barriers (measured no faster
//    than one 512-thread block, and no slower: PERF.md). At C = 48 and 64
//    the tile's five float32 groups fill the SM's shared memory, so one
//    block of 384 or 512 threads runs there, as before. Deeper slabs
//    (32 or 48 rows) halve the barriers a tile.
// 5. Spills: the attention's register array and the split pass are gone;
//    at 128 registers a thread (C = 16, 32, 64) a few words of the tile
//    loop's state still spill (-Xptxas -v in PERF.md).
//
// With bf16 x (the bf16-I/O library, x 16-byte aligned) the next tile's x
// is staged raw by 16-byte cp.async into a free group during the block
// concat, and converted from shared memory at that tile's start.
// ---------------------------------------------------------------------------

// Tier codes of the products (kernels.TC_TIERS): 0 default, 1 high_lhs, 2
// high_rhs, 3 high; and of the attention's dots (kernels.ATTN_TIERS): 0
// highest, 1 default, 2 high_lhs, 3 high_rhs, 4 high.
struct Tiers {
  int sem, proj, lcat, acat, gcat, score, apply;
};

// The widest C of the tiered form (kernels.NARROW_TIERED_WIDTHS): the
// float32 kernel loses to the chain above it, so the tiered form is built
// for C <= 64 alone.
constexpr int MAX_TIERED_C = 64;

// The tiered form's tiling of each width (Cfg<C, threads along rows, rows
// a thread, blocks an SM, slab rows, slabs in the ring>): 256 rows and two
// blocks of 256 threads an SM at C = 16; 128 rows and two blocks of 256 at
// C = 32; 128 rows and one block of 384 or 512 threads at C = 48, 64. A
// slab is as deep as the shared memory allows (C rows up to 48, 32 at
// 64): a barrier a slab costs more than the ring's depth gains.
template <int C>
struct TieredCfg;
template <>
struct TieredCfg<16> {
  using type = Cfg<16, 64, 4, 2, 16, 4>;
};
template <>
struct TieredCfg<32> {
  using type = Cfg<32, 32, 4, 2, 32, 2>;
};
template <>
struct TieredCfg<48> {
  using type = Cfg<48, 32, 4, 1, 48, 2>;
};
template <>
struct TieredCfg<64> {
  using type = Cfg<64, 32, 4, 1, 32, 2>;
};

// The warp grid of a width: WM x WN warps over the tile's 16-row tiles and
// a C-wide group's 8-column tiles, the first WN (fewest columns a warp
// shares) that divides both; and a slab of split words: N <= 2C columns of
// BK / 2 k-pair words, hi, then lo at HALF. A column's 16-byte chunks are
// swizzled (word()) so that the 8 columns an ldmatrix reads for one k
// chunk fall in 8 distinct groups of 4 banks.
constexpr int tc_wn(int w, int mt, int n8) {
  for (int wn = 1; wn <= w; ++wn)
    if (w % wn == 0 && n8 % wn == 0 && mt % (w / wn) == 0) return wn;
  return 0;
}

template <class G>
struct Tc {
  static constexpr int W = G::NT / 32;
  static constexpr int MT = G::BM / 16;
  static constexpr int N8 = G::C / 8;
  static constexpr int WN = tc_wn(W, MT, N8);
  static constexpr int WM = WN ? W / WN : 1;
  static constexpr int MPW = MT / WM;  // 16-row tiles a warp
  static constexpr int NPG = WN ? N8 / WN : 1;  // 8-column tiles a group
  static constexpr int KPW = G::BK / 2;  // words a column
  static constexpr int HALF = 2 * G::C * KPW;
  static constexpr int WORDS = 2 * HALF;  // a slab's words, hi and lo
  static_assert(WN > 0 && G::BK % 16 == 0 && NPG % 2 == 0 &&
                    (G::BK == 16 || G::BK == 32 || G::BK == 48),
                "tensor-core warp grid");
  // The word of (column n, k pair kp) in a half: chunk kp / 4 of the
  // column XOR a function of n (2 or 6 chunks a column: bit 2 of n; 4:
  // bits 1-2).
  static __device__ __forceinline__ int word(int n, int kp) {
    const int sw = KPW % 16 == 0 ? (n >> 1) & 3 : (n >> 2) & 1;
    return n * KPW + (((kp >> 2) ^ sw) << 2) + (kp & 3);
  }
};

// The scratch buffer: CTL words of the grid barrier's counters, then a
// tile's SPT slabs of split words, Tc::WORDS each (kernels.narrow_scratch).
constexpr int CTL = 16;

__device__ __forceinline__ uint32_t bf16_bits(float x) {
  const __nv_bfloat16 h = __float2bfloat16_rn(x);
  return static_cast<uint32_t>(*reinterpret_cast<const unsigned short*>(&h));
}
__device__ __forceinline__ float bits_bf16(uint32_t b) {
  return __uint_as_float(b << 16);
}

// The bf16 halves (hi, lo) of (x0, x1) as mma operand registers, x0 in the
// low 16 bits (the smaller k): two cvt.rn.bf16x2.f32, nearest even.
__device__ __forceinline__ uint32_t bf16x2(float x0, float x1) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  return *reinterpret_cast<const uint32_t*>(&h);
}
__device__ __forceinline__ void split2(float x0, float x1, uint32_t& hi,
                                       uint32_t& lo) {
  hi = bf16x2(x0, x1);
  lo = bf16x2(x0 - __uint_as_float(hi << 16),
              x1 - __uint_as_float(hi & 0xffff0000u));
}

// Four 8 x 8 matrices of 16-bit values from shared memory, row addresses
// from lanes 8i .. 8i + 7 for matrix i (ldmatrix).
__device__ __forceinline__ void ldsm_x4(uint32_t* d, const uint32_t* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(d[0]), "=r"(d[1]), "=r"(d[2]), "=r"(d[3])
      : "r"(a)
      : "memory");
}

__device__ __forceinline__ void mma_bf16(float* d, const uint32_t* a,
                                         const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// A 16-byte copy from device memory through L2 alone (cp.async.cg): the
// split words were written by other blocks of this launch.
__device__ __forceinline__ void copy16_cg(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src));
}

// Slab s of a tile's stream (stage()'s order): the product it belongs to
// (0 .. 6: P1 .. P7), its weights `w` (ld floats a row), its N and its
// first row k0.
template <class G>
__device__ __forceinline__ int slab_src(const Tables& t, int s, int nh,
                                        const float*& w, int& ld, int& n,
                                        int& k0) {
  constexpr int C = G::C, S = G::S;
  int p;
  if constexpr (G::FOLD) {
    const int lp = 5 * C + 2 * nh;
    if (s < S) {
      p = 0; w = t.w_proj; ld = lp; n = 2 * C; k0 = s;
    } else if (s < 2 * S) {
      p = 1; w = t.w_proj + 2 * C; ld = lp; n = 2 * C; k0 = s - S;
    } else if (s < 4 * S) {
      p = 2; w = t.lcat_w; ld = C; n = C; k0 = s - 2 * S;
    } else if (s < 5 * S) {  // P5: g
      p = 4; w = t.w_proj + 4 * C + 2 * nh; ld = lp; n = C; k0 = s - 4 * S;
    } else if (s < 6 * S) {
      p = 5; w = t.acat_w; ld = C; n = C; k0 = s - 5 * S;
    } else {
      p = 6; w = t.gcat_w; ld = 2 * C; n = 2 * C; k0 = s - 6 * S;
    }
  } else if (s < S) {
    p = 0; w = t.w_proj; ld = 7 * C; n = 2 * C; k0 = s;
  } else if (s < 2 * S) {
    p = 1; w = t.w_proj + 2 * C; ld = 7 * C; n = 2 * C; k0 = s - S;
  } else if (s < 4 * S) {
    p = 2; w = t.lcat_w; ld = C; n = C; k0 = s - 2 * S;
  } else if (s < 5 * S) {
    p = 3; w = t.w_proj + 4 * C; ld = 7 * C; n = 2 * C; k0 = s - 4 * S;
  } else if (s < 6 * S) {
    p = 4; w = t.w_proj + 6 * C; ld = 7 * C; n = C; k0 = s - 5 * S;
  } else if (s < 7 * S) {
    p = 5; w = t.acat_w; ld = C; n = C; k0 = s - 6 * S;
  } else {
    p = 6; w = t.gcat_w; ld = 2 * C; n = 2 * C; k0 = s - 7 * S;
  }
  k0 *= G::BK;
  return p;
}

// The tier code of product p (P1 .. P7).
__device__ __forceinline__ int product_tier(int p, const Tiers& tr) {
  return p < 2 ? tr.sem : p == 2 ? tr.lcat : p < 5 ? tr.proj
                                    : p == 5 ? tr.acat : tr.gcat;
}

// The launch's split: slab s of the stream as words (n, kp) = rows k0 + 2kp
// and k0 + 2kp + 1 of column n (the smaller k in the low half), hi at
// sw + s * WORDS + word(n, kp) and lo HALF words on; the grid's threads
// share the SPT * BK / 2 * 2C items.
template <class G>
__device__ __forceinline__ void split_weights(const Tables& t, uint32_t* sw,
                                              int nh) {
  using T = Tc<G>;
  constexpr int ROW = 2 * G::C, PER = G::BK / 2 * ROW;
  const long long items = (long long)G::SPT * PER;
  for (long long e = (long long)blockIdx.x * G::NT + threadIdx.x;
       /*TPRE*/true && e < items; e += (long long)gridDim.x * G::NT) {
    const int s = (int)(e / PER), rem = (int)(e - (long long)s * PER);
    const int kp = rem / ROW, n = rem - kp * ROW;
    const float* w;
    int ld, nn, k0;
    slab_src<G>(t, s, nh, w, ld, nn, k0);
    if (n >= nn) continue;
    const float* src = w + (size_t)(k0 + 2 * kp) * ld + n;
    uint32_t hi, lo;
    split2(__ldg(src), __ldg(src + ld), hi, lo);
    uint32_t* dst = sw + (size_t)s * T::WORDS + T::word(n, kp);
    dst[0] = hi;
    dst[T::HALF] = lo;
  }
}

// Every block of the launch waits here until all have arrived (after their
// split); ctl[0] counts arrivals, ctl[1] departures, and the last block to
// leave sets both back to 0 for the next launch on the buffer. Blocks are
// at most as many as fit on the card at once (launch_tiered), so all are
// resident.
__device__ __forceinline__ void grid_barrier(unsigned* ctl) {
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    atomicAdd(ctl, 1u);
    while (atomicAdd(ctl, 0u) < gridDim.x) __nanosleep(100);
    __threadfence();
    if (atomicAdd(ctl + 1, 1u) == gridDim.x - 1) {
      atomicExch(ctl, 0u);
      atomicExch(ctl + 1, 0u);
    }
  }
  __syncthreads();
}

// Stages slab i of the block's stream into its ring slot: the slab's hi
// words and, where its product's tier reads B's lo half, its lo words.
template <class G>
__device__ __forceinline__ void stage_t(const uint32_t* sw, uint32_t* ring,
                                        int i, int total,
                                        const Tables& t, int nh,
                                        const Tiers& tr) {
  using T = Tc<G>;
  if (/*TCOPY*/true && i < total) {
    const int s = i % G::SPT;
    const float* w;
    int ld, n, k0;
    const int tier = product_tier(slab_src<G>(t, s, nh, w, ld, n, k0), tr);
    const int chunks = n * T::KPW / 4;
    const int all = tier >= 2 ? 2 * chunks : chunks;
    const uint32_t* src = sw + (size_t)s * T::WORDS;
    uint32_t* dst = ring + i % G::STAGES * T::WORDS;
    for (int e = threadIdx.x; e < all; e += G::NT) {
      const int h = e >= chunks;
      const int o = (e - h * chunks) * 4 + h * T::HALF;
      copy16_cg(dst + o, src + o);
    }
  }
  __pipeline_commit();
}

// What the block concat brings in for the next tile: the semantic-graph
// weights of both branches (into groups 4 and 3, if staged) and x: into
// group 0 (float32, or bf16 by plain loads), or raw bf16 into group 1 by
// 16-byte copies (`raw`) for the next tile's start to convert.
struct TPrefetch {
  const void* x;
  bool x_bf, raw;
  int rows, j, d;
  bool sem;
};

// x's rows of a tile as raw bf16 (rows * C values, row-major) into `dst`.
template <class G>
__device__ __forceinline__ void stage_x_raw(const void* xg, float* dst,
                                            int rows) {
  const char* src = static_cast<const char*>(xg);
  char* out = reinterpret_cast<char*>(dst);
  for (int e = threadIdx.x; e < rows * G::C / 8; e += G::NT)
    copy16_cg(out + 16 * e, src + 16 * e);
}

// The staged raw bf16 rows into group 0 as load_x leaves it.
template <class G>
__device__ __forceinline__ void convert_x_raw(const float* raw, float* xs,
                                              int rows) {
  constexpr int C = G::C;
  const unsigned short* xb = reinterpret_cast<const unsigned short*>(raw);
  for (int e = threadIdx.x; e < G::BM * C; e += G::NT) {
    const int r = e / C, c = e - r * C;
    xs[c * G::BMP + r] =
        r < rows ? __uint_as_float(static_cast<uint32_t>(xb[e]) << 16) : 0.f;
  }
}

// One product over the tile's BM rows at a tier: out[r, n] = epi(sum_k
// A[r, k] W[k, n]), N = MM * C, K = NS * BK, as product() computes it
// (the operands, output layouts and epilogue are its), by tensor-core
// passes. Each landed slab is read as the split words stage_t copied: word
// (n, kp) of the hi half (Tc::word) holds rows 2kp and 2kp+1 of column n,
// the lo half Tc::HALF words on; one ldmatrix.x4 loads a k16 step's B
// fragments of two 8-column tiles.
template <class G, int MM, int NS, bool RELU, bool TO_GLOBAL,
          bool ROW_MAJOR = false>
__device__ __forceinline__ void product_t(
    int tier, const uint32_t* sw, uint32_t* ring, int& g, int total,
    const Tables& t, int nh, const Tiers& tr, float* acts,
    int a0, int a1, int a2, const float* scale, const float* shift, int o0,
    int o1, void* out = nullptr, int rows_valid = 0,
    const TPrefetch* pre = nullptr, bool out_bf = false) {
  using T = Tc<G>;
  constexpr int C = G::C, N = MM * C, BMP = G::BMP;
  constexpr int BK = G::BK, S = G::S;
  constexpr int NN = MM * T::NPG;  // 8-column tiles a warp
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int wm = warp % T::WM, wn = warp / T::WM;
  const int gq = lane / 4, tq = lane % 4;
  const bool a_lo = tier == 1 || tier == 3, b_lo = tier == 2 || tier == 3;
  // Column of the warp's q-th 8-column tile.
  auto col = [&](int q) {
    return (q / T::NPG) * C + (wn * T::NPG + q % T::NPG) * 8;
  };
  float acc[T::MPW][NN][4];
#pragma unroll
  for (int i = 0; i < T::MPW; ++i)
#pragma unroll
    for (int q = 0; q < NN; ++q)
#pragma unroll
      for (int v = 0; v < 4; ++v) acc[i][q][v] = 0.f;
  for (int s = 0; s < NS; ++s) {
    __pipeline_wait_prior(G::STAGES - 2);
    __syncthreads();  // slab g has landed; slab g - 1 is read
    if (pre != nullptr) {
      // Groups 4 and 1 are free; group 0 from slab S, group 3 from 2S on.
      if (s == 0 && pre->sem)
        load_sem<G, true>(t, acts + 4 * G::GROUP, pre->j, pre->d, 0);
      if (s == 0 && pre->raw)
        stage_x_raw<G>(pre->x, acts + G::GROUP, pre->rows);
      if (s == S && pre->x != nullptr && !pre->raw)
        load_x<G, true>(pre->x, pre->x_bf, acts, pre->rows);
      if (s == 2 * S && pre->sem)
        load_sem<G, true>(t, acts + 3 * G::GROUP, pre->j, pre->d, 1);
    }
    stage_t<G>(sw, ring, g + G::STAGES - 1, total, t, nh, tr);
    const uint32_t* wb = ring + g % G::STAGES * T::WORDS;
    ++g;
    const int k0 = s * BK, piece = k0 / C;
    const float* a =
        acts + (size_t)(piece == 0 ? a0 : piece == 1 ? a1 : a2) * G::GROUP +
        (size_t)(k0 - piece * C) * BMP;
    if (!/*TMMA*/true) continue;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      // The warp's A fragments, split once for every column tile and
      // pass; then two column tiles' B fragments at a time.
      uint32_t ah[T::MPW][4], al[T::MPW][4];
#pragma unroll
      for (int i = 0; i < T::MPW; ++i) {
        const float* ac =
            a + (kk + 2 * tq) * BMP + (wm * T::MPW + i) * 16 + gq;
        split2(ac[0], ac[BMP], ah[i][0], al[i][0]);
        split2(ac[8], ac[BMP + 8], ah[i][1], al[i][1]);
        split2(ac[8 * BMP], ac[9 * BMP], ah[i][2], al[i][2]);
        split2(ac[8 * BMP + 8], ac[9 * BMP + 8], ah[i][3], al[i][3]);
      }
#pragma unroll
      for (int q = 0; q < NN; q += 2) {
        // Lane l addresses row l % 8 of matrix l / 8: k 0..7 (then 8..15)
        // of column tile q (then q + 1).
        const uint32_t* wc =
            wb + T::word(col(q + (lane >> 4)) + (lane & 7),
                         kk / 2 + ((lane >> 3) & 1) * 4);
        uint32_t bh[4], bl[4];
        ldsm_x4(bh, wc);
        if (b_lo) ldsm_x4(bl, wc + T::HALF);
#pragma unroll
        for (int i = 0; i < T::MPW; ++i)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            mma_bf16(acc[i][q + h], ah[i], bh + 2 * h);
            if (b_lo) mma_bf16(acc[i][q + h], ah[i], bl + 2 * h);
            if (a_lo) mma_bf16(acc[i][q + h], al[i], bh + 2 * h);
          }
      }
    }
  }
  // Epilogue: accumulator v of tile (i, q) is row r0 + 8 (v / 2), column
  // c + v % 2.
#pragma unroll
  for (int q = 0; q < NN; ++q) {
    const int c = col(q) + 2 * tq, j = c / C, cc = c - j * C;
    const float sc0 = __ldg(scale + c), sc1 = __ldg(scale + c + 1);
    const float sh0 = __ldg(shift + c), sh1 = __ldg(shift + c + 1);
#pragma unroll
    for (int i = 0; i < T::MPW; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = (wm * T::MPW + i) * 16 + gq + 8 * h;
        float y0 = acc[i][q][2 * h] * sc0 + sh0;
        float y1 = acc[i][q][2 * h + 1] * sc1 + sh1;
        if (RELU) {
          y0 = fmaxf(y0, 0.f);
          y1 = fmaxf(y1, 0.f);
        }
        if (TO_GLOBAL) {
          if (r >= rows_valid) continue;
          if (out_bf)
            *reinterpret_cast<uint32_t*>(static_cast<unsigned short*>(out) +
                                         (size_t)r * N + c) =
                float_to_bf16(y0) | float_to_bf16(y1) << 16;
          else
            *reinterpret_cast<float2*>(static_cast<float*>(out) +
                                       (size_t)r * N + c) =
                make_float2(y0, y1);
        } else if (ROW_MAJOR) {
          *reinterpret_cast<float2*>(acts + (size_t)o0 * G::GROUP +
                                     (size_t)r * C + c) = make_float2(y0, y1);
        } else {
          float* o = acts + (size_t)(j ? o1 : o0) * G::GROUP +
                     (size_t)cc * BMP + r;
          o[0] = y0;
          o[BMP] = y1;
        }
      }
  }
}

// x rounded: mode 0 exact, 1 q1, 2 q2; lo(x) = q1(x - q1(x))
// (joint_attention.cu).
__device__ __forceinline__ float q1(float x) { return bits_bf16(bf16_bits(x)); }
__device__ __forceinline__ float rnd(float x, int mode) {
  if (mode == 0) return x;
  const float h = q1(x);
  return mode == 1 ? h : h + q1(x - h);
}
__device__ __forceinline__ float lo_half(float x) { return q1(x - q1(x)); }
// The rounding of a tier's lhs and rhs operand in its first term (ATTN
// codes).
__device__ __forceinline__ int lhs_mode(int tier) {
  return tier == 0 ? 0 : (tier == 2 || tier == 4 ? 2 : 1);
}
__device__ __forceinline__ int rhs_mode(int tier) {
  return tier == 0 ? 0 : (tier == 3 ? 2 : 1);
}

// The fold form's score columns at the score tier (`mode`: rhs_mode of
// its code), once a block: the rounded columns as load_fold lays them out
// (2KC floats), their lo halves (2KC), then the 2K scales and 2K shifts.
__host__ __device__ constexpr int fold_tiered_floats(int c, int nh) {
  return 4 * nh * c + 4 * nh;
}

template <class G>
__device__ __forceinline__ void load_fold_tiered(const Tables& t, float* dst,
                                                 int nh, int mode) {
  constexpr int C = G::C;
  const int ld = 5 * C + 2 * nh, n = 2 * nh * C;
  for (int e = threadIdx.x; e < n; e += G::NT) {
    const int kk = e / C, c = e - kk * C;
    const float v = __ldg(t.w_proj + (size_t)c * ld + 4 * C + kk);
    dst[e] = rnd(v, mode);
    dst[n + e] = lo_half(v);
  }
  for (int e = threadIdx.x; e < 2 * nh; e += G::NT) {
    dst[2 * n + e] = __ldg(t.proj_scale + 4 * C + e);
    dst[2 * n + 2 * nh + e] = __ldg(t.proj_shift + 4 * C + e);
  }
}

// The attention at the tiers, with its score dots at `score` and its apply
// dots at `apply` (ATTN codes): theta/phi the lhs and p_theta/p_phi the
// rhs of the score, the attention weights the lhs and g the rhs of the
// apply; the high tier adds its q1(a) lo(b) term. Three passes between
// barriers over the tile's nf frames (theta, phi column-major; g
// row-major, C floats a row):
//  1. the scores, one thread a (row, head), the score vectors rounded once
//     a block in `pr` (rhs(p_theta) | rhs(p_phi) | lo(p_theta) |
//     lo(p_phi), C each), into `sc` (sa of head k at 2k * BM, sb at
//     (2k + 1) * BM);
//  2. g rounded in place as the apply's rhs, and, for the high apply tier,
//     lo(g) into phi's group (row-major; read in pass 1);
//  3. the apply, one thread a (row, head): the row's softmax max and sum
//     over the frame's sb, then each weight (softmax + C_k) rounded once
//     against up to 16 columns of g at a time; the head's outputs over its
//     theta columns (column-major).
// The fold form (G::FOLD) reads no theta or phi (their groups are free): an
// item's scores are its row of x (xs) against the head's folded columns at
// the score tier, x the lhs and the columns the rhs, as gemm_tc computes
// the chain's sa | sb; pr then holds the columns as load_fold_tiered
// leaves them, and the heads go to theta's group, G = C / K columns a
// head. Each sum runs in the order of the first design's (bitwise its
// results).
template <class G>
__device__ __forceinline__ void attention_t(
    float* theta, float* phi, float* gv, float* sc, int nf, int j,
    int nheads, const float* pr, const float* c_k, int score, int apply,
    const float* xs) {
  constexpr int C = G::C, BMP = G::BMP, BM = G::BM;
  const int inter = C / nheads, rows = nf * j, items = rows * nheads;
  const int s_lhs = lhs_mode(score);
  const int a_lhs = lhs_mode(apply), a_rhs = rhs_mode(apply);
  const bool s_high = score == 4, a_high = apply == 4;
  for (int e = threadIdx.x; e < items; e += G::NT) {
    const int k = e / rows, r = e - k * rows;
    float sa = 0.f, sb = 0.f;
    if constexpr (G::FOLD) {
      const int n = 2 * nheads * C;
      const float* wa = pr + k * C;
      const float* wb = pr + (nheads + k) * C;
#pragma unroll 4
      for (int c = 0; c < C; ++c) {
        const float a = xs[c * BMP + r], ar = rnd(a, s_lhs);
        sa = fmaf(ar, wa[c], sa);
        sb = fmaf(ar, wb[c], sb);
        if (s_high) {
          const float ah = q1(a);
          sa = fmaf(ah, wa[n + c], sa);
          sb = fmaf(ah, wb[n + c], sb);
        }
      }
      const float* ss = pr + 2 * n;
      sa = sa * ss[k] + ss[2 * nheads + k];
      sb = sb * ss[nheads + k] + ss[3 * nheads + k];
    } else {
#pragma unroll 4
      for (int i = 0; i < inter; ++i) {
        const int cc = k * inter + i;
        const float a = theta[cc * BMP + r], b = phi[cc * BMP + r];
        sa = fmaf(rnd(a, s_lhs), pr[cc], sa);
        sb = fmaf(rnd(b, s_lhs), pr[C + cc], sb);
        if (s_high) {
          sa = fmaf(q1(a), pr[2 * C + cc], sa);
          sb = fmaf(q1(b), pr[3 * C + cc], sb);
        }
      }
    }
    sc[2 * k * BM + r] = sa;
    sc[(2 * k + 1) * BM + r] = sb;
  }
  if (apply != 0) {
    __syncthreads();  // theta and phi are read
    for (int e = threadIdx.x; e < rows * C; e += G::NT) {
      const float v = gv[e];
      gv[e] = rnd(v, a_rhs);
      if (a_high) phi[e] = lo_half(v);
    }
  }
  __syncthreads();
  for (int e = threadIdx.x; /*TAPPLY*/true && e < items; e += G::NT) {
    const int k = e / rows, r = e - k * rows;
    const int q = r % j;
    const float sa = sc[2 * k * BM + r];
    const float* sb = sc + (2 * k + 1) * BM + r - q;
    float mx = -INFINITY;
    for (int m = 0; m < j; ++m) mx = fmaxf(mx, leaky(sa + sb[m]));
    float sum = 0.f;
    for (int m = 0; m < j; ++m) sum += expf(leaky(sa + sb[m]) - mx);
    const float inv = 1.f / sum;
    const float* ck = c_k + (k * j + q) * j;
    for (int c0 = 0; c0 < inter; c0 += 16) {
      const int nv = min(4, (inter - c0) / 4);  // float4s of this pass
      float4 acc[4];
#pragma unroll
      for (int v = 0; v < 4; ++v) acc[v] = make_float4(0.f, 0.f, 0.f, 0.f);
      const float* gk = gv + (size_t)(r - q) * C + k * inter + c0;
      const float* gl = phi + (size_t)(r - q) * C + k * inter + c0;
      for (int m = 0; m < j; ++m) {
        const float w = expf(leaky(sa + sb[m]) - mx) * inv + ck[m];
        float wa = w, wh = w;
        if (a_lhs) {
          wh = q1(w);
          wa = a_lhs == 2 ? wh + q1(w - wh) : wh;
        }
#pragma unroll
        for (int v = 0; v < 4; ++v) {
          if (v >= nv) break;
          float4& o = acc[v];
          const float4 a =
              *reinterpret_cast<const float4*>(gk + m * C + 4 * v);
          o.x = fmaf(wa, a.x, o.x);
          o.y = fmaf(wa, a.y, o.y);
          o.z = fmaf(wa, a.z, o.z);
          o.w = fmaf(wa, a.w, o.w);
          if (a_high) {
            const float4 h =
                *reinterpret_cast<const float4*>(gl + m * C + 4 * v);
            o.x = fmaf(wh, h.x, o.x);
            o.y = fmaf(wh, h.y, o.y);
            o.z = fmaf(wh, h.z, o.z);
            o.w = fmaf(wh, h.w, o.w);
          }
        }
      }
      float* o = theta + (size_t)(k * inter + c0) * BMP + r;
#pragma unroll
      for (int v = 0; v < 4; ++v) {
        if (v >= nv) break;
        o[(4 * v) * BMP] = acc[v].x;
        o[(4 * v + 1) * BMP] = acc[v].y;
        o[(4 * v + 2) * BMP] = acc[v].z;
        o[(4 * v + 3) * BMP] = acc[v].w;
      }
    }
  }
}

// The block at the tiers: the float32 kernel's group plan and prefetch,
// its products on product_t, the launch's split first (note above).
// Shared memory: the five groups, the ring (STAGES slabs of Tc::WORDS),
// C_k, the score buffer (2 * MAX_HEADS * BM), the score vectors (v1: 4C)
// or the fold form's columns (fold_tiered_floats), the neighbour table.
template <class G>
__global__ void __launch_bounds__(G::NT, G::MINB)
gab_narrow_tiered_kernel(const void* __restrict__ x, void* __restrict__ out,
                         long long frames, int fpt, long long tiles, int j,
                         int d, int nheads, const Tables t, bool x_bf,
                         bool out_bf, bool x_raw, const Tiers tr,
                         uint32_t* __restrict__ scratch) {
  using T = Tc<G>;
  x_bf = BF16_IO && x_bf;
  out_bf = BF16_IO && out_bf;
  x_raw = BF16_IO && x_bf && x_raw;
  extern __shared__ float4 smem4[];
  constexpr int C = G::C, GR = G::GROUP;
  float* acts = reinterpret_cast<float*>(smem4);
  uint32_t* ring = reinterpret_cast<uint32_t*>(acts + 5 * GR);
  float* ck = reinterpret_cast<float*>(ring + G::STAGES * T::WORDS);
  float* sc = ck + nheads * j * j;
  float* pr = sc + 2 * MAX_HEADS * G::BM;
  int* col = reinterpret_cast<int*>(
      pr + (G::FOLD ? fold_tiered_floats(C, nheads) : 4 * C));
  const uint32_t* sw = scratch + CTL;
  for (int i = threadIdx.x; i < nheads * j * j; i += G::NT)
    ck[i] = __ldg(t.c_k + i);
  if constexpr (G::FOLD) {
    load_fold_tiered<G>(t, pr, nheads, rhs_mode(tr.score));
  } else {
    // The score vectors as the score tier's rhs, and their lo halves.
    for (int i = threadIdx.x; i < C; i += G::NT) {
      const float vt = __ldg(t.proj_t + i), vp = __ldg(t.proj_p + i);
      const int mode = rhs_mode(tr.score);
      pr[i] = rnd(vt, mode);
      pr[C + i] = rnd(vp, mode);
      pr[2 * C + i] = lo_half(vt);
      pr[3 * C + i] = lo_half(vp);
    }
  }
  for (int i = threadIdx.x; i < 2 * j * d; i += G::NT)
    col[i] = __ldg(t.col + i);
  const bool staged = j * (1 + d) * C + 2 * C <= GR;
  split_weights<G>(t, scratch + CTL, nheads);
  grid_barrier(scratch);
  // The block's slabs (launch_tiered keeps their count an int).
  const int total = (int)((tiles - 1 - blockIdx.x) / gridDim.x + 1) * G::SPT;
  int g = 0;
  for (int i = 0; i < G::STAGES - 1; ++i)
    stage_t<G>(sw, ring, i, total, t, nheads, tr);
  const int gcol = G::FOLD ? 4 * C + 2 * nheads : 6 * C;
  for (long long tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const long long f0 = tile * fpt;
    const int nf = (int)min((long long)fpt, frames - f0);
    const int rows = nf * j;
    if (tile == blockIdx.x) {
      load_x<G, false>(elem_ptr(x, f0 * j * C, x_bf), x_bf, acts, rows);
      if (staged) {
        load_sem<G, false>(t, acts + 4 * GR, j, d, 0);
        load_sem<G, false>(t, acts + 3 * GR, j, d, 1);
      }
    } else if (x_raw) {
      // The raw rows the block concat staged (their copies are in commit
      // groups at least STAGES - 1 older than the newest).
      __pipeline_wait_prior(G::STAGES - 2);
      __syncthreads();
      convert_x_raw<G>(acts + GR, acts, rows);
    }
    product_t<G, 2, G::S, false, false>(tr.sem, sw, ring, g, total, t,
                                        nheads, tr, acts, 0, 0, 0,
                                        t.proj_scale, t.proj_shift, 1, 2);
    __syncthreads();
    if (/*TSEM*/true)
      sem_graph<G>(sem_src<G>(t, staged ? acts + 4 * GR : nullptr, j, d, 0),
                   col, acts + GR, acts + 2 * GR, nf, j, d, 0);
    product_t<G, 2, G::S, false, false>(tr.sem, sw, ring, g, total, t,
                                        nheads, tr, acts, 0, 0, 0,
                                        t.proj_scale + 2 * C,
                                        t.proj_shift + 2 * C, 2, 4);
    __syncthreads();
    if (/*TSEM*/true)
      sem_graph<G>(sem_src<G>(t, staged ? acts + 3 * GR : nullptr, j, d, 1),
                   col, acts + 2 * GR, acts + 4 * GR, nf, j, d, 1);
    product_t<G, 1, 2 * G::S, true, false>(tr.lcat, sw, ring, g, total, t,
                                           nheads, tr, acts, 1, 2, 0,
                                           t.lcat_scale, t.lcat_shift, 3, 0);
    if constexpr (!G::FOLD)
      product_t<G, 2, G::S, false, false>(tr.proj, sw, ring, g, total, t,
                                          nheads, tr, acts, 0, 0, 0,
                                          t.proj_scale + 4 * C,
                                          t.proj_shift + 4 * C, 1, 2);
    product_t<G, 1, G::S, false, false, true>(tr.proj, sw, ring, g, total,
                                              t, nheads, tr, acts, 0, 0, 0,
                                              t.proj_scale + gcol,
                                              t.proj_shift + gcol, 4, 0);
    __syncthreads();
    if (/*TATTN*/true)
      attention_t<G>(acts + GR, acts + 2 * GR, acts + 4 * GR, sc, nf, j,
                     nheads, pr, ck, tr.score, tr.apply, acts);
    product_t<G, 1, G::S, true, false>(tr.acat, sw, ring, g, total, t,
                                       nheads, tr, acts, 1, 0, 0,
                                       t.acat_scale, t.acat_shift, 2, 0);
    const long long f1 = (tile + gridDim.x) * fpt;
    const bool more = tile + gridDim.x < tiles;
    const TPrefetch pre{more ? elem_ptr(x, f1 * j * C, x_bf) : nullptr, x_bf,
                        more && x_raw,
                        more ? (int)min((long long)fpt, frames - f1) * j : 0,
                        j, d, more && staged};
    product_t<G, 2, 3 * G::S, true, true>(
        tr.gcat, sw, ring, g, total, t, nheads, tr, acts, 0, 3, 2,
        t.gcat_scale, t.gcat_shift, 0, 0,
        const_cast<void*>(elem_ptr(out, f0 * j * 2 * C, out_bf)), rows, &pre,
        out_bf);
  }
}

// The words of the scratch buffer a tiling's launch needs (CTL, then a
// tile's slabs).
template <class G>
constexpr long long scratch_words() {
  return CTL + (long long)G::SPT * Tc<G>::WORDS;
}

// As many persistent blocks as fit on the card, but no more than tiles,
// all resident at once (the grid barrier waits for every one).
template <class G>
int launch_tiered(const void* x, void* out, long long frames, int j, int d,
                  int nheads, const Tables& t, cudaStream_t stream, bool x_bf,
                  bool out_bf, const Tiers& tr, void* scratch,
                  long long scratch_size) {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e == cudaSuccess)
      e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  if (scratch == nullptr || !aligned16(scratch) ||
      scratch_size < scratch_words<G>())
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem =
      sizeof(float) *
          ((size_t)5 * G::GROUP + G::STAGES * Tc<G>::WORDS +
           nheads * j * j + 2 * MAX_HEADS * G::BM +
           (G::FOLD ? fold_tiered_floats(G::C, nheads) : 4 * G::C)) +
      sizeof(int) * 2 * j * d;
  cudaError_t e = cudaFuncSetAttribute(
      gab_narrow_tiered_kernel<G>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  int per_sm = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, gab_narrow_tiered_kernel<G>, G::NT, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (per_sm < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  const int fpt = G::BM / j;
  const long long tiles = (frames + fpt - 1) / fpt;
  // x's rows are staged raw where x and its tiles start on 16 bytes (C is
  // a multiple of 16, so a tile's rows do where x does).
  const bool raw = x_bf && aligned16(x);
  if (tiles > 0) {
    const long long blocks =
        tiles < (long long)per_sm * sms ? tiles : (long long)per_sm * sms;
    if ((tiles / blocks + 1) * G::SPT > INT_MAX)
      return static_cast<int>(cudaErrorInvalidValue);
    gab_narrow_tiered_kernel<G><<<(unsigned)blocks, G::NT, smem, stream>>>(
        x, out, frames, fpt, tiles, j, d, nheads, t, x_bf, out_bf, raw, tr,
        static_cast<uint32_t*>(scratch));
  }
  return static_cast<int>(cudaGetLastError());
}
#endif  // GASTX_TIERED_FORM

// The tables of the C functions' arguments, in GabTables' field order.
Tables make_tables(const void* const* p) {
  Tables t;
  t.w_proj = static_cast<const float*>(p[0]);
  t.proj_scale = static_cast<const float*>(p[1]);
  t.proj_shift = static_cast<const float*>(p[2]);
  t.w_self = static_cast<const float*>(p[3]);
  t.w_nbr = static_cast<const float*>(p[4]);
  t.col = static_cast<const int*>(p[5]);
  t.sem_scale = static_cast<const float*>(p[6]);
  t.sem_shift = static_cast<const float*>(p[7]);
  t.lcat_w = static_cast<const float*>(p[8]);
  t.lcat_scale = static_cast<const float*>(p[9]);
  t.lcat_shift = static_cast<const float*>(p[10]);
  t.proj_t = static_cast<const float*>(p[11]);
  t.proj_p = static_cast<const float*>(p[12]);
  t.c_k = static_cast<const float*>(p[13]);
  t.acat_w = static_cast<const float*>(p[14]);
  t.acat_scale = static_cast<const float*>(p[15]);
  t.acat_shift = static_cast<const float*>(p[16]);
  t.gcat_w = static_cast<const float*>(p[17]);
  t.gcat_scale = static_cast<const float*>(p[18]);
  t.gcat_shift = static_cast<const float*>(p[19]);
  return t;
}

// The shape and alignment rule of both C functions (the note above; the
// fold form: I = 1, C <= MAX_FOLD_C, and an even K, so that the folded
// w_proj's rows, 5C + 2K floats, and its g columns start on 16 bytes).
bool refused(const void* out, const Tables& t, long long frames, int j,
             int c, int d, int nheads, int inter, int g_ch, int x_bf16,
             int out_bf16, int fold) {
  const bool heads = fold ? inter == 1 && nheads % 2 == 0 && c <= MAX_FOLD_C
                          : nheads * inter == c;
  return frames < 0 || j < 1 || j > MAX_J || d < 1 || d > MAX_D ||
         nheads < 1 || nheads > MAX_HEADS || !heads ||
         nheads * g_ch != c || !aligned16(out) || !aligned16(t.w_proj) ||
         !aligned16(t.lcat_w) || !aligned16(t.acat_w) ||
         !aligned16(t.gcat_w) || ((x_bf16 || out_bf16) && !BF16_IO);
}

// Cfg<C, threads along rows, rows a thread, blocks an SM, slab rows, slabs
// in the ring>: tiles of 256 rows at C <= 32, 128 at C = 48..64, 64 at C
// >= 80; 256 to 512 threads; 32-row slabs where C allows. L is a functor
// that launches a Cfg.
template <class L>
int by_width(int c, L launch_cfg) {
  switch (c) {
    case 16:
      return launch_cfg(Cfg<16, 64, 4, 2, 16, 3>());
    case 32:
      return launch_cfg(Cfg<32, 64, 4, 1, 32, 2>());
    case 48:
      return launch_cfg(Cfg<48, 32, 4, 1, 16, 3>());
    case 64:
      return launch_cfg(Cfg<64, 32, 4, 1, 32, 2>());
    case 80:
      return launch_cfg(Cfg<80, 16, 4, 1, 16, 3>());
    case 96:
      return launch_cfg(Cfg<96, 16, 4, 1, 32, 2>());
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
}  // namespace

// The fold form's launch, which the C functions of part 1 call and part 2
// defines where the library is built in parts (GASTX_NARROW_PART, above);
// p: the 20 tables in GabTables' order (as the C functions take them).
namespace gastx_narrow_parts {
#ifndef GASTX_TIERED_FORM
__attribute__((visibility("hidden"))) int fold(
    const void* x, void* out, long long frames, int j, int c, int d,
    int nheads, const void* const* p, cudaStream_t st, bool xb, bool ob);
#if NARROW_FOLD
int fold(const void* x, void* out, long long frames, int j, int c, int d,
         int nheads, const void* const* p, cudaStream_t st, bool xb,
         bool ob) {
  const Tables t = make_tables(p);
  return by_width(c, [&](auto cfg) {
    using G = decltype(cfg);
    if constexpr (G::C <= MAX_FOLD_C)
      return launch<FoldCfg<G>>(x, out, frames, j, d, nheads, t, st, xb, ob);
    else
      return static_cast<int>(cudaErrorInvalidValue);
  });
}
#endif
#else
// codes: the seven tier codes in Tiers' order.
__attribute__((visibility("hidden"))) int fold(
    const void* x, void* out, long long frames, int j, int c, int d,
    int nheads, const void* const* p, cudaStream_t st, bool xb, bool ob,
    const int* codes, void* scratch, long long scratch_size);
#if NARROW_FOLD
int fold(const void* x, void* out, long long frames, int j, int c, int d,
         int nheads, const void* const* p, cudaStream_t st, bool xb, bool ob,
         const int* codes, void* scratch, long long scratch_size) {
  const Tables t = make_tables(p);
  const Tiers tr{codes[0], codes[1], codes[2], codes[3],
                 codes[4], codes[5], codes[6]};
  return by_width(c, [&](auto cfg) {
    constexpr int width = decltype(cfg)::C;
    using G = typename TieredCfg<width <= MAX_TIERED_C ? width : 16>::type;
    if constexpr (width > MAX_TIERED_C)
      return static_cast<int>(cudaErrorInvalidValue);
    else
      return launch_tiered<FoldCfg<G>>(x, out, frames, j, d, nheads, t, st,
                                       xb, ob, tr, scratch, scratch_size);
  });
}
#endif
#endif  // GASTX_TIERED_FORM
}  // namespace gastx_narrow_parts

#if NARROW_V1
extern "C" {

#ifndef GASTX_TIERED_FORM
// Launches on `stream`, x bf16 if x_bf16 and the output bf16 if out_bf16
// (else float32), the fold form if fold (its tables: gab_tables(...,
// "fold")); returns cudaGetLastError() after the launch, or
// cudaErrorInvalidValue for a shape the kernel does not take (the rule in
// the note above), for `out` or a weight it copies 16 bytes at a time
// that is not 16-byte aligned, or, in the float32 library, for bf16.
int gab_narrow(const void* x, void* out, long long frames, int j, int c,
               int d, int nheads, int inter, int g_ch,
               const void* w_proj, const void* proj_scale,
               const void* proj_shift, const void* w_self,
               const void* w_nbr, const void* col, const void* sem_scale,
               const void* sem_shift, const void* lcat_w,
               const void* lcat_scale, const void* lcat_shift,
               const void* proj_t, const void* proj_p, const void* c_k,
               const void* acat_w, const void* acat_scale,
               const void* acat_shift, const void* gcat_w,
               const void* gcat_scale, const void* gcat_shift,
               void* stream, int x_bf16, int out_bf16, int fold) {
  const void* p[20] = {w_proj,     proj_scale, proj_shift, w_self,
                       w_nbr,      col,        sem_scale,  sem_shift,
                       lcat_w,     lcat_scale, lcat_shift, proj_t,
                       proj_p,     c_k,        acat_w,     acat_scale,
                       acat_shift, gcat_w,     gcat_scale, gcat_shift};
  const Tables t = make_tables(p);
  if (refused(out, t, frames, j, c, d, nheads, inter, g_ch, x_bf16,
              out_bf16, fold))
    return static_cast<int>(cudaErrorInvalidValue);
  const bool xb = x_bf16 != 0, ob = out_bf16 != 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (fold)
    return gastx_narrow_parts::fold(x, out, frames, j, c, d, nheads, p, st,
                                    xb, ob);
  return by_width(c, [&](auto cfg) {
    return launch<decltype(cfg)>(x, out, frames, j, d, nheads, t, st, xb,
                                 ob);
  });
}
#else

// gab_narrow at the tiers, C <= MAX_TIERED_C: the same arguments, then the
// tier codes of the projection's sem columns, its attention columns (the
// fold form's g; its sa | sb take the score's), the local cat, the global
// cat and the block concat (0 default .. 3 high) and of the attention's
// score and apply dots (0 highest .. 4 high), then the scratch buffer the
// launch splits the weights into (16-byte aligned, scratch_size 4-byte
// words; kernels.narrow_scratch) and that no other launch uses meanwhile.
int gab_narrow_tiered(const void* x, void* out, long long frames, int j,
                      int c, int d, int nheads, int inter, int g_ch,
                      const void* w_proj, const void* proj_scale,
                      const void* proj_shift, const void* w_self,
                      const void* w_nbr, const void* col,
                      const void* sem_scale, const void* sem_shift,
                      const void* lcat_w, const void* lcat_scale,
                      const void* lcat_shift, const void* proj_t,
                      const void* proj_p, const void* c_k,
                      const void* acat_w, const void* acat_scale,
                      const void* acat_shift, const void* gcat_w,
                      const void* gcat_scale, const void* gcat_shift,
                      void* stream, int x_bf16, int out_bf16, int fold,
                      int sem, int proj, int lcat, int acat, int gcat,
                      int score, int apply, void* scratch,
                      long long scratch_size) {
  const void* p[20] = {w_proj,     proj_scale, proj_shift, w_self,
                       w_nbr,      col,        sem_scale,  sem_shift,
                       lcat_w,     lcat_scale, lcat_shift, proj_t,
                       proj_p,     c_k,        acat_w,     acat_scale,
                       acat_shift, gcat_w,     gcat_scale, gcat_shift};
  const Tables t = make_tables(p);
  const Tiers tr{sem, proj, lcat, acat, gcat, score, apply};
  bool bad = refused(out, t, frames, j, c, d, nheads, inter, g_ch, x_bf16,
                     out_bf16, fold);
  const int codes[7] = {sem, proj, lcat, acat, gcat, score, apply};
  for (int i = 0; i < 7; ++i)
    bad = bad || codes[i] < 0 || codes[i] > (i < 5 ? 3 : 4);
  if (bad || c > MAX_TIERED_C)
    return static_cast<int>(cudaErrorInvalidValue);
  const bool xb = x_bf16 != 0, ob = out_bf16 != 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (fold)
    return gastx_narrow_parts::fold(x, out, frames, j, c, d, nheads, p, st,
                                    xb, ob, codes, scratch, scratch_size);
  return by_width(c, [&](auto cfg) {
    constexpr int width = decltype(cfg)::C;
    using G = typename TieredCfg<width <= MAX_TIERED_C ? width : 16>::type;
    if constexpr (width > MAX_TIERED_C)
      return static_cast<int>(cudaErrorInvalidValue);
    else
      return launch_tiered<G>(x, out, frames, j, d, nheads, t, st, xb, ob,
                              tr, scratch, scratch_size);
  });
}

#endif  // GASTX_TIERED_FORM

const char* error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
#endif  // NARROW_V1
