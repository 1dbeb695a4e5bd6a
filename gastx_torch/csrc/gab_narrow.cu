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
// (gab_narrow_tiered, below) in libraries of its own (kernels.py,
// TIERED_SOURCES), so that the two forms compile side by side.
//
// Each form also has a fold instantiation (FoldCfg; the C functions' fold
// flag): the function of fused_gab_pbatch(..., form="fold") on the tables
// of gab_tables(..., "fold"), whose projection holds each head's scores
// already folded with its score vectors (the note at gab_narrow_kernel);
// C <= 64, I = 1 and K = 2 or 4.
#include <cuda_bf16.h>
#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

// GASTX_BF16_IO builds the bf16-I/O library (kernels.py, IO_SOURCES), whose
// code reads the dtype bits; the float32 library's has no dtype branch.
#ifdef GASTX_BF16_IO
constexpr bool BF16_IO = true;
#else
constexpr bool BF16_IO = false;
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
// Its four products (the projection, local cat, global cat and block
// concat; seven slab streams as above) run as bf16 mma.sync.m16n8k16
// passes with float32 accumulation, by tier: one pass (ah bh) at default
// and kdefault, two at high_lhs (+ al bh) and high_rhs (+ ah bl), three at
// high, with a = ah + al, ah = bf16(a), al = bf16(a - ah) rounded to
// nearest even (precision.split_bf16). The projection's sem columns take
// local_sem's tier and its attention columns attn_proj's (they are apart
// products here: P1, P2 and P4, P5). The activations stay float32 in
// shared memory in the float32 kernel's group plan (the semantic graph
// and the attention read them), and each warp splits its A fragments as
// it loads them. The weights stream through a float32 ring as above, and
// each slab, once landed, is split once by the whole block into a bf16
// buffer of k-pair words (hi, and lo where the product's tier takes it;
// rows padded 8 words so that the B fragments load without bank
// conflicts). The attention rounds its score and apply operands as
// joint_attention.cu's tiered instantiations do (q1 = bf16, q2 = q1 + q1
// of the rest; high: q2(a) q1(b) + q1(a) lo(b)) and accumulates in
// float32 FMAs, each operand rounded once (attention_tiered).
//
// Bound: the same bytes as the float32 kernel (x in, 2C out a row) and
// 2 * 16 * C^2 FLOPs a row at the bf16 tensor-core rate a pass, 2.7 C
// FLOPs a byte a pass against the card's ~295: bytes bound it at every
// tier up to C = 32 (at C = 32, 33 kFLOP against 384 bytes a row) and at
// one pass at every narrow width. Its tiles are the float32 kernel's; its
// slabs 16 rows (32 at C = 32) in a ring of 3 or 4 (TiersCfg). A warp
// owns MPW 16-row by NPG 8-column tiles of each C-wide output group (Tc),
// its accumulators in registers.
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

// The tiered form's tiling of each width: the float32 kernel's tiles, with
// slabs and ring depth of its own.
template <int C>
struct TieredCfg;
template <>
struct TieredCfg<16> {
  using type = Cfg<16, 64, 4, 2, 16, 4>;
};
template <>
struct TieredCfg<32> {
  using type = Cfg<32, 64, 4, 1, 32, 3>;
};
template <>
struct TieredCfg<48> {
  using type = Cfg<48, 32, 4, 1, 16, 4>;
};
template <>
struct TieredCfg<64> {
  using type = Cfg<64, 32, 4, 1, 16, 4>;
};

// The warp grid of a width: WM x WN warps over the tile's 16-row tiles and
// a C-wide group's 8-column tiles, the first WN (fewest columns a warp
// shares) that divides both; and the bf16 slab buffer: BK / 2 k-pair rows
// of at most 2C words and 8 more, hi then lo.
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
  static constexpr int WB_HALF = G::BK / 2 * (2 * G::C + 8);  // words
  static_assert(WN > 0 && G::BK % 16 == 0, "tensor-core warp grid");
};

__device__ __forceinline__ uint32_t bf16_bits(float x) {
  const __nv_bfloat16 h = __float2bfloat16_rn(x);
  return static_cast<uint32_t>(*reinterpret_cast<const unsigned short*>(&h));
}
__device__ __forceinline__ float bits_bf16(uint32_t b) {
  return __uint_as_float(b << 16);
}

// The bf16 halves (hi, lo) of (x0, x1) as mma operand registers, x0 in the
// low 16 bits (the smaller k).
__device__ __forceinline__ void split2(float x0, float x1, uint32_t& hi,
                                       uint32_t& lo) {
  const uint32_t h0 = bf16_bits(x0), h1 = bf16_bits(x1);
  hi = h0 | h1 << 16;
  lo = bf16_bits(x0 - bits_bf16(h0)) | bf16_bits(x1 - bits_bf16(h1)) << 16;
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

// product() at a tier (the code above): the same operands, slab stream,
// prefetch, epilogue and output layouts, its sums by tensor-core passes.
// Each landed slab (BK rows of N floats) is split into `wb`: word (kp, n)
// of the hi half holds rows 2kp and 2kp+1 of column n, rows N + 8 words
// apart; the lo half follows at Tc::WB_HALF, made only where b_lo.
template <class G, int MM, int NS, bool RELU, bool TO_GLOBAL,
          bool ROW_MAJOR = false>
__device__ __forceinline__ void product_tc(
    int tier, const Tables& t, float* ring, uint32_t* wb, long long& g,
    long long total, int nh, float* acts, int a0, int a1, int a2,
    const float* scale, const float* shift, int o0, int o1,
    void* out = nullptr, int rows_valid = 0, const Prefetch* pre = nullptr,
    bool out_bf = false) {
  using T = Tc<G>;
  constexpr int C = G::C, N = MM * C, NW = N + 8, BMP = G::BMP;
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
    __syncthreads();  // slab g has landed; slab g - 1 and wb are read
    if (pre != nullptr) {
      if (s == 0 && pre->sem)
        load_sem<G, true>(t, acts + 4 * G::GROUP, pre->j, pre->d, 0);
      if (s == S && pre->x != nullptr)
        load_x<G, true>(pre->x, pre->x_bf, acts, pre->rows);
      if (s == 2 * S && pre->sem)
        load_sem<G, true>(t, acts + 3 * G::GROUP, pre->j, pre->d, 1);
    }
    stage<G>(t, ring, g + G::STAGES - 1, total, nh);
    const float* w = ring + (int)(g % G::STAGES) * G::SLAB;
    ++g;
    for (int e = threadIdx.x; /*TSPLIT*/true && e < BK / 2 * N;
         e += G::NT) {
      const int kp = e / N, n = e - kp * N;
      uint32_t hi, lo;
      split2(w[2 * kp * N + n], w[(2 * kp + 1) * N + n], hi, lo);
      wb[kp * NW + n] = hi;
      if (b_lo) wb[T::WB_HALF + kp * NW + n] = lo;
    }
    __syncthreads();  // wb holds slab g
    const int k0 = s * BK, piece = k0 / C;
    const float* a =
        acts + (size_t)(piece == 0 ? a0 : piece == 1 ? a1 : a2) * G::GROUP +
        (size_t)(k0 - piece * C) * BMP;
    if (!/*TMMA*/true) continue;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      uint32_t bh[NN][2], bl[NN][2];
#pragma unroll
      for (int q = 0; q < NN; ++q) {
        const uint32_t* wc = wb + (kk / 2 + tq) * NW + col(q) + gq;
        bh[q][0] = wc[0];
        bh[q][1] = wc[4 * NW];
        if (b_lo) {
          bl[q][0] = wc[T::WB_HALF];
          bl[q][1] = wc[T::WB_HALF + 4 * NW];
        }
      }
#pragma unroll
      for (int i = 0; i < T::MPW; ++i) {
        const float* ac =
            a + (kk + 2 * tq) * BMP + (wm * T::MPW + i) * 16 + gq;
        uint32_t ah[4], al[4];
        split2(ac[0], ac[BMP], ah[0], al[0]);
        split2(ac[8], ac[BMP + 8], ah[1], al[1]);
        split2(ac[8 * BMP], ac[9 * BMP], ah[2], al[2]);
        split2(ac[8 * BMP + 8], ac[9 * BMP + 8], ah[3], al[3]);
#pragma unroll
        for (int q = 0; q < NN; ++q) {
          mma_bf16(acc[i][q], ah, bh[q]);
          if (b_lo) mma_bf16(acc[i][q], ah, bl[q]);
          if (a_lo) mma_bf16(acc[i][q], al, bh[q]);
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
// its code) in `dst` (the slab-split buffer wb, free between P5 and P6):
// the rounded columns as load_fold lays them out (2KC floats), their lo
// halves (2KC), then the 2K scales and 2K shifts. The tiles' shared memory
// has no room beside wb for a copy a block at C = 64 and J = 32, so each
// tile loads them (from L2) after P5.
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

// attention() with its score dots at `score` and its apply dots at `apply`
// (ATTN codes): theta/phi the lhs and p_theta/p_phi the rhs of the score,
// the attention weights the lhs and g the rhs of the apply, each rounded
// as read; the high tier adds its q1(a) lo(b) term. Three passes between
// barriers over the tile's nf frames (theta, phi column-major; g
// row-major, C floats a row):
//  1. the scores, one thread a (row, head), the score vectors rounded once
//     a block in `pr` (rhs(p_theta) | rhs(p_phi) | lo(p_theta) |
//     lo(p_phi), C each); each (row, head)'s pair goes over theta's first
//     two columns of the head, which that pair alone reads;
//  2. g rounded in place as the apply's rhs, and, for the high apply tier,
//     lo(g) into phi's group (free after the scores);
//  3. the apply: one warp a (frame, head), one lane a query joint, 8
//     output columns a step, its weights rounded in registers; each head's
//     outputs over its theta columns.
// The fold form (G::FOLD) takes no theta or phi: an item's scores are its
// row of x (xs) against the head's folded columns at the score tier, x the
// lhs and the columns the rhs, as gemm_tc computes the chain's sa | sb; pr
// then holds the columns as load_fold_tiered leaves them, and the heads
// go to `theta`'s group, G = C / K columns a head.
template <class G>
__device__ __forceinline__ void attention_tiered(
    float* theta, float* phi, float* gv, int nf, int j, int nheads,
    const float* pr, const float* c_k, int score, int apply,
    const float* xs) {
  constexpr int C = G::C, BMP = G::BMP;
  constexpr int ITEMS = (G::BM * MAX_HEADS + G::NT - 1) / G::NT;
  const int inter = C / nheads, rows = nf * j, items = rows * nheads;
  const int s_lhs = lhs_mode(score);
  const int a_lhs = lhs_mode(apply), a_rhs = rhs_mode(apply);
  const bool s_high = score == 4, a_high = apply == 4;
  float sab[ITEMS][2];
#pragma unroll
  for (int it = 0; it < ITEMS; ++it) {
    const int e = threadIdx.x + it * G::NT;
    const int k = e / rows, r = e - k * rows;
    float sa = 0.f, sb = 0.f;
    if constexpr (G::FOLD) {
      if (e < items) {
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
      }
    } else if (e < items) {
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
    sab[it][0] = sa;
    sab[it][1] = sb;
  }
  __syncthreads();  // theta and phi are read
#pragma unroll
  for (int it = 0; it < ITEMS; ++it) {
    const int e = threadIdx.x + it * G::NT;
    const int k = e / rows, r = e - k * rows;
    if (e < items) {
      theta[k * inter * BMP + r] = sab[it][0];
      theta[(k * inter + 1) * BMP + r] = sab[it][1];
    }
  }
  if (apply != 0)
    for (int e = threadIdx.x; e < rows * C; e += G::NT) {
      const float v = gv[e];
      gv[e] = rnd(v, a_rhs);
      if (a_high) phi[e] = lo_half(v);
    }
  __syncthreads();
  const int warp = threadIdx.x / 32, q = threadIdx.x % 32;
  for (int pair = warp; pair < nf * nheads; pair += G::NT / 32) {
    const int fr = pair / nheads, k = pair - fr * nheads;
    const int row0 = fr * j;
    const float* sc = theta + k * inter * BMP + row0;
    const float sa = q < j ? sc[q] : 0.f, sb = q < j ? sc[BMP + q] : 0.f;
    __syncwarp();  // every lane has its scores before the outputs go there
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
    const float* gk = gv + (size_t)row0 * C + k * inter;
    const float* gl = phi + (size_t)row0 * C + k * inter;
    for (int g0 = 0; g0 < inter; g0 += 8) {
      const bool hi = g0 + 4 < inter;
      float4 lo4 = make_float4(0.f, 0.f, 0.f, 0.f), hi4 = lo4;
#pragma unroll
      for (int m = 0; m < MAX_J; ++m) {
        if (m >= j) break;
        float wa = w[m], wh = w[m];
        if (a_lhs) {
          wh = q1(w[m]);
          wa = a_lhs == 2 ? wh + q1(w[m] - wh) : wh;
        }
        const float4 a = *reinterpret_cast<const float4*>(gk + m * C + g0);
        lo4.x = fmaf(wa, a.x, lo4.x);
        lo4.y = fmaf(wa, a.y, lo4.y);
        lo4.z = fmaf(wa, a.z, lo4.z);
        lo4.w = fmaf(wa, a.w, lo4.w);
        if (hi) {
          const float4 h =
              *reinterpret_cast<const float4*>(gk + m * C + g0 + 4);
          hi4.x = fmaf(wa, h.x, hi4.x);
          hi4.y = fmaf(wa, h.y, hi4.y);
          hi4.z = fmaf(wa, h.z, hi4.z);
          hi4.w = fmaf(wa, h.w, hi4.w);
        }
        if (a_high) {
          const float4 b = *reinterpret_cast<const float4*>(gl + m * C + g0);
          lo4.x = fmaf(wh, b.x, lo4.x);
          lo4.y = fmaf(wh, b.y, lo4.y);
          lo4.z = fmaf(wh, b.z, lo4.z);
          lo4.w = fmaf(wh, b.w, lo4.w);
          if (hi) {
            const float4 h =
                *reinterpret_cast<const float4*>(gl + m * C + g0 + 4);
            hi4.x = fmaf(wh, h.x, hi4.x);
            hi4.y = fmaf(wh, h.y, hi4.y);
            hi4.z = fmaf(wh, h.z, hi4.z);
            hi4.w = fmaf(wh, h.w, hi4.w);
          }
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

// gab_narrow_kernel at the tiers: the same tiles, group plan and prefetch
// (the fold form's too: load_fold_tiered).
template <class G>
__global__ void __launch_bounds__(G::NT, G::MINB)
gab_narrow_tiered_kernel(const void* __restrict__ x, void* __restrict__ out,
                         long long frames, int fpt, long long tiles, int j,
                         int d, int nheads, const Tables t, bool x_bf,
                         bool out_bf, const Tiers tr) {
  x_bf = BF16_IO && x_bf;
  out_bf = BF16_IO && out_bf;
  extern __shared__ float4 smem4[];
  constexpr int C = G::C, GR = G::GROUP, S = G::S;
  float* acts = reinterpret_cast<float*>(smem4);
  float* ring = acts + 5 * GR;
  uint32_t* wb = reinterpret_cast<uint32_t*>(ring + G::STAGES * G::SLAB);
  float* ck = reinterpret_cast<float*>(wb + 2 * Tc<G>::WB_HALF);
  float* pr = ck + nheads * j * j;
  int* col = reinterpret_cast<int*>(pr + (G::FOLD ? 0 : 4 * C));
  static_assert(4 * MAX_HEADS * (C + 1) <= 2 * Tc<G>::WB_HALF,
                "the fold form's score columns fit in wb");
  for (int i = threadIdx.x; i < nheads * j * j; i += G::NT)
    ck[i] = __ldg(t.c_k + i);
  // The score vectors as the score tier's rhs, and their lo halves.
  for (int i = threadIdx.x; !G::FOLD && i < C; i += G::NT) {
    const float vt = __ldg(t.proj_t + i), vp = __ldg(t.proj_p + i);
    const int mode = rhs_mode(tr.score);
    pr[i] = rnd(vt, mode);
    pr[C + i] = rnd(vp, mode);
    pr[2 * C + i] = lo_half(vt);
    pr[3 * C + i] = lo_half(vp);
  }
  for (int i = threadIdx.x; i < 2 * j * d; i += G::NT)
    col[i] = __ldg(t.col + i);
  const bool staged = j * (1 + d) * C + 2 * C <= GR;
  const SemSrc sem_w0 = sem_src<G>(t, staged ? acts + 4 * GR : nullptr, j,
                                   d, 0);
  const SemSrc sem_w1 = sem_src<G>(t, staged ? acts + 3 * GR : nullptr, j,
                                   d, 1);
  const long long total =
      ((tiles - 1 - blockIdx.x) / gridDim.x + 1) * G::SPT;
  long long g = 0;
  for (int i = 0; i < G::STAGES - 1; ++i)
    stage<G>(t, ring, i, total, nheads);
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
    }
    product_tc<G, 2, S, false, false>(tr.sem, t, ring, wb, g, total, nheads,
                                      acts, 0, 0, 0, t.proj_scale,
                                      t.proj_shift, 1, 2);
    __syncthreads();
    if (/*TSEM*/true)
      sem_graph<G>(sem_w0, col, acts + GR, acts + 2 * GR, nf, j, d, 0);
    product_tc<G, 2, S, false, false>(tr.sem, t, ring, wb, g, total, nheads,
                                      acts, 0, 0, 0, t.proj_scale + 2 * C,
                                      t.proj_shift + 2 * C, 2, 4);
    __syncthreads();
    if (/*TSEM*/true)
      sem_graph<G>(sem_w1, col, acts + 2 * GR, acts + 4 * GR, nf, j, d, 1);
    product_tc<G, 1, 2 * S, true, false>(tr.lcat, t, ring, wb, g, total,
                                         nheads, acts, 1, 2, 0, t.lcat_scale,
                                         t.lcat_shift, 3, 0);
    if constexpr (!G::FOLD)
      product_tc<G, 2, S, false, false>(tr.proj, t, ring, wb, g, total,
                                        nheads, acts, 0, 0, 0,
                                        t.proj_scale + 4 * C,
                                        t.proj_shift + 4 * C, 1, 2);
    product_tc<G, 1, S, false, false, true>(tr.proj, t, ring, wb, g, total,
                                            nheads, acts, 0, 0, 0,
                                            t.proj_scale + gcol,
                                            t.proj_shift + gcol, 4, 0);
    __syncthreads();
    float* scores = pr;
    if constexpr (G::FOLD) {
      scores = reinterpret_cast<float*>(wb);
      load_fold_tiered<G>(t, scores, nheads, rhs_mode(tr.score));
      __syncthreads();
    }
    if (/*TATTN*/true)
      attention_tiered<G>(acts + GR, acts + 2 * GR, acts + 4 * GR, nf, j,
                          nheads, scores, ck, tr.score, tr.apply, acts);
    product_tc<G, 1, S, true, false>(tr.acat, t, ring, wb, g, total, nheads,
                                     acts, 1, 0, 0, t.acat_scale,
                                     t.acat_shift, 2, 0);
    const long long f1 = (tile + gridDim.x) * fpt;
    const bool more = tile + gridDim.x < tiles;
    const Prefetch pre{more ? elem_ptr(x, f1 * j * C, x_bf) : nullptr, x_bf,
                       more ? (int)min((long long)fpt, frames - f1) * j : 0,
                       j, d, more && staged};
    product_tc<G, 2, 3 * S, true, true>(
        tr.gcat, t, ring, wb, g, total, nheads, acts, 0, 3, 2, t.gcat_scale,
        t.gcat_shift, 0, 0,
        const_cast<void*>(elem_ptr(out, f0 * j * 2 * C, out_bf)), rows, &pre,
        out_bf);
  }
}

template <class G>
int launch_tiered(const void* x, void* out, long long frames, int j, int d,
                  int nheads, const Tables& t, cudaStream_t stream, bool x_bf,
                  bool out_bf, const Tiers& tr) {
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
                       2 * Tc<G>::WB_HALF + nheads * j * j +
                       (G::FOLD ? 0 : 4 * G::C)) +
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
  if (tiles > 0) {
    const long long blocks =
        tiles < (long long)per_sm * sms ? tiles : (long long)per_sm * sms;
    gab_narrow_tiered_kernel<G><<<(unsigned)blocks, G::NT, smem, stream>>>(
        x, out, frames, fpt, tiles, j, d, nheads, t, x_bf, out_bf, tr);
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
  return by_width(c, [&](auto cfg) {
    using G = decltype(cfg);
    if constexpr (G::C <= MAX_FOLD_C) {
      if (fold)
        return launch<FoldCfg<G>>(x, out, frames, j, d, nheads, t, st, xb,
                                  ob);
    }
    return launch<G>(x, out, frames, j, d, nheads, t, st, xb, ob);
  });
}
#else

// gab_narrow at the tiers, C <= MAX_TIERED_C: the same arguments, then the
// tier codes of the projection's sem columns, its attention columns (the
// fold form's g; its sa | sb take the score's), the local cat, the global
// cat and the block concat (0 default .. 3 high) and of the attention's
// score and apply dots (0 highest .. 4 high).
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
                      int score, int apply) {
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
  return by_width(c, [&](auto cfg) {
    constexpr int width = decltype(cfg)::C;
    using G = typename TieredCfg<width <= MAX_TIERED_C ? width : 16>::type;
    if constexpr (width > MAX_TIERED_C)
      return static_cast<int>(cudaErrorInvalidValue);
    else if (fold)
      return launch_tiered<FoldCfg<G>>(x, out, frames, j, d, nheads, t, st,
                                       xb, ob, tr);
    else
      return launch_tiered<G>(x, out, frames, j, d, nheads, t, st, xb, ob,
                              tr);
  });
}

#endif  // GASTX_TIERED_FORM

const char* error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
