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
#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

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
  static_assert(C_ % BK_ == 0 && TM_ % 4 == 0 && RTH_ % 4 == 0 &&
                    NT % 32 == 0 && STAGES_ >= 2, "tiling");
};

// Stages slab i of the block's stream into its ring slot: slab i % SPT of
// a tile, whose seven products take S, S, 2S, S, S, S and 3S slabs.
template <class G>
__device__ __forceinline__ void stage(const Tables& t, float* ring,
                                      long long i, long long total) {
  constexpr int C = G::C, S = G::S;
  if (i < total) {
    const int s = (int)(i % G::SPT);
    const float* w;
    int ld, n, k0;
    if (s < S) {         // P1: sym semantic columns
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

// x rows of the tile (row-major, `rows` of them) into activation group 0,
// column-major; the rows past them zero.
template <class G, bool ASYNC>
__device__ __forceinline__ void load_x(const float* __restrict__ xg,
                                       float* xs, int rows) {
  constexpr int C = G::C;
  for (int e = threadIdx.x; e < G::BM * C; e += G::NT) {
    const int r = e / C, c = e - r * C;
    float* dst = xs + c * G::BMP + r;
    if (r >= rows)
      *dst = 0.f;
    else if (ASYNC)
      __pipeline_memcpy_async(dst, xg + e, 4);
    else
      *dst = __ldg(xg + e);
  }
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
  const float* x;
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
template <class G, int MM, int NS, bool RELU, bool TO_GLOBAL,
          bool ROW_MAJOR = false>
__device__ __forceinline__ void product(
    bool on, const Tables& t, float* ring, long long& g, long long total,
    float* acts, int a0, int a1, int a2, const float* scale,
    const float* shift, int o0, int o1, float* out = nullptr,
    int rows_valid = 0, const Prefetch* pre = nullptr) {
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
        load_x<G, true>(pre->x, acts, pre->rows);
      if (s == 2 * S && pre->sem)
        load_sem<G, true>(t, acts + 3 * G::GROUP, pre->j, pre->d, 1);
    }
    stage<G>(t, ring, g + G::STAGES - 1, total);
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
    if (TO_GLOBAL || ROW_MAJOR) {
      float* base = TO_GLOBAL ? out + c0
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

// Per-frame multi-head attention over the joints of the tile's nf frames:
// theta and phi column-major, g row-major (C floats a row; head-major, I =
// G = C / K columns a head; I is a multiple of 4). Each head's outputs go
// over its theta columns. proj_t/proj_p (K, I) and c_k (K, J, J) are the
// block's copies.
template <class G>
__device__ __forceinline__ void attention(float* theta, const float* phi,
                                          const float* gv, int nf, int j,
                                          int nheads, const float* proj_t,
                                          const float* proj_p,
                                          const float* c_k) {
  constexpr int C = G::C, BMP = G::BMP;
  const int warp = threadIdx.x / 32, q = threadIdx.x % 32;
  const int inter = C / nheads;
  for (int pair = warp; pair < nf * nheads; pair += G::NT / 32) {
    const int fr = pair / nheads, k = pair - fr * nheads;
    const int row0 = fr * j;
    float sa = 0.f, sb = 0.f;
    if (q < j) {
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
template <class G>
__global__ void __launch_bounds__(G::NT, G::MINB)
gab_narrow_kernel(const float* __restrict__ x, float* __restrict__ out,
                  long long frames, int fpt, long long tiles, int j, int d,
                  int nheads, const Tables t) {
  extern __shared__ float4 smem4[];
  constexpr int C = G::C, S = G::S, GR = G::GROUP;
  float* acts = reinterpret_cast<float*>(smem4);
  float* ring = acts + 5 * GR;
  float* ck = ring + G::STAGES * G::SLAB;
  float* pt = ck + nheads * j * j;
  float* pp = pt + C;
  int* col = reinterpret_cast<int*>(pp + C);
  for (int i = threadIdx.x; i < nheads * j * j; i += G::NT)
    ck[i] = __ldg(t.c_k + i);
  for (int i = threadIdx.x; i < C; i += G::NT) {
    pt[i] = __ldg(t.proj_t + i);
    pp[i] = __ldg(t.proj_p + i);
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
  for (int i = 0; i < G::STAGES - 1; ++i) stage<G>(t, ring, i, total);
  for (long long tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const long long f0 = tile * fpt;
    const int nf = (int)min((long long)fpt, frames - f0);
    const int rows = nf * j;
    if (tile == blockIdx.x) {  // the first tile's; P7 brings the next ones
      if (/*XLOAD*/true) load_x<G, false>(x + f0 * j * C, acts, rows);
      if (staged) {
        load_sem<G, false>(t, acts + 4 * GR, j, d, 0);
        load_sem<G, false>(t, acts + 3 * GR, j, d, 1);
      }
    }
    product<G, 2, S, false, false>(/*P1*/true, t, ring, g, total, acts, 0,
                                   0, 0, t.proj_scale, t.proj_shift, 1, 2);
    __syncthreads();
    if (/*SEM*/true)
      sem_graph<G>(sem_w0, col, acts + GR, acts + 2 * GR, nf, j, d, 0);
    product<G, 2, S, false, false>(/*P2*/true, t, ring, g, total, acts, 0,
                                   0, 0, t.proj_scale + 2 * C,
                                   t.proj_shift + 2 * C, 2, 4);
    __syncthreads();
    if (/*SEM*/true)
      sem_graph<G>(sem_w1, col, acts + 2 * GR, acts + 4 * GR, nf, j, d, 1);
    product<G, 1, 2 * S, true, false>(/*P3*/true, t, ring, g, total, acts,
                                      1, 2, 0, t.lcat_scale, t.lcat_shift,
                                      3, 0);
    product<G, 2, S, false, false>(/*P4*/true, t, ring, g, total, acts, 0,
                                   0, 0, t.proj_scale + 4 * C,
                                   t.proj_shift + 4 * C, 1, 2);
    product<G, 1, S, false, false, true>(/*P5*/true, t, ring, g, total,
                                         acts, 0, 0, 0,
                                         t.proj_scale + 6 * C,
                                         t.proj_shift + 6 * C, 4, 0);
    __syncthreads();
    if (/*ATTN*/true)
      attention<G>(acts + GR, acts + 2 * GR, acts + 4 * GR, nf, j, nheads,
                   pt, pp, ck);
    product<G, 1, S, true, false>(/*P6*/true, t, ring, g, total, acts, 1,
                                  0, 0, t.acat_scale, t.acat_shift, 2, 0);
    const long long f1 = (tile + gridDim.x) * fpt;
    const bool more = tile + gridDim.x < tiles;
    const Prefetch pre{more && /*XLOAD*/true ? x + f1 * j * C : nullptr,
                       more ? (int)min((long long)fpt, frames - f1) * j : 0,
                       j, d, more && staged};
    product<G, 2, 3 * S, true, true>(/*P7*/true, t, ring, g, total, acts,
                                     0, 3, 2, t.gcat_scale, t.gcat_shift, 0,
                                     0, out + f0 * j * 2 * C, rows, &pre);
  }
}

// As many persistent blocks as fit on the card, but no more than tiles.
template <class G>
int launch(const float* x, float* out, long long frames, int j, int d,
           int nheads, const Tables& t, cudaStream_t stream) {
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
                       nheads * j * j + 2 * G::C) +
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
        x, out, frames, fpt, tiles, j, d, nheads, t);
  }
  return static_cast<int>(cudaGetLastError());
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

}  // namespace

extern "C" {

// Launches on `stream`; returns cudaGetLastError() after the launch, or
// cudaErrorInvalidValue for a shape the kernel does not take (the rule in
// the note above) or for `out` or a weight it copies 16 bytes at a time
// that is not 16-byte aligned.
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
               void* stream) {
  if (frames < 0 || j < 1 || j > MAX_J || d < 1 || d > MAX_D ||
      nheads < 1 || nheads > MAX_HEADS || nheads * inter != c ||
      nheads * g_ch != c || !aligned16(out) || !aligned16(w_proj) ||
      !aligned16(lcat_w) || !aligned16(acat_w) || !aligned16(gcat_w))
    return static_cast<int>(cudaErrorInvalidValue);
  Tables t;
  t.w_proj = static_cast<const float*>(w_proj);
  t.proj_scale = static_cast<const float*>(proj_scale);
  t.proj_shift = static_cast<const float*>(proj_shift);
  t.w_self = static_cast<const float*>(w_self);
  t.w_nbr = static_cast<const float*>(w_nbr);
  t.col = static_cast<const int*>(col);
  t.sem_scale = static_cast<const float*>(sem_scale);
  t.sem_shift = static_cast<const float*>(sem_shift);
  t.lcat_w = static_cast<const float*>(lcat_w);
  t.lcat_scale = static_cast<const float*>(lcat_scale);
  t.lcat_shift = static_cast<const float*>(lcat_shift);
  t.proj_t = static_cast<const float*>(proj_t);
  t.proj_p = static_cast<const float*>(proj_p);
  t.c_k = static_cast<const float*>(c_k);
  t.acat_w = static_cast<const float*>(acat_w);
  t.acat_scale = static_cast<const float*>(acat_scale);
  t.acat_shift = static_cast<const float*>(acat_shift);
  t.gcat_w = static_cast<const float*>(gcat_w);
  t.gcat_scale = static_cast<const float*>(gcat_scale);
  t.gcat_shift = static_cast<const float*>(gcat_shift);
  const float* xf = static_cast<const float*>(x);
  float* of = static_cast<float*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  // Cfg<C, threads along rows, rows a thread, blocks an SM, slab rows,
  // slabs in the ring>: tiles of 256 rows at C <= 32, 128 at C = 48..64,
  // 64 at C >= 80; 256 to 512 threads; 32-row slabs where C allows.
  switch (c) {
    case 16:
      return launch<Cfg<16, 64, 4, 2, 16, 3>>(xf, of, frames, j, d, nheads,
                                              t, st);
    case 32:
      return launch<Cfg<32, 64, 4, 1, 32, 2>>(xf, of, frames, j, d, nheads,
                                              t, st);
    case 48:
      return launch<Cfg<48, 32, 4, 1, 16, 3>>(xf, of, frames, j, d, nheads,
                                              t, st);
    case 64:
      return launch<Cfg<64, 32, 4, 1, 32, 2>>(xf, of, frames, j, d, nheads,
                                              t, st);
    case 80:
      return launch<Cfg<80, 16, 4, 1, 16, 3>>(xf, of, frames, j, d, nheads,
                                              t, st);
    case 96:
      return launch<Cfg<96, 16, 4, 1, 32, 2>>(xf, of, frames, j, d, nheads,
                                              t, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

const char* error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
