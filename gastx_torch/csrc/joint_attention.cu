// Multi-head attention over the joints of one frame, for sm_90a.
//
// Replaces the score/softmax/apply chain of gastx/ops/pallas/fused_gab.py:248
// `_global_branch` (the TPU kernel's per-head rank-1 score dots, grouped
// LeakyReLU/softmax chains and per-head apply dots), and the TPU kernel
// gastx/ops/pallas/head_attn.py:61 `head_attention` when K = 1. For each
// frame and head k, with theta/phi/g the head's columns of the projection
// output (column views sharing one row stride ldp):
//
//   sa[q] = theta_k[q] . p_theta[k]      sb[m] = phi_k[m] . p_phi[k]
//   f[q, m] = LeakyReLU_0.2(sa[q] + sb[m])
//   attn[q, m] = softmax_m(f[q, :])[m] + C_k[k, q, m]   (row max subtracted)
//   out[q, k*G + g] = sum_m attn[q, m] * g_k[m, g]      (head-major)
//
// Bound on this card: per frame and head it reads J (2I + G) projection
// values and writes J G, 16 bytes a row and channel, for about J (2I + J G
// + 3J) operations: some 2.4 operations per byte at J = 17, under the
// card's float32 ridge of ~20, so device-memory bytes bound it. The loads
// and stores alone reach 81-85% of that bound on the card; what the design
// does is keep the scores, softmax and apply, which run between the
// block's syncs, short enough not to stall them:
//
// - Persistent blocks of 256 threads, about one wave: a block owns one
//   head (blockIdx.y) and walks tiles of `fpt` whole frames (the most that
//   fit in TILE_BYTES). Its head's p_theta, p_phi and C_k are staged in
//   shared memory once. (A block of every head, with longer runs of a row,
//   and smaller or larger tiles measured slower.)
// - The tile's theta | phi | g segments of the head arrive by cp.async (16
//   bytes a lane, each row a warp) into two shared-memory buffers, so the
//   next tile's rows load during this tile's scores, softmax and apply.
// - Scores: 8 lanes a row, its theta and phi dots side by side from
//   16-byte shared loads (a group reads 128 contiguous bytes), reduced by
//   shuffles.
// - Softmax: 4 lanes a (frame, query) row over only the key slots J
//   needs, holding them in registers; row max and sum by shuffles, expf of
//   the max-subtracted score, one reciprocal of the sum; the result, plus
//   C_k, is stored key-major. A warp with no row left skips the round.
// - Apply: one thread a (frame, 4 queries, 4 output channels), reading a
//   float4 of g and a float4 of 4 queries' weights per key, 16 FMAs, and
//   storing float4s (16 lanes write 256 contiguous bytes at G = 64).
//
// Tiers. The score dots (theta/phi by p_theta/p_phi) and the apply dots
// (attn by g) each carry the TPU kernel's tier (`kdot`, gastx/ops/pallas/
// precision.py:99; codes 0 highest, 1 default, 2 high_lhs, 3 high_rhs,
// 4 high). With q1(x) = bf16(x), lo(x) = q1(x - q1(x)) and q2(x) = q1(x) +
// lo(x) (x to 16 bits), every rounding to nearest even:
//
// - The score dots stay float32 FMAs of rounded operands: default q1(a)
//   q1(b), high_lhs q2(a) q1(b), high_rhs q1(a) q2(b), high q2(a) q1(b) +
//   q1(a) lo(b); each equals the sum of kdot's bf16 passes, whose products
//   are exact in float32. p_theta/p_phi are rounded once as they are
//   staged, theta/phi in registers as the score loop loads them.
// - The apply runs on the tensor cores (mma.sync.m16n8k16, bf16 operands,
//   float32 accumulation) as kdot's passes:
//   default hi(w) hi(g); high_lhs + lo(w) hi(g); high_rhs + hi(w) lo(g);
//   high hi(w) hi(g) + lo(w) hi(g) + hi(w) lo(g). At the apply tier
//   "highest" it is the float32 apply below.
//
// The tiered forms were the float32 kernel with runtime tier codes until
// this design, which answers their four costs so:
// 1. Runtime tiers in the inner loops: the pairs the shipped routes launch,
//    default/default and high/high, are template parameters (ST, AT), so
//    their loops have no rounding branch; every other pair shares one
//    instantiation with runtime codes (RUNTIME), or, at the apply tier
//    "highest", one with the float32 apply. The tiered score loop keeps the
//    float32 loop's 16-byte loads and rounds two values an instruction
//    (cvt.rn.bf16x2.f32), each operand once.
// 2. The shared-memory pass that rounded g in place (an integer division a
//    value, lo(g) into a second buffer) is gone: the apply loads g's
//    float32 values from the tile and rounds them in registers into the
//    mma's B words (hi, and lo where the tier takes it), each value once,
//    by the one warp that multiplies it.
// 3. The CUDA-core apply (16 FMAs and two 16-byte shared loads a key, twice
//    at high) is one mma a pass per (16 queries, 8 channels, 16 keys): the
//    softmax (4 lanes a row, each holding key pairs, __expf) writes each
//    row's weights as bf16 pair words (hi, and lo where the tier takes
//    it), keys past J as zeros, into the tile's own rows over their theta
//    | phi columns, dead once the scores are taken (rows at stride rs, so
//    the eight rows of an ldmatrix fall in distinct banks); a warp takes
//    one (frame, NT n-tiles of 8 channels), both m-tiles of J > 16 on the
//    same B words, and stores its float32 sums from the accumulators (J =
//    17 pads to 32 queries and keys; padded query rows read row J - 1 and
//    are not stored).
// 4. More blocks an SM: with the words in the tile and no g copies, a
//    tensor-core block takes the double buffer and the head's constants
//    alone (~55 KB at C=256), and its registers are bounded for TC_BLOCKS
//    = 4 blocks an SM (64), so four blocks' phases interleave where the
//    float32 kernel runs three; the next tile loads under each tile's
//    phases, as in the float32 kernel.
// (scripts/torch_graph_kernels.py --variants undoes each choice: integer
// rounding, other tiles, one n-tile a warp, 8 lanes a softmax row, expf,
// words apart and 3 blocks an SM measured slower; so did a third tile
// buffer.)
//
// Two alignment instantiations of each: VEC = 4 (16-byte copies, loads and
// stores) where I, G and ldp are multiples of 4 and theta, phi, g and out
// start 16-byte aligned, and VEC = 1 (4-byte) otherwise, e.g. the
// 8-channel model's heads (I = 2) or a view at an odd offset
// (kernels.graph_variant picks; the C entry point refuses VEC = 4 for
// operands that do not meet its rule). J <= 32; two tiles of one frame must
// fit in shared memory (2 J (2I + G + 8) floats and the head's constants:
// 2I + G up to ~1600 at J = 17, ~850 at J = 32).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int MAX_J = 32;
constexpr int THREADS = 256;
constexpr int GROUP = 8;        // lanes of a score row
constexpr int ROW = 4;          // lanes of a softmax row
constexpr int QB = 4;           // queries of a float32 apply thread
// A tile is the most whole frames whose rows fit in TILE_BYTES (at least
// one): at J = 17, 3 frames at C=128, 2 at 256, 1 at 512.
constexpr int TILE_BYTES = 27136;
constexpr int MAX_FRAMES = 8;   // frames a tile, at most
constexpr unsigned FULL = 0xffffffffu;
// The tensor-core apply: 32-bit words of a row of attention weights (32
// keys as bf16 pairs, and 4 words so that the 8 rows of an ldmatrix fall
// in distinct banks), and the 8-channel n-tiles a warp takes. The words
// lie in the tile's own rows, over its theta | phi columns (dead once the
// scores are taken), where those hold them (WORDS_IN_TILE), else apart.
constexpr int AW = 20;
constexpr int NT = 2;
constexpr bool WORDS_IN_TILE = true;
// Lanes of a row of the tensor-core instantiations' softmax, and the
// blocks an SM their registers are bounded for (__launch_bounds__).
constexpr int SROW = 4;
constexpr int TC_BLOCKS = 4;

// Tier codes (kernels.ATTN_TIERS), and the template argument of a tier
// read from the launch's runtime code.
constexpr int HIGHEST = 0, DEFAULT = 1, HIGH_LHS = 2, HIGH_RHS = 3,
              HIGH = 4, RUNTIME = -1;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

template <int VEC>
__device__ __forceinline__ void cp_async(float* dst, const float* src) {
  if constexpr (VEC == 4)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                     smem_addr(dst)),
                 "l"(src)
                 : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                     smem_addr(dst)),
                 "l"(src)
                 : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// (x0, x1) rounded to bf16, nearest even, as one word: x0 in the low 16
// bits (cvt.rn.bf16x2.f32), and the two halves back as floats.
__device__ __forceinline__ uint32_t bf16x2(float x0, float x1) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  return *reinterpret_cast<const uint32_t*>(&h);
}
__device__ __forceinline__ float bf_lo(uint32_t w) {
  return __uint_as_float(w << 16);
}
__device__ __forceinline__ float bf_hi(uint32_t w) {
  return __uint_as_float(w & 0xffff0000u);
}

// VEC consecutive floats as one value: float4 or float. split(a, h, l,
// want_lo): h = q1(a), and l = lo(a) where want_lo, elementwise.
template <int VEC>
struct Vec;
template <>
struct Vec<4> {
  using T = float4;
  static __device__ __forceinline__ T load(const float* p) {
    return *reinterpret_cast<const float4*>(p);
  }
  static __device__ __forceinline__ void store(float* p, T v) {
    *reinterpret_cast<float4*>(p) = v;
  }
  static __device__ __forceinline__ T zero() {
    return make_float4(0.f, 0.f, 0.f, 0.f);
  }
  static __device__ __forceinline__ float dot(T a, T b, float acc) {
    return fmaf(a.w, b.w, fmaf(a.z, b.z, fmaf(a.y, b.y, fmaf(a.x, b.x, acc))));
  }
  static __device__ __forceinline__ T axpy(float a, T x, T acc) {
    return make_float4(fmaf(a, x.x, acc.x), fmaf(a, x.y, acc.y),
                       fmaf(a, x.z, acc.z), fmaf(a, x.w, acc.w));
  }
  static __device__ __forceinline__ T add(T a, T b) {
    return make_float4(a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w);
  }
  static __device__ __forceinline__ void split(T a, T& h, T& l,
                                               bool want_lo) {
    const uint32_t w0 = bf16x2(a.x, a.y), w1 = bf16x2(a.z, a.w);
    h = make_float4(bf_lo(w0), bf_hi(w0), bf_lo(w1), bf_hi(w1));
    if (want_lo) {
      const uint32_t v0 = bf16x2(a.x - h.x, a.y - h.y);
      const uint32_t v1 = bf16x2(a.z - h.z, a.w - h.w);
      l = make_float4(bf_lo(v0), bf_hi(v0), bf_lo(v1), bf_hi(v1));
    }
  }
};
template <>
struct Vec<1> {
  using T = float;
  static __device__ __forceinline__ T load(const float* p) { return *p; }
  static __device__ __forceinline__ void store(float* p, T v) { *p = v; }
  static __device__ __forceinline__ T zero() { return 0.f; }
  static __device__ __forceinline__ float dot(T a, T b, float acc) {
    return fmaf(a, b, acc);
  }
  static __device__ __forceinline__ T axpy(float a, T x, T acc) {
    return fmaf(a, x, acc);
  }
  static __device__ __forceinline__ T add(T a, T b) { return a + b; }
  static __device__ __forceinline__ void split(T a, T& h, T& l,
                                               bool want_lo) {
    h = bf_lo(bf16x2(a, 0.f));
    if (want_lo) l = bf_lo(bf16x2(a - h, 0.f));
  }
};

__host__ __device__ __forceinline__ int round4(int n) { return (n + 3) & ~3; }

// x rounded: mode 0 exact, 1 q1, 2 q2 (the module note).
__device__ __forceinline__ float q1(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}
__device__ __forceinline__ float rnd(float x, int mode) {
  if (mode == 0) return x;
  const float h = q1(x);
  return mode == 1 ? h : h + q1(x - h);
}
__device__ __forceinline__ float lo(float x) { return q1(x - q1(x)); }
// The rounding of a tier's lhs and rhs operand in its first term.
__host__ __device__ __forceinline__ int lhs_mode(int tier) {
  return tier == HIGHEST ? 0 : (tier == HIGH_LHS || tier == HIGH ? 2 : 1);
}
__host__ __device__ __forceinline__ int rhs_mode(int tier) {
  return tier == HIGHEST ? 0 : (tier == HIGH_RHS ? 2 : 1);
}
// The apply passes that take lo(w) (the lhs) and lo(g) (the rhs).
__host__ __device__ __forceinline__ bool apply_lo_w(int tier) {
  return tier == HIGH_LHS || tier == HIGH;
}
__host__ __device__ __forceinline__ bool apply_lo_g(int tier) {
  return tier == HIGH_RHS || tier == HIGH;
}

// Four 8 x 8 matrices of 16-bit values from shared memory, row addresses
// from lanes 8i .. 8i + 7 for matrix i (ldmatrix).
__device__ __forceinline__ void ldsm_x4(uint32_t* d, const uint32_t* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(d[0]), "=r"(d[1]), "=r"(d[2]), "=r"(d[3])
      : "r"(smem_addr(p))
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

// Floats of shared memory a block takes, and where each part starts. The
// attention weights are floats [fpt][key][query padded to jp] for the
// float32 apply; for the tensor-core apply (mma) a row r's hi words are
// words [0, AW) of row r at stride aws, its lo words (where the apply tier
// takes them) words [AW, 2 AW): in the tile's rows (in_tile, aws = rs)
// where 2I floats hold them, else apart at `at` (aws = 2 AW + 4, or AW
// without lo words: rows in distinct banks). pt2/pp2 (the score weights'
// lo halves) only at the score tier high.
struct Layout {
  int rs;     // row stride of a tile buffer: theta | phi | g, padded
  int jp;     // queries of a key-major attention row, padded to 4
  int tile;   // floats of one tile buffer
  bool in_tile;  // mma: the attention words in the tile's rows
  int aws;    // mma: row stride of the attention words
  int pt, pp, ck, sa, sb, at, pt2, pp2, total;
  __host__ __device__ Layout(int j, int inter, int g_ch, int fpt,
                             bool score_lo, bool mma, bool lo_w) {
    rs = round4(2 * inter + g_ch) + 4;
    jp = round4(j);
    tile = fpt * j * rs;
    pt = 2 * tile;
    pp = pt + round4(inter);
    ck = pp + round4(inter);
    sa = ck + round4(j * j);
    sb = sa + round4(fpt * j);
    at = sb + round4(fpt * j);
    in_tile = mma && WORDS_IN_TILE && 2 * inter >= (lo_w ? 2 : 1) * AW;
    aws = in_tile ? rs : (lo_w ? 2 * AW + 4 : AW);
    pt2 = at + (in_tile ? 0 : fpt * j * (mma ? aws : jp));
    pp2 = pt2 + (score_lo ? round4(inter) : 0);
    total = pp2 + (score_lo ? round4(inter) : 0);
  }
};

// A block of the grid (blocks a head, heads); THREADS threads. ST, AT: the
// score and apply tier codes, or RUNTIME for the launch's score_tier /
// apply_tier. AT == HIGHEST runs the float32 softmax and apply, any other
// AT the tensor-core apply.
template <int VEC, int ST, int AT>
__device__ __forceinline__ void attention(
    const float* __restrict__ theta, const float* __restrict__ phi,
    const float* __restrict__ g, long long ldp,
    const float* __restrict__ proj_t, const float* __restrict__ proj_p,
    const float* __restrict__ c_k, float* __restrict__ out,
    long long frames, int j, int inter, int g_ch, int heads, int fpt,
    int score_tier, int apply_tier) {
  using V = Vec<VEC>;
  constexpr bool MMA = AT != HIGHEST;
  extern __shared__ __align__(16) float smem[];
  const int s_tier = ST == RUNTIME ? score_tier : ST;
  const int a_tier = AT == RUNTIME ? apply_tier : AT;
  const bool score_lo = s_tier == HIGH;
  const bool lo_w = MMA && apply_lo_w(a_tier);
  const bool lo_g = MMA && apply_lo_g(a_tier);
  const Layout L(j, inter, g_ch, fpt, score_lo, MMA, lo_w);
  const int k = blockIdx.y;
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int e = tid % GROUP, er = tid % ROW;
  float* pt = smem + L.pt;
  float* pp = smem + L.pp;
  float* ck = smem + L.ck;
  float* sa = smem + L.sa;
  float* sb = smem + L.sb;
  float* at = smem + L.at;  // float32 apply: [fpt][key m][query, to jp]
  float* pt2 = smem + L.pt2;
  float* pp2 = smem + L.pp2;
  const int s_lhs = lhs_mode(s_tier), s_rhs = rhs_mode(s_tier);

  // The head's score weights, rounded as the rhs of the score tier.
  for (int i = tid; i < inter; i += THREADS) {
    const float vt = proj_t[k * inter + i], vp = proj_p[k * inter + i];
    pt[i] = rnd(vt, s_rhs);
    pp[i] = rnd(vp, s_rhs);
    if (score_lo) {
      pt2[i] = lo(vt);
      pp2[i] = lo(vp);
    }
  }
  for (int i = tid; i < j * j; i += THREADS) ck[i] = c_k[k * j * j + i];

  const long long tiles = (frames + fpt - 1) / fpt;
  const long long step = gridDim.x;
  const int ci = inter / VEC;              // chunks of theta (and of phi)
  const int chunks = (2 * inter + g_ch) / VEC;
  const float* th = theta + k * inter;
  const float* ph = phi + k * inter;
  const float* gk = g + k * g_ch;
  // A warp a row: theta, phi, then g of the head, VEC floats a lane.
  auto load = [&](long long t, int buf) {
    if (t < tiles) {
      const long long r0 = t * fpt * j;
      const int rows =
          (frames - t * fpt < fpt ? (int)(frames - t * fpt) : fpt) * j;
      float* dst = smem + buf * L.tile;
      for (int r = warp; r < rows; r += THREADS / 32) {
        const long long off = (r0 + r) * ldp;
        for (int x = lane; x < chunks; x += 32) {
          const float* src = x < ci       ? th + off + x * VEC
                             : x < 2 * ci ? ph + off + (x - ci) * VEC
                                          : gk + off + (x - 2 * ci) * VEC;
          cp_async<VEC>(dst + r * L.rs + x * VEC, src);
        }
      }
    }
    cp_async_commit();
  };

  const int kg = heads * g_ch;
  const int gv = g_ch / VEC;             // output vectors of the head a row
  const int nqb = (j + QB - 1) / QB;
  const int ksteps = j > 16 ? 2 : 1;     // mma: k16 steps, and m16 tiles
  const int ngroups = ((g_ch + 7) / 8 + NT - 1) / NT;
  long long t = blockIdx.x;
  int buf = 0;
  load(t, 0);
  for (; t < tiles; t += step, buf ^= 1) {
    load(t + step, buf ^ 1);
    cp_async_wait<1>();
    __syncthreads();
    const float* h = smem + buf * L.tile;
    // mma: the attention words (row r at aw + r * L.aws; lo at + AW).
    uint32_t* aw = reinterpret_cast<uint32_t*>(
        L.in_tile ? smem + buf * L.tile : smem + L.at);
    const int nf = frames - t * fpt < fpt ? (int)(frames - t * fpt) : fpt;
    const int rows = nf * j;

    // Scores: row r's theta and phi dots, 8 lanes each; a warp takes 4
    // rows a round and stops when it has none.
    for (int base = warp * (32 / GROUP); base < rows;
         base += THREADS / GROUP) {
      const int r = base + lane / GROUP;
      float s1 = 0.f, s2 = 0.f;
      if (r < rows) {
        const float* row = h + r * L.rs;
        if (s_lhs == 0) {  // highest: the float32 dots
          for (int i = e; i < ci; i += GROUP) {
            s1 = V::dot(V::load(row + i * VEC), V::load(pt + i * VEC), s1);
            s2 = V::dot(V::load(row + inter + i * VEC),
                        V::load(pp + i * VEC), s2);
          }
        } else if (/*SCORE*/true) {
          // theta/phi rounded as loaded: q1 (h), or q2 (h + l) at high_lhs
          // and high, whose second term adds q1(a) lo(b).
          const bool q2 = s_lhs == 2;
          for (int i = e; i < ci; i += GROUP) {
            typename V::T a = V::load(row + i * VEC);
            typename V::T b = V::load(row + inter + i * VEC);
            typename V::T ah, al = V::zero(), bh, bl = V::zero();
            V::split(a, ah, al, q2);
            V::split(b, bh, bl, q2);
            s1 = V::dot(q2 ? V::add(ah, al) : ah, V::load(pt + i * VEC), s1);
            s2 = V::dot(q2 ? V::add(bh, bl) : bh, V::load(pp + i * VEC), s2);
            if (score_lo) {
              s1 = V::dot(ah, V::load(pt2 + i * VEC), s1);
              s2 = V::dot(bh, V::load(pp2 + i * VEC), s2);
            }
          }
        }
      }
#pragma unroll
      for (int o = GROUP / 2; o > 0; o >>= 1) {
        s1 += __shfl_xor_sync(FULL, s1, o);
        s2 += __shfl_xor_sync(FULL, s2, o);
      }
      if (r < rows && e == 0) {
        sa[r] = s1;
        sb[r] = s2;
      }
    }
    __syncthreads();

    const long long r0 = t * fpt * j;
    if constexpr (!MMA) {
      // Softmax: row r = f * j + q, 4 lanes each, lane er holding keys er,
      // er + 4, ...; a warp takes 8 rows a round and stops when it has
      // none, and key slots past J are skipped by the whole warp.
      for (int base = warp * (32 / ROW); base < rows;
           base += THREADS / ROW) {
        const int r = base + lane / ROW;
        const bool ok = r < rows;
        const int f = ok ? r / j : 0;
        const int q = r - f * j;
        const float a = ok ? sa[r] : 0.f;
        float v[MAX_J / ROW];
        float mx = -INFINITY;
#pragma unroll
        for (int u = 0; u < MAX_J / ROW; ++u) {
          const int m = er + u * ROW;
          float x = -INFINITY;
          if (u * ROW < j && ok && m < j) {
            x = a + sb[f * j + m];
            x = x > 0.f ? x : 0.2f * x;
          }
          v[u] = x;
          mx = fmaxf(mx, x);
        }
        mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, 2));
        mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, 1));
        float sum = 0.f;
#pragma unroll
        for (int u = 0; u < MAX_J / ROW; ++u) {
          const int m = er + u * ROW;
          v[u] = u * ROW < j && ok && m < j ? expf(v[u] - mx) : 0.f;
          sum += v[u];
        }
        sum += __shfl_xor_sync(FULL, sum, 2);
        sum += __shfl_xor_sync(FULL, sum, 1);
        const float inv = 1.f / sum;
#pragma unroll
        for (int u = 0; u < MAX_J / ROW; ++u) {
          const int m = er + u * ROW;
          if (u * ROW < j && ok && m < j)
            at[(f * j + m) * L.jp + q] = v[u] * inv + ck[q * j + m];
        }
      }
      __syncthreads();

      // Apply: item = (f, query block qb, output vector c).
      for (int it = tid; it < nf * nqb * gv; it += THREADS) {
        const int c = it % gv;
        const int fq = it / gv;
        const int f = fq / nqb;
        const int q0 = (fq - f * nqb) * QB;
        const float* gs = h + f * j * L.rs + 2 * inter + c * VEC;
        const float* as = at + f * j * L.jp + q0;
        typename V::T acc[QB];
#pragma unroll
        for (int u = 0; u < QB; ++u) acc[u] = V::zero();
        for (int m = 0; m < j; ++m) {
          const typename V::T gm = V::load(gs + m * L.rs);
          const float4 w = *reinterpret_cast<const float4*>(as + m * L.jp);
          acc[0] = V::axpy(w.x, gm, acc[0]);
          acc[1] = V::axpy(w.y, gm, acc[1]);
          acc[2] = V::axpy(w.z, gm, acc[2]);
          acc[3] = V::axpy(w.w, gm, acc[3]);
        }
        float* o = out + (r0 + f * j + q0) * kg + k * g_ch + c * VEC;
#pragma unroll
        for (int u = 0; u < QB; ++u)
          if (q0 + u < j) V::store(o + (long long)u * kg, acc[u]);
      }
    } else {
      // Softmax: row r = f * j + q, SROW lanes each, lane l = lane % SROW
      // holding the key pairs (2 (p SROW + l), + 1), p < 16 / SROW: the
      // row's words p SROW + l; a warp takes 32 / SROW rows a round. The
      // weights w = softmax + C_k are stored as bf16 pair words, hi (and
      // lo), keys past J as zeros.
      constexpr int PAIRS = MAX_J / 2 / SROW;
      const int l = lane % SROW;
      for (int base = warp * (32 / SROW); /*SOFTMAX*/true && base < rows;
           base += THREADS / SROW) {
        const int r = base + lane / SROW;
        const bool ok = r < rows;
        const int f = ok ? r / j : 0;
        const int q = r - f * j;
        const float a = ok ? sa[r] : 0.f;
        float v[2 * PAIRS];
        float mx = -INFINITY;
#pragma unroll
        for (int i = 0; i < 2 * PAIRS; ++i) {
          const int m = 2 * ((i / 2) * SROW + l) + i % 2;
          float x = -INFINITY;
          if ((i / 2) * 2 * SROW < j && ok && m < j) {
            x = a + sb[f * j + m];
            x = x > 0.f ? x : 0.2f * x;
          }
          v[i] = x;
          mx = fmaxf(mx, x);
        }
#pragma unroll
        for (int o = SROW / 2; o > 0; o >>= 1)
          mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, o));
        float sum = 0.f;
#pragma unroll
        for (int i = 0; i < 2 * PAIRS; ++i) {
          const int m = 2 * ((i / 2) * SROW + l) + i % 2;
          v[i] = (i / 2) * 2 * SROW < j && ok && m < j
                     ? /*EXP*/__expf(v[i] - mx) : 0.f;
          sum += v[i];
        }
#pragma unroll
        for (int o = SROW / 2; o > 0; o >>= 1)
          sum += __shfl_xor_sync(FULL, sum, o);
        const float inv = 1.f / sum;
        if (ok) {
#pragma unroll
          for (int p = 0; p < PAIRS; ++p) {
            const int m = 2 * (p * SROW + l);
            const float w0 = m < j ? v[2 * p] * inv + ck[q * j + m] : 0.f;
            const float w1 =
                m + 1 < j ? v[2 * p + 1] * inv + ck[q * j + m + 1] : 0.f;
            const uint32_t hw = bf16x2(w0, w1);
            aw[r * L.aws + p * SROW + l] = hw;
            if (lo_w)
              aw[r * L.aws + AW + p * SROW + l] =
                  bf16x2(w0 - bf_lo(hw), w1 - bf_hi(hw));
          }
        }
      }
      __syncthreads();

      // Apply: a warp a (frame f, NT n-tiles of 8 channels from n0); for
      // each k16 step of keys the A words of its m16 tiles (ldmatrix), and
      // per n-tile the B words: g's float32 values at (key 2t + {0, 1, 8,
      // 9}, channel lane / 4) rounded in registers, lo(g) apart where the
      // tier takes it; then the tier's passes.
      for (int u = warp; u < nf * ngroups; u += THREADS / 32) {
        const int f = u / ngroups;
        const int n0 = (u - f * ngroups) * NT * 8;
        const float* gf = h + f * j * L.rs + 2 * inter;
        float acc[2][NT][4] = {};
        for (int ks = 0; /*APPLY*/true && ks < ksteps; ++ks) {
          uint32_t ah[2][4], al[2][4];
#pragma unroll
          for (int mt = 0; mt < 2; ++mt)
            if (mt < ksteps) {
              // Query rows past J read row J - 1 (their sums are not
              // stored).
              const int q = min(mt * 16 + (lane & 15), j - 1);
              const uint32_t* o =
                  aw + (f * j + q) * L.aws + ks * 8 + (lane >> 4) * 4;
              ldsm_x4(ah[mt], o);
              if (lo_w) ldsm_x4(al[mt], o + AW);
            }
#pragma unroll
          for (int nt = 0; nt < NT; ++nt) {
            const int col = n0 + nt * 8 + (lane >> 2);
            const int m0 = ks * 16 + 2 * (lane & 3);
            float x[4];
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              const int m = m0 + (i & 1) + (i >> 1) * 8;
              x[i] = col < g_ch && m < j ? gf[m * L.rs + col] : 0.f;
            }
            uint32_t bh[2], bl[2];
            bh[0] = bf16x2(x[0], x[1]);
            bh[1] = bf16x2(x[2], x[3]);
            if (lo_g) {
              bl[0] = bf16x2(x[0] - bf_lo(bh[0]), x[1] - bf_hi(bh[0]));
              bl[1] = bf16x2(x[2] - bf_lo(bh[1]), x[3] - bf_hi(bh[1]));
            }
#pragma unroll
            for (int mt = 0; mt < 2; ++mt)
              if (mt < ksteps) {
                mma_bf16(acc[mt][nt], ah[mt], bh);
                if (lo_w) mma_bf16(acc[mt][nt], al[mt], bh);
                if (lo_g) mma_bf16(acc[mt][nt], ah[mt], bl);
              }
          }
        }
        // acc[mt][nt]: (query mt * 16 + lane / 4 (+ 8), channel n0 + nt *
        // 8 + 2 (lane % 4) (+ 1)).
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
#pragma unroll
          for (int nt = 0; nt < NT; ++nt)
#pragma unroll
            for (int half = 0; half < 2; ++half) {
              const int q = mt * 16 + (lane >> 2) + half * 8;
              const int col = n0 + nt * 8 + 2 * (lane & 3);
              if (mt >= ksteps || q >= j || col >= g_ch) continue;
              float* o = out + (r0 + f * j + q) * kg + k * g_ch + col;
              const float* c = acc[mt][nt] + 2 * half;
              if constexpr (VEC == 4) {
                *reinterpret_cast<float2*>(o) = make_float2(c[0], c[1]);
              } else {
                o[0] = c[0];
                if (col + 1 < g_ch) o[1] = c[1];
              }
            }
      }
    }
    __syncthreads();  // before the buffer is loaded again
  }
  cp_async_wait<0>();
}

// The float32 apply's kernels (registers as the compiler picks them), and
// the tensor-core apply's (bounded for TC_BLOCKS blocks an SM); both names
// hold "joint_attention_kernel", which profiles group kernels by.
#define JA_PARAMS                                                          \
  const float *__restrict__ theta, const float *__restrict__ phi,          \
      const float *__restrict__ g, long long ldp,                          \
      const float *__restrict__ proj_t, const float *__restrict__ proj_p,  \
      const float *__restrict__ c_k, float *__restrict__ out,              \
      long long frames, int j, int inter, int g_ch, int heads, int fpt,    \
      int score_tier, int apply_tier
#define JA_ARGS                                                            \
  theta, phi, g, ldp, proj_t, proj_p, c_k, out, frames, j, inter, g_ch,   \
      heads, fpt, score_tier, apply_tier
template <int VEC, int ST>
__global__ void __launch_bounds__(THREADS)
    joint_attention_kernel(JA_PARAMS) {
  attention<VEC, ST, HIGHEST>(JA_ARGS);
}
template <int VEC, int ST, int AT>
__global__ void __launch_bounds__(THREADS, TC_BLOCKS)
    joint_attention_kernel_tc(JA_PARAMS) {
  attention<VEC, ST, AT>(JA_ARGS);
}
#undef JA_PARAMS
#undef JA_ARGS

template <int VEC, int ST, int AT>
constexpr auto kernel_of() {
  if constexpr (AT == HIGHEST)
    return joint_attention_kernel<VEC, ST>;
  else
    return joint_attention_kernel_tc<VEC, ST, AT>;
}

int device_attr(cudaDeviceAttr attr, int* value) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(value, attr, dev);
  return static_cast<int>(e);
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

// About one wave of persistent blocks, spread evenly over the heads.
template <int VEC, int ST, int AT>
int launch(const float* theta, const float* phi, const float* g,
           long long ldp, const float* proj_t, const float* proj_p,
           const float* c_k, float* out, long long frames, int j, int inter,
           int g_ch, int heads, int score_tier, int apply_tier,
           cudaStream_t stream) {
  static int sms = 0, max_smem = 0;
  if (sms == 0) {
    int e = device_attr(cudaDevAttrMultiProcessorCount, &sms);
    if (e == 0)
      e = device_attr(cudaDevAttrMaxSharedMemoryPerBlockOptin, &max_smem);
    if (e != 0) {
      sms = 0;
      return e;
    }
  }
  const int frame_bytes = (int)sizeof(float) * j * (round4(2 * inter + g_ch) + 4);
  int fpt = TILE_BYTES / frame_bytes;
  fpt = fpt < 1 ? 1 : (fpt > MAX_FRAMES ? MAX_FRAMES : fpt);
  const size_t smem =
      sizeof(float) * Layout(j, inter, g_ch, fpt, score_tier == HIGH,
                             AT != HIGHEST, apply_lo_w(apply_tier))
                          .total;
  if (smem > (size_t)max_smem) return static_cast<int>(cudaErrorInvalidValue);
  const auto kernel = kernel_of<VEC, ST, AT>();
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  int per_sm = 0;
  cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, kernel, THREADS, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (per_sm < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  const long long tiles = (frames + fpt - 1) / fpt;
  long long per_head = (long long)per_sm * sms / heads;
  if (per_head < 1) per_head = 1;
  if (per_head > tiles) per_head = tiles;
  if (tiles > 0) {
    kernel<<<dim3((unsigned)per_head, heads), THREADS, smem, stream>>>(
        theta, phi, g, ldp, proj_t, proj_p, c_k, out, frames, j, inter, g_ch,
        heads, fpt, score_tier, apply_tier);
  }
  return static_cast<int>(cudaGetLastError());
}

using Launch = int (*)(const float*, const float*, const float*, long long,
                       const float*, const float*, const float*, float*,
                       long long, int, int, int, int, int, int,
                       cudaStream_t);

// The instantiation of a tier pair (kernels.attn_instantiation): float32;
// the shipped pairs default/default and high/high; a tiered score with the
// float32 apply; every other pair on runtime codes.
template <int VEC>
Launch pick(int score_tier, int apply_tier) {
  if (apply_tier == HIGHEST)
    return score_tier == HIGHEST ? launch<VEC, HIGHEST, HIGHEST>
                                 : launch<VEC, RUNTIME, HIGHEST>;
  if (score_tier == DEFAULT && apply_tier == DEFAULT)
    return launch<VEC, DEFAULT, DEFAULT>;
  if (score_tier == HIGH && apply_tier == HIGH) return launch<VEC, HIGH, HIGH>;
  return launch<VEC, RUNTIME, RUNTIME>;
}

}  // namespace

extern "C" {

// Launches the 16-byte instantiation if vec16, else the 4-byte one, with
// the score and apply dots at their tier codes (0 highest .. 4 high), on
// `stream`; returns cudaGetLastError() after the launch, or
// cudaErrorInvalidValue with no launch for a shape the kernel does not take
// (J > 32, or a one-frame tile that does not fit in shared memory), an
// unknown tier code or, with vec16, for I, G or ldp not a multiple of 4 or
// a view or out not 16-byte aligned.
int joint_attention(const void* theta, const void* phi, const void* g,
                    int ldp, const void* proj_t, const void* proj_p,
                    const void* c_k, void* out, long long frames, int j,
                    int inter, int g_ch, int heads, void* stream,
                    int score_tier, int apply_tier, int vec16) {
  if (frames < 0 || j < 1 || j > MAX_J || inter < 1 || g_ch < 1 ||
      heads < 1 || score_tier < 0 || score_tier > HIGH || apply_tier < 0 ||
      apply_tier > HIGH ||
      (vec16 && (inter % 4 != 0 || g_ch % 4 != 0 || ldp % 4 != 0 ||
                 !aligned16(theta) || !aligned16(phi) || !aligned16(g) ||
                 !aligned16(out))))
    return static_cast<int>(cudaErrorInvalidValue);
  const Launch run = vec16 ? pick<4>(score_tier, apply_tier)
                           : pick<1>(score_tier, apply_tier);
  return run(static_cast<const float*>(theta), static_cast<const float*>(phi),
             static_cast<const float*>(g), ldp,
             static_cast<const float*>(proj_t),
             static_cast<const float*>(proj_p),
             static_cast<const float*>(c_k), static_cast<float*>(out), frames,
             j, inter, g_ch, heads, score_tier, apply_tier,
             static_cast<cudaStream_t>(stream));
}

const char* error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
