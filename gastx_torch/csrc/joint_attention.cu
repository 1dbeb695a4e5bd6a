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
// 4 high). With q1(x) = bf16(x) and q2(x) = q1(x) + q1(x - q1(x)) (x to
// 16 bits), a tier is its operands rounded as they are loaded, the
// accumulation staying float32 FMA: default q1(a) q1(b), high_lhs q2(a)
// q1(b), high_rhs q1(a) q2(b), and high q2(a) q1(b) + q1(a) lo(b) with
// lo(b) = q1(b - q1(b)); each equals the sum of kdot's bf16 passes, whose
// products are exact in float32. The weights p_theta/p_phi are rounded
// once as they are staged, theta/phi in registers at the score, g in place
// in shared memory after the scores, and the attention weights as the
// softmax stores them; the high apply tier keeps a second copy of each (its
// second term), the one instantiation that changes the apply loop
// (APPLY_HIGH). The kernel is byte-bound, so the rounding is cheap; at
// codes (0, 0) it computes exactly what it did without tiers.
//
// Two instantiations: VEC = 4 (16-byte copies, loads and stores) where I, G
// and ldp are multiples of 4 and theta, phi, g and out start 16-byte
// aligned, and VEC = 1 (4-byte) otherwise, e.g. the 8-channel model's heads
// (I = 2) or a view at an odd offset (kernels.graph_variant picks; the C
// entry point refuses VEC = 4 for operands that do not meet its rule).
// J <= 32; two tiles of one frame must fit in shared memory (2 J (2I + G +
// 8) floats and the head's constants: 2I + G up to ~1600 at J = 17, ~850
// at J = 32).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int MAX_J = 32;
constexpr int THREADS = 256;
constexpr int GROUP = 8;        // lanes of a score row
constexpr int ROW = 4;          // lanes of a softmax row
constexpr int QB = 4;           // queries of an apply thread
// A tile is the most whole frames whose rows fit in TILE_BYTES (at least
// one): at J = 17, 3 frames at C=128, 2 at 256, 1 at 512.
constexpr int TILE_BYTES = 27136;
constexpr int MAX_FRAMES = 8;   // frames a tile, at most
constexpr unsigned FULL = 0xffffffffu;

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

// VEC consecutive floats as one value: float4 or float.
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
};

__host__ __device__ __forceinline__ int round4(int n) { return (n + 3) & ~3; }

constexpr int HIGH = 4;  // the tier code of "high"

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
__device__ __forceinline__ int lhs_mode(int tier) {
  return tier == 0 ? 0 : (tier == 2 || tier == 4 ? 2 : 1);
}
__device__ __forceinline__ int rhs_mode(int tier) {
  return tier == 0 ? 0 : (tier == 3 ? 2 : 1);
}

// Floats of shared memory a block takes, and where each part starts; the
// high tiers' second copies (pt2/pp2 for the score, at2/gl for the apply)
// take room only where their tier is high.
struct Layout {
  int rs;     // row stride of a tile buffer: theta | phi | g, padded
  int jp;     // queries of a key-major attention row, padded to 4
  int gp;     // row stride of g's lo half
  int tile;   // floats of one tile buffer
  int pt, pp, ck, sa, sb, at, pt2, pp2, at2, gl, total;
  __host__ __device__ Layout(int j, int inter, int g_ch, int fpt,
                             bool score_high, bool apply_high) {
    rs = round4(2 * inter + g_ch) + 4;
    jp = round4(j);
    gp = round4(g_ch);
    tile = fpt * j * rs;
    pt = 2 * tile;
    pp = pt + round4(inter);
    ck = pp + round4(inter);
    sa = ck + round4(j * j);
    sb = sa + round4(fpt * j);
    at = sb + round4(fpt * j);
    pt2 = at + fpt * j * jp;
    pp2 = pt2 + (score_high ? round4(inter) : 0);
    at2 = pp2 + (score_high ? round4(inter) : 0);
    gl = at2 + (apply_high ? fpt * j * jp : 0);
    total = gl + (apply_high ? fpt * j * gp : 0);
  }
};

// Grid (blocks a head, heads); THREADS threads. APPLY_HIGH: apply_tier is
// "high" (4); score_tier and the other apply tiers are runtime codes.
template <int VEC, bool APPLY_HIGH>
__global__ void __launch_bounds__(THREADS)
    joint_attention_kernel(const float* __restrict__ theta,
                           const float* __restrict__ phi,
                           const float* __restrict__ g, long long ldp,
                           const float* __restrict__ proj_t,
                           const float* __restrict__ proj_p,
                           const float* __restrict__ c_k,
                           float* __restrict__ out, long long frames, int j,
                           int inter, int g_ch, int heads, int fpt,
                           int score_tier, int apply_tier) {
  using V = Vec<VEC>;
  extern __shared__ __align__(16) float smem[];
  const bool score_high = score_tier == HIGH;
  const Layout L(j, inter, g_ch, fpt, score_high, APPLY_HIGH);
  const int k = blockIdx.y;
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int e = tid % GROUP, er = tid % ROW;
  float* pt = smem + L.pt;
  float* pp = smem + L.pp;
  float* ck = smem + L.ck;
  float* sa = smem + L.sa;
  float* sb = smem + L.sb;
  float* at = smem + L.at;  // [fpt][key m][query, padded to jp]
  float* pt2 = smem + L.pt2;
  float* pp2 = smem + L.pp2;
  float* at2 = smem + L.at2;  // APPLY_HIGH: q1 of the attention weights
  float* gl = smem + L.gl;    // APPLY_HIGH: lo(g), [fpt * J][gp]
  const int s_lhs = lhs_mode(score_tier), s_rhs = rhs_mode(score_tier);
  const int a_lhs = lhs_mode(apply_tier), a_rhs = rhs_mode(apply_tier);

  // The head's score weights, rounded as the rhs of the score tier.
  for (int i = tid; i < inter; i += THREADS) {
    const float vt = proj_t[k * inter + i], vp = proj_p[k * inter + i];
    pt[i] = rnd(vt, s_rhs);
    pp[i] = rnd(vp, s_rhs);
    if (score_high) {
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
  long long t = blockIdx.x;
  int buf = 0;
  load(t, 0);
  for (; t < tiles; t += step, buf ^= 1) {
    load(t + step, buf ^ 1);
    cp_async_wait<1>();
    __syncthreads();
    const float* h = smem + buf * L.tile;
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
        } else {  // one float a step, theta/phi rounded as loaded
          for (int i = e * VEC; i < inter; i += GROUP * VEC)
#pragma unroll
            for (int u = 0; u < VEC; ++u) {
              const float a = row[i + u], b = row[inter + i + u];
              s1 = fmaf(rnd(a, s_lhs), pt[i + u], s1);
              s2 = fmaf(rnd(b, s_lhs), pp[i + u], s2);
              if (score_high) {
                s1 = fmaf(q1(a), pt2[i + u], s1);
                s2 = fmaf(q1(b), pp2[i + u], s2);
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

    // The tile's g rounded in place as the apply's rhs (and its lo half
    // apart for the high tier); the softmax does not read g.
    if (APPLY_HIGH || a_rhs != 0) {
      float* gs = smem + buf * L.tile + 2 * inter;
      for (int it = tid; it < rows * g_ch; it += THREADS) {
        const int r = it / g_ch, c = it - r * g_ch;
        const float v = gs[r * L.rs + c];
        gs[r * L.rs + c] = rnd(v, a_rhs);
        if (APPLY_HIGH) gl[r * L.gp + c] = lo(v);
      }
    }

    // Softmax: row r = f * j + q, 4 lanes each, lane er holding keys er,
    // er + 4, ...; a warp takes 8 rows a round and stops when it has none,
    // and key slots past J are skipped by the whole warp.
    for (int base = warp * (32 / ROW); base < rows; base += THREADS / ROW) {
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
        if (u * ROW < j && ok && m < j) {
          const float w = v[u] * inv + ck[q * j + m];
          at[(f * j + m) * L.jp + q] = rnd(w, a_lhs);
          if (APPLY_HIGH) at2[(f * j + m) * L.jp + q] = q1(w);
        }
      }
    }
    __syncthreads();

    // Apply: item = (f, query block qb, output vector c).
    const long long r0 = t * fpt * j;
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
        if constexpr (APPLY_HIGH) {  // + q1(attn) lo(g)
          const typename V::T g2 =
              V::load(gl + (f * j + m) * L.gp + c * VEC);
          const float4 w2 = *reinterpret_cast<const float4*>(
              at2 + f * j * L.jp + q0 + m * L.jp);
          acc[0] = V::axpy(w2.x, g2, acc[0]);
          acc[1] = V::axpy(w2.y, g2, acc[1]);
          acc[2] = V::axpy(w2.z, g2, acc[2]);
          acc[3] = V::axpy(w2.w, g2, acc[3]);
        }
      }
      float* o = out + (r0 + f * j + q0) * kg + k * g_ch + c * VEC;
#pragma unroll
      for (int u = 0; u < QB; ++u)
        if (q0 + u < j) V::store(o + (long long)u * kg, acc[u]);
    }
    __syncthreads();  // before the buffer is loaded again
  }
  cp_async_wait<0>();
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
template <int VEC, bool APPLY_HIGH>
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
      sizeof(float) *
      Layout(j, inter, g_ch, fpt, score_tier == HIGH, APPLY_HIGH).total;
  if (smem > (size_t)max_smem) return static_cast<int>(cudaErrorInvalidValue);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        joint_attention_kernel<VEC, APPLY_HIGH>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  int per_sm = 0;
  cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, joint_attention_kernel<VEC, APPLY_HIGH>, THREADS, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (per_sm < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  const long long tiles = (frames + fpt - 1) / fpt;
  long long per_head = (long long)per_sm * sms / heads;
  if (per_head < 1) per_head = 1;
  if (per_head > tiles) per_head = tiles;
  if (tiles > 0) {
    joint_attention_kernel<VEC, APPLY_HIGH>
        <<<dim3((unsigned)per_head, heads), THREADS, smem, stream>>>(
            theta, phi, g, ldp, proj_t, proj_p, c_k, out, frames, j, inter,
            g_ch, heads, fpt, score_tier, apply_tier);
  }
  return static_cast<int>(cudaGetLastError());
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
  const bool high = apply_tier == HIGH;
  const auto run = vec16 ? (high ? launch<4, true> : launch<4, false>)
                         : (high ? launch<1, true> : launch<1, false>);
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
