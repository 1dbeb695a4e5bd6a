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
// Two instantiations: VEC = 4 (16-byte copies, loads and stores) where I, G
// and ldp are multiples of 4 and theta, phi, g and out start 16-byte
// aligned, and VEC = 1 (4-byte) otherwise, e.g. the 8-channel model's heads
// (I = 2) or a view at an odd offset (kernels.graph_variant picks; the C
// entry point refuses VEC = 4 for operands that do not meet its rule).
// J <= 32; two tiles of one frame must fit in shared memory (2 J (2I + G +
// 8) floats and the head's constants: 2I + G up to ~1600 at J = 17, ~850
// at J = 32).
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

// Floats of shared memory a block takes, and where each part starts.
struct Layout {
  int rs;     // row stride of a tile buffer: theta | phi | g, padded
  int jp;     // queries of a key-major attention row, padded to 4
  int tile;   // floats of one tile buffer
  int pt, pp, ck, sa, sb, at, total;
  __host__ __device__ Layout(int j, int inter, int g_ch, int fpt) {
    rs = round4(2 * inter + g_ch) + 4;
    jp = round4(j);
    tile = fpt * j * rs;
    pt = 2 * tile;
    pp = pt + round4(inter);
    ck = pp + round4(inter);
    sa = ck + round4(j * j);
    sb = sa + round4(fpt * j);
    at = sb + round4(fpt * j);
    total = at + fpt * j * jp;
  }
};

// Grid (blocks a head, heads); THREADS threads.
template <int VEC>
__global__ void __launch_bounds__(THREADS)
    joint_attention_kernel(const float* __restrict__ theta,
                           const float* __restrict__ phi,
                           const float* __restrict__ g, long long ldp,
                           const float* __restrict__ proj_t,
                           const float* __restrict__ proj_p,
                           const float* __restrict__ c_k,
                           float* __restrict__ out, long long frames, int j,
                           int inter, int g_ch, int heads, int fpt) {
  using V = Vec<VEC>;
  extern __shared__ __align__(16) float smem[];
  const Layout L(j, inter, g_ch, fpt);
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

  for (int i = tid; i < inter; i += THREADS) {
    pt[i] = proj_t[k * inter + i];
    pp[i] = proj_p[k * inter + i];
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
        for (int i = e; i < ci; i += GROUP) {
          s1 = V::dot(V::load(row + i * VEC), V::load(pt + i * VEC), s1);
          s2 = V::dot(V::load(row + inter + i * VEC), V::load(pp + i * VEC),
                      s2);
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
        if (u * ROW < j && ok && m < j)
          at[(f * j + m) * L.jp + q] = v[u] * inv + ck[q * j + m];
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
template <int VEC>
int launch(const float* theta, const float* phi, const float* g,
           long long ldp, const float* proj_t, const float* proj_p,
           const float* c_k, float* out, long long frames, int j, int inter,
           int g_ch, int heads, cudaStream_t stream) {
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
  const size_t smem = sizeof(float) * Layout(j, inter, g_ch, fpt).total;
  if (smem > (size_t)max_smem) return static_cast<int>(cudaErrorInvalidValue);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        joint_attention_kernel<VEC>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  int per_sm = 0;
  cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, joint_attention_kernel<VEC>, THREADS, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (per_sm < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  const long long tiles = (frames + fpt - 1) / fpt;
  long long per_head = (long long)per_sm * sms / heads;
  if (per_head < 1) per_head = 1;
  if (per_head > tiles) per_head = tiles;
  if (tiles > 0) {
    joint_attention_kernel<VEC>
        <<<dim3((unsigned)per_head, heads), THREADS, smem, stream>>>(
            theta, phi, g, ldp, proj_t, proj_p, c_k, out, frames, j, inter,
            g_ch, heads, fpt);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Launches the 16-byte instantiation if vec16, else the 4-byte one, on
// `stream`; returns cudaGetLastError() after the launch, or
// cudaErrorInvalidValue with no launch for a shape the kernel does not take
// (J > 32, or a one-frame tile that does not fit in shared memory) or, with
// vec16, for I, G or ldp not a multiple of 4 or a view or out not 16-byte
// aligned.
int joint_attention(const void* theta, const void* phi, const void* g,
                    int ldp, const void* proj_t, const void* proj_p,
                    const void* c_k, void* out, long long frames, int j,
                    int inter, int g_ch, int heads, void* stream, int vec16) {
  if (frames < 0 || j < 1 || j > MAX_J || inter < 1 || g_ch < 1 ||
      heads < 1 ||
      (vec16 && (inter % 4 != 0 || g_ch % 4 != 0 || ldp % 4 != 0 ||
                 !aligned16(theta) || !aligned16(phi) || !aligned16(g) ||
                 !aligned16(out))))
    return static_cast<int>(cudaErrorInvalidValue);
  const auto run = vec16 ? launch<4> : launch<1>;
  return run(static_cast<const float*>(theta), static_cast<const float*>(phi),
             static_cast<const float*>(g), ldp,
             static_cast<const float*>(proj_t),
             static_cast<const float*>(proj_p),
             static_cast<const float*>(c_k), static_cast<float*>(out), frames,
             j, inter, g_ch, heads, static_cast<cudaStream_t>(stream));
}

const char* error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
