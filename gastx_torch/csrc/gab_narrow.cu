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
// joint_attention launches in gastx_torch/ops/cuda/fused_gab.py.
//
// Bound on this card: the block reads x (C floats a row) and writes 2C, and
// does about 2 * 16 * C^2 FLOPs a row in its five products (35 kFLOP at
// C=32, about 140 kFLOP at C=64), some 90 to 180 FLOPs per byte of device
// memory, far above the float32 ridge of ~20: the SMs' float32 FMA rate
// bounds it. The chain of six launches moves ~9x those bytes through device
// memory (P alone is 7C wide) and runs its products on 128-wide tiles that
// C = 32..64 leaves mostly idle.
//
// Design: one block per tile of whole frames, so attention never crosses a
// block; x and P stay in shared memory, and every later intermediate is
// written over a part of P that is no longer read (heads over g, ab over
// theta/phi, local and global over the sem columns), so only x is read and
// only the output is written to device memory, and two blocks fit an SM.
// Each product is a block-level loop: warp w owns RT rows, each lane CT
// columns strided by 32; BK-deep slabs of the weight are staged into shared
// memory by cp.async, double-buffered and shared by all warps, and the A
// rows are float2 broadcasts from shared memory. Attention runs one warp
// per (frame, head), one lane per query joint (J <= 32); the key scores come
// from the other lanes by shuffle, so no J x J score matrix is stored. C_k,
// the score vectors and the neighbour table are copied into shared memory
// once per block; the semantic-graph weights are read once per (joint,
// channel) for all the frames of the tile. Float32 FMAs only: no tensor
// cores.
#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int MAX_WARPS = 8;
constexpr int BK = 16;       // weight rows per staged slab
constexpr int STAGES = 2;    // slabs in flight
constexpr int MAX_J = 32;    // joints a frame may have (one lane each)
constexpr int MAX_D = 8;     // neighbour slots of a joint in sem_graph
constexpr int PAD = 2;       // extra floats per row of P: spreads the rows
                             // attention's lanes read over the banks
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

// out[r, col] = epi([A_0 | A_1 | A_2][r, :] @ w[:, col]): up to three A
// pieces of kp columns each in shared memory (even row strides), w (k, n)
// row-major in device memory; epi = * scale + shift, then ReLU if RELU.
// Stored for r < rows_store.
struct Gemm {
  const float* a[3];
  int lda[3];
  int kp, k;
  const float* w;
  int n;
  const float* scale;
  const float* shift;
  float* out;
  int ldo, rows_store;
};

// The weight streams through a ring of STAGES slabs (BK rows of one column
// strip) that cp.async fills STAGES - 1 slabs ahead, across strips, so one
// barrier a slab suffices. Warps whose rows all lie past `rows_active` only
// help stage the weights. Ends with a barrier: `ws` is free again.
template <int RT, int CT, bool RELU>
__device__ void block_gemm(const Gemm& g, float* ws, int rows_active) {
  constexpr int NC = 32 * CT;
  constexpr int SLAB = BK * NC;
  const int tid = threadIdx.x, lane = tid % 32;
  const int r0 = (tid / 32) * RT;
  const bool active = r0 < rows_active;
  const int slabs = g.k / BK;
  const int total = slabs * ((g.n + NC - 1) / NC);
  auto stage = [&](int i) {  // slab i % slabs of strip i / slabs
    if (i < total) {
      const int s0 = (i / slabs) * NC, k0 = (i % slabs) * BK;
      float* buf = ws + (i % STAGES) * SLAB;
      for (int e = tid; e < SLAB / 4; e += blockDim.x) {
        const int kl = e / (NC / 4), cl = (e % (NC / 4)) * 4;
        if (s0 + cl < g.n)
          __pipeline_memcpy_async(buf + 4 * e,
                                  g.w + (k0 + kl) * g.n + s0 + cl, 16);
        else
          *reinterpret_cast<float4*>(buf + 4 * e) =
              make_float4(0.f, 0.f, 0.f, 0.f);
      }
    }
    __pipeline_commit();
  };
  for (int i = 0; i < STAGES - 1; ++i) stage(i);
  float acc[RT][CT];
  for (int i = 0; i < total; ++i) {
    const int s = i % slabs;
    if (s == 0) {
#pragma unroll
      for (int r = 0; r < RT; ++r)
#pragma unroll
        for (int jj = 0; jj < CT; ++jj) acc[r][jj] = 0.f;
    }
    __pipeline_wait_prior(STAGES - 2);
    __syncthreads();        // slab i has landed; slab i - 1 is read
    stage(i + STAGES - 1);  // into the buffer slab i - 1 held
    if (!active) continue;
    const float* cur = ws + (i % STAGES) * SLAB;
    const int k0 = s * BK, piece = k0 / g.kp;
    const int lda = piece == 0 ? g.lda[0] : piece == 1 ? g.lda[1] : g.lda[2];
    const float* a = (piece == 0 ? g.a[0] : piece == 1 ? g.a[1] : g.a[2]) +
                     r0 * lda + (k0 - piece * g.kp);
#pragma unroll
    for (int kk = 0; kk < BK; kk += 2) {
      float2 av[RT];
#pragma unroll
      for (int r = 0; r < RT; ++r)
        av[r] = *reinterpret_cast<const float2*>(a + r * lda + kk);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float wv[CT];
#pragma unroll
        for (int jj = 0; jj < CT; ++jj)
          wv[jj] = cur[(kk + h) * NC + lane + 32 * jj];
#pragma unroll
        for (int r = 0; r < RT; ++r)
#pragma unroll
          for (int jj = 0; jj < CT; ++jj)
            acc[r][jj] = fmaf(h ? av[r].y : av[r].x, wv[jj], acc[r][jj]);
      }
    }
    if (s != slabs - 1) continue;
    const int s0 = (i / slabs) * NC;
#pragma unroll
    for (int jj = 0; jj < CT; ++jj) {
      const int col = s0 + lane + 32 * jj;
      if (col >= g.n) continue;
      const float sc = __ldg(g.scale + col), sh = __ldg(g.shift + col);
#pragma unroll
      for (int r = 0; r < RT; ++r) {
        if (r0 + r >= g.rows_store) continue;
        float v = acc[r][jj] * sc + sh;
        if (RELU) v = fmaxf(v, 0.f);
        g.out[(r0 + r) * g.ldo + col] = v;
      }
    }
  }
  __syncthreads();
}

__device__ __forceinline__ float leaky(float f) {
  return f > 0.f ? f : 0.2f * f;
}

// Per-frame multi-head attention over the joints of the nf frames: reads
// theta/phi/g from P and writes each head's outputs over its g columns
// (head-major, so the heads are P[:, 4C + 2KI : 4C + 2KI + KG)).
// proj_t/proj_p (K, I) and c_k (K, J, J) are the block's copies in shared
// memory.
__device__ void attention(float* p, int ldp, int nf, int j, int c,
                          int nheads, int inter, int g_ch,
                          const float* proj_t, const float* proj_p,
                          const float* c_k) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int nwarps = blockDim.x / 32;
  const int ki = nheads * inter;
  const float* theta = p + 4 * c;
  const float* phi = theta + ki;
  float* g = p + 4 * c + 2 * ki;
  const int q = lane;
  for (int pair = warp; pair < nf * nheads; pair += nwarps) {
    const int fr = pair / nheads, k = pair - fr * nheads;
    const int row0 = fr * j;
    float sa = 0.f, sb = 0.f;
    if (q < j) {
      const float* th = theta + (row0 + q) * ldp + k * inter;
      const float* ph = phi + (row0 + q) * ldp + k * inter;
      for (int i = 0; i < inter; ++i) {
        sa = fmaf(th[i], proj_t[k * inter + i], sa);
        sb = fmaf(ph[i], proj_p[k * inter + i], sb);
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
    float* gk = g + row0 * ldp + k * g_ch;
    for (int g0 = 0; g0 < g_ch; g0 += 8) {
      float acc[8];
#pragma unroll
      for (int u = 0; u < 8; ++u) acc[u] = 0.f;
#pragma unroll
      for (int m = 0; m < MAX_J; ++m) {
        if (m >= j) break;
        const float* gm = gk + m * ldp + g0;
#pragma unroll
        for (int u = 0; u < 8; ++u)
          if (g0 + u < g_ch) acc[u] = fmaf(w[m], gm[u], acc[u]);
      }
      __syncwarp();  // every lane has read this chunk of g before any
                     // lane writes its outputs over it
      if (q < j) {
        float* o = gk + q * ldp + g0;
#pragma unroll
        for (int u = 0; u < 8; ++u)
          if (g0 + u < g_ch) o[u] = acc[u];
      }
    }
  }
}

// Widest column strip of a block's products: the projection's (CT = 7) or
// the block concat's (CT = 2 CW).
template <int CW>
__host__ __device__ constexpr int slab_width() {
  return 64 * CW > 224 ? 64 * CW : 224;
}

// CW = ceil(C / 32): the narrow products (N = C and 2C) take one strip.
template <int RT, int CW>
__global__ void __launch_bounds__(MAX_WARPS * 32, 2)
gab_narrow_kernel(const float* __restrict__ x, float* __restrict__ out,
                  long long frames, int fpb, int j, int c, int d, int nheads,
                  int inter, int g_ch, const Tables t) {
  extern __shared__ float4 smem4[];
  const int ki = nheads * inter, kg = nheads * g_ch, c2 = 2 * c;
  const int np = 4 * c + 2 * ki + kg;
  const int ldp = np + PAD;
  const int rows_p = (blockDim.x / 32) * RT;
  // Shared memory: weight slabs (STAGES, BK, slab width) | x (rows_p, C) |
  // P (rows_p, ldp) | c_k (K, J, J) | proj_t, proj_p (K, I) | col (2, J, D).
  float* ws = reinterpret_cast<float*>(smem4);
  float* xs = ws + STAGES * BK * slab_width<CW>();
  float* p = xs + rows_p * c;
  float* heads = p + 4 * c + 2 * ki;
  float* ck = p + rows_p * ldp;
  float* pt = ck + nheads * j * j;
  float* pp = pt + ki;
  int* col = reinterpret_cast<int*>(pp + ki);

  const long long f0 = (long long)blockIdx.x * fpb;
  const int nf = (int)min((long long)fpb, frames - f0);
  const int rows = nf * j;
  const float* xg = x + f0 * j * c;

  // Rows past the last frame of a tile are zero, so every value computed
  // for them stays finite; none is stored.
  for (int idx = threadIdx.x; idx < rows_p * c; idx += blockDim.x)
    xs[idx] = idx < rows * c ? xg[idx] : 0.f;
  for (int idx = threadIdx.x; idx < nheads * j * j; idx += blockDim.x)
    ck[idx] = __ldg(t.c_k + idx);
  for (int idx = threadIdx.x; idx < ki; idx += blockDim.x) {
    pt[idx] = __ldg(t.proj_t + idx);
    pp[idx] = __ldg(t.proj_p + idx);
  }
  for (int idx = threadIdx.x; idx < 2 * j * d; idx += blockDim.x)
    col[idx] = __ldg(t.col + idx);
  __syncthreads();

  // P = x @ [W0_sym | W1_sym | W0_con | W1_con | theta | phi | g] + bias
  block_gemm<RT, 7, false>(
      Gemm{{xs, xs, xs}, {c, c, c}, c, c, t.w_proj, np, t.proj_scale,
           t.proj_shift, p, ldp, rows_p},
      ws, rows);

  attention(p, ldp, nf, j, c, nheads, inter, g_ch, pt, pp, ck);
  __syncthreads();

  // Semantic graph aggregation of both branches (b = 0 sym, 1 con) from
  // P[:, 2bC:2bC+C) (self) and P[:, 2bC+C:2bC+2C) (the frame's neighbours),
  // written over theta/phi as ab = P[:, 4C:6C). A thread takes a (joint,
  // channel) and its weights once, for every frame of the tile.
  for (int idx = threadIdx.x; idx < j * c2; idx += blockDim.x) {
    const int q = idx / c2, cc = idx - q * c2;
    const int b = cc / c, ch = cc - b * c, bq = b * j + q;
    float wn[MAX_D];
    int nb[MAX_D];
#pragma unroll
    for (int dd = 0; dd < MAX_D; ++dd) {
      wn[dd] = dd < d ? __ldg(t.w_nbr + (bq * d + dd) * c + ch) : 0.f;
      nb[dd] = dd < d ? col[bq * d + dd] : 0;
    }
    const float w_self = __ldg(t.w_self + bq * c + ch);
    const float sc = __ldg(t.sem_scale + cc), sh = __ldg(t.sem_shift + cc);
    const float* h = p + b * c2 + ch;
    for (int fr = 0; fr < nf; ++fr) {
      const int r0 = fr * j;
      float acc = h[(r0 + q) * ldp] * w_self;
#pragma unroll
      for (int dd = 0; dd < MAX_D; ++dd) {
        if (dd >= d) break;
        acc = fmaf(h[(r0 + nb[dd]) * ldp + c], wn[dd], acc);
      }
      p[(r0 + q) * ldp + 4 * c + cc] = fmaxf(acc * sc + sh, 0.f);
    }
  }
  __syncthreads();

  // local = relu(BN(ab @ lcat_w)) -> P[:, 0:C), then global =
  // relu(BN(heads @ acat_w)) -> P[:, C:2C). Each product ends with a
  // barrier.
  block_gemm<RT, CW, true>(
      Gemm{{p + 4 * c, p, p}, {ldp, ldp, ldp}, c2, c2, t.lcat_w, c,
           t.lcat_scale, t.lcat_shift, p, ldp, rows_p},
      ws, rows);
  block_gemm<RT, CW, true>(
      Gemm{{heads, p, p}, {ldp, ldp, ldp}, kg, kg, t.acat_w, c,
           t.acat_scale, t.acat_shift, p + c, ldp, rows_p},
      ws, rows);

  // out = relu(BN([x | local | global] @ gcat_w)), the concat unformed
  block_gemm<RT, 2 * CW, true>(
      Gemm{{xs, p, p + c}, {c, ldp, ldp}, c, 3 * c, t.gcat_w, c2,
           t.gcat_scale, t.gcat_shift, out + f0 * j * c2, c2, rows},
      ws, rows);
}

// Frames per block: as many as MAX_WARPS warps of RT rows hold, but no
// more than leave two blocks for each SM when there are few frames.
template <int RT, int CW>
int launch(const float* x, float* out, long long frames, int j, int c,
           int d, int nheads, int inter, int g_ch, const Tables& t,
           cudaStream_t stream) {
  const int np = 4 * c + 2 * nheads * inter + nheads * g_ch;
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e == cudaSuccess)
      e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const long long spread = (frames + 2LL * sms - 1) / (2LL * sms);
  int fpb = MAX_WARPS * RT / j;
  if (spread < fpb) fpb = spread < 1 ? 1 : (int)spread;
  const int warps = (fpb * j + RT - 1) / RT;
  const long long smem =
      (long long)sizeof(float) *
      (STAGES * BK * slab_width<CW>() +
       (long long)warps * RT * (c + np + PAD) + nheads * j * j +
       2 * nheads * inter + 2 * j * d);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        gab_narrow_kernel<RT, CW>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  if (frames > 0) {
    const long long blocks = (frames + fpb - 1) / fpb;
    gab_narrow_kernel<RT, CW><<<(unsigned)blocks, warps * 32, (size_t)smem,
                                stream>>>(x, out, frames, fpb, j, c, d,
                                          nheads, inter, g_ch, t);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Launches on `stream`; returns cudaGetLastError() after the launch, or
// cudaErrorInvalidValue for a shape the kernel does not take.
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
  // The products step k by BK and copy 16 bytes: C and KG multiples of 8;
  // ab goes over theta/phi (KI >= C) and the projection fits a strip count.
  if (j < 1 || j > MAX_J || d > MAX_D || c < 8 || c >= 128 ||
      c % 8 ||
      (nheads * g_ch) % 8 || nheads * inter < c)
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
  // Rows a warp owns, by width: as many frames as two blocks an SM allow.
  if (c <= 32)
    return launch<10, 1>(xf, of, frames, j, c, d, nheads, inter, g_ch,
                         t, st);
  if (c <= 64)
    return launch<5, 2>(xf, of, frames, j, c, d, nheads, inter, g_ch,
                        t, st);
  return launch<4, 4>(xf, of, frames, j, c, d, nheads, inter, g_ch, t,
                      st);
}

const char* error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
