// The weight gradient of a plain site's product at the bf16 precision
// tiers, on the tensor cores of sm_90a.
//
// The JAX package trains at its matmul tiers: every XLA site's dot_general
// and conv carries its tier, and JAX's transpose rules pass that tier on
// unchanged to both transposed products (jax/_src/lax/lax.py,
// _dot_general_transpose_lhs / _rhs; the conv's likewise), so on the TPU
// the weight gradient dW = A^T G of a site at "high" is three bf16 passes
// and at "default" one. The port's forward and input-gradient products run
// on gemm_tc / gemm_smallk; this kernel is the weight gradient's:
//
//   dW_p[k, n] = sum_m A_p[in_row(m, p), k] * G[m, n]
//
// for up to three pieces p in one launch, with gemm_epilogue.cu's row map
// in_row(m, p) = (m / s_out) * a_s_in + m % s_out + a_off[p] (a conv's taps
// read the input in place, a concatenation's pieces their own tensors).
// With a = ah + al and g = gh + gl split as kernels.split_bf16 splits them
// (ah = bf16(a), al = bf16(a - ah), both rounded to nearest even):
//
//   TIER 0 "default":  ah.gh                 one pass
//   TIER 3 "high":     ah.gh + ah.gl + al.gh three passes
//
// each pass a product of bf16 operands into float32 accumulators. The
// codes are gemm_tc's (TC_TIERS); the sites take no two-pass tier (their
// tiers are XLA's: default, high, highest), and "highest" is a float32
// torch product that never launches this kernel.
//
// Shape: the reduction runs over all M rows (156,672 at the 27f level 0,
// strided, B = 1024 windows) and the output is small (at most a few hundred
// by a few hundred; the expand conv's 3 x 2 x 128). One output tile a block
// would leave most of the 132 SMs idle, so the rows are split: block
// (tile, s) sums rows [s * chunk, (s + 1) * chunk) of its 64 x 64 output
// tile into slice s of a float32 workspace (the wrapper allocates it), and
// a second kernel sums the slices in order, s = 0, 1, ... No float atomics:
// the result is the same bits on every run (a resumed training run is held
// bit for bit against a straight one). With one split the tile kernel
// writes the output itself.
//
// The tile kernel: 128 threads, four warps of 32 x 32 output elements,
// mma.sync.m16n8k16 bf16. A slab of 32 rows of A (64 k) and G (64 n) is
// loaded into registers as float32 (bounds-checked scalar loads: any K_p,
// N, row offset and alignment, K = 2 taps and N = 51 included), split into
// bf16 halves and stored row-major ([m][k], [m][n]) into one of two
// shared-memory buffers while the other buffer's MMAs run; both operands
// reach the MMA by ldmatrix.trans (A^T: the reduction runs down the rows of
// both tiles). A simple kernel first: no TMA or wgmma (ROADMAP A).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int MAX_PIECES = 3;
constexpr int BK = 64;        // output rows (k of A) a tile
constexpr int BN = 64;        // output columns (n of G) a tile
constexpr int BR = 32;        // rows (the reduction) a slab
constexpr int THREADS = 128;
constexpr int PITCH = 64 + 8; // halves of a shared row: 144 bytes, so the
                              // eight rows of an ldmatrix hit 8 bank quads
constexpr int TILE = BR * PITCH;
// Loads: thread t reads columns (t % 16) * 4 .. + 3 of rows t / 16 + 8 i.
constexpr int LOAD_ROWS = BR * 16 / THREADS;

template <int TIER>
struct Passes {
  static constexpr bool LO = TIER == 3;  // the lo halves and passes 2, 3
};

struct Args {
  const float* a[MAX_PIECES];
  int k[MAX_PIECES];
  int a_off[MAX_PIECES];
  int out_row[MAX_PIECES];  // piece p's first row in dW
  int k_tiles[MAX_PIECES];  // ceil(K_p / BK)
  int npieces;
  const float* g;
  int m, n;
  int s_out, a_s_in;
  int chunk;                // rows a split, a multiple of BR
  int k_total;              // rows of dW
  float* dst;               // the output, or the workspace's slices
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// d += a (16x16, row) . b (16x8, col), bf16 in, float32 accumulators.
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Four float32 values as their bf16 hi halves (and lo halves) in shared
// memory at `hi` (and `lo`), 8 bytes each.
template <bool LO>
__device__ __forceinline__ void store_split(const float (&v)[4],
                                            __nv_bfloat16* hi,
                                            __nv_bfloat16* lo) {
  __align__(8) __nv_bfloat16 h[4], l[4];
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    h[e] = __float2bfloat16_rn(v[e]);
    if (LO) l[e] = __float2bfloat16_rn(v[e] - __bfloat162float(h[e]));
  }
  *reinterpret_cast<uint2*>(hi) = *reinterpret_cast<uint2*>(h);
  if (LO) *reinterpret_cast<uint2*>(lo) = *reinterpret_cast<uint2*>(l);
}

template <int TIER>
__global__ void __launch_bounds__(THREADS)
gemm_wgrad_kernel(const Args args, int tiles_n) {
  constexpr bool LO = Passes<TIER>::LO;
  // Buffer s: A hi, G hi [, A lo, G lo], each BR x PITCH halves.
  constexpr int STAGE = TILE * (LO ? 4 : 2);
  __shared__ __align__(16) __nv_bfloat16 smem[2 * STAGE];

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  // The tile: piece p, its k rows k0 .., columns n0 ..
  int kt = blockIdx.x / tiles_n;
  const int n0 = (blockIdx.x % tiles_n) * BN;
  int p = 0;
  while (p + 1 < args.npieces && kt >= args.k_tiles[p]) kt -= args.k_tiles[p++];
  const int k0 = kt * BK;
  const float* A = args.a[p];
  const int kp = args.k[p], a_off = args.a_off[p];
  const int m = args.m, n = args.n;
  const int r_begin = blockIdx.y * args.chunk;
  const int r_end = min(m, r_begin + args.chunk);

  const int lc = (tid % 16) * 4;  // the four columns this thread loads
  float va[LOAD_ROWS][4], vg[LOAD_ROWS][4];
  // Slab rows r0 .. r0 + BR - 1 into registers, zeros past the edges.
  auto load = [&](int r0) {
#pragma unroll
    for (int i = 0; i < LOAD_ROWS; ++i) {
      const int r = r0 + tid / 16 + 8 * i;
      const bool row_ok = r < r_end;
      const float* arow = A;
      const float* grow = args.g;
      if (row_ok) {
        const int s = r / args.s_out;
        arow = A + ((long long)s * args.a_s_in + (r - s * args.s_out) + a_off)
                       * kp;
        grow = args.g + (long long)r * n;
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int k = k0 + lc + e, c = n0 + lc + e;
        va[i][e] = row_ok && k < kp ? __ldg(arow + k) : 0.f;
        vg[i][e] = row_ok && c < n ? __ldg(grow + c) : 0.f;
      }
    }
  };
  auto store = [&](int buf) {
    __nv_bfloat16* base = smem + buf * STAGE;
#pragma unroll
    for (int i = 0; i < LOAD_ROWS; ++i) {
      const int o = (tid / 16 + 8 * i) * PITCH + lc;
      store_split<LO>(va[i], base + o, base + 2 * TILE + o);
      store_split<LO>(vg[i], base + TILE + o, base + 3 * TILE + o);
    }
  };

  // Warp (wk, wn) of a 2 x 2 grid owns dW rows wk .. wk + 31 (two m16
  // tiles) and columns wn .. wn + 31 (four n8 tiles).
  const int wk = (warp / 2) * 32, wn = (warp % 2) * 32;
  float acc[2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  // ldmatrix.trans lane addresses. A^T's fragment (16 k x 16 m): matrix q
  // holds k rows (q & 1) * 8 .., m columns (q >> 1) * 8 .., read from the
  // [m][k] tile's rows m. G's (16 m x 8 n, two n8 tiles): matrix q holds m
  // rows (q & 1) * 8 .., n columns (q >> 1) * 8 .., as gemm_tc.cu's W.
  const int q = lane / 8, r8 = lane % 8;
  const int a_lane = ((q >> 1) * 8 + r8) * PITCH + wk + (q & 1) * 8;
  const int g_lane = ((q & 1) * 8 + r8) * PITCH + wn + (q >> 1) * 8;

  const int slabs = r_end > r_begin ? (r_end - r_begin + BR - 1) / BR : 0;
  if (slabs > 0) {
    load(r_begin);
    store(0);
  }
  __syncthreads();
  for (int t = 0; t < slabs; ++t) {
    const bool next = t + 1 < slabs;
    if (next) load(r_begin + (t + 1) * BR);
    const __nv_bfloat16* base = smem + (t % 2) * STAGE;
    const uint32_t ah = smem_addr(base), gh = smem_addr(base + TILE);
    const uint32_t al = smem_addr(base + 2 * TILE);
    const uint32_t gl = smem_addr(base + 3 * TILE);
#pragma unroll
    for (int ks = 0; ks < BR; ks += 16) {
      uint32_t fgh[4][2], fgl[4][2];
#pragma unroll
      for (int pair = 0; pair < 2; ++pair) {
        const uint32_t o = 2 * (g_lane + ks * PITCH + pair * 16);
        uint32_t r[4];
        ldmatrix_x4_trans(r, gh + o);
        fgh[2 * pair][0] = r[0]; fgh[2 * pair][1] = r[1];
        fgh[2 * pair + 1][0] = r[2]; fgh[2 * pair + 1][1] = r[3];
        if constexpr (LO) {
          ldmatrix_x4_trans(r, gl + o);
          fgl[2 * pair][0] = r[0]; fgl[2 * pair][1] = r[1];
          fgl[2 * pair + 1][0] = r[2]; fgl[2 * pair + 1][1] = r[3];
        }
      }
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const uint32_t o = 2 * (a_lane + ks * PITCH + i * 16);
        uint32_t fa[4];
        ldmatrix_x4_trans(fa, ah + o);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          mma(acc[i][j], fa, fgh[j][0], fgh[j][1]);
          if constexpr (LO) mma(acc[i][j], fa, fgl[j][0], fgl[j][1]);
        }
        if constexpr (LO) {
          ldmatrix_x4_trans(fa, al + o);
#pragma unroll
          for (int j = 0; j < 4; ++j)
            mma(acc[i][j], fa, fgh[j][0], fgh[j][1]);
        }
      }
    }
    // The other buffer was last read before the previous barrier.
    if (next) store((t + 1) % 2);
    __syncthreads();
  }

  // Lane holds dW rows g and g + 8 of each m16 tile, columns 2c and 2c + 1
  // of each n8 tile.
  float* dst = args.dst + (long long)blockIdx.y * args.k_total * n;
  const int g = lane / 4, c2 = (lane % 4) * 2;
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int k = k0 + wk + i * 16 + g + h * 8;
      if (k >= kp) continue;
      float* row = dst + (long long)(args.out_row[p] + k) * n;
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int c = n0 + wn + j * 8 + c2 + e;
          if (c < n) row[c] = acc[i][j][2 * h + e];
        }
    }
}

// out[i] = sum over s = 0 .. splits - 1 of ws[s][i], in that order.
__global__ void __launch_bounds__(256)
sum_slices_kernel(const float* ws, float* out, long long size, int splits) {
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       i < size; i += (long long)gridDim.x * blockDim.x) {
    float s = ws[i];
    for (int j = 1; j < splits; ++j) s += ws[j * size + i];
    out[i] = s;
  }
}

template <int TIER>
int launch(Args args, int splits, float* ws, float* out,
           cudaStream_t stream) {
  int tiles_k = 0;
  for (int p = 0; p < args.npieces; ++p) tiles_k += args.k_tiles[p];
  const int tiles_n = (args.n + BN - 1) / BN;
  args.dst = splits > 1 ? ws : out;
  gemm_wgrad_kernel<TIER><<<dim3(tiles_k * tiles_n, splits), THREADS, 0,
                            stream>>>(args, tiles_n);
  if (splits > 1) {
    const long long size = (long long)args.k_total * args.n;
    const long long blocks = (size + 255) / 256;
    sum_slices_kernel<<<(unsigned)(blocks < 1024 ? blocks : 1024), 256, 0,
                        stream>>>(ws, out, size, splits);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// dW (K_0 + .. + K_{npieces-1}, n) float32, row-major, of `tier` (0
// default, 3 high) on `stream`: piece p's rows are A_p^T G over the row
// map, A_p (rows_p, K_p) and G (m, n) float32, row-major. Rows are split
// `splits` ways, `chunk` rows each (a multiple of 32; splits * chunk >= m):
// with splits > 1, `ws` holds splits x K_total x n floats. Returns
// cudaGetLastError() after the launches, or cudaErrorInvalidValue with no
// launch for another tier, a piece count outside 1-3, an empty shape or a
// split that does not cover the rows.
int gemm_wgrad(const void* a0, int k0, int off0, const void* a1, int k1,
               int off1, const void* a2, int k2, int off2, int npieces,
               const void* g, int m, int n, int s_out, int a_s_in,
               void* ws, int splits, int chunk, void* out, void* stream,
               int tier) {
  if (npieces < 1 || npieces > MAX_PIECES || (tier != 0 && tier != 3) ||
      m < 1 || n < 1 || s_out < 1 || splits < 1 || chunk < BR ||
      chunk % BR != 0 || (long long)splits * chunk < m ||
      (splits > 1 && ws == nullptr) || out == nullptr || g == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  Args args = {};
  const void* as[MAX_PIECES] = {a0, a1, a2};
  const int ks[MAX_PIECES] = {k0, k1, k2};
  const int offs[MAX_PIECES] = {off0, off1, off2};
  int row = 0;
  for (int p = 0; p < npieces; ++p) {
    if (as[p] == nullptr || ks[p] < 1)
      return static_cast<int>(cudaErrorInvalidValue);
    args.a[p] = static_cast<const float*>(as[p]);
    args.k[p] = ks[p];
    args.a_off[p] = offs[p];
    args.out_row[p] = row;
    args.k_tiles[p] = (ks[p] + BK - 1) / BK;
    row += ks[p];
  }
  args.npieces = npieces;
  args.g = static_cast<const float*>(g);
  args.m = m;
  args.n = n;
  args.s_out = s_out;
  args.a_s_in = a_s_in;
  args.chunk = chunk;
  args.k_total = row;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* w = static_cast<float*>(ws);
  float* o = static_cast<float*>(out);
  return tier == 0 ? launch<0>(args, splits, w, o, s)
                   : launch<3>(args, splits, w, o, s);
}

const char* error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
