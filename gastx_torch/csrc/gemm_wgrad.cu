// The weight gradient of a plain site's product at the bf16 precision
// tiers, on sm_90a.
//
// The JAX package trains at its matmul tiers: every XLA site's dot_general
// and conv carries its tier, and JAX's transpose rules pass that tier on
// unchanged to both transposed products (jax/_src/lax/lax.py,
// _dot_general_transpose_lhs / _rhs; the conv's likewise), so on the TPU
// the weight gradient dW = A^T G of a site at "high" is three bf16 passes
// and at "default" one. No TPU kernel stands behind it: it replaces XLA's
// transposed product of the JAX train forward (gastx/models/gastnet.py:
// 89-90). The port's forward and input-gradient products run on gemm_tc /
// gemm_smallk; this file computes the weight gradient:
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
// each pass a product of bf16 operands into float32 sums, the passes of a
// step in that order. The codes are gemm_tc's (TC_TIERS); the sites take
// no two-pass tier (their tiers are XLA's: default, high, highest), and
// "highest" is a float32 torch product that never launches this file.
//
// Shape: the reduction runs over all M rows (17,408-352,512 in the tiered
// train steps) and the output is small (6 x 32 to 1536 x 1024). Bound on
// this card: A's rows, G and dW once at 3.35 TB/s against 2 M K N a pass
// at 989 TFLOP/s. At the 27f B=1024 GAB-0 block concat (M = 156,672, K =
// 3 x 128, N = 256) 0.120 ms of bytes, 0.093 of operations at "high"; at
// the C=512 block concat (M = 17,408, K = 1536, N = 1024) 0.166 ms of
// operations at "high"; the expand conv's K = 2 taps G's read alone.
// Each instantiation splits the rows across blocks by a rule of the shape
// alone (kernels.wgrad_splits): block (tile, s) sums rows [s * chunk,
// (s + 1) * chunk) into slice s of a float32 workspace (the wrapper
// allocates it), and a second kernel sums the slices in order. No float
// atomics: a call gives the same bits on every run (a resumed training run
// and one NCCL rank are held bit for bit). With one split the tile kernel
// writes the output itself.
//
// Three instantiations (kernels.wgrad_route picks one from the shapes):
//
// * wgmma (every K_p and N multiples of 8, A_p and G 16-byte aligned, a
//   conv's runs within GATHER_ROWS a slab: the sites' products at C =
//   32-512, the strided taps too). A block of three warpgroups computes a
//   128 x BN tile of dW (BN = 64, 128 or 256 by N; 128 rows of the pieces'
//   K, each padded to 32, so that one tile may hold several small pieces
//   and A and G are read once where K_pad <= 128 and N <= 256), about one
//   block an SM.
//   - One thread of warpgroup 2 produces float32 slabs of 32 rows into a
//     ring (a full and an empty mbarrier a slab), all by TMA, in blocks of
//     32 columns (128-byte rows): G's, 32 rows a box; A's, 32 rows a box
//     where the tile's rows are contiguous in A (s_out == a_s_in: the 1x1
//     and concatenation sites), else (the strided conv taps, runs of s_out
//     rows every a_s_in) one box of a 3D map (columns, rows of a run, runs)
//     for each run the slab meets, into a region of its own, where the
//     consumers find each of its rows. TMA fills the rows
//     past a run's end or M and the columns past K_p or N with zeros.
//     Row gathers by 16-byte cp.async, the first design, took twice as
//     long a slab as the boxes, and one 128-byte box a row longer still.
//   - Warpgroups 0 and 1 split each slab once: every thread reads one
//     float4 of each block and writes its bf16 hi (and lo at "high") into
//     one of two bf16 buffers in wgmma's MN-major layout with 128-byte
//     swizzle: A^T's M dimension is k, held as [m][64 k] a warpgroup, G's
//     N dimension is n, held as [m][64 n] an atom of 64 columns. Each row
//     of A and of G is then split once for the whole tile (the general
//     kernel re-reads and re-splits A for every 64 columns and G for every
//     64 rows of dW). Then each issues wgmma.m64nBNk16 with both
//     operands from shared memory (the transpose bits), three a k16 step
//     at "high", into the same accumulators; the split of the next slab
//     runs while they do. Two named barriers a slab keep a buffer from
//     being rewritten before both warpgroups' wgmmas have read it.
//   - The epilogue stores the accumulators (float2 a thread) to dW's rows,
//     the padding's rows and columns past N dropped.
// * smallk (sum K_p <= 16, N a multiple of 4 up to 1024, G 16-byte
//   aligned: the expand conv's three K = 2 taps). CUDA-core float32 FMAs on
//   the split values, whose products are exact, as gemm_smallk.cu computes
//   its forward: thread (c, r) of a block holds dW's K_total x 4 columns
//   4c .. 4c + 3 for the rows r, r + R, ... of the block's split (R = 256 /
//   (N / 4)), each row of G read once by 16-byte loads and A's few values
//   a row by broadcast loads; the block sums its R partial sums in order
//   through shared memory, and a warp a dW element sums the slices.
// * general (anything else: N not a multiple of 8, K_p not of 8, unaligned
//   rows, the shrink's N = 3): the first design, 64 x 64 tiles of 128
//   threads, mma.sync.m16n8k16 bf16. A slab of 32 rows of A (64 k) and G
//   (64 n) is loaded into registers as float32 (bounds-checked scalar
//   loads: any K_p, N, row offset and alignment), split into bf16 halves
//   and stored row-major ([m][k], [m][n]) into one of two shared-memory
//   buffers while the other buffer's MMAs run; both operands reach the MMA
//   by ldmatrix.trans (A^T: the reduction runs down the rows of both
//   tiles).
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int MAX_PIECES = 3;

template <typename T>
__device__ __forceinline__ T pick(const T (&v)[MAX_PIECES], int p) {
  return p == 0 ? v[0] : (p == 1 ? v[1] : v[2]);
}

__device__ __forceinline__ long long map_row(int r, int s_out, int s_in) {
  const int s = r / s_out;
  return (long long)s * s_in + (r - s * s_out);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
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

// The same sum for a small output over many slices, a warp an element:
// lane l sums slices l, l + 32, ... in order (from 0), then the lanes'
// sums are added by a fixed xor butterfly (16, 8, 4, 2, 1); lane 0 stores.
__global__ void __launch_bounds__(256)
sum_slices_warp_kernel(const float* ws, float* out, int size, int splits) {
  const int lane = threadIdx.x % 32;
  for (int i = (blockIdx.x * blockDim.x + threadIdx.x) / 32; i < size;
       i += gridDim.x * blockDim.x / 32) {
    float s = 0.f;
    for (int j = lane; j < splits; j += 32) s += ws[(long long)j * size + i];
#pragma unroll
    for (int o = 16; o > 0; o /= 2) s += __shfl_xor_sync(0xffffffffu, s, o);
    if (lane == 0) out[i] = s;
  }
}

// The sum of the slices into `out`, where there is more than one.
int sum_slices(const float* ws, float* out, long long size, int splits,
               bool by_warp, cudaStream_t stream) {
  if (splits > 1) {
    const long long threads = by_warp ? 32 * size : size;
    const long long blocks = (threads + 255) / 256;
    const unsigned grid = (unsigned)(blocks < 1024 ? blocks : 1024);
    if (by_warp)
      sum_slices_warp_kernel<<<grid, 256, 0, stream>>>(ws, out, (int)size,
                                                       splits);
    else
      sum_slices_kernel<<<grid, 256, 0, stream>>>(ws, out, size, splits);
  }
  return static_cast<int>(cudaGetLastError());
}

// ==========================================================================
// general: 64 x 64 mma.sync tiles, scalar loads.
// ==========================================================================
namespace general {

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

template <int TIER>
int launch(Args args, int splits, float* ws, float* out,
           cudaStream_t stream) {
  int tiles_k = 0;
  for (int p = 0; p < args.npieces; ++p) tiles_k += args.k_tiles[p];
  const int tiles_n = (args.n + BN - 1) / BN;
  args.dst = splits > 1 ? ws : out;
  gemm_wgrad_kernel<TIER><<<dim3(tiles_k * tiles_n, splits), THREADS, 0,
                            stream>>>(args, tiles_n);
  return sum_slices(ws, out, (long long)args.k_total * args.n, splits,
                    false, stream);
}

}  // namespace general

// ==========================================================================
// wgmma: the split slabs of A and G as both operands of wgmma in shared
// memory, fed by TMA through a ring of float32 slabs.
// ==========================================================================
namespace hopper {

constexpr int BK = 128;        // rows of dW a tile: two consumer warpgroups
constexpr int BR = 32;         // rows of the reduction a slab: two k16 steps
constexpr int COLS = 32;       // float32 columns of a staged block
constexpr int CONSUMERS = 2;
constexpr int THREADS = 128 * (CONSUMERS + 1);
constexpr int PRODUCER_REGS = 56;   // setmaxnreg: 56 * 128 + 224 * 256 =
constexpr int CONSUMER_REGS = 224;  // 168 * 384, the launch's allocation
constexpr int BLOCK = BR * COLS * 4;  // a staged block: 32 rows x 128 bytes
constexpr int ATOM = BR * 128;        // a bf16 atom: 32 rows x 64 values
constexpr int A_BLOCKS = BK / COLS;
constexpr int STEP = 16 * 128;        // one k16 step of an atom's rows
constexpr int EMPTY_ARRIVALS = 4 * CONSUMERS;  // one a consumer warp
// A gathered block: the runs of the row map a slab meets, a region of
// box_rows rows each (kernels.wgrad_route: at most GATHER_ROWS in all).
constexpr int GATHER_ROWS = 64;
constexpr int BUDGET = 225 * 1024;

// Shared memory: a ring of STAGES float32 slabs (A's 4 blocks, of
// GATHER_ROWS rows where gathered, then G's BN / 32), two bf16 buffers
// (each: A hi, one atom a consumer warpgroup, then G hi, BN / 64 atoms; at
// "high" the lo halves after them), then the mbarriers.
template <int TIER, int BN, bool GATHER>
struct Smem {
  static constexpr bool LO = TIER == 3;
  static constexpr int G_BLOCKS = BN / COLS;
  static constexpr int A_BLOCK = GATHER ? GATHER_ROWS * 128 : BLOCK;
  static constexpr int STAGE = A_BLOCKS * A_BLOCK + G_BLOCKS * BLOCK;
  static constexpr int HALF = (BK / 64 + BN / 64) * ATOM;
  static constexpr int BUF = HALF * (LO ? 2 : 1);
  static constexpr int FIT = (BUDGET - 2 * BUF) / STAGE;
  static constexpr int STAGES = FIT < 4 ? FIT : 4;
  static_assert(STAGES >= 2, "two staged slabs at least");
  static constexpr int BUFS = STAGES * STAGE;
  static constexpr int BARS = BUFS + 2 * BUF;
  static constexpr int BYTES = BARS + 2 * STAGES * 8 + 1024;
};

struct Args {
  const float* a[MAX_PIECES];
  int k[MAX_PIECES];
  int a_off[MAX_PIECES];
  int pad_end[MAX_PIECES];  // cumulative K_p padded to 32 (past the pieces:
                            // the total)
  int out_row[MAX_PIECES];  // piece p's first row in dW
  int pad_total;
  int m, n;
  int s_out, a_s_in;
  int gather;               // A run by run of the row map (s_out !=
                            // a_s_in)
  int box_rows;             // rows of a run's box: min(s_out, 32)
  int chunk;                // rows a split, a multiple of BR
  int k_total;              // rows of dW
  int tiles_n;
  float* dst;               // the output, or the workspace's slices
};

// The piece and its column of padded column kp (< pad_total).
__device__ __forceinline__ int piece_at(const Args& args, int kp, int& col) {
  const int p = kp < args.pad_end[0] ? 0 : (kp < args.pad_end[1] ? 1 : 2);
  col = kp - (p ? pick(args.pad_end, p - 1) : 0);
  return p;
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  }
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               ::"r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];\n"
      ::"r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0),
      "r"(c1) : "memory");
}

// A box of a 3D map (columns, rows of a run, runs) at {c0, c1, c2}.
__device__ __forceinline__ void tma_load3(uint32_t dst,
                                          const CUtensorMap* map,
                                          uint32_t bar, int c0, int c1,
                                          int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];\n"
      ::"r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0),
      "r"(c1), "r"(c2) : "memory");
}

// The 256 threads of the two consumer warpgroups (named barrier 1).
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, 256;\n" ::: "memory");
}

// wgmma descriptor of an MN-major bf16 operand with 128-byte swizzle: atoms
// of 64 MN values (128-byte rows) x 8 rows of the reduction, 1024 bytes;
// SBO = 1024 bytes from one 8-row group to the next along the reduction,
// LBO = ATOM bytes from one 64-value atom to the next along MN; layout
// type 1.
__device__ __forceinline__ uint64_t desc_mn_sw128(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) |
         ((uint64_t)(ATOM >> 4) << 16) | ((uint64_t)(1024 >> 4) << 32) |
         (1ull << 62);
}

// d (64 x 64 float32) += a (64 x 16) . b (16 x 64), both bf16 MN-major in
// shared memory (descriptors), always accumulating.
__device__ __forceinline__ void wgmma_n64(float (&d)[32], uint64_t a,
                                          uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(1));
}

// d (64 x 128 float32) += a (64 x 16) . b (16 x 128), both bf16 MN-major in
// shared memory (descriptors), always accumulating.
__device__ __forceinline__ void wgmma_n128(float (&d)[64], uint64_t a,
                                          uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(1));
}

// d (64 x 256 float32) += a (64 x 16) . b (16 x 256), both bf16 MN-major in
// shared memory (descriptors), always accumulating.
__device__ __forceinline__ void wgmma_n256(float (&d)[128], uint64_t a,
                                          uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, "
      "%88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, "
      "%104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129, p, 1, 1, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]),
        "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]),
        "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]),
        "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
        "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]),
        "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]),
        "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(a), "l"(b), "r"(1));
}

template <int BN>
__device__ __forceinline__ void wgmma(float (&d)[BN / 2], uint64_t a,
                                      uint64_t b) {
  if constexpr (BN == 64)
    wgmma_n64(d, a, b);
  else if constexpr (BN == 128)
    wgmma_n128(d, a, b);
  else
    wgmma_n256(d, a, b);
}

// A float4 of four k (or n) as its bf16 hi and lo halves, four values each.
__device__ __forceinline__ void split4(const float4 v, uint2& hi, uint2& lo) {
  const __nv_bfloat162 h0 = __floats2bfloat162_rn(v.x, v.y);
  const __nv_bfloat162 h1 = __floats2bfloat162_rn(v.z, v.w);
  const float2 f0 = __bfloat1622float2(h0), f1 = __bfloat1622float2(h1);
  const __nv_bfloat162 l0 = __floats2bfloat162_rn(v.x - f0.x, v.y - f0.y);
  const __nv_bfloat162 l1 = __floats2bfloat162_rn(v.z - f1.x, v.w - f1.y);
  hi.x = *reinterpret_cast<const uint32_t*>(&h0);
  hi.y = *reinterpret_cast<const uint32_t*>(&h1);
  lo.x = *reinterpret_cast<const uint32_t*>(&l0);
  lo.y = *reinterpret_cast<const uint32_t*>(&l1);
}

template <int TIER, int BN, bool GATHER>
__global__ void __launch_bounds__(THREADS, 1)
wgrad_kernel(const Args args, const __grid_constant__ CUtensorMap map_a0,
             const __grid_constant__ CUtensorMap map_a1,
             const __grid_constant__ CUtensorMap map_a2,
             const __grid_constant__ CUtensorMap map_g) {
  using S = Smem<TIER, BN, GATHER>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  // The slabs and atoms start 1024-byte aligned (the swizzle's repeat).
  const uint32_t raw = smem_addr(smem_raw);
  unsigned char* base = smem_raw + ((1024 - (raw & 1023)) & 1023);
  const uint32_t base_s = smem_addr(base);
  const uint32_t full0 = base_s + S::BARS;
  const uint32_t empty0 = full0 + 8 * S::STAGES;

  const int tid = threadIdx.x;
  const int wg = tid / 128;
  const int k0 = (blockIdx.x / args.tiles_n) * BK;
  const int n0 = (blockIdx.x % args.tiles_n) * BN;
  const int r_begin = blockIdx.y * args.chunk;
  const int r_end = min(args.m, r_begin + args.chunk);
  const int slabs = r_end > r_begin ? (r_end - r_begin + BR - 1) / BR : 0;
  // The tile's blocks: A's padded columns k0 + 32 j that lie in a piece,
  // G's columns n0 + 32 j below N (the same every slab).
  const int g_blocks = min(S::G_BLOCKS, (args.n - n0 + COLS - 1) / COLS);

  if (tid == 0) {
    for (int s = 0; s < S::STAGES; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, EMPTY_ARRIVALS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == CONSUMERS) {
    // ---- producer warpgroup ----------------------------------------------
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(PRODUCER_REGS));
    // One thread issues every box of a slab: G's blocks, and A's, one box
    // a block where the tile's rows are contiguous in A, else one box a
    // block and run of the row map the slab meets (a 3D map of the runs:
    // rows past a run's end read as zeros), each run in its own region.
    if (tid != 128 * CONSUMERS) return;
    int a_blocks = 0;
    for (int j = 0; j < A_BLOCKS; ++j) a_blocks += k0 + COLS * j < args.pad_total;
    for (int it = 0; it < slabs; ++it) {
      const int s = it % S::STAGES;
      const uint32_t full = full0 + 8 * s, stage = base_s + s * S::STAGE;
      mbar_wait(empty0 + 8 * s, ((it / S::STAGES) & 1) ^ 1);
      const int r0 = r_begin + it * BR;
      const int run0 = r0 / args.s_out;
      const int runs =
          GATHER ? (min(r0 + BR, r_end) - 1) / args.s_out - run0 + 1 : 1;
      const int a_box = GATHER ? args.box_rows * 128 : BLOCK;
      mbar_expect_tx(full, g_blocks * BLOCK + a_blocks * runs * a_box);
      for (int j = 0; j < g_blocks; ++j)
        tma_load(stage + A_BLOCKS * S::A_BLOCK + j * BLOCK, &map_g, full,
                 n0 + COLS * j, r0);
      for (int j = 0; j < a_blocks; ++j) {
        int col;
        const int p = piece_at(args, k0 + COLS * j, col);
        const CUtensorMap* ma =
            p == 0 ? &map_a0 : (p == 1 ? &map_a1 : &map_a2);
        if (GATHER) {
          for (int u = 0; u < runs; ++u)
            tma_load3(stage + j * S::A_BLOCK + u * a_box, ma, full, col,
                      u ? 0 : r0 - run0 * args.s_out, run0 + u);
        } else {
          tma_load(stage + j * BLOCK, ma, full, col, r0 + pick(args.a_off, p));
        }
      }
    }
  } else {
    // ---- consumer warpgroups: dW rows k0 + 64 wg .. + 63 -----------------
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(CONSUMER_REGS));
    const int warp = tid / 32, lane = tid % 32;
    // The split: thread (warp, lane) takes chunk q = lane % 8 (4 floats) of
    // row cr of every block. A warp's four rows are r, r + 4, r + 1, r + 5
    // (+ 2 for odd warps) of their 8, so that its 8-byte stores of four
    // rows fall in both halves of the swizzled 128-byte rows: no bank
    // conflicts on either side.
    const int q = lane % 8, r4 = lane / 8;
    const int cr = 8 * (warp / 2) + 4 * (r4 % 2) + r4 / 2 + 2 * (warp % 2);
    const int sw_off = cr * 128 + (q % 2) * 8;
    // Blocks and columns past the pieces or N keep the zeros written here.
    for (int o = tid * 16; o < 2 * S::BUF; o += 256 * 16)
      *reinterpret_cast<uint4*>(base + S::BUFS + o) = make_uint4(0, 0, 0, 0);
    bool a_ok[A_BLOCKS];
#pragma unroll
    for (int j = 0; j < A_BLOCKS; ++j)
      a_ok[j] = k0 + COLS * j < args.pad_total;
    float acc[BN / 2];
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    consumers_sync();

    // Block j of the staged slab into the atom at `atom`, as its column
    // half h (0: values 0-31 of the atom's 64, 1: 32-63).
    auto split_block = [&](const unsigned char* block, int row,
                           unsigned char* atom, int h) {
      const float4 v =
          *reinterpret_cast<const float4*>(block + row * 128 + q * 16);
      uint2 hi, lo;
      split4(v, hi, lo);
      const int o = sw_off + (((4 * h + q / 2) ^ (cr % 8)) * 16);
      *reinterpret_cast<uint2*>(atom + o) = hi;
      if constexpr (S::LO) *reinterpret_cast<uint2*>(atom + S::HALF + o) = lo;
    };
    for (int it = 0; it < slabs; ++it) {
      const int s = it % S::STAGES;
      // Row cr of the slab in the staged A blocks: gathered, row
      // m - j0 of the first run's region or row j of a later run's (rows
      // past the split read its last row: G's rows there are zeros).
      int a_row = cr;
      if (GATHER) {
        const int r0 = r_begin + it * BR, m = min(r0 + cr, r_end - 1);
        const int run = m / args.s_out - r0 / args.s_out;
        a_row = run * args.box_rows + m % args.s_out -
                (run ? 0 : r0 % args.s_out);
      }
      mbar_wait(full0 + 8 * s, (it / S::STAGES) & 1);
      const unsigned char* stage = base + s * S::STAGE;
      unsigned char* buf = base + S::BUFS + (it % 2) * S::BUF;
#pragma unroll
      for (int j = 0; j < A_BLOCKS; ++j)
        if (a_ok[j])
          split_block(stage + j * S::A_BLOCK, a_row, buf + (j / 2) * ATOM,
                      j % 2);
#pragma unroll
      for (int j = 0; j < S::G_BLOCKS; ++j)
        if (j < g_blocks)
          split_block(stage + A_BLOCKS * S::A_BLOCK + j * BLOCK, cr,
                      buf + (2 + j / 2) * ATOM, j % 2);
      __syncwarp();
      if (lane == 0) mbar_arrive(empty0 + 8 * s);
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      consumers_sync();
      // Both warpgroups' wgmmas on this buffer; the other one's retire.
      const uint32_t a_hi = base_s + S::BUFS + (it % 2) * S::BUF + wg * ATOM;
      const uint32_t g_hi = base_s + S::BUFS + (it % 2) * S::BUF + 2 * ATOM;
      asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
      for (int ks = 0; ks < 2; ++ks) {
        const uint64_t da = desc_mn_sw128(a_hi + ks * STEP);
        const uint64_t db = desc_mn_sw128(g_hi + ks * STEP);
        wgmma<BN>(acc, da, db);
        if constexpr (S::LO) {
          wgmma<BN>(acc, da, desc_mn_sw128(g_hi + S::HALF + ks * STEP));
          wgmma<BN>(acc, desc_mn_sw128(a_hi + S::HALF + ks * STEP), db);
        }
      }
      asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
      asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
      consumers_sync();
    }
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");

    // Accumulator 4j + 2h + e holds the tile's row 64 wg + 16 (warp % 4) +
    // lane / 4 + 8h, column 8j + 2 (lane % 4) + e.
    float* dst = args.dst + (long long)blockIdx.y * args.k_total * args.n;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int kp = k0 + 64 * wg + 16 * (warp % 4) + lane / 4 + 8 * h;
      if (kp >= args.pad_total) continue;
      int col;
      const int p = piece_at(args, kp, col);
      if (col >= pick(args.k, p)) continue;
      float* row = dst + (long long)(pick(args.out_row, p) + col) * args.n;
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        const int c = n0 + 8 * j + 2 * (lane % 4);
        if (c < args.n)
          *reinterpret_cast<float2*>(row + c) =
              make_float2(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
      }
    }
  }
}

// cuTensorMapEncodeTiled from the driver through the runtime, so that the
// library needs no link against libcuda.
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                            cudaEnableDefault, &q);
#endif
    if (e != cudaSuccess || q != cudaDriverEntryPointSuccess) return nullptr;
    fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A tensor map of a row-major (rows, cols) float32 matrix in boxes of 32
// rows x 32 columns, unswizzled; out-of-bounds elements read as zero.
bool encode(CUtensorMap* map, const void* base, long long rows,
            long long cols) {
  EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)(cols * 4)};
  const cuuint32_t box[2] = {(cuuint32_t)COLS, (cuuint32_t)BR};
  const cuuint32_t unit[2] = {1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, const_cast<void*>(base),
            dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// The 3D map of piece a's rows through the row map: (cols, s_out rows of a
// run, runs), a run every a_s_in rows from row a_off, in boxes of
// box_rows rows x 32 columns of one run.
bool encode_runs(CUtensorMap* map, const float* a, int cols, int a_off,
                 int s_out, int a_s_in, int runs, int box_rows) {
  EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[3] = {(cuuint64_t)cols, (cuuint64_t)s_out,
                              (cuuint64_t)runs};
  const cuuint64_t strides[2] = {(cuuint64_t)cols * 4,
                                 (cuuint64_t)a_s_in * cols * 4};
  const cuuint32_t box[3] = {(cuuint32_t)COLS, (cuuint32_t)box_rows, 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3,
            const_cast<float*>(a + (long long)a_off * cols), dims, strides,
            box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int TIER, int BN, bool GATHER>
int launch(const Args& args, const CUtensorMap (&ma)[MAX_PIECES],
           const CUtensorMap& mg, int tiles, int splits, float* ws,
           float* out, cudaStream_t stream) {
  using S = Smem<TIER, BN, GATHER>;
  cudaError_t e = cudaFuncSetAttribute(
      wgrad_kernel<TIER, BN, GATHER>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, S::BYTES);
  if (e != cudaSuccess) return static_cast<int>(e);
  wgrad_kernel<TIER, BN, GATHER>
      <<<dim3(tiles, splits), THREADS, S::BYTES, stream>>>(
      args, ma[0], ma[1], ma[2], mg);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  return sum_slices(ws, out, (long long)args.k_total * args.n, splits, false,
                    stream);
}

template <int TIER, bool GATHER>
int launch_bn(int bn, const Args& args, const CUtensorMap (&ma)[MAX_PIECES],
              const CUtensorMap& mg, int tiles, int splits, float* ws,
              float* out, cudaStream_t stream) {
  switch (bn) {
    case 64: return launch<TIER, 64, GATHER>(args, ma, mg, tiles, splits,
                                             ws, out, stream);
    case 128: return launch<TIER, 128, GATHER>(args, ma, mg, tiles, splits,
                                               ws, out, stream);
    default: return launch<TIER, 256, GATHER>(args, ma, mg, tiles, splits,
                                              ws, out, stream);
  }
}

// The rows of a gathered A block that a slab of BR rows needs at a run
// length of s_out: the most runs it can meet, box_rows rows each.
int gather_rows(int s_out) {
  const int box = s_out < 32 ? s_out : 32;
  return box * ((s_out - 1 + BR + s_out - 1) / s_out);
}

}  // namespace hopper

// ==========================================================================
// smallk: sum K_p <= 16, CUDA-core FMAs on the split values.
// ==========================================================================
namespace smallk {

constexpr int THREADS = 256;
// Rows of G in flight a thread: 4 at K_total <= 6 (two blocks an SM,
// 128 registers a thread), 2 above (one block an SM).
template <int KMAX>
constexpr int UNROLL = KMAX <= 6 ? 4 : 2;

struct Args {
  const float* a[MAX_PIECES];
  int k[MAX_PIECES];
  int a_off[MAX_PIECES];
  int npieces;
  const float* g;
  int m, n;
  int s_out, a_s_in;
  int chunk;                  // rows a split
  int k_total;                // rows of dW
  float* dst;                 // the output, or the workspace's slices
};

__device__ __forceinline__ void split(float x, float& hi, float& lo) {
  hi = __bfloat162float(__float2bfloat16_rn(x));
  lo = __bfloat162float(__float2bfloat16_rn(x - hi));
}

// Thread t: columns 4c .. 4c + 3 (c = t % (N / 4)) of every dW row, over
// the rows r_begin + rl, + R, + 2R, ... of the block's split (rl = t / (N /
// 4), R = 256 / (N / 4)), in that order, each row's terms added as
// fma(ah, gh), then at "high" fma(ah, gl), fma(al, gh). KMAX >= K_total.
template <int TIER, int KMAX>
__global__ void __launch_bounds__(THREADS, KMAX <= 6 ? 2 : 1)
wgrad_smallk_kernel(const Args args) {
  constexpr bool LO = TIER == 3;
  extern __shared__ float part[];   // [R][K_total][N]
  const int n = args.n, kt = args.k_total;
  const int tpr = n / 4, rows = THREADS / tpr;
  const int t = threadIdx.x, c = t % tpr, rl = t / tpr;
  const int r_begin = blockIdx.x * args.chunk;
  const int r_end = min(args.m, r_begin + args.chunk);
  // Row k of dW: piece p's column, as a base pointer and a row stride.
  const float* kp[KMAX];
  int ks[KMAX];
#pragma unroll
  for (int k = 0, p = 0, k_p = 0; k < KMAX; ++k) {
    while (p + 1 < args.npieces && k - k_p >= pick(args.k, p)) k_p += pick(args.k, p++);
    ks[k] = pick(args.k, p);
    kp[k] = pick(args.a, p) + (long long)pick(args.a_off, p) * ks[k] + (k - k_p);
  }
  float acc[KMAX][4];
#pragma unroll
  for (int k = 0; k < KMAX; ++k)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[k][e] = 0.f;
  if (rl < rows) {
    for (int r = r_begin + rl; r < r_end; r += UNROLL<KMAX> * rows) {
      float4 gv[UNROLL<KMAX>];
      float av[UNROLL<KMAX>][KMAX];
#pragma unroll
      for (int u = 0; u < UNROLL<KMAX>; ++u) {
        const int ru = r + u * rows;
        const bool ok = ru < r_end;
        gv[u] = ok ? __ldg(reinterpret_cast<const float4*>(
                              args.g + (long long)ru * n) + c)
                   : make_float4(0.f, 0.f, 0.f, 0.f);
        const long long in = ok ? map_row(ru, args.s_out, args.a_s_in) : 0;
#pragma unroll
        for (int k = 0; k < KMAX; ++k)
          av[u][k] = ok && k < kt ? __ldg(kp[k] + in * ks[k]) : 0.f;
      }
#pragma unroll
      for (int u = 0; u < UNROLL<KMAX>; ++u) {
        const float g4[4] = {gv[u].x, gv[u].y, gv[u].z, gv[u].w};
        float gh[4], gl[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) split(g4[e], gh[e], gl[e]);
#pragma unroll
        for (int k = 0; k < KMAX; ++k) {
          float ah, al;
          split(av[u][k], ah, al);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            acc[k][e] = fmaf(ah, gh[e], acc[k][e]);
            if (LO) {
              acc[k][e] = fmaf(ah, gl[e], acc[k][e]);
              acc[k][e] = fmaf(al, gh[e], acc[k][e]);
            }
          }
        }
      }
    }
#pragma unroll
    for (int k = 0; k < KMAX; ++k)
      if (k < kt)
        *reinterpret_cast<float4*>(part + ((long long)rl * kt + k) * n +
                                   4 * c) =
            make_float4(acc[k][0], acc[k][1], acc[k][2], acc[k][3]);
  }
  __syncthreads();
  // The block's sum of its R partial sums, in order, into its slice.
  float* dst = args.dst + (long long)blockIdx.x * kt * n;
  for (int i = t; i < kt * n; i += THREADS) {
    float s = part[i];
    for (int j = 1; j < rows; ++j) s += part[(long long)j * kt * n + i];
    dst[i] = s;
  }
}

template <int TIER, int KMAX>
int launch(const Args& args, int splits, float* ws, float* out,
           cudaStream_t stream) {
  const int smem = (THREADS / (args.n / 4)) * args.k_total * args.n * 4;
  cudaError_t e = cudaFuncSetAttribute(
      wgrad_smallk_kernel<TIER, KMAX>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  wgrad_smallk_kernel<TIER, KMAX><<<splits, THREADS, smem, stream>>>(args);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  return sum_slices(ws, out, (long long)args.k_total * args.n, splits, true,
                    stream);
}

}  // namespace smallk

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

}  // namespace

extern "C" {

// The general instantiation. dW (K_0 + .. + K_{npieces-1}, n) float32,
// row-major, of `tier` (0 default, 3 high) on `stream`: piece p's rows are
// A_p^T G over the row map, A_p (rows_p, K_p) and G (m, n) float32,
// row-major. Rows are split `splits` ways, `chunk` rows each (a multiple of
// 32; splits * chunk >= m): with splits > 1, `ws` holds splits x K_total x
// n floats. Returns cudaGetLastError() after the launches, or
// cudaErrorInvalidValue with no launch for another tier, a piece count
// outside 1-3, an empty shape or a split that does not cover the rows.
int gemm_wgrad(const void* a0, int k0, int off0, const void* a1, int k1,
               int off1, const void* a2, int k2, int off2, int npieces,
               const void* g, int m, int n, int s_out, int a_s_in,
               void* ws, int splits, int chunk, void* out, void* stream,
               int tier) {
  using namespace general;
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

// The wgmma instantiation, the same function: piece p's a_p (rows_p, K_p)
// and its row offset; the output tile's width `bn` (64, 128 or 256); the
// rows split `splits` ways, `chunk` rows each, a multiple of 32, into `ws`
// as gemm_wgrad's. Returns cudaErrorInvalidValue with no launch where the
// operands break the instantiation's rule (K_p and N multiples of 8, a_p,
// g, ws and out 16-byte aligned) or a tensor map cannot be encoded.
int gemm_wgrad_hopper(const void* a0, int k0, int rows0, int off0,
                      const void* a1, int k1, int rows1, int off1,
                      const void* a2, int k2, int rows2, int off2,
                      int npieces, const void* g, int m, int n, int s_out,
                      int a_s_in, void* ws, int splits, int chunk, void* out,
                      void* stream, int tier, int bn) {
  using namespace hopper;
  if (npieces < 1 || npieces > MAX_PIECES || (tier != 0 && tier != 3) ||
      (bn != 64 && bn != 128 && bn != 256) || m < 1 || n < 1 || n % 8 != 0 ||
      s_out < 1 || m % s_out != 0 || splits < 1 || chunk < BR ||
      chunk % BR != 0 || (long long)splits * chunk < m ||
      (splits > 1 && (ws == nullptr || !aligned16(ws))) || out == nullptr ||
      !aligned16(out) || g == nullptr || !aligned16(g))
    return static_cast<int>(cudaErrorInvalidValue);
  Args args = {};
  const void* as[MAX_PIECES] = {a0, a1, a2};
  const int ks[MAX_PIECES] = {k0, k1, k2};
  const int rows[MAX_PIECES] = {rows0, rows1, rows2};
  const int offs[MAX_PIECES] = {off0, off1, off2};
  args.gather = s_out != a_s_in;
  args.box_rows = s_out < 32 ? s_out : 32;
  if (args.gather && gather_rows(s_out) > GATHER_ROWS)
    return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap ma[MAX_PIECES] = {}, mg = {};
  int pad = 0, row = 0;
  for (int p = 0; p < MAX_PIECES; ++p) {
    if (p < npieces) {
      if (as[p] == nullptr || ks[p] < 1 || ks[p] % 8 != 0 ||
          !aligned16(as[p]) ||
          !(args.gather
                ? encode_runs(&ma[p], static_cast<const float*>(as[p]),
                              ks[p], offs[p], s_out, a_s_in, m / s_out,
                              args.box_rows)
                : encode(&ma[p], as[p], rows[p], ks[p])))
        return static_cast<int>(cudaErrorInvalidValue);
      args.a[p] = static_cast<const float*>(as[p]);
      args.k[p] = ks[p];
      args.a_off[p] = offs[p];
      args.out_row[p] = row;
      pad += (ks[p] + COLS - 1) / COLS * COLS;
      row += ks[p];
    }
    args.pad_end[p] = pad;
  }
  if (!encode(&mg, g, m, n)) return static_cast<int>(cudaErrorInvalidValue);
  args.pad_total = pad;
  args.m = m;
  args.n = n;
  args.s_out = s_out;
  args.a_s_in = a_s_in;
  args.chunk = chunk;
  args.k_total = row;
  args.tiles_n = (n + bn - 1) / bn;
  float* w = static_cast<float*>(ws);
  float* o = static_cast<float*>(out);
  args.dst = splits > 1 ? w : o;
  const int tiles = (pad + BK - 1) / BK * args.tiles_n;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (args.gather)
    return tier == 0
        ? launch_bn<0, true>(bn, args, ma, mg, tiles, splits, w, o, s)
        : launch_bn<3, true>(bn, args, ma, mg, tiles, splits, w, o, s);
  return tier == 0
      ? launch_bn<0, false>(bn, args, ma, mg, tiles, splits, w, o, s)
      : launch_bn<3, false>(bn, args, ma, mg, tiles, splits, w, o, s);
}

// The smallk instantiation, the same function with gemm_wgrad's arguments:
// the sum of K_p from 1 to 16, N a multiple of 4 up to 1024, g 16-byte
// aligned; any chunk (splits * chunk >= m), the slices summed a warp an
// element. Returns cudaErrorInvalidValue with no launch otherwise.
int gemm_wgrad_smallk(const void* a0, int k0, int off0, const void* a1,
                      int k1, int off1, const void* a2, int k2, int off2,
                      int npieces, const void* g, int m, int n, int s_out,
                      int a_s_in, void* ws, int splits, int chunk, void* out,
                      void* stream, int tier) {
  using namespace smallk;
  if (npieces < 1 || npieces > MAX_PIECES || (tier != 0 && tier != 3) ||
      m < 1 || n < 4 || n % 4 != 0 || n > 4 * THREADS || s_out < 1 ||
      splits < 1 || chunk < 1 || (long long)splits * chunk < m ||
      (splits > 1 && ws == nullptr) || out == nullptr || g == nullptr ||
      !aligned16(g))
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
    row += ks[p];
  }
  if (row > 16) return static_cast<int>(cudaErrorInvalidValue);
  args.npieces = npieces;
  args.g = static_cast<const float*>(g);
  args.m = m;
  args.n = n;
  args.s_out = s_out;
  args.a_s_in = a_s_in;
  args.chunk = chunk;
  args.k_total = row;
  float* w = static_cast<float*>(ws);
  float* o = static_cast<float*>(out);
  args.dst = splits > 1 ? w : o;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (row <= 6)
    return tier == 0 ? launch<0, 6>(args, splits, w, o, s)
                     : launch<3, 6>(args, splits, w, o, s);
  return tier == 0 ? launch<0, 16>(args, splits, w, o, s)
                   : launch<3, 16>(args, splits, w, o, s);
}

const char* error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
