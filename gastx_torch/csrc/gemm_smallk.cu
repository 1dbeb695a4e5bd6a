// gemm_epilogue's function for GEMMs whose K is tiny, on the CUDA cores of
// sm_90a, at "highest" and at every bf16 precision tier.
//
// Replaces, on the card, the level-0 expand conv that the TPU computes
// inside `fused_level0` (gastx/ops/pallas/fused_level.py:194, its taps in
// `_kernel_level`, :82-87, init_bn folded into the weights): three taps of
// K = 2 (x, y of every joint) into N = C = 128 / 64 / 32 channels at the
// 27f / 81f / 243f models, then BN and ReLU. It computes
//
//   out[r, n] = epi( sum_p sum_k A_p[in_row(r, p), k] * W_p[k, n] )
//
// with the arguments and row map of gemm_epilogue.cu (up to three pieces,
// in_row(r, p) = (r / s_out) * a_s_in + r % s_out + a_off[p]; the
// epilogue * scale + shift, ReLU, + res[res_row(r)]), for float32 A
// pieces, residual and output, sum of K_p from 1 to 16, N a multiple of 4,
// res and out 16-byte aligned (kernels.smallk_ok; the C entry point
// refuses anything else).
//
// Bound on this card: 2 M N K_total operations (0.67 GFLOP at 27f, B=1024
// windows, M = 435,200: 10 us of CUDA-core FMA) against the float32 output
// (223 MB there) and the input once (the three taps read one 3.8 MB tensor
// at row offsets): device-memory bytes bound it, the stores above all
// (68 us at 3.35 TB/s).
//
// What held the tiled GEMMs back at this shape, and what this design does
// about each:
//   * gemm_epilogue.cu's general body and gemm_tc.cu's mma.sync body pad
//     every piece to a full slab (BK = 16, 32): 6 real k cost 48 or 96 k
//     of FMAs or MMAs on zeros, and three pipeline rounds a tile, each
//     with a barrier. Here there is no slab and no barrier: each thread
//     walks its rows, reads the K_total values of a row through the row
//     map (8 bytes a tap at K = 2; a warp's lanes share a row, from L1)
//     and does K_total FMAs a column;
//   * gemm_tc.cu's general body restaged its 32 x 128 W slab with scalar,
//     bounds-checked loads for every 128-row tile, and its wrapper split W
//     into bf16 halves on the host's stream at every launch. Here a
//     thread's four columns never change while it walks its rows, so it
//     loads its K_total x 4 weights, scale and shift into registers once
//     and rounds W there to the tier's operand (below); the wrapper passes
//     W as float32;
//   * both tiled epilogues stored scalars in the general bodies. Here a
//     thread owns one float4 of output columns of a row, so a warp stores
//     512 contiguous bytes a row at N = 128 (two rows at N = 64, four at
//     N = 32: 128 contiguous float4 in every case), 16 bytes a lane;
//   * the 128-wide tiles computed 2x and 4x the columns they stored at N =
//     64 and 32 (the 81f and 243f models). Here threads map onto the
//     output's float4 columns and nothing is computed and thrown away;
//   * persistent blocks (as many as fit on the SMs, fewer where the rows
//     run out: a streaming push's 17-459 rows take a few blocks and no
//     tile padding).
// With those gone the loop is issue- and latency-bound more than
// store-bound (cut builds, scripts/torch_gemm_tc.py --smallk, NVIDIA H100
// 80GB HBM3, 700.00 W: with its stores cut out, a first version took as
// long as with them, and this one 71-79% of its time at "highest" and all
// of it at "high"), so the rest of the design counts instructions:
//   * each A value's address is one wide multiply-add: rows and their
//     offsets are 32-bit unsigned, and the host hands each k its A column
//     in bytes and a byte stride (a first version's 64-bit products and
//     guards took ~15 instructions a load and ran at half the bound);
//     rows past m read row 0 and k past K_total read A's first element,
//     zeroed, so no load is predicated;
//   * ROWS = 4 rows an iteration, all their loads issued before the
//     first is used (2 or 8 rows, and loading the next rows ahead, were
//     slower: more registers, fewer warps);
//   * evict-first stores (`st.global.cs`): the output is written once and
//     read by the next kernel. At 27f B=1024, `highest`, 0.0752 ms against
//     plain `st.global`'s 0.1028 (81f B=1024: 0.129 / 0.161; 243f B=256:
//     0.049 / 0.064; `high` at 27f B=256, where the output fits in L2:
//     0.0263 / 0.0290). Inside the 27f B=256 forward (scripts/
//     torch_gemm_tc.py --stores) plain stores were no faster, and GAB 0's
//     projection, the next reader, read the output no faster after them
//     (plain / evict-first, median ms on an H100 80GB HBM3 at 700 W:
//     0.6247 / 0.6244 at "highest", 0.2565 / 0.2518 at "high").
//
// Arithmetic by tier (a template parameter: one instantiation a tier, no
// tier branch in the loop; codes as joint_attention.cu's: 0 highest, 1
// default, 2 high_lhs, 3 high_rhs, 4 high). With q1(x) = bf16(x) and
// q2(x) = q1(x) + q1(x - q1(x)) (x kept to 16 bits), lo(x) = q1(x - q1(x)),
// each tier is its operands rounded as they are loaded and float32 FMAs:
// highest a w; default q1(a) q1(w); high_lhs q2(a) q1(w); high_rhs q1(a)
// q2(w); high q2(a) q1(w) + q1(a) lo(w). Each product is the sum of kdot's
// bf16 passes over that element (gastx/ops/pallas/precision.py:99: ah wh
// + al wh + ah wl at high), taken exactly inside the FMA, so the result
// differs from the passes of gemm_tc's mma only in the order of the
// float32 sums, as joint_attention's tiers do. At "highest" a thread runs
// one fmaf chain from 0 in gemm_epilogue.cu's order (piece by piece, k
// ascending; its padded zeros add exact zeros), then its epilogue
// expression by expression, so the float32 output is bitwise
// gemm_epilogue's. (q1 in integer instructions in place of the F2F
// conversion was slower at the rounding tiers: more registers.)
//
// A second template parameter sizes the register arrays of the weights
// and a row's A values: KMAX = 6 where K_total <= 6 (the expand conv's
// three taps of 2) and 16 for the rest of the shape rule, so that the
// main path's instantiation keeps its registers (126 at "high") and the
// larger K does not spill.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int MAX_PIECES = 3;
constexpr int MAX_K = 16;     // the shape rule's largest sum of K_p
constexpr int MAX_Q = THREADS;  // float4 columns of one column chunk
constexpr int ROWS = 4;         // rows a thread computes an iteration
constexpr int HIGHEST = 0, HIGH_RHS = 3, HIGH = 4;

// The pieces flattened: for each k of the K_total, A's column k (the
// piece's A shifted by a_off * K_p + k, in bytes) and the bytes from one
// row of A to the next (4 K_p), and W's row k. Slots past K_total read
// A's first element (stride 0) and are zeroed in the kernel.
struct SmallKArgs {
  const char* a[MAX_K];
  unsigned a_stride[MAX_K];
  const float* w[MAX_K];
  int kt;
  int m, n;
  int s_out, a_s_in, res_s_in;
  const float* scale;
  const float* shift;
  int relu;
  const float* res;
  int res_off;
  float* out;
};

__device__ __forceinline__ float q1(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}
// x rounded: mode 0 exact, 1 q1, 2 q2.
__device__ __forceinline__ float rnd(float x, int mode) {
  if (mode == 0) return x;
  const float h = q1(x);
  return mode == 1 ? h : h + q1(x - h);
}
__device__ __forceinline__ float lo(float x) { return q1(x - q1(x)); }
// The rounding of a tier's lhs (A) and rhs (W) operand in its first term.
__host__ __device__ constexpr int lhs_mode(int tier) {
  return tier == HIGHEST ? 0 : (tier == 2 || tier == HIGH ? 2 : 1);
}
__host__ __device__ constexpr int rhs_mode(int tier) {
  return tier == HIGHEST ? 0 : (tier == HIGH_RHS ? 2 : 1);
}

__device__ __forceinline__ void store4(float* p, float4 v) {
  __stcs(reinterpret_cast<float4*>(p), v);
}

// Grid (persistent blocks, column chunks of MAX_Q float4); THREADS
// threads. Thread t of a chunk of nq float4 columns owns float4 column
// t % nq of rows t / nq + rpb * (blockIdx.x + gridDim.x * i), rpb =
// THREADS / nq rows a block (threads past rpb * nq idle); each iteration
// takes ROWS such rows. Rows and their offsets are 32-bit unsigned (m <
// 2^31), so an address is one wide multiply-add.
template <int TIER, int KMAX>
__global__ void __launch_bounds__(THREADS)
gemm_smallk_kernel(const SmallKArgs args, int q_total) {
  constexpr int LHS = lhs_mode(TIER);
  constexpr int RHS = rhs_mode(TIER);
  const int q0 = blockIdx.y * MAX_Q;
  const int nq = min(q_total - q0, MAX_Q);
  const unsigned rpb = THREADS / nq;
  const unsigned lane_row = threadIdx.x / nq;
  if (lane_row >= rpb) return;
  const int c = 4 * (q0 + threadIdx.x % nq);
  const unsigned m = args.m, n = args.n;
  const int kt = args.kt, s_out = args.s_out;

  // This thread's weights, rounded to the tier's rhs operand (and lo(w),
  // the second term of "high"), scale and shift: loaded once.
  float w1[KMAX][4], w2[KMAX][4];
#pragma unroll
  for (int k = 0; k < KMAX; ++k)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float w = k < kt ? __ldg(args.w[k] + c + j) : 0.f;
      w1[k][j] = rnd(w, RHS);
      w2[k][j] = TIER == HIGH ? lo(w) : 0.f;
    }
  float sc[4], sh[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    sc[j] = args.scale ? __ldg(args.scale + c + j) : 1.f;
    sh[j] = args.scale ? __ldg(args.shift + c + j) : 0.f;
  }
  float* const out_c = args.out + c;
  const float* const res_c = args.res ? args.res + c : nullptr;

  // ROWS rows an iteration, row_step apart, each r = s * s_out + q; each
  // advances by ROWS row_step.
  const unsigned row_step = gridDim.x * rpb;
  const unsigned step = ROWS * row_step;
  const int step_s = (int)(step / s_out);
  const int step_q = (int)(step % s_out);
  unsigned r[ROWS];
  int s[ROWS], q[ROWS];
#pragma unroll
  for (int u = 0; u < ROWS; ++u) {
    r[u] = blockIdx.x * rpb + lane_row + u * row_step;
    s[u] = (int)(r[u] / s_out);
    q[u] = (int)(r[u] - (unsigned)s[u] * s_out);
  }

  while (r[0] < m) {
    // Every row's A values first (a row past m reads row 0), then each
    // row's product, epilogue and store.
    float av[ROWS][KMAX];
#pragma unroll
    for (int u = 0; u < ROWS; ++u) {
      const unsigned in_row =
          r[u] < m ? (unsigned)(s[u] * args.a_s_in + q[u]) : 0u;
#pragma unroll
      for (int k = 0; k < KMAX; ++k) {
        const float x = __ldg(reinterpret_cast<const float*>(
            args.a[k] + (size_t)in_row * args.a_stride[k]));
        av[u][k] = k < kt ? x : 0.f;
      }
    }
#pragma unroll
    for (int u = 0; u < ROWS; ++u) {
      if (r[u] >= m) break;
      float acc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int k = 0; k < KMAX; ++k) {
        const float a1 = rnd(av[u][k], LHS);
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[j] = fmaf(a1, w1[k][j], acc[j]);
        if constexpr (TIER == HIGH) {
          const float a2 = q1(av[u][k]);
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[j] = fmaf(a2, w2[k][j], acc[j]);
        }
      }
      // Epilogue: * scale + shift, ReLU, + residual, in that order, each
      // as gemm_epilogue.cu writes it.
      float v[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        v[j] = acc[j];
        if (args.scale) v[j] = v[j] * sc[j] + sh[j];
        if (args.relu) v[j] = fmaxf(v[j], 0.f);
      }
      if (res_c) {
        const unsigned res_row =
            (unsigned)(s[u] * args.res_s_in + q[u] + args.res_off);
        const float4 rv = __ldg(reinterpret_cast<const float4*>(
            res_c + (size_t)res_row * n));
        v[0] += rv.x;
        v[1] += rv.y;
        v[2] += rv.z;
        v[3] += rv.w;
      }
      store4(out_c + (size_t)r[u] * n, make_float4(v[0], v[1], v[2], v[3]));
    }
#pragma unroll
    for (int u = 0; u < ROWS; ++u) {
      r[u] += step;
      s[u] += step_s;
      q[u] += step_q;
      if (q[u] >= s_out) {
        q[u] -= s_out;
        ++s[u];
      }
    }
  }
}

// Blocks of one instantiation that fit on an SM (cached).
template <int TIER, int KMAX>
int blocks_per_sm() {
  static int occ = 0;
  if (occ == 0 && cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                      &occ, gemm_smallk_kernel<TIER, KMAX>, THREADS, 0) !=
                      cudaSuccess)
    occ = 1;
  return occ > 0 ? occ : 1;
}

int sm_count() {
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  return sms > 0 ? sms : 1;
}

template <int TIER, int KMAX>
void launch(const SmallKArgs& args, cudaStream_t stream) {
  const int q_total = args.n / 4;
  const int chunks = (q_total + MAX_Q - 1) / MAX_Q;
  const int rpb = THREADS / (q_total < MAX_Q ? q_total : MAX_Q);
  const long long need = (args.m + (long long)rpb - 1) / rpb;
  long long fit = (long long)sm_count() * blocks_per_sm<TIER, KMAX>() / chunks;
  if (fit < 1) fit = 1;
  const dim3 grid((unsigned)(need < fit ? need : fit), (unsigned)chunks);
  gemm_smallk_kernel<TIER, KMAX><<<grid, THREADS, 0, stream>>>(args,
                                                               q_total);
}

template <int TIER>
void launch_tier(const SmallKArgs& args, cudaStream_t stream) {
  if (args.kt <= 6)
    launch<TIER, 6>(args, stream);
  else
    launch<TIER, 16>(args, stream);
}

}  // namespace

extern "C" {

// Launches the instantiation of `tier` (0 highest, 1 default, 2 high_lhs,
// 3 high_rhs, 4 high) on `stream`, gemm_epilogue's arguments otherwise;
// returns cudaGetLastError() after the launch, or cudaErrorInvalidValue,
// with no launch, where the shape rule does not hold (1 to 3 pieces, sum of
// K_p from 1 to 16, N a multiple of 4, res and out 16-byte aligned) or the
// tier is unknown.
int gemm_smallk(const void* a0, const void* w0, int k0, int off0,
                const void* a1, const void* w1, int k1, int off1,
                const void* a2, const void* w2, int k2, int off2,
                int npieces, int m, int n, int s_out, int a_s_in,
                int res_s_in, const void* scale, const void* shift, int relu,
                const void* res, int res_off, void* out, void* stream,
                int tier) {
  const void* as[MAX_PIECES] = {a0, a1, a2};
  const void* ws[MAX_PIECES] = {w0, w1, w2};
  const int ks[MAX_PIECES] = {k0, k1, k2};
  const int offs[MAX_PIECES] = {off0, off1, off2};
  if (npieces < 1 || npieces > MAX_PIECES || n % 4 != 0 || s_out < 1 ||
      tier < 0 || tier > HIGH ||
      reinterpret_cast<uintptr_t>(out) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(res) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  SmallKArgs args = {};
  int kt = 0;
  for (int p = 0; p < npieces; ++p) {
    if (ks[p] < 0 || kt + ks[p] > MAX_K)
      return static_cast<int>(cudaErrorInvalidValue);
    const float* a = static_cast<const float*>(as[p]);
    const float* w = static_cast<const float*>(ws[p]);
    for (int k = 0; k < ks[p]; ++k, ++kt) {
      args.a[kt] = reinterpret_cast<const char*>(
          a + (long long)offs[p] * ks[p] + k);
      args.a_stride[kt] = 4u * ks[p];
      args.w[kt] = w + (long long)k * n;
    }
  }
  if (kt == 0) return static_cast<int>(cudaErrorInvalidValue);
  for (int k = kt; k < MAX_K; ++k) args.a[k] = args.a[0];  // stride 0
  args.kt = kt;
  args.m = m;
  args.n = n;
  args.s_out = s_out;
  args.a_s_in = a_s_in;
  args.res_s_in = res_s_in;
  args.scale = static_cast<const float*>(scale);
  args.shift = static_cast<const float*>(shift);
  args.relu = relu;
  args.res = static_cast<const float*>(res);
  args.res_off = res_off;
  args.out = static_cast<float*>(out);
  if (m > 0 && n > 0) {
    const auto s = static_cast<cudaStream_t>(stream);
    switch (tier) {
      case 0: launch_tier<0>(args, s); break;
      case 1: launch_tier<1>(args, s); break;
      case 2: launch_tier<2>(args, s); break;
      case 3: launch_tier<3>(args, s); break;
      default: launch_tier<4>(args, s); break;
    }
  }
  return static_cast<int>(cudaGetLastError());
}

const char* error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
