// The gemm_epilogue function at the bf16 precision tiers, on the tensor
// cores of sm_90a.
//
// Replaces the same TPU dots as gemm_epilogue.cu (the projection, cat and
// concat dots of gastx/ops/pallas/fused_gab.py `_local_branch`,
// `_global_branch` and `_block_concat`, and the conv taps of
// gastx/ops/pallas/fused_level.py `_kernel_level`) where the model gives
// them a tier below "highest": the kernels' `kdot` (gastx/ops/pallas/
// precision.py:99, `kdot_general` :112), which computes a product as bf16
// passes on the TPU's matrix unit. With a = ah + al (ah = bf16(a),
// al = bf16(a - ah), both rounded to nearest even) and W = wh + wl likewise:
//
//   TIER 0 "default" (and "kdefault"):  ah.wh               one pass
//   TIER 1 "high_lhs":                  ah.wh + al.wh       two passes
//   TIER 2 "high_rhs":                  ah.wh + ah.wl       two passes
//   TIER 3 "high":                      ah.wh + ah.wl + al.wh
//
// each pass a product of bf16 operands into float32 accumulators (all
// passes into one accumulator). The function and its arguments are
// gemm_epilogue.cu's (see there): up to three pieces, the row map
// in_row(r, p) = (r / s_out) * a_s_in + r % s_out + a_off[p], the epilogue
// * scale + shift, ReLU, + res[res_row(r)].
//
// Bound on this card: 2MNK operations at 989 TFLOP/s a pass against the
// bytes of A (float32), W's bf16 halves and the float32 output at 3.35
// TB/s. At the 27f level-1 projection (M = 330,752, K = 256, N = 1792) the
// output is 2.37 of the 2.71 GB, so one and two passes are byte-bound
// (0.81 ms) and three passes are at the ridge (0.92 ms by operations).
//
// Two instantiations a tier, picked by the wrapper from the operands
// (kernels.tc_variant):
//
// * vec16 (every K_p a multiple of 4, N a multiple of 8, a_p and res
//   16-byte aligned): a persistent, warp-specialised wgmma kernel.
//   - One block of three warpgroups an SM (grid = min(tiles, SMs)); each
//     walks 128 x 256 output tiles, m-band by m-band, so the band of A
//     that neighbouring tiles share stays in L2.
//   - Warpgroup 2 produces into a ring of slabs of BK = 32 k (4 at one W
//     half, 3 at two; a full and an empty mbarrier a slab, phases carried
//     across tiles). W arrives by TMA with 64-byte swizzle, the layout of
//     wgmma's K-major descriptor: the wrapper hands W^T, its bf16 halves as
//     (N, K_pad) of every piece, each piece padded to BK and every 16 k in
//     the order TC_K_ORDER (kernels.py, tc_weights). A arrives in
//     float32 as one 128-byte-swizzled box where the tile's rows are
//     contiguous in A (s_out == a_s_in: the 1x1 products), else by 16-byte
//     cp.async row gathers through the row map (the conv taps) into the
//     same swizzled layout.
//   - Warpgroups 0 and 1 consume, 64 rows each. Every thread reads its A
//     fragment as two float4 (TC_K_ORDER puts the fragment's k 2c, 2c+1,
//     2c+8, 2c+9 at A's 4c .. 4c+3; fragment row g is the tile's row
//     4 (g % 2) + g / 2 of its 8, so a quarter-warp's two rows lie in the
//     swizzle's two 64-byte halves: no bank conflicts), splits it into hi
//     and lo in registers, and issues wgmma.m64n256k16 with A from
//     registers, one a pass, against the slab's W descriptors. Two wgmma
//     groups stay in flight: the next slab's fragments are split while
//     this slab's wgmmas run, and a slab is released once its group has
//     retired.
//   - The epilogue applies scale/shift, ReLU and the residual gather in
//     registers, stages each 64 x 32 box of the warpgroup's rows in a
//     shared-memory slot (128-byte swizzle) and writes it by TMA store,
//     which clips rows >= m and columns >= n. The slots are used in turn
//     (6 a warpgroup at one W half, 5 at two, of a tile's 8); a slot is
//     rewritten only once the store that read it has read it, so the
//     stores drain while the next boxes and the next tile's loads and
//     wgmmas run.
//   - The output, 2.37 of the projection's 2.71 GB, is the main byte
//     stream; A's float32 band is read once from device memory and 7
//     times from L2 (N / 256), W's halves from L2.
// * general (anything else, e.g. the level-0 expand conv, K = 2 a tap):
//   a 128 x 128 tile a block, 8 warps of mma.sync.m16n8k16, BK = 32, two
//   buffers, A split as it is stored into shared memory, W's halves
//   (K_p, N) row-major per piece, scalar loads and stores.
//
// bf16 I/O (bf16 storage): bit p of `dtypes` makes piece p's A bf16, bit 3
// the residual and bit 4 the output (rounded to nearest even as stored).
// A bf16 A is its own hi half (its lo half is zero): general skips the
// A-lo pass of "high" and "high_lhs" for its slabs; vec16_bf16 multiplies
// the zeros (below). The flags are read at run time, in a library of its
// own (GASTX_BF16_IO, below), which holds both bodies; the float32
// library's code has no dtype branch.
// * vec16_bf16 (vec16's rule, with every bf16 K_p a multiple of 8): the
//   same persistent wgmma kernel with bf16 TMA boxes.
//   - A bf16 piece's slab is 128 rows x 32 k x 2 bytes, one TMA box with
//     64-byte swizzle (or 16-byte cp.async gathers of 8 k into the same
//     layout), half a float32 slab; each slab's expect_tx counts its own
//     bytes. The consumer reads it as it is: one 16-byte load a row
//     holds the thread's fragments of both k16 steps (k 8c .. 8c + 7,
//     which TC_K_ORDER_BF16 makes the fragment's k 2c, 2c+1, 2c+8, 2c+9
//     of step 0, then of step 1), with no split; its A-lo pass at "high"
//     and "high_lhs" multiplies zeros (a branch around that wgmma, though
//     uniform, makes ptxas serialize all of them). A stays in registers,
//     as for a float32 slab, so slabs of both dtypes feed
//     the same accumulators in one GEMM (the block concat's [x (bf16) |
//     local | global]): wgmma with A from shared memory would give the
//     accumulators the slab's row order, which the float32 slabs' float4
//     reads cannot keep without bank conflicts.
//   - Fragment row g is the tile's row (g / 2) ^ (5 (g % 2)) of its 8:
//     a quarter-warp's two rows then differ in bit 2 (the float32 slab's
//     128-byte swizzle) and in bit 0 (the bf16 slab's 64-byte rows), so
//     both slabs' loads are free of bank conflicts.
//   - The piece of a slab, hence its dtype, is uniform over the block:
//     the choice of load is a uniform branch.
//   - A bf16 residual is read as bf16 pairs; a bf16 output is rounded in
//     registers and staged as 64 x 64 boxes of 128-byte rows (the float32
//     slots' size and swizzle), stored by TMA.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

// GASTX_BF16_IO builds the bf16-I/O library (kernels.py, IO_SOURCES), whose
// code reads the dtype bits; the float32 library's has no dtype branch.
#ifdef GASTX_BF16_IO
constexpr bool BF16_IO = true;
#else
constexpr bool BF16_IO = false;
#endif

namespace {

constexpr int MAX_PIECES = 3;
// The dtype bits beyond the pieces' (bit p: A piece p bf16).
constexpr int RES_BF16 = 8;
constexpr int OUT_BF16 = 16;

template <int TIER>
struct Passes {
  static constexpr bool A_LO = TIER == 1 || TIER == 3;
  static constexpr bool B_LO = TIER == 2 || TIER == 3;
};

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

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

// The two bf16 halves of x, rounded to nearest even.
__device__ __forceinline__ void split(float x, __nv_bfloat16& hi,
                                      __nv_bfloat16& lo) {
  hi = __float2bfloat16_rn(x);
  lo = __float2bfloat16_rn(x - __bfloat162float(hi));
}

// ==========================================================================
// general: the mma.sync kernel, scalar loads and stores.
// ==========================================================================
namespace general {

constexpr int BM = 128;
constexpr int BN = 128;
constexpr int BK = 32;
constexpr int THREADS = 256;
constexpr int A_PITCH = BK + 8;   // halves of an A row in shared memory
constexpr int B_PITCH = BN + 8;   // halves of a W row (one k)
constexpr int A_HALVES = BM * A_PITCH;
constexpr int B_HALVES = BK * B_PITCH;
// A staging: thread t loads k-chunk t % 8 (4 k) of rows t / 8 + 32 i.
constexpr int A_CHUNKS = BK / 4;
constexpr int A_ROWS = BM * A_CHUNKS / THREADS;
constexpr int A_ROW_STEP = THREADS / A_CHUNKS;

struct GemmArgs {
  const void* a[MAX_PIECES];  // float32 or bf16 (dtypes bit p)
  const __nv_bfloat16* wh[MAX_PIECES];
  const __nv_bfloat16* wl[MAX_PIECES];
  int k[MAX_PIECES];
  int a_off[MAX_PIECES];
  int npieces;
  int m, n;
  int s_out, a_s_in, res_s_in;
  const float* scale;
  const float* shift;
  int relu;
  const void* res;  // float32 or bf16 (bit 3)
  int res_off;
  void* out;        // float32 or bf16 (bit 4)
  int dtypes;
};

// Element k of a float32 or bf16 row (`row` in bytes), as float32 (a bf16
// value exactly); `ldg` through the read-only path.
template <bool LDG>
__device__ __forceinline__ float load_at(const char* row, int k, bool bf) {
  const auto* h = reinterpret_cast<const unsigned short*>(row) + k;
  const auto* f = reinterpret_cast<const float*>(row) + k;
  if (bf)
    return __uint_as_float(static_cast<uint32_t>(LDG ? __ldg(h) : *h) << 16);
  return LDG ? __ldg(f) : *f;
}

template <int TIER>
struct Layout {
  using P = Passes<TIER>;
  // Halves of one buffer: A hi [, A lo], W hi [, W lo].
  static constexpr int STAGE =
      A_HALVES * (P::A_LO ? 2 : 1) + B_HALVES * (P::B_LO ? 2 : 1);
  static constexpr size_t SMEM = sizeof(__nv_bfloat16) * 2 * STAGE;
};

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4],
                                            uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
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

template <int TIER>
__global__ void __launch_bounds__(THREADS, 2)
gemm_tc_kernel(const GemmArgs args, int tiles_n) {
  using P = Passes<TIER>;
  using L = Layout<TIER>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* smem = reinterpret_cast<__nv_bfloat16*>(smem_raw);

  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int warp = tid / 32;
  const int row0 = (blockIdx.x / tiles_n) * BM;
  const int col0 = (blockIdx.x % tiles_n) * BN;
  const int m = args.m, n = args.n;

  // Buffer s: A hi, [A lo,] W hi, [W lo].
  auto a_hi = [&](int s) { return smem + s * L::STAGE; };
  auto a_lo = [&](int s) { return smem + s * L::STAGE + A_HALVES; };
  auto b_hi = [&](int s) {
    return smem + s * L::STAGE + A_HALVES * (P::A_LO ? 2 : 1);
  };
  auto b_lo = [&](int s) { return b_hi(s) + B_HALVES; };

  const int a_k = (tid % A_CHUNKS) * 4;
  int a_row[A_ROWS], a_base[A_ROWS];
#pragma unroll
  for (int i = 0; i < A_ROWS; ++i) {
    a_row[i] = tid / A_CHUNKS + A_ROW_STEP * i;
    const int r = row0 + a_row[i];
    a_base[i] = r < m ? (int)map_row(r, args.s_out, args.a_s_in) : -1;
  }

  // a_ptr[i]: row i's k 0 in the piece's A, in bytes (float32, or bf16
  // where a_bf).
  const char* a_ptr[A_ROWS];
  bool a_bf = false;
  const __nv_bfloat16* wh_ptr;
  const __nv_bfloat16* wl_ptr;
  int lp = 0, lk0 = 0, lK = 0;
  auto set_piece = [&](int p) {
    const char* A = static_cast<const char*>(pick(args.a, p));
    a_bf = BF16_IO && ((args.dtypes >> p) & 1);
    const int es = a_bf ? 2 : 4;
    lK = pick(args.k, p);
    const int off = pick(args.a_off, p);
#pragma unroll
    for (int i = 0; i < A_ROWS; ++i)
      a_ptr[i] = a_base[i] >= 0 ? A + (long long)(a_base[i] + off) * lK * es
                                : A;
    wh_ptr = pick(args.wh, p);
    wl_ptr = pick(args.wl, p);
  };
  set_piece(0);
  int total = 0;
  for (int p = 0; p < args.npieces; ++p)
    total += (pick(args.k, p) + BK - 1) / BK;

  float a_stage[A_ROWS][4];
  int a_slot = -1;
  // Bit s: buffer s holds a slab of a bf16 piece (its A lo half is zero).
  int bf_slots = 0;

  // W's halves of slab rows [lk0, lk0 + BK) into buffer `slot`.
  auto load_w = [&](int slot) {
    __nv_bfloat16* dst_h = b_hi(slot);
    __nv_bfloat16* dst_l = b_lo(slot);
    const __nv_bfloat16 zero = __float2bfloat16_rn(0.f);
    for (int idx = tid; idx < BK * BN; idx += THREADS) {
      const int kr = idx / BN;
      const int cc = idx % BN;
      const bool v = lk0 + kr < lK && col0 + cc < n;
      const long long off = (long long)(lk0 + kr) * n + col0 + cc;
      dst_h[kr * B_PITCH + cc] = v ? wh_ptr[off] : zero;
      if constexpr (P::B_LO) dst_l[kr * B_PITCH + cc] = v ? wl_ptr[off] : zero;
    }
  };

  // The next slab: A into registers (stored by store_a after the MMAs), W
  // into buffer `slot`; one commit group, empty past the last slab.
  auto load_slab = [&](int slot) {
    if (lp < args.npieces) {
#pragma unroll
      for (int i = 0; i < A_ROWS; ++i) {
        const int k = lk0 + a_k;
#pragma unroll
        for (int e = 0; e < 4; ++e)
          a_stage[i][e] = (a_base[i] >= 0 && k + e < lK)
              ? load_at<true>(a_ptr[i], k + e, a_bf) : 0.f;
      }
      a_slot = slot;
      if constexpr (BF16_IO)
        bf_slots = (bf_slots & ~(1 << slot)) | (int(a_bf) << slot);
      load_w(slot);
      lk0 += BK;
      if (lk0 >= lK) {
        lk0 = 0;
        if (++lp < args.npieces) set_piece(lp);
      }
    }
    cp_async_commit();
  };
  // The staged A, split into its halves, into its slot ([m][k]).
  auto store_a = [&]() {
    if (a_slot < 0) return;
    __nv_bfloat16* ah = a_hi(a_slot);
    __nv_bfloat16* al = a_lo(a_slot);
    const bool lo = P::A_LO && !(BF16_IO && ((bf_slots >> a_slot) & 1));
    a_slot = -1;
#pragma unroll
    for (int i = 0; i < A_ROWS; ++i) {
      __align__(8) __nv_bfloat16 h[4], l[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) split(a_stage[i][e], h[e], l[e]);
      const int o = a_row[i] * A_PITCH + a_k;
      *reinterpret_cast<uint2*>(ah + o) = *reinterpret_cast<uint2*>(h);
      if (lo)
        *reinterpret_cast<uint2*>(al + o) = *reinterpret_cast<uint2*>(l);
    }
  };

  // Warp (wm, wn) of a 2x4 grid owns rows wm*64 .. +63 and columns
  // wn*32 .. +31: 4 m16 tiles by 4 n8 tiles.
  const int wm = (warp / 4) * 64;
  const int wn = (warp % 4) * 32;
  float acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  // ldmatrix lane addresses: A matrices (m 0-7 | 8-15) x (k 0-7 | 8-15),
  // W matrices (k 0-7 | 8-15) x (n 0-7 | 8-15) of a pair of n8 tiles.
  const int q = lane / 8, r8 = lane % 8;
  const int a_lane = (wm + (q & 1) * 8 + r8) * A_PITCH + (q >> 1) * 8;
  const int b_lane = ((q & 1) * 8 + r8) * B_PITCH + wn + (q >> 1) * 8;

  load_slab(0);
  store_a();
  for (int t = 0; t < total; ++t) {
    cp_async_wait_all();
    __syncthreads();
    load_slab((t + 1) % 2);
    const int s = t % 2;
    const uint32_t ah = smem_addr(a_hi(s)), al = smem_addr(a_lo(s));
    const uint32_t bh = smem_addr(b_hi(s)), bl = smem_addr(b_lo(s));
    const bool a_lo_pass = P::A_LO && !(BF16_IO && ((bf_slots >> s) & 1));
#pragma unroll
    for (int ks = 0; ks < BK; ks += 16) {
      // W fragments of the four n8 tiles: [tile][k half].
      uint32_t wh[4][2], wl[4][2];
#pragma unroll
      for (int pair = 0; pair < 2; ++pair) {
        const uint32_t o = 2 * (b_lane + ks * B_PITCH + pair * 16);
        uint32_t r[4];
        ldmatrix_x4_trans(r, bh + o);
        wh[2 * pair][0] = r[0]; wh[2 * pair][1] = r[1];
        wh[2 * pair + 1][0] = r[2]; wh[2 * pair + 1][1] = r[3];
        if constexpr (P::B_LO) {
          ldmatrix_x4_trans(r, bl + o);
          wl[2 * pair][0] = r[0]; wl[2 * pair][1] = r[1];
          wl[2 * pair + 1][0] = r[2]; wl[2 * pair + 1][1] = r[3];
        }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const uint32_t o = 2 * (a_lane + i * 16 * A_PITCH + ks);
        uint32_t fa[4];
        ldmatrix_x4(fa, ah + o);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          mma(acc[i][j], fa, wh[j][0], wh[j][1]);
          if constexpr (P::B_LO) mma(acc[i][j], fa, wl[j][0], wl[j][1]);
        }
        if (a_lo_pass) {
          ldmatrix_x4(fa, al + o);
#pragma unroll
          for (int j = 0; j < 4; ++j) mma(acc[i][j], fa, wh[j][0], wh[j][1]);
        }
      }
    }
    store_a();
  }
  cp_async_wait_all();

  // Epilogue: lane holds rows g and g + 8 of each m16 tile, columns 2c and
  // 2c + 1 of each n8 tile.
  const int g = lane / 4, c2 = (lane % 4) * 2;
  const bool res_bf = BF16_IO && (args.dtypes & RES_BF16);
  const bool out_bf = BF16_IO && (args.dtypes & OUT_BF16);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int c = col0 + wn + j * 8 + c2;
    float sc[2], sh[2];
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const bool v = args.scale != nullptr && c + e < n;
      sc[e] = v ? args.scale[c + e] : 1.f;
      sh[e] = v ? args.shift[c + e] : 0.f;
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = row0 + wm + i * 16 + g + h * 8;
        if (r >= m) continue;
        float v[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          v[e] = acc[i][j][2 * h + e];
          if (args.scale) v[e] = v[e] * sc[e] + sh[e];
          if (args.relu) v[e] = fmaxf(v[e], 0.f);
        }
        // Row r's column 0 in the residual and output, in bytes.
        const char* res_row =
            args.res ? static_cast<const char*>(args.res) +
                           (map_row(r, args.s_out, args.res_s_in) +
                            args.res_off) * (long long)n * (res_bf ? 2 : 4)
                     : nullptr;
        char* out_row = static_cast<char*>(args.out) +
                        (long long)r * n * (out_bf ? 2 : 4);
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          if (c + e >= n) continue;
          const float y =
              res_row ? v[e] + load_at<false>(res_row, c + e, res_bf) : v[e];
          if (out_bf)
            reinterpret_cast<__nv_bfloat16*>(out_row)[c + e] =
                __float2bfloat16_rn(y);
          else
            reinterpret_cast<float*>(out_row)[c + e] = y;
        }
      }
  }
}

template <int TIER>
int launch(const GemmArgs& args, cudaStream_t stream) {
  using L = Layout<TIER>;
  for (int p = 0; p < args.npieces; ++p)
    if (args.wh[p] == nullptr || (Passes<TIER>::B_LO && args.wl[p] == nullptr))
      return static_cast<int>(cudaErrorInvalidValue);
  if (L::SMEM > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        gemm_tc_kernel<TIER>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)L::SMEM);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  if (args.m > 0 && args.n > 0) {
    const int tiles_n = (args.n + BN - 1) / BN;
    const long long tiles = (long long)tiles_n * ((args.m + BM - 1) / BM);
    gemm_tc_kernel<TIER><<<(unsigned)tiles, THREADS, L::SMEM, stream>>>(
        args, tiles_n);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace general

// ==========================================================================
// vec16 (and, in the bf16-I/O library, vec16_bf16): the persistent,
// warp-specialised wgmma kernel.
// ==========================================================================
namespace hopper {

constexpr int BM = 128;            // two consumer warpgroups of 64 rows
constexpr int BN = 256;            // one wgmma.m64n256k16 a pass
constexpr int BK = 32;             // k a slab: two wgmma k16 steps
constexpr int CONSUMERS = 2;
constexpr int THREADS = 128 * (CONSUMERS + 1);
constexpr int PRODUCER_REGS = 56;  // setmaxnreg: 56 * 128 + 224 * 256 =
constexpr int CONSUMER_REGS = 224; // 168 * 384, the launch's allocation
constexpr int A_BYTES = BM * BK * 4;   // [128 rows][32 k] f32, 128B swizzle
constexpr int A_BYTES_BF16 = BM * BK * 2;  // [128][32] bf16, 64B swizzle
constexpr int W_BYTES = BN * BK * 2;   // [256 n][32 k] bf16, 64B swizzle
// A warpgroup's output box: 64 rows of 128 bytes (32 float32 columns, or
// 64 bf16 ones), 128B swizzle.
constexpr int BOX = 64 * 32 * 4;
constexpr int BUDGET = 224 * 1024;     // ring and output boxes
constexpr int EMPTY_ARRIVALS = 4 * CONSUMERS;  // one a consumer warp
constexpr int GATHER_ARRIVALS = 128 + 1;       // noinc arrivals + expect_tx

// Shared memory: a ring of STAGES slabs, then SLOTS output boxes a
// consumer warpgroup (of the 8 in its 64 x 256 rows), then the mbarriers.
template <int TIER>
struct Ring {
  static constexpr int STAGE = A_BYTES + W_BYTES * (Passes<TIER>::B_LO ? 2 : 1);
  static constexpr int STAGES = Passes<TIER>::B_LO ? 3 : 4;
  static constexpr int SLOTS_FIT = (BUDGET - STAGES * STAGE) / (CONSUMERS * BOX);
  static constexpr int SLOTS = SLOTS_FIT < 8 ? SLOTS_FIT : 8;  // 6 or 5
  static_assert(SLOTS >= 2, "two output boxes a warpgroup at least");
  static constexpr int BOXES = STAGES * STAGE;
  static constexpr int BARS = BOXES + CONSUMERS * SLOTS * BOX;
  static constexpr int SMEM = BARS + 2 * STAGES * 8 + 1024;
};

struct Args {
  const float* a[MAX_PIECES];  // bf16 where dtypes bit p (bf16-I/O library)
  int k[MAX_PIECES];
  int a_off[MAX_PIECES];
  int kb_end[MAX_PIECES];   // cumulative slabs at the end of each piece
  int npieces;
  int m, n;
  int s_out, a_s_in, res_s_in;
  int gather;               // A by cp.async row gathers (s_out != a_s_in)
  const float* scale;
  const float* shift;
  int relu;
  const float* res;         // bf16 where RES_BF16
  int res_off;
  float* out;               // bf16 where OUT_BF16
  int dtypes;               // 0 in the float32 library
};

// Whether k-block kb's slab holds a bf16 piece (always false in the
// float32 library).
__device__ __forceinline__ bool slab_bf16(const Args& args, int kb) {
  if (!BF16_IO) return false;
  const int p = kb < args.kb_end[0] ? 0 : (kb < args.kb_end[1] ? 1 : 2);
  return (args.dtypes >> p) & 1;
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

// The executing thread's cp.asyncs arrive on `bar` when they complete.
__device__ __forceinline__ void cp_async_arrive(uint32_t bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n"
               ::"r"(bar) : "memory");
}

__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];\n"
      ::"r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0),
      "r"(c1) : "memory");
}

__device__ __forceinline__ void tma_store(const CUtensorMap* map,
                                          uint32_t src, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.global.shared::cta.bulk_group "
      "[%0, {%2, %3}], [%1];\n"
      ::"l"(reinterpret_cast<uint64_t>(map)), "r"(src), "r"(c0), "r"(c1)
      : "memory");
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// Until at most N of this thread's bulk stores have not yet read their
// shared memory.
template <int N>
__device__ __forceinline__ void store_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;\n" ::"n"(N) : "memory");
}

// The 128 threads of consumer warpgroup `wg` (named barrier 1 + wg).
__device__ __forceinline__ void wg_sync(int wg) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory");
}

// wgmma descriptor of a K-major bf16 tile with 64-byte swizzle (TMA's
// SWIZZLE_64B): rows of 64 bytes, 8-row groups 512 bytes apart (SBO = 32
// units of 16 bytes), LBO unused (1), layout type 2.
__device__ __forceinline__ uint64_t desc_sw64(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | (1ull << 16) | (32ull << 32) |
         (2ull << 62);
}

// d (64 x 256 float32, the warpgroup's accumulators) += a (64 x 16 bf16,
// registers) . b (16 x 256 bf16, K-major in shared memory); d = a.b where
// `accumulate` is 0.
__device__ __forceinline__ void wgmma(float (&d)[128], const uint32_t (&a)[4],
                                      uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %133, 0;\n"
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
      "%120, %121, %122, %123, %124, %125, %126, %127}, "
      "{%128, %129, %130, %131}, %132, p, 1, 1, 0;\n}\n"
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
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(accumulate));
}

// Both halves of two adjacent k of one row, packed as a fragment register
// (the lower k in the low 16 bits).
__device__ __forceinline__ void split2(float x, float y, uint32_t& hi,
                                       uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  const float2 hf = __bfloat1622float2(h);
  const __nv_bfloat162 l = __floats2bfloat162_rn(x - hf.x, y - hf.y);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = *reinterpret_cast<const uint32_t*>(&l);
}

template <int TIER>
__global__ void __launch_bounds__(THREADS, 1)
gemm_tc_kernel_ws(const Args args, const __grid_constant__ CUtensorMap map_a0,
                  const __grid_constant__ CUtensorMap map_a1,
                  const __grid_constant__ CUtensorMap map_a2,
                  const __grid_constant__ CUtensorMap map_wh,
                  const __grid_constant__ CUtensorMap map_wl,
                  const __grid_constant__ CUtensorMap map_out) {
  using P = Passes<TIER>;
  using R = Ring<TIER>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  // The ring's slabs start 1024-byte aligned (the swizzle's repeat).
  const uint32_t raw = smem_addr(smem_raw);
  unsigned char* ring = smem_raw + ((1024 - (raw & 1023)) & 1023);
  const uint32_t ring_s = smem_addr(ring);
  const uint32_t full0 = ring_s + R::BARS;
  const uint32_t empty0 = full0 + 8 * R::STAGES;

  const int tid = threadIdx.x;
  const int wg = tid / 128;
  const int m = args.m, n = args.n;
  const int tiles_n = (n + BN - 1) / BN;
  const int tiles = tiles_n * ((m + BM - 1) / BM);
  const int nkb = args.kb_end[args.npieces - 1];

  if (tid == 0) {
    for (int s = 0; s < R::STAGES; ++s) {
      mbar_init(full0 + 8 * s, args.gather ? GATHER_ARRIVALS : 1);
      mbar_init(empty0 + 8 * s, EMPTY_ARRIVALS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == CONSUMERS) {
    // ---- producer warpgroup --------------------------------------------
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(PRODUCER_REGS));
    const int t = tid - 128 * CONSUMERS;
    if (!args.gather && t != 0) return;
    const uint32_t w_bytes = W_BYTES * (P::B_LO ? 2 : 1);
    // Gathers: thread t copies the 16-byte chunk t % 8 (4 k) of the tile's
    // rows t / 8 + 16 i, into TMA's 128-byte swizzle (chunk ^ row % 8).
    const int ch = t % 8;
    int in_row[8];
    uint32_t it = 0;
    for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
      const int row0 = (tile / tiles_n) * BM;
      const int col0 = (tile % tiles_n) * BN;
      if (args.gather) {
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const int r = row0 + t / 8 + 16 * i;
          in_row[i] = r < m ? (int)map_row(r, args.s_out, args.a_s_in) : -1;
        }
      }
      for (int kb = 0; kb < nkb; ++kb, ++it) {
        const int s = it % R::STAGES;
        const uint32_t ph = (it / R::STAGES) & 1;
        const uint32_t full = full0 + 8 * s, slab = ring_s + s * R::STAGE;
        mbar_wait(empty0 + 8 * s, ph ^ 1);
        const int p = kb < args.kb_end[0] ? 0 : (kb < args.kb_end[1] ? 1 : 2);
        const int k0 = (kb - (p ? pick(args.kb_end, p - 1) : 0)) * BK;
        const bool a_bf = BF16_IO && ((args.dtypes >> p) & 1);
        // The slab's bytes by TMA: W's halves, and A unless gathered.
        const uint32_t a_bytes =
            args.gather ? 0 : (a_bf ? A_BYTES_BF16 : A_BYTES);
        if (t == 0) {
          mbar_expect_tx(full, w_bytes + a_bytes);
          if (!args.gather) {
            const CUtensorMap* ma = p == 0 ? &map_a0 : (p == 1 ? &map_a1 : &map_a2);
            tma_load(slab, ma, full, k0, row0 + pick(args.a_off, p));
          }
          tma_load(slab + A_BYTES, &map_wh, full, kb * BK, col0);
          if constexpr (P::B_LO)
            tma_load(slab + A_BYTES + W_BYTES, &map_wl, full, kb * BK, col0);
        }
        if (args.gather && a_bf) {
          // A bf16 slab's rows are 64 bytes, 4 chunks of 8 k: thread t
          // copies chunk ch % 4 of the rows t / 8 + 16 i with i % 2 ==
          // ch / 4, into TMA's 64-byte swizzle (chunk ^ (row / 2) % 4).
          const auto* A = reinterpret_cast<const unsigned short*>(
              pick(args.a, p));
          const int K = pick(args.k, p);
          const int off = pick(args.a_off, p);
          const int q = ch % 4;
          const int k = k0 + 8 * q;
          const uint32_t dst =
              slab + (t / 8) * 64 + ((q ^ ((t / 8) / 2 % 4)) * 16);
#pragma unroll
          for (int i = 0; i < 8; ++i) {
            if (i % 2 != ch / 4) continue;
            const bool v = in_row[i] >= 0 && k < K;
            const auto* src = v ? A + (long long)(in_row[i] + off) * K + k : A;
            cp_async16(dst + 16 * i * 64, src, v);
          }
          cp_async_arrive(full);
        } else if (args.gather) {
          const float* A = pick(args.a, p);
          const int K = pick(args.k, p);
          const int off = pick(args.a_off, p);
          const int k = k0 + 4 * ch;
          const uint32_t dst = slab + (t / 8) * 128 + ((ch ^ (t / 8 % 8)) * 16);
#pragma unroll
          for (int i = 0; i < 8; ++i) {
            const bool v = in_row[i] >= 0 && k < K;
            const float* src = v ? A + (long long)(in_row[i] + off) * K + k : A;
            cp_async16(dst + 16 * i * 128, src, v);
          }
          cp_async_arrive(full);
        }
      }
    }
  } else {
    // ---- consumer warpgroups: rows 64 wg .. +63 of each tile -------------
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(CONSUMER_REGS));
    const int lane = tid % 32, warp = (tid / 32) % 4;
    const int g = lane / 4, c = lane % 4;
    // Fragment row g of each 8 is the tile's row 4 (g % 2) + g / 2 of
    // those 8 (sg): the two rows a quarter-warp reads then sit in the two
    // 64-byte halves of the 128-byte swizzle (conflict-free float4 loads).
    // With bf16 slabs too, (g / 2) ^ (5 (g % 2)): the two rows also differ
    // in bit 0, so they sit in the two 64-byte halves of a bank line as
    // bf16 slab rows (64 bytes) as well. The float32 library keeps the
    // first order, so that its code stays vec16's own.
    // The thread holds tile rows rr + 8h, rr = 64 wg + 16 warp + sg.
    const int sg = BF16_IO ? (g / 2) ^ (5 * (g % 2)) : 4 * (g % 2) + g / 2;
    const int rr = 64 * wg + 16 * warp + sg;
    const int box_row = (16 * warp + sg) * 128;   // in the warpgroup's box
    const uint32_t boxes = ring_s + R::BOXES + wg * R::SLOTS * BOX;
    const bool issuer = tid % 128 == 0;
    float acc[128];
#pragma unroll
    for (int i = 0; i < 128; ++i) acc[i] = 0.f;
    // Slab `it`'s A fragments, both k16 steps: rows rr and rr + 8,
    // physical k 16j + 4c .. + 3 (the swizzled chunk 4j + c), which
    // TC_K_ORDER makes the fragment's k 2c, 2c + 1, 2c + 8, 2c + 9; split
    // into hi and lo. A bf16 slab (k-block kb of a bf16 piece): physical
    // k 8c .. 8c + 7 (the 64-byte row's chunk c, swizzled by (row / 2) %
    // 4), which TC_K_ORDER_BF16 makes step 0's fragment, then step 1's;
    // its lo half is zero. Waits for the slab first.
    auto fragments = [&](uint32_t it, int kb, uint32_t (&ah)[2][4],
                         uint32_t (&al)[2][4]) {
      const int s = it % R::STAGES;
      mbar_wait(full0 + 8 * s, (it / R::STAGES) & 1);
      const unsigned char* slab = ring + s * R::STAGE;
      if (slab_bf16(args, kb)) {
        const int o = rr * 64 + ((c ^ (sg / 2 % 4)) * 16);
        const uint4 x0 = *reinterpret_cast<const uint4*>(slab + o);
        const uint4 x1 = *reinterpret_cast<const uint4*>(slab + o + 512);
        ah[0][0] = x0.x; ah[0][1] = x1.x; ah[0][2] = x0.y; ah[0][3] = x1.y;
        ah[1][0] = x0.z; ah[1][1] = x1.z; ah[1][2] = x0.w; ah[1][3] = x1.w;
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
          for (int r = 0; r < 4; ++r) al[j][r] = 0u;
        return;
      }
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int o = rr * 128 + (((4 * j + c) ^ sg) * 16);
        const float4 x0 = *reinterpret_cast<const float4*>(slab + o);
        const float4 x1 = *reinterpret_cast<const float4*>(slab + o + 1024);
        split2(x0.x, x0.y, ah[j][0], al[j][0]);
        split2(x1.x, x1.y, ah[j][1], al[j][1]);
        split2(x0.z, x0.w, ah[j][2], al[j][2]);
        split2(x1.z, x1.w, ah[j][3], al[j][3]);
      }
    };
    // Slab `it` of the tile (its k-block kb): issue its wgmmas on the
    // fragments `cur`, let at most this group run on, release the slab
    // before it (whose group has now retired) and split the next slab's A
    // into `nxt`, the registers that retired group read.
    auto step = [&](uint32_t it, int kb, uint32_t (&ch)[2][4],
                    uint32_t (&cl)[2][4], uint32_t (&nh)[2][4],
                    uint32_t (&nl)[2][4]) {
      const int s = it % R::STAGES;
      const uint32_t wh = ring_s + s * R::STAGE + A_BYTES;
      // A bf16 slab's A-lo pass multiplies zeros: skipping it by a branch,
      // uniform as it is, makes ptxas serialize every wgmma of the kernel
      // (C7520, "compiler-inserted WG.AR in divergent path").
      asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const uint64_t bh = desc_sw64(wh + 32 * j);
        wgmma(acc, ch[j], bh, kb | j);
        if constexpr (P::B_LO)
          wgmma(acc, ch[j], desc_sw64(wh + W_BYTES + 32 * j), 1);
        if constexpr (P::A_LO) wgmma(acc, cl[j], bh, 1);
      }
      asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
      asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
      if (kb > 0 && lane == 0)
        mbar_arrive(empty0 + 8 * ((it + R::STAGES - 1) % R::STAGES));
      if (kb + 1 < nkb) fragments(it + 1, kb + 1, nh, nl);
    };
    uint32_t it = 0, q = 0;
    for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
      const int row0 = (tile / tiles_n) * BM;
      const int col0 = (tile % tiles_n) * BN;
      uint32_t xh[2][4], xl[2][4], yh[2][4], yl[2][4];
      fragments(it, 0, xh, xl);
      for (int kb = 0; kb < nkb; kb += 2) {
        step(it++, kb, xh, xl, yh, yl);
        if (kb + 1 < nkb) step(it++, kb + 1, yh, yl, xh, xl);
      }
      asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
      if (lane == 0)
        mbar_arrive(empty0 + 8 * ((it + R::STAGES - 1) % R::STAGES));

      // Epilogue: accumulator 4j + 2h + e holds tile row rr + 8h, column
      // 8j + 2c + e. Box b (columns 32b .. +31) of the warpgroup's 64 rows
      // goes through a slot of SLOTS in turn: the issuer waits until the
      // store that last read the slot has read it, the warpgroup writes
      // it (128-byte swizzle), and the issuer stores it by TMA, which
      // clips rows >= m and columns >= n; the next box, and the next
      // tile's wgmmas, go on while it drains.
#ifdef GASTX_BF16_IO
      // The bf16-I/O library's epilogue: a bf16 residual (RES_BF16) is read
      // as pairs of bf16; a bf16 output (OUT_BF16) goes through 64 x 64
      // boxes of 128-byte rows, the thread's two columns one 4-byte word at
      // chunk jj (of 8, swizzled by the row) of its row. The float32
      // library keeps vec16's own epilogue (#else): this one, instantiated
      // there for float32 only and with res_bf constant false, computes
      // the same but compiles to other instructions (2824 against 2840 at
      // "default"; scripts/torch_sass_diff.py).
      const bool res_bf = args.dtypes & RES_BF16;
      const float* res_row[2];   // a row of bf16 where res_bf
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = row0 + rr + 8 * h;
        const long long at =
            (map_row(r, args.s_out, args.res_s_in) + args.res_off) *
            (long long)n;
        res_row[h] = (r < m && args.res)
            ? (res_bf ? reinterpret_cast<const float*>(
                            reinterpret_cast<const __nv_bfloat16*>(args.res) +
                            at)
                      : args.res + at)
            : nullptr;
      }
      auto epilogue = [&](auto out_bf16) {
        constexpr bool OB = decltype(out_bf16)::value;
        constexpr int COLS = OB ? 64 : 32;  // output columns a box
#pragma unroll
        for (int b = 0; b < BN / COLS; ++b) {
          if (col0 + COLS * b >= n || row0 + 64 * wg >= m) break;
          const uint32_t box = boxes + (q % R::SLOTS) * BOX;
          if (issuer) store_wait_read<R::SLOTS - 1>();
          wg_sync(wg);
#pragma unroll
          for (int jj = 0; jj < COLS / 8; ++jj) {
            const int j = COLS / 8 * b + jj;
            const int col = col0 + 8 * j + 2 * c;
            const bool in = col < n;   // n % 8 == 0: both columns in or out
            float sc0 = 1.f, sc1 = 1.f, sh0 = 0.f, sh1 = 0.f;
            if (args.scale && in) {
              sc0 = __ldg(args.scale + col); sc1 = __ldg(args.scale + col + 1);
              sh0 = __ldg(args.shift + col); sh1 = __ldg(args.shift + col + 1);
            }
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              float v0 = acc[4 * j + 2 * h], v1 = acc[4 * j + 2 * h + 1];
              if (args.scale) { v0 = v0 * sc0 + sh0; v1 = v1 * sc1 + sh1; }
              if (args.relu) { v0 = fmaxf(v0, 0.f); v1 = fmaxf(v1, 0.f); }
              if (res_row[h] && in) {
                if (res_bf) {
                  const uint32_t rv = __ldg(reinterpret_cast<const unsigned*>(
                      reinterpret_cast<const __nv_bfloat16*>(res_row[h]) +
                      col));
                  v0 += __uint_as_float(rv << 16);
                  v1 += __uint_as_float(rv & 0xffff0000u);
                } else {
                  const float2 rv =
                      __ldg(reinterpret_cast<const float2*>(res_row[h] + col));
                  v0 += rv.x; v1 += rv.y;
                }
              }
              if constexpr (OB) {
                const __nv_bfloat162 pk = __floats2bfloat162_rn(v0, v1);
                const uint32_t dst = box + box_row + h * 1024 +
                                     ((jj ^ sg) * 16) + c * 4;
                asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(dst),
                             "r"(*reinterpret_cast<const uint32_t*>(&pk))
                             : "memory");
              } else {
                const uint32_t dst = box + box_row + h * 1024 +
                                     (((2 * jj + c / 2) ^ sg) * 16) +
                                     (c % 2) * 8;
                asm volatile("st.shared.v2.f32 [%0], {%1, %2};\n" ::"r"(dst),
                             "f"(v0), "f"(v1) : "memory");
              }
            }
          }
          asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
          wg_sync(wg);
          if (issuer) tma_store(&map_out, box, col0 + COLS * b, row0 + 64 * wg);
          ++q;
        }
      };
      if (args.dtypes & OUT_BF16)
        epilogue(std::true_type{});
      else
        epilogue(std::false_type{});
#else
      const float* res_row[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = row0 + rr + 8 * h;
        res_row[h] = (r < m && args.res)
            ? args.res + (map_row(r, args.s_out, args.res_s_in) +
                          args.res_off) * (long long)n
            : nullptr;
      }
#pragma unroll
      for (int b = 0; b < BN / 32; ++b) {
        if (col0 + 32 * b >= n || row0 + 64 * wg >= m) break;
        const uint32_t box = boxes + (q % R::SLOTS) * BOX;
        if (issuer) store_wait_read<R::SLOTS - 1>();
        wg_sync(wg);
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
          const int j = 4 * b + jj;
          const int col = col0 + 8 * j + 2 * c;
          const bool in = col < n;   // n % 8 == 0: both columns in or out
          float sc0 = 1.f, sc1 = 1.f, sh0 = 0.f, sh1 = 0.f;
          if (args.scale && in) {
            sc0 = __ldg(args.scale + col); sc1 = __ldg(args.scale + col + 1);
            sh0 = __ldg(args.shift + col); sh1 = __ldg(args.shift + col + 1);
          }
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            float v0 = acc[4 * j + 2 * h], v1 = acc[4 * j + 2 * h + 1];
            if (args.scale) { v0 = v0 * sc0 + sh0; v1 = v1 * sc1 + sh1; }
            if (args.relu) { v0 = fmaxf(v0, 0.f); v1 = fmaxf(v1, 0.f); }
            if (res_row[h] && in) {
              const float2 rv =
                  __ldg(reinterpret_cast<const float2*>(res_row[h] + col));
              v0 += rv.x; v1 += rv.y;
            }
            const uint32_t dst = box + box_row + h * 1024 +
                                 (((2 * jj + c / 2) ^ sg) * 16) + (c % 2) * 8;
            asm volatile("st.shared.v2.f32 [%0], {%1, %2};\n" ::"r"(dst),
                         "f"(v0), "f"(v1) : "memory");
          }
        }
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
        wg_sync(wg);
        if (issuer) tma_store(&map_out, box, col0 + 32 * b, row0 + 64 * wg);
        ++q;
      }
#endif  // GASTX_BF16_IO
    }
    if (issuer) asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
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

// A 2D tensor map of a row-major (rows, cols) matrix; out-of-bounds
// elements of a box read as zero.
bool encode(CUtensorMap* map, const void* base, CUtensorMapDataType type,
            int elem, long long rows, long long cols, int box_cols,
            int box_rows, CUtensorMapSwizzle swizzle) {
  EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)(cols * elem)};
  const cuuint32_t box[2] = {(cuuint32_t)box_cols, (cuuint32_t)box_rows};
  const cuuint32_t unit[2] = {1, 1};
  return fn(map, type, 2, const_cast<void*>(base), dims, strides, box, unit,
            CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
            CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// One block an SM, never more blocks than output tiles.
template <int TIER>
int launch(const Args& args, const CUtensorMap (&ma)[MAX_PIECES],
           const CUtensorMap& mwh, const CUtensorMap& mwl,
           const CUtensorMap& mout, cudaStream_t stream) {
  using R = Ring<TIER>;
  int device, sms;
  cudaError_t e = cudaGetDevice(&device);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(gemm_tc_kernel_ws<TIER>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             R::SMEM);
  if (e != cudaSuccess) return static_cast<int>(e);
  const long long tiles = (long long)((args.m + BM - 1) / BM) *
                          ((args.n + BN - 1) / BN);
  const int grid = tiles < sms ? (int)tiles : sms;
  gemm_tc_kernel_ws<TIER><<<grid, THREADS, R::SMEM, stream>>>(
      args, ma[0], ma[1], ma[2], mwh, mwl, mout);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace hopper

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

}  // namespace

extern "C" {

// The general instantiation of `tier` (0 default, 1 high_lhs, 2 high_rhs,
// 3 high) on `stream`: W's halves per piece, (K_p, N) row-major bf16 (the
// lo half only where the tier multiplies it); the activations' dtypes by
// `dtypes` (bit p: A piece p bf16; bit 3 the residual, bit 4 the output).
// Returns cudaGetLastError() after the launch, or cudaErrorInvalidValue
// with no launch for an unknown tier, a missing W half or, in the float32
// library, a bf16 activation.
int gemm_tc(const void* a0, const void* wh0, const void* wl0, int k0,
            int off0, const void* a1, const void* wh1, const void* wl1,
            int k1, int off1, const void* a2, const void* wh2,
            const void* wl2, int k2, int off2, int npieces, int m, int n,
            int s_out, int a_s_in, int res_s_in, const void* scale,
            const void* shift, int relu, const void* res, int res_off,
            void* out, void* stream, int tier, int dtypes) {
  if (npieces < 1 || npieces > MAX_PIECES || (dtypes && !BF16_IO))
    return static_cast<int>(cudaErrorInvalidValue);
  general::GemmArgs args;
  const void* as[MAX_PIECES] = {a0, a1, a2};
  const void* whs[MAX_PIECES] = {wh0, wh1, wh2};
  const void* wls[MAX_PIECES] = {wl0, wl1, wl2};
  const int ks[MAX_PIECES] = {k0, k1, k2};
  const int offs[MAX_PIECES] = {off0, off1, off2};
  for (int p = 0; p < MAX_PIECES; ++p) {
    args.a[p] = as[p];
    args.wh[p] = static_cast<const __nv_bfloat16*>(whs[p]);
    args.wl[p] = static_cast<const __nv_bfloat16*>(wls[p]);
    args.k[p] = ks[p];
    args.a_off[p] = offs[p];
  }
  args.npieces = npieces;
  args.m = m;
  args.n = n;
  args.s_out = s_out;
  args.a_s_in = a_s_in;
  args.res_s_in = res_s_in;
  args.scale = static_cast<const float*>(scale);
  args.shift = static_cast<const float*>(shift);
  args.relu = relu;
  args.res = res;
  args.res_off = res_off;
  args.out = out;
  args.dtypes = dtypes;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (tier) {
    case 0: return general::launch<0>(args, s);
    case 1: return general::launch<1>(args, s);
    case 2: return general::launch<2>(args, s);
    case 3: return general::launch<3>(args, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The wgmma instantiation of `tier` on `stream`, one persistent block an
// SM: vec16 (float32 I/O, the float32 library) or vec16_bf16 (the bf16-I/O
// library, `dtypes` as gemm_tc's). Piece p: a_p (rows_p, K_p) float32 or
// bf16 and its row offset off_p; W of every piece as one K-major matrix,
// its bf16 halves wt_hi and wt_lo (N, k_pad) (wt_lo only where the tier
// multiplies it): piece p's columns padded with zeros to a multiple of 32,
// every 16 permuted by TC_K_ORDER for a float32 piece, every 32 by
// TC_K_ORDER_BF16 for a bf16 one (kernels.py, tc_weights). Returns
// cudaGetLastError() after the launch, or cudaErrorInvalidValue with no
// launch where the operands break the instantiation's rule (K_p % 4, and
// % 8 for a bf16 piece; N % 8; 16-byte a_p, res, out and W; k_pad the
// pieces' padded sum), a bf16 dtype bit in the float32 library, or a
// tensor map cannot be encoded.
int gemm_tc_hopper(const void* a0, int k0, int rows0, int off0,
                   const void* a1, int k1, int rows1, int off1,
                   const void* a2, int k2, int rows2, int off2, int npieces,
                   const void* wt_hi, const void* wt_lo, int k_pad, int m,
                   int n, int s_out, int a_s_in, int res_s_in,
                   const void* scale, const void* shift, int relu,
                   const void* res, int res_off, void* out, void* stream,
                   int tier, int dtypes) {
  using namespace hopper;
  if (npieces < 1 || npieces > MAX_PIECES || tier < 0 || tier > 3 ||
      n % 8 != 0 || !aligned16(out) || !aligned16(res) ||
      !aligned16(wt_hi) || !aligned16(wt_lo) || wt_hi == nullptr ||
      ((tier == 2 || tier == 3) && wt_lo == nullptr) ||
      (dtypes && !BF16_IO))
    return static_cast<int>(cudaErrorInvalidValue);
  Args args;
  const void* as[MAX_PIECES] = {a0, a1, a2};
  const int ks[MAX_PIECES] = {k0, k1, k2};
  const int rows[MAX_PIECES] = {rows0, rows1, rows2};
  const int offs[MAX_PIECES] = {off0, off1, off2};
  args.gather = s_out != a_s_in;
  CUtensorMap ma[MAX_PIECES] = {}, mwh = {}, mwl = {}, mout = {};
  int kb = 0;
  for (int p = 0; p < MAX_PIECES; ++p) {
    args.a[p] = static_cast<const float*>(as[p]);
    args.k[p] = ks[p];
    args.a_off[p] = offs[p];
    if (p < npieces) {
      // A bf16 piece: rows of 16-byte multiples, a box of 32 k x 128 rows
      // with 64-byte swizzle (the consumers' bf16 slab layout).
      const bool bf = (dtypes >> p) & 1;
      if (ks[p] < 1 || ks[p] % (bf ? 8 : 4) != 0 || !aligned16(as[p]))
        return static_cast<int>(cudaErrorInvalidValue);
      kb += (ks[p] + BK - 1) / BK;
      if (!args.gather &&
          !encode(&ma[p], as[p],
                  bf ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                     : CU_TENSOR_MAP_DATA_TYPE_FLOAT32,
                  bf ? 2 : 4, rows[p], ks[p], BK, BM,
                  bf ? CU_TENSOR_MAP_SWIZZLE_64B : CU_TENSOR_MAP_SWIZZLE_128B))
        return static_cast<int>(cudaErrorInvalidValue);
    }
    args.kb_end[p] = kb;
  }
  if (kb * BK != k_pad) return static_cast<int>(cudaErrorInvalidValue);
  if (m < 1 || n < 1) return static_cast<int>(cudaGetLastError());
  // The output in boxes of 64 rows x 128 bytes: 32 float32 or 64 bf16.
  const bool out_bf = dtypes & OUT_BF16;
  if (!encode(&mout, out,
              out_bf ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                     : CU_TENSOR_MAP_DATA_TYPE_FLOAT32,
              out_bf ? 2 : 4, m, n, out_bf ? 64 : 32, 64,
              CU_TENSOR_MAP_SWIZZLE_128B) ||
      !encode(&mwh, wt_hi, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, n, k_pad, BK,
              BN, CU_TENSOR_MAP_SWIZZLE_64B) ||
      (wt_lo != nullptr &&
       !encode(&mwl, wt_lo, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, n, k_pad,
               BK, BN, CU_TENSOR_MAP_SWIZZLE_64B)))
    return static_cast<int>(cudaErrorInvalidValue);
  args.npieces = npieces;
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
  args.dtypes = dtypes;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (tier) {
    case 0: return launch<0>(args, ma, mwh, mwl, mout, s);
    case 1: return launch<1>(args, ma, mwh, mwl, mout, s);
    case 2: return launch<2>(args, ma, mwh, mwl, mout, s);
    default: return launch<3>(args, ma, mwh, mwl, mout, s);
  }
}

const char* error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
