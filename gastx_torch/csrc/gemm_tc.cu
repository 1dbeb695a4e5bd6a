// The gemm_epilogue function at the bf16 precision tiers, on the tensor
// cores of sm_90a.
//
// Replaces the same TPU dots as gemm_epilogue.cu (the projection, cat and
// concat dots of gastx/ops/pallas/fused_gab.py `_local_branch`,
// `_global_branch` and `_block_concat`, and the conv taps of
// gastx/ops/pallas/fused_level.py `_kernel_level`) where the model gives
// them a tier below "highest": the kernels' `kdot` (gastx/ops/pallas/
// precision.py:99), which computes a product as bf16 passes on the TPU's
// matrix unit. With a = ah + al (ah = bf16(a), al = bf16(a - ah), both
// rounded to nearest even) and W = wh + wl likewise:
//
//   TIER 0 "default" (and "kdefault"):  ah.wh               one pass
//   TIER 1 "high_lhs":                  ah.wh + al.wh       two passes
//   TIER 2 "high_rhs":                  ah.wh + ah.wl       two passes
//   TIER 3 "high":                      ah.wh + ah.wl + al.wh
//
// each pass an mma.sync.m16n8k16 of bf16 operands into float32
// accumulators (all passes into one accumulator). The function and its
// arguments are gemm_epilogue.cu's (see there): up to three pieces, the
// row map in_row(r, p) = (r / s_out) * a_s_in + r % s_out + a_off[p], the
// epilogue * scale + shift, ReLU, + res[res_row(r)]; W's halves come split
// on the host (bf16, (K_p, N) row-major; the lo half only where the tier
// multiplies it).
//
// Bound on this card: at the main path's shapes (K = 128..1536, N up to
// 3584, M up to ~1e6) a product does 2MNK operations at 989 TFLOP/s a
// pass against 4(MK + MN) bytes at 3.35 TB/s, about 30-70 operations a
// byte for one pass, so on paper it is byte-bound at one pass and near
// the ridge at three. The design is the simple one that is right first:
//   * 128x128 output tiles, 256 threads (8 warps of 64x32), BK = 32 rows
//     of K a slab, two shared-memory buffers: the next slab's A is loaded
//     into registers (16-byte loads where aligned) and W's halves are
//     copied by cp.async while this slab is multiplied;
//   * A arrives as float32 and is split into its bf16 halves as it is
//     stored into shared memory ([m][k], a row pitch of 40 halves so the
//     ldmatrix rows do not conflict); W's halves are stored [k][n] (pitch
//     136) and read with ldmatrix.trans;
//   * the K tail of every piece is zero-filled (the level-0 expand conv
//     has K = 2 a tap), and the pieces and taps are one stream of slabs;
//   * the epilogue writes each thread's two adjacent columns (8 bytes).
// wgmma and TMA are later work. Two alignment instantiations a tier: VEC
// (every K_p a multiple of 4, N a multiple of 8, a_p, res and the W
// halves 16-byte aligned) and the general one (scalar loads and stores).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 128;
constexpr int BN = 128;
constexpr int BK = 32;
constexpr int THREADS = 256;
constexpr int MAX_PIECES = 3;
constexpr int A_PITCH = BK + 8;   // halves of an A row in shared memory
constexpr int B_PITCH = BN + 8;   // halves of a W row (one k)
constexpr int A_HALVES = BM * A_PITCH;
constexpr int B_HALVES = BK * B_PITCH;
// A staging: thread t loads the float4 at k-chunk t % 8 of rows t / 8 +
// 32 i, i < 4.
constexpr int A_CHUNKS = BK / 4;
constexpr int A_ROWS = BM * A_CHUNKS / THREADS;
constexpr int A_ROW_STEP = THREADS / A_CHUNKS;

struct GemmArgs {
  const float* a[MAX_PIECES];
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
  const float* res;
  int res_off;
  float* out;
};

template <int TIER>
struct Passes {
  static constexpr bool A_LO = TIER == 1 || TIER == 3;
  static constexpr bool B_LO = TIER == 2 || TIER == 3;
  // Halves of one buffer: A hi [, A lo], W hi [, W lo].
  static constexpr int STAGE =
      A_HALVES * (A_LO ? 2 : 1) + B_HALVES * (B_LO ? 2 : 1);
  static constexpr size_t SMEM = sizeof(__nv_bfloat16) * 2 * STAGE;
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

// The two bf16 halves of x, rounded to nearest even.
__device__ __forceinline__ void split(float x, __nv_bfloat16& hi,
                                      __nv_bfloat16& lo) {
  hi = __float2bfloat16_rn(x);
  lo = __float2bfloat16_rn(x - __bfloat162float(hi));
}

template <int TIER, bool VEC>
__global__ void __launch_bounds__(THREADS, 2)
gemm_tc_kernel(const GemmArgs args, int tiles_n) {
  using P = Passes<TIER>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* smem = reinterpret_cast<__nv_bfloat16*>(smem_raw);

  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int warp = tid / 32;
  const int row0 = (blockIdx.x / tiles_n) * BM;
  const int col0 = (blockIdx.x % tiles_n) * BN;
  const int m = args.m, n = args.n;

  // Buffer s: A hi, [A lo,] W hi, [W lo].
  auto a_hi = [&](int s) { return smem + s * P::STAGE; };
  auto a_lo = [&](int s) { return smem + s * P::STAGE + A_HALVES; };
  auto b_hi = [&](int s) {
    return smem + s * P::STAGE + A_HALVES * (P::A_LO ? 2 : 1);
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

  const float* a_ptr[A_ROWS];
  const __nv_bfloat16* wh_ptr;
  const __nv_bfloat16* wl_ptr;
  int lp = 0, lk0 = 0, lK = 0;
  auto set_piece = [&](int p) {
    const float* A = pick(args.a, p);
    lK = pick(args.k, p);
    const int off = pick(args.a_off, p);
#pragma unroll
    for (int i = 0; i < A_ROWS; ++i)
      a_ptr[i] = a_base[i] >= 0 ? A + (long long)(a_base[i] + off) * lK : A;
    wh_ptr = pick(args.wh, p);
    wl_ptr = pick(args.wl, p);
  };
  set_piece(0);
  int total = 0;
  for (int p = 0; p < args.npieces; ++p)
    total += (pick(args.k, p) + BK - 1) / BK;

  float a_stage[A_ROWS][4];
  int a_slot = -1;

  // W's halves of slab rows [lk0, lk0 + BK) into buffer `slot`.
  auto load_w = [&](int slot) {
    __nv_bfloat16* dst_h = b_hi(slot);
    __nv_bfloat16* dst_l = b_lo(slot);
    if constexpr (VEC) {  // N % 8 == 0: 8 halves are in or out together
#pragma unroll
      for (int c = 0; c < BK * BN / 8 / THREADS; ++c) {
        const int idx = tid + c * THREADS;
        const int kr = idx / (BN / 8);
        const int cc = (idx % (BN / 8)) * 8;
        const bool v = lk0 + kr < lK && col0 + cc < n;
        const long long off = v ? (long long)(lk0 + kr) * n + col0 + cc : 0;
        cp_async16(smem_addr(dst_h + kr * B_PITCH + cc), wh_ptr + off, v);
        if constexpr (P::B_LO)
          cp_async16(smem_addr(dst_l + kr * B_PITCH + cc), wl_ptr + off, v);
      }
    } else {
      const __nv_bfloat16 zero = __float2bfloat16_rn(0.f);
      for (int idx = tid; idx < BK * BN; idx += THREADS) {
        const int kr = idx / BN;
        const int cc = idx % BN;
        const bool v = lk0 + kr < lK && col0 + cc < n;
        const long long off = (long long)(lk0 + kr) * n + col0 + cc;
        dst_h[kr * B_PITCH + cc] = v ? wh_ptr[off] : zero;
        if constexpr (P::B_LO)
          dst_l[kr * B_PITCH + cc] = v ? wl_ptr[off] : zero;
      }
    }
  };

  // The next slab: A into registers (stored by store_a after the MMAs), W
  // into buffer `slot`; one commit group, empty past the last slab.
  auto load_slab = [&](int slot) {
    if (lp < args.npieces) {
#pragma unroll
      for (int i = 0; i < A_ROWS; ++i) {
        const float* src = a_ptr[i] + lk0 + a_k;
        if constexpr (VEC) {  // K % 4 == 0: the 4 k are in or out
          const float4 v = (a_base[i] >= 0 && lk0 + a_k < lK)
              ? __ldg(reinterpret_cast<const float4*>(src))
              : make_float4(0.f, 0.f, 0.f, 0.f);
          a_stage[i][0] = v.x; a_stage[i][1] = v.y;
          a_stage[i][2] = v.z; a_stage[i][3] = v.w;
        } else {
#pragma unroll
          for (int e = 0; e < 4; ++e)
            a_stage[i][e] = (a_base[i] >= 0 && lk0 + a_k + e < lK)
                ? __ldg(src + e) : 0.f;
        }
      }
      a_slot = slot;
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
    a_slot = -1;
#pragma unroll
    for (int i = 0; i < A_ROWS; ++i) {
      __align__(8) __nv_bfloat16 h[4], l[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) split(a_stage[i][e], h[e], l[e]);
      const int o = a_row[i] * A_PITCH + a_k;
      *reinterpret_cast<uint2*>(ah + o) = *reinterpret_cast<uint2*>(h);
      if constexpr (P::A_LO)
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
        if constexpr (P::A_LO) {
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
        const float* res_row =
            args.res ? args.res + (map_row(r, args.s_out, args.res_s_in) +
                                   args.res_off) * (long long)n
                     : nullptr;
        float* out_row = args.out + (long long)r * n;
        if constexpr (VEC) {  // n % 8 == 0: both columns are in or out
          if (c >= n) continue;
          if (res_row) {
            const float2 rv = *reinterpret_cast<const float2*>(res_row + c);
            v[0] += rv.x; v[1] += rv.y;
          }
          *reinterpret_cast<float2*>(out_row + c) = make_float2(v[0], v[1]);
        } else {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            if (c + e >= n) continue;
            out_row[c + e] = res_row ? v[e] + res_row[c + e] : v[e];
          }
        }
      }
  }
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

template <int TIER, bool VEC>
int launch(const GemmArgs& args, cudaStream_t stream) {
  using P = Passes<TIER>;
  if constexpr (VEC) {  // tc_variant picks VEC only where these hold
    bool ok = args.n % 8 == 0 && aligned16(args.out) && aligned16(args.res);
    for (int p = 0; p < args.npieces; ++p)
      ok = ok && args.k[p] % 4 == 0 && aligned16(args.a[p]) &&
           aligned16(args.wh[p]) && aligned16(args.wl[p]);
    if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  }
  for (int p = 0; p < args.npieces; ++p)
    if (args.wh[p] == nullptr || (P::B_LO && args.wl[p] == nullptr))
      return static_cast<int>(cudaErrorInvalidValue);
  if (P::SMEM > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        gemm_tc_kernel<TIER, VEC>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)P::SMEM);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  if (args.m > 0 && args.n > 0) {
    const int tiles_n = (args.n + BN - 1) / BN;
    const long long tiles = (long long)tiles_n * ((args.m + BM - 1) / BM);
    gemm_tc_kernel<TIER, VEC><<<(unsigned)tiles, THREADS, P::SMEM, stream>>>(
        args, tiles_n);
  }
  return static_cast<int>(cudaGetLastError());
}

template <bool VEC>
int launch_tier(int tier, const GemmArgs& args, cudaStream_t stream) {
  switch (tier) {
    case 0: return launch<0, VEC>(args, stream);
    case 1: return launch<1, VEC>(args, stream);
    case 2: return launch<2, VEC>(args, stream);
    case 3: return launch<3, VEC>(args, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" {

// Launches the instantiation of `tier` (0 default, 1 high_lhs, 2 high_rhs,
// 3 high), 16-byte if vec16, on `stream`; returns cudaGetLastError() after
// the launch, or cudaErrorInvalidValue with no launch for an unknown tier,
// a missing W half the tier multiplies, or vec16 where its alignment does
// not hold.
int gemm_tc(const void* a0, const void* wh0, const void* wl0, int k0,
            int off0, const void* a1, const void* wh1, const void* wl1,
            int k1, int off1, const void* a2, const void* wh2,
            const void* wl2, int k2, int off2, int npieces, int m, int n,
            int s_out, int a_s_in, int res_s_in, const void* scale,
            const void* shift, int relu, const void* res, int res_off,
            void* out, void* stream, int tier, int vec16) {
  if (npieces < 1 || npieces > MAX_PIECES)
    return static_cast<int>(cudaErrorInvalidValue);
  GemmArgs args;
  const void* as[MAX_PIECES] = {a0, a1, a2};
  const void* whs[MAX_PIECES] = {wh0, wh1, wh2};
  const void* wls[MAX_PIECES] = {wl0, wl1, wl2};
  const int ks[MAX_PIECES] = {k0, k1, k2};
  const int offs[MAX_PIECES] = {off0, off1, off2};
  for (int p = 0; p < MAX_PIECES; ++p) {
    args.a[p] = static_cast<const float*>(as[p]);
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
  args.res = static_cast<const float*>(res);
  args.res_off = res_off;
  args.out = static_cast<float*>(out);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return vec16 ? launch_tier<true>(tier, args, s)
               : launch_tier<false>(tier, args, s);
}

const char* error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
