// Pipelined float32 GEMM with a fused epilogue, for sm_90a.
//
// Replaces the dots of the TPU GAB and level kernels
// (gastx/ops/pallas/fused_gab.py `_block_concat`, the projection and cat
// dots of `_local_branch` / `_global_branch`, and the conv taps of
// gastx/ops/pallas/fused_level.py `_kernel_level`):
//
//   out[r, n] = epi( sum_p sum_k A_p[in_row(r, p), k] * W_p[k, n] )
//
// with up to three pieces p, so the 2C->C and 3C->2C concat products run
// without materialising the concat. A_p is (rows_p, K_p) row-major, W_p is
// (K_p, N) row-major. The row map serves the dilated temporal conv: with
// r = s * s_out + q (sequence s, row q of its output rows),
//   in_row(r, p) = s * a_s_in + q + a_off[p],
// so piece k of a conv reads rows q + k*d*J of its sequence's T_in*J rows.
// a_s_in = s_out and a_off = 0 is the plain product. The epilogue applies,
// in order: * scale[n] + shift[n] (a bias is scale 1), ReLU,
// + res[res_row(r), n]
// with res_row(r) = s * res_s_in + q + res_off (the level's residual
// slice); res is (rows, N) row-major.
//
// Bound on this card: at the main path's shapes (K = 128..1536, N =
// 128..3584, M up to ~1e6) the products are far above the f32 ridge
// point, so the kernel is bound by the SMs' float32 FMA rate (67 TFLOP/s
// outside the tensor cores; FFMA only: no tensor cores, TF32 or bf16).
// What keeps an FFMA kernel off that rate is every instruction that is
// not an FFMA, every exposed load latency, and the shared-memory reads
// that feed the FMAs. The design:
//   * 128x128 output tiles, 256 threads, two blocks an SM (128 registers
//     a thread); each warp owns a 64x32 warp tile and each thread 8x8
//     accumulators as 2x2 sub-tiles of 4x4, so a k step reads its 16
//     operands with four conflict-free LDS.128 for 64 FFMA;
//   * two shared-memory buffers, each one slab of BK = 16 rows of K: the
//     next slab's loads are in flight while this one is multiplied, with one
//     barrier a slab. The pieces and taps are one stream of slabs (one
//     counter over (piece, k0)), so the pipeline does not drain at a
//     piece boundary;
//   * A is needed k-major and is row-major in memory: each thread loads
//     its next-slab float4s of A into registers (16-byte loads where
//     aligned) before the FMAs and stores them transposed after them,
//     into a row pitch of BM + 4 floats. This beat 4-byte cp.async
//     straight into that layout by 4.3% (6.697 against 6.998 ms, best
//     ring depth of each, 27f level-1 projection, NVIDIA H100 80GB HBM3,
//     700 W; PERF.md). W is copied with cp.async, 16 bytes at a time
//     where N and the pointers allow;
//   * the row map (one division) is computed once per thread row and
//     turned into a row pointer once per piece, in 64-bit arithmetic;
//   * the epilogue keeps scale/shift in registers and reads the residual
//     and writes the output 16 bytes at a time where aligned.
// Two instantiations: VEC (every K_p and N a multiple of 4, every pointer
// 16-byte aligned: 16-byte loads, copies and epilogue) and the general one
// (4-byte loads and copies, scalar epilogue), picked by the wrapper
// (kernels.gemm_variant).
//
// bf16 I/O (bf16 storage; the TPU kernels read their block's input in its
// dtype, upcast on load and write the output in it, fused_gab.py:501-541):
// bit p of `dtypes` makes piece p's A bf16, bit 3 the residual, bit 4 the
// output. A bf16 value is upcast exactly as it is loaded (8-byte loads of
// 4 values in VEC), the FMAs and the epilogue stay float32, and a bf16
// output is rounded to nearest even as it is stored. W, scale and shift
// are float32. The flags are read at run time, in a library of their own
// (below).
#include <cuda_runtime.h>
#include <stdint.h>

// GASTX_BF16_IO builds the bf16-I/O library (kernels.py, IO_SOURCES), whose
// code reads the dtype bits; the float32 library's has no dtype branch.
#ifdef GASTX_BF16_IO
constexpr bool BF16_IO = true;
#else
constexpr bool BF16_IO = false;
#endif

namespace {

constexpr int BM = 128;
constexpr int BN = 128;
constexpr int BK = 16;
constexpr int THREADS = 256;
constexpr int MAX_PIECES = 3;

// A is staged through registers: thread t reads the float4 (4 k) at
// k-chunk t % (BK/4) of rows t / (BK/4) + (THREADS*4/BK)*i, i < A_ROWS,
// and stores it transposed, k-major, after the slab's FMAs, into a row
// pitch of BM + 4 floats (a store instruction conflicts at most 2-way;
// the micro-kernel's LDS.128 do not conflict).
constexpr int A_CHUNKS = BK / 4;
constexpr int A_ROWS = BM * A_CHUNKS / THREADS;
constexpr int A_ROW_STEP = THREADS / A_CHUNKS;
constexpr int AS_PITCH = BM + 4;
constexpr int AS_FLOATS = BK * AS_PITCH;
constexpr int STAGE_FLOATS = AS_FLOATS + BK * BN;
// Two buffers, 33 KB: under the 48 KB a launch takes without opting in.
constexpr size_t SMEM_BYTES = sizeof(float) * 2 * STAGE_FLOATS;

struct GemmArgs {
  const void* a[MAX_PIECES];  // float32 or bf16 (dtypes bit p)
  const float* w[MAX_PIECES];
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

constexpr int RES_BF16 = 8;
constexpr int OUT_BF16 = 16;

// bf16 bits to float32, exactly.
__device__ __forceinline__ float bf16_to_float(unsigned short h) {
  return __uint_as_float(static_cast<uint32_t>(h) << 16);
}

// Four bf16 values (8 bytes) to float32.
__device__ __forceinline__ float4 bf16x4_to_float4(uint2 v) {
  return make_float4(__uint_as_float(v.x << 16),
                     __uint_as_float(v.x & 0xffff0000u),
                     __uint_as_float(v.y << 16),
                     __uint_as_float(v.y & 0xffff0000u));
}

// float32 to bf16 bits, rounded to nearest even (finite values).
__device__ __forceinline__ unsigned short float_to_bf16(float f) {
  const uint32_t u = __float_as_uint(f);
  return static_cast<unsigned short>((u + 0x7fffu + ((u >> 16) & 1u)) >> 16);
}

// Element k of a float32 or bf16 row (`row` in bytes), as float32.
__device__ __forceinline__ float load_at(const char* row, int k, bool bf) {
  return bf ? bf16_to_float(
                  __ldg(reinterpret_cast<const unsigned short*>(row) + k))
            : __ldg(reinterpret_cast<const float*>(row) + k);
}

template <typename T>
__device__ __forceinline__ T pick(const T (&v)[MAX_PIECES], int p) {
  return p == 0 ? v[0] : (p == 1 ? v[1] : v[2]);
}

// s * s_in + q for r = s * s_out + q.
__device__ __forceinline__ long long map_row(int r, int s_out, int s_in) {
  const int s = r / s_out;
  return (long long)s * s_in + (r - s * s_out);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Copies 4 (16) bytes, or writes zeros where !valid (src-size 0).
__device__ __forceinline__ void cp_async4(uint32_t dst, const float* src,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const float* src,
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

template <bool VEC>
__global__ void __launch_bounds__(THREADS, 2)
gemm_epilogue_kernel(const GemmArgs args, int tiles_n) {
  extern __shared__ __align__(16) float smem[];

  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int warp = tid / 32;
  const int row0 = (blockIdx.x / tiles_n) * BM;
  const int col0 = (blockIdx.x % tiles_n) * BN;
  const int m = args.m, n = args.n;

  // The rows this thread loads: their mapped row s * a_s_in + q, or -1
  // past m; turned into pointers once per piece.
  const int a_k = (tid % A_CHUNKS) * 4;
  int a_row[A_ROWS], a_base[A_ROWS];
#pragma unroll
  for (int i = 0; i < A_ROWS; ++i) {
    a_row[i] = tid / A_CHUNKS + A_ROW_STEP * i;
    const int r = row0 + a_row[i];
    a_base[i] = r < m ? (int)map_row(r, args.s_out, args.a_s_in) : -1;
  }

  // The load side walks (piece, k0) as one stream of slabs. a_ptr[i]:
  // row i's k 0 in the piece's A, in bytes (float32, or bf16 where a_bf).
  const char* a_ptr[A_ROWS];
  bool a_bf = false;
  const float* w_ptr;
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
    w_ptr = pick(args.w, p);
  };
  set_piece(0);
  int total = 0;
  for (int p = 0; p < args.npieces; ++p)
    total += (pick(args.k, p) + BK - 1) / BK;

  float a_stage[A_ROWS][4];
  int a_slot = -1;  // the buffer a_stage belongs to; -1: none

  // Loads the next slab's A into registers (stored by store_a after the
  // FMAs) and issues the copies of its W into buffer `slot`; commits one
  // group, empty past the last slab.
  auto load_slab = [&](int slot) {
    if (lp < args.npieces) {
#pragma unroll
      for (int i = 0; i < A_ROWS; ++i) {
        const int k = lk0 + a_k;
        if constexpr (VEC) {  // K % 4 == 0: the 4 k are in or out
          float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
          if (a_base[i] >= 0 && k < lK)
            v = a_bf ? bf16x4_to_float4(__ldg(reinterpret_cast<const uint2*>(
                           reinterpret_cast<const unsigned short*>(a_ptr[i]) +
                           k)))
                     : __ldg(reinterpret_cast<const float4*>(
                           reinterpret_cast<const float*>(a_ptr[i]) + k));
          a_stage[i][0] = v.x; a_stage[i][1] = v.y;
          a_stage[i][2] = v.z; a_stage[i][3] = v.w;
        } else {
#pragma unroll
          for (int e = 0; e < 4; ++e)
            a_stage[i][e] = (a_base[i] >= 0 && k + e < lK)
                ? load_at(a_ptr[i], k + e, a_bf) : 0.f;
        }
      }
      a_slot = slot;
      float* Ws = smem + slot * STAGE_FLOATS + AS_FLOATS;
      if constexpr (VEC) {
#pragma unroll
        for (int c = 0; c < BK * BN / 4 / THREADS; ++c) {
          const int idx = tid + c * THREADS;
          const int kr = idx / (BN / 4);
          const int cc = (idx % (BN / 4)) * 4;
          const bool v = lk0 + kr < lK && col0 + cc < n;
          cp_async16(smem_addr(Ws + kr * BN + cc),
                     v ? w_ptr + (long long)(lk0 + kr) * n + col0 + cc : w_ptr,
                     v);
        }
      } else {
#pragma unroll
        for (int c = 0; c < BK * BN / THREADS; ++c) {
          const int idx = tid + c * THREADS;
          const int kr = idx / BN;
          const int cc = idx % BN;
          const bool v = lk0 + kr < lK && col0 + cc < n;
          cp_async4(smem_addr(Ws + kr * BN + cc),
                    v ? w_ptr + (long long)(lk0 + kr) * n + col0 + cc : w_ptr,
                    v);
        }
      }
      lk0 += BK;
      if (lk0 >= lK) {
        lk0 = 0;
        if (++lp < args.npieces) set_piece(lp);
      }
    }
    cp_async_commit();
  };
  // The staged A, transposed into its slot's As.
  auto store_a = [&]() {
    if (a_slot < 0) return;
    float* As = smem + a_slot * STAGE_FLOATS;
    a_slot = -1;
#pragma unroll
    for (int e = 0; e < 4; ++e)
#pragma unroll
      for (int i = 0; i < A_ROWS; ++i)
        As[(a_k + e) * AS_PITCH + a_row[i]] = a_stage[i][e];
  };

  // The micro-kernel: warp (wm, wn) of a 2x4 grid owns a 64x32 warp tile,
  // lane (tr, tc) of 8x4 the 2x2 sub-tiles (i, j) of 4x4 at rows wm + 32i
  // + 4tr .. +3 and columns wn + 16j + 4tc .. +3.
  const int wm = (warp / 4) * 64 + (lane / 4) * 4;
  const int wn = (warp % 4) * 32 + (lane % 4) * 4;
  float acc[2][2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int ii = 0; ii < 4; ++ii)
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) acc[i][j][ii][jj] = 0.f;

  // Two buffers: slab t + 1 loads into one while slab t is multiplied
  // from the other.
  load_slab(0);
  store_a();
  for (int t = 0; t < total; ++t) {
    cp_async_wait_all();
    __syncthreads();
    // Buffer (t + 1) % 2 was read in the last step, before the barrier.
    load_slab((t + 1) % 2);
    const float* As = smem + (t % 2) * STAGE_FLOATS;
    const float* Ws = As + AS_FLOATS;
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      float a[2][4], w[2][4];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const float4 v = *reinterpret_cast<const float4*>(
            As + kk * AS_PITCH + wm + 32 * i);
        a[i][0] = v.x; a[i][1] = v.y; a[i][2] = v.z; a[i][3] = v.w;
      }
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const float4 v = *reinterpret_cast<const float4*>(
            Ws + kk * BN + wn + 16 * j);
        w[j][0] = v.x; w[j][1] = v.y; w[j][2] = v.z; w[j][3] = v.w;
      }
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
          for (int ii = 0; ii < 4; ++ii)
#pragma unroll
            for (int jj = 0; jj < 4; ++jj)
              acc[i][j][ii][jj] = fmaf(a[i][ii], w[j][jj], acc[i][j][ii][jj]);
    }
    store_a();
  }
  cp_async_wait_all();

  // Epilogue: * scale + shift, ReLU, + residual, in that order.
  const bool res_bf = BF16_IO && (args.dtypes & RES_BF16);
  const bool out_bf = BF16_IO && (args.dtypes & OUT_BF16);
  float sc[2][4], sh[2][4];
#pragma unroll
  for (int j = 0; j < 2; ++j)
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
      const int c = col0 + wn + 16 * j + jj;
      const bool v = args.scale != nullptr && c < n;
      sc[j][jj] = v ? args.scale[c] : 1.f;
      sh[j][jj] = v ? args.shift[c] : 0.f;
    }
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int ii = 0; ii < 4; ++ii) {
      const int r = row0 + wm + 32 * i + ii;
      if (r >= m) continue;
      // Row r's column 0 in the residual and output, in bytes.
      const char* res_row =
          args.res ? static_cast<const char*>(args.res) +
                         (map_row(r, args.s_out, args.res_s_in) +
                          args.res_off) * (long long)n * (res_bf ? 2 : 4)
                   : nullptr;
      char* out_row =
          static_cast<char*>(args.out) + (long long)r * n * (out_bf ? 2 : 4);
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int c = col0 + wn + 16 * j;
        float v[4];
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
          v[jj] = acc[i][j][ii][jj];
          if (args.scale) v[jj] = v[jj] * sc[j][jj] + sh[j][jj];
          if (args.relu) v[jj] = fmaxf(v[jj], 0.f);
        }
        if constexpr (VEC) {
          if (c >= n) continue;  // n % 4 == 0: the 4 columns are in or out
          if (res_row) {
            const float4 rv =
                res_bf ? bf16x4_to_float4(*reinterpret_cast<const uint2*>(
                             reinterpret_cast<const unsigned short*>(res_row) +
                             c))
                       : *reinterpret_cast<const float4*>(
                             reinterpret_cast<const float*>(res_row) + c);
            v[0] += rv.x; v[1] += rv.y; v[2] += rv.z; v[3] += rv.w;
          }
          if (out_bf) {
            uint2 o;
            o.x = float_to_bf16(v[0]) | (uint32_t)float_to_bf16(v[1]) << 16;
            o.y = float_to_bf16(v[2]) | (uint32_t)float_to_bf16(v[3]) << 16;
            *reinterpret_cast<uint2*>(
                reinterpret_cast<unsigned short*>(out_row) + c) = o;
          } else {
            *reinterpret_cast<float4*>(reinterpret_cast<float*>(out_row) + c) =
                make_float4(v[0], v[1], v[2], v[3]);
          }
        } else {
#pragma unroll
          for (int jj = 0; jj < 4; ++jj) {
            if (c + jj >= n) continue;
            float y = v[jj];
            if (res_row)
              y += res_bf ? bf16_to_float(reinterpret_cast<const uint16_t*>(
                                res_row)[c + jj])
                          : reinterpret_cast<const float*>(res_row)[c + jj];
            if (out_bf)
              reinterpret_cast<unsigned short*>(out_row)[c + jj] =
                  float_to_bf16(y);
            else
              reinterpret_cast<float*>(out_row)[c + jj] = y;
          }
        }
      }
    }
}

template <bool VEC>
int launch(const void* a0, const void* w0, int k0, int off0, const void* a1,
           const void* w1, int k1, int off1, const void* a2, const void* w2,
           int k2, int off2, int npieces, int m, int n, int s_out,
           int a_s_in, int res_s_in, const void* scale, const void* shift,
           int relu, const void* res, int res_off, void* out, void* stream,
           int dtypes) {
  GemmArgs args;
  const void* as[MAX_PIECES] = {a0, a1, a2};
  const void* ws[MAX_PIECES] = {w0, w1, w2};
  const int ks[MAX_PIECES] = {k0, k1, k2};
  const int offs[MAX_PIECES] = {off0, off1, off2};
  for (int p = 0; p < MAX_PIECES; ++p) {
    args.a[p] = as[p];
    args.w[p] = static_cast<const float*>(ws[p]);
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
  if constexpr (VEC) {  // gemm_variant picks VEC only where these hold
    bool ok = n % 4 == 0 && reinterpret_cast<uintptr_t>(out) % 16 == 0 &&
              reinterpret_cast<uintptr_t>(res) % 16 == 0;
    for (int p = 0; p < npieces; ++p)
      ok = ok && ks[p] % 4 == 0 &&
           reinterpret_cast<uintptr_t>(as[p]) % 16 == 0 &&
           reinterpret_cast<uintptr_t>(ws[p]) % 16 == 0;
    if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  }
  if (m > 0 && n > 0) {
    const int tiles_n = (n + BN - 1) / BN;
    const long long tiles = (long long)tiles_n * ((m + BM - 1) / BM);
    gemm_epilogue_kernel<VEC><<<(unsigned)tiles, THREADS, SMEM_BYTES,
                                static_cast<cudaStream_t>(stream)>>>(
        args, tiles_n);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Launches the 16-byte instantiation if vec16, else the general one, on
// `stream`, the activations' dtypes by `dtypes` (bit p: A piece p bf16;
// bit 3 the residual, bit 4 the output); returns cudaGetLastError() after
// the launch (cudaErrorInvalidValue, with no launch, where vec16's
// alignment does not hold or, in the float32 library, for a bf16
// activation).
int gemm_epilogue(const void* a0, const void* w0, int k0, int off0,
                  const void* a1, const void* w1, int k1, int off1,
                  const void* a2, const void* w2, int k2, int off2,
                  int npieces, int m, int n, int s_out, int a_s_in,
                  int res_s_in, const void* scale, const void* shift,
                  int relu, const void* res, int res_off, void* out,
                  void* stream, int dtypes, int vec16) {
  if (dtypes && !BF16_IO) return static_cast<int>(cudaErrorInvalidValue);
  const auto run = vec16 ? launch<true> : launch<false>;
  return run(a0, w0, k0, off0, a1, w1, k1, off1, a2, w2, k2, off2, npieces,
             m, n, s_out, a_s_in, res_s_in, scale, shift, relu, res,
             res_off, out, stream, dtypes);
}

const char* error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
