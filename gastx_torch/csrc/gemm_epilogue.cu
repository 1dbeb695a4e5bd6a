// Tiled float32 GEMM with a fused epilogue, for sm_90a.
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
// 128..3584, M up to ~4e5) the products are far above the f32 ridge
// point, so the kernel is bound by the SMs' float32 FMA rate (67 TFLOP/s
// outside the tensor cores). Design: 128x128 output tiles per block of 256
// threads, 8x8 register micro-tiles strided by 16 so shared-memory reads
// are broadcast or conflict-free, a BK=8 slab of A (stored transposed) and
// W in shared memory, masked loads and stores on every ragged edge. No
// tensor cores, TMA or pipelining yet: a right, simple kernel first.
#include <cuda_runtime.h>

namespace {

constexpr int BM = 128;
constexpr int BN = 128;
constexpr int BK = 8;
constexpr int TM = 8;
constexpr int TN = 8;
constexpr int THREADS = (BM / TM) * (BN / TN);  // 256
constexpr int MAX_PIECES = 3;

struct GemmArgs {
  const float* a[MAX_PIECES];
  const float* w[MAX_PIECES];
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

__device__ __forceinline__ long long map_row(int r, int s_out, int s_in,
                                             int off) {
  const int s = r / s_out;
  return (long long)s * s_in + (r - s * s_out) + off;
}

__global__ void __launch_bounds__(THREADS)
gemm_epilogue_kernel(const GemmArgs args) {
  __shared__ float As[BK][BM];
  __shared__ float Ws[BK][BN];

  const int tid = threadIdx.x;
  const int tx = tid % (BN / TN);  // 0..15, column group
  const int ty = tid / (BN / TN);  // 0..15, row group
  const int row0 = blockIdx.y * BM;
  const int col0 = blockIdx.x * BN;

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  // Each thread loads BM*BK/THREADS = 4 elements of the A slab and 4 of
  // the W slab per step; the rows it loads are fixed across k steps.
  constexpr int A_LOADS = BM * BK / THREADS;
  constexpr int W_LOADS = BK * BN / THREADS;

  for (int p = 0; p < args.npieces; ++p) {
    const float* __restrict__ A = args.a[p];
    const float* __restrict__ W = args.w[p];
    const int K = args.k[p];

    const float* arow[A_LOADS];
    int acol[A_LOADS], arow_l[A_LOADS];
#pragma unroll
    for (int i = 0; i < A_LOADS; ++i) {
      const int idx = tid + i * THREADS;
      const int rl = idx / BK;
      arow_l[i] = rl;
      acol[i] = idx % BK;
      const int r = row0 + rl;
      arow[i] = r < args.m
          ? A + map_row(r, args.s_out, args.a_s_in, args.a_off[p]) * K
          : nullptr;
    }

    for (int k0 = 0; k0 < K; k0 += BK) {
#pragma unroll
      for (int i = 0; i < A_LOADS; ++i) {
        const int kk = k0 + acol[i];
        As[acol[i]][arow_l[i]] =
            (arow[i] != nullptr && kk < K) ? arow[i][kk] : 0.f;
      }
#pragma unroll
      for (int i = 0; i < W_LOADS; ++i) {
        const int idx = tid + i * THREADS;
        const int kl = idx / BN;
        const int cl = idx % BN;
        const int kk = k0 + kl;
        const int c = col0 + cl;
        Ws[kl][cl] = (kk < K && c < args.n) ? W[(long long)kk * args.n + c]
                                            : 0.f;
      }
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < BK; ++kk) {
        float af[TM], wf[TN];
#pragma unroll
        for (int i = 0; i < TM; ++i) af[i] = As[kk][ty + i * (BM / TM)];
#pragma unroll
        for (int j = 0; j < TN; ++j) wf[j] = Ws[kk][tx + j * (BN / TN)];
#pragma unroll
        for (int i = 0; i < TM; ++i)
#pragma unroll
          for (int j = 0; j < TN; ++j)
            acc[i][j] = fmaf(af[i], wf[j], acc[i][j]);
      }
      __syncthreads();
    }
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int r = row0 + ty + i * (BM / TM);
    if (r >= args.m) continue;
    const float* res_row = args.res
        ? args.res +
              map_row(r, args.s_out, args.res_s_in, args.res_off) * args.n
        : nullptr;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int c = col0 + tx + j * (BN / TN);
      if (c >= args.n) continue;
      float v = acc[i][j];
      if (args.scale) v = v * args.scale[c] + args.shift[c];
      if (args.relu) v = fmaxf(v, 0.f);
      if (res_row) v += res_row[c];
      args.out[(long long)r * args.n + c] = v;
    }
  }
}

}  // namespace

extern "C" {

// Launches on `stream`; returns cudaGetLastError() after the launch.
int gemm_epilogue(const void* a0, const void* w0, int k0, int off0,
                  const void* a1, const void* w1, int k1, int off1,
                  const void* a2, const void* w2, int k2, int off2,
                  int npieces, int m, int n, int s_out, int a_s_in,
                  int res_s_in, const void* scale, const void* shift,
                  int relu, const void* res, int res_off, void* out,
                  void* stream) {
  GemmArgs args;
  const void* as[MAX_PIECES] = {a0, a1, a2};
  const void* ws[MAX_PIECES] = {w0, w1, w2};
  const int ks[MAX_PIECES] = {k0, k1, k2};
  const int offs[MAX_PIECES] = {off0, off1, off2};
  for (int p = 0; p < MAX_PIECES; ++p) {
    args.a[p] = static_cast<const float*>(as[p]);
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
  args.res = static_cast<const float*>(res);
  args.res_off = res_off;
  args.out = static_cast<float*>(out);
  if (m > 0 && n > 0) {
    dim3 grid((n + BN - 1) / BN, (m + BM - 1) / BM);
    gemm_epilogue_kernel<<<grid, THREADS, 0,
                           static_cast<cudaStream_t>(stream)>>>(args);
  }
  return static_cast<int>(cudaGetLastError());
}

const char* error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
