// Semantic graph aggregation of the GAB's local branch, for sm_90a.
//
// Replaces the aggregation loop of gastx/ops/pallas/fused_gab.py:190-202
// `_local_branch` (`sem_conv`: per-joint static-index FMAs over the
// masked-softmax edge weights). For both branches b (0 = sym, 1 = con) and
// each row r = frame * J + q, channel c:
//
//   out[r, b*C + c] = relu((h0[r, c] * w_self[b, q, c]
//                           + sum_d h1[frame*J + col[b, q, d], c]
//                                   * w_nbr[b, q, d, c])
//                          * scale[b*C + c] + shift[b*C + c])
//
// where h0/h1 of branch b are columns [2bC, 2bC + C) and [2bC + C,
// 2bC + 2C) of the projection output P (row stride ldp): the GEMM that
// precedes this kernel computes [W0_sym | W1_sym | W0_con | W1_con | ...]
// in one launch. The tables (softmax edge weights padded to the larger row
// degree D with zero weights; the diagonal slot of a row has zero weight
// too) are built on the host, as `_local_weight_tables` does. The output
// is (rows, 2C) = [sym | con], the operand of the 2C->C local cat product.
//
// Bound on this card: about 2 (1 + D) FMAs per output against 12 bytes
// of device memory (4 of h0, 4 of h1, 4 written), so device-memory bytes
// bound it: read the 4C projection columns once, write 2C. The design
// aims at moving those bytes at the card's rate and nothing else:
//
// - Persistent blocks, about one wave. A block owns a slice of up to 64
//   channels (16 lanes of 4, or of 1 in the 4-byte instantiation) of one
//   branch and walks tiles of FRAMES whole frames. Thread (q, lane) owns
//   joint q and the lane's channels for the whole run, so no division
//   happens past the block's first lines and none is 64-bit.
// - Staged once per block: the slice's w_self and w_nbr for every (q, d),
//   and, for each joint, the list of its neighbour slots whose weights are
//   not all zero on the slice (the padded and diagonal slots drop out:
//   acc + 0 * h == acc for finite h; the order h0 * w_self, then the
//   neighbours in slot order, is kept). Scale and shift live in registers.
// - The h0 and h1 columns of the slice arrive by cp.async (16 bytes a
//   lane, a 256-byte run a row and half), into two shared-memory buffers:
//   the next tile's loads are in flight while this one computes, 17 to 35
//   KB a block at J = 17 and two blocks an SM.
// - Each thread computes its joint's outputs for every frame of the tile
//   from shared memory, each neighbour weight read once a tile, and
//   stores them as float4 (coalesced: 16 lanes write 256 contiguous
//   bytes). So each P value is read from device memory once and each
//   output written once.
//
// Two instantiations: VEC = 4 (16-byte copies, loads and stores) where C
// and ldp are multiples of 4 and P and out start 16-byte aligned, and
// VEC = 1 (4-byte) otherwise, e.g. a view at an odd column offset
// (kernels.graph_variant picks; the C entry point refuses VEC = 4 for
// operands that do not meet its rule). J <= 32 and D <= 8.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int MAX_J = 32;
constexpr int MAX_D = 8;
constexpr int LANES = 16;   // threads along a row of the slice
constexpr int FRAMES = 4;   // frames a tile

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
  static __device__ __forceinline__ T loadu(const float* p) {  // unaligned
    return make_float4(p[0], p[1], p[2], p[3]);
  }
  static __device__ __forceinline__ void store(float* p, T v) {
    *reinterpret_cast<float4*>(p) = v;
  }
  static __device__ __forceinline__ T zero() {
    return make_float4(0.f, 0.f, 0.f, 0.f);
  }
  static __device__ __forceinline__ T mul(T a, T b) {
    return make_float4(a.x * b.x, a.y * b.y, a.z * b.z, a.w * b.w);
  }
  static __device__ __forceinline__ T fma(T a, T b, T c) {
    return make_float4(fmaf(a.x, b.x, c.x), fmaf(a.y, b.y, c.y),
                       fmaf(a.z, b.z, c.z), fmaf(a.w, b.w, c.w));
  }
  static __device__ __forceinline__ T bn_relu(T a, T s, T t) {
    return make_float4(fmaxf(a.x * s.x + t.x, 0.f), fmaxf(a.y * s.y + t.y, 0.f),
                       fmaxf(a.z * s.z + t.z, 0.f), fmaxf(a.w * s.w + t.w, 0.f));
  }
};
template <>
struct Vec<1> {
  using T = float;
  static __device__ __forceinline__ T load(const float* p) { return *p; }
  static __device__ __forceinline__ T loadu(const float* p) { return *p; }
  static __device__ __forceinline__ void store(float* p, T v) { *p = v; }
  static __device__ __forceinline__ T zero() { return 0.f; }
  static __device__ __forceinline__ T mul(T a, T b) { return a * b; }
  static __device__ __forceinline__ T fma(T a, T b, T c) {
    return fmaf(a, b, c);
  }
  static __device__ __forceinline__ T bn_relu(T a, T s, T t) {
    return fmaxf(a * s + t, 0.f);
  }
};

// Grid (blocks a slice, 2 * slices): blockIdx.y is branch b's slice of
// lanes * VEC channels; blockIdx.x walks the frame tiles. j * lanes
// threads, thread (q, lane).
template <int VEC>
__global__ void __launch_bounds__(MAX_J * LANES)
    sem_graph_kernel(const float* __restrict__ p, long long ldp,
                     float* __restrict__ out, long long frames, int j, int c,
                     int d, int lanes, int slices,
                     const float* __restrict__ w_self,
                     const float* __restrict__ w_nbr,
                     const int* __restrict__ col,
                     const float* __restrict__ scale,
                     const float* __restrict__ shift) {
  using V = Vec<VEC>;
  extern __shared__ __align__(16) float smem[];
  const int s = lanes * VEC;  // channels of the slice
  const int b = blockIdx.y / slices;
  const int c0 = (blockIdx.y - b * slices) * s;
  const int nt = j * lanes;
  const int tid = threadIdx.x;
  const int q = tid / lanes;
  const int lane = tid - q * lanes;
  const int ch = c0 + lane * VEC;  // the thread's first channel
  const bool active = ch < c;

  // Shared memory: two tile buffers [FRAMES * j rows][h0 | h1: 2s], then
  // w_self [j][s], w_nbr [j][d][s], and the neighbour lists.
  const int tile = FRAMES * j * 2 * s;
  float* ws = smem + 2 * tile;
  float* wn = ws + j * s;
  int* used = reinterpret_cast<int*>(wn + j * d * s);  // [j][d]
  int* nbr = used + j * d;                             // [j][d]: joint
  int* slot = nbr + j * d;                             // [j][d]: its slot
  int* count = slot + j * d;                           // [j]

  for (int i = tid; i < j * d; i += nt) used[i] = 0;
  __syncthreads();
  const float* wsb = w_self + (long long)b * j * c + c0;
  const float* wnb = w_nbr + (long long)b * j * d * c + c0;
  for (int i = tid; i < j * s; i += nt) {
    const int row = i / s, cc = i - row * s;
    ws[i] = c0 + cc < c ? wsb[row * c + cc] : 0.f;
  }
  for (int i = tid; i < j * d * s; i += nt) {
    const int row = i / s, cc = i - row * s;
    const float w = c0 + cc < c ? wnb[(long long)row * c + cc] : 0.f;
    wn[i] = w;
    if (w != 0.f) used[row] = 1;  // NaN counts as used
  }
  __syncthreads();
  if (tid < j) {
    const int* colq = col + (b * j + tid) * d;
    int n = 0;
    for (int dd = 0; dd < d; ++dd) {
      if (used[tid * d + dd]) {
        nbr[tid * d + n] = colq[dd];
        slot[tid * d + n] = dd;
        ++n;
      }
    }
    count[tid] = n;
  }
  typename V::T sc = V::zero(), sh = V::zero();
  if (active) {
    sc = V::loadu(scale + b * c + ch);
    sh = V::loadu(shift + b * c + ch);
  }

  const long long tiles = (frames + FRAMES - 1) / FRAMES;
  const long long step = gridDim.x;
  const float* src = p + 2LL * b * c + ch + (long long)q * ldp;
  const long long frame_ld = (long long)j * ldp;
  // The thread copies its own (q, lane) h0 and h1 of each frame of a tile.
  auto load = [&](long long t, int buf) {
    if (t < tiles && active) {
      const long long f0 = t * FRAMES;
      const int nf = frames - f0 < FRAMES ? (int)(frames - f0) : FRAMES;
      float* dst = smem + buf * tile + q * 2 * s + lane * VEC;
      const float* g = src + f0 * frame_ld;
      for (int f = 0; f < nf; ++f) {
        cp_async<VEC>(dst + f * j * 2 * s, g + f * frame_ld);
        cp_async<VEC>(dst + f * j * 2 * s + s, g + f * frame_ld + c);
      }
    }
    cp_async_commit();
  };

  long long t = blockIdx.x;
  int buf = 0;
  load(t, 0);
  __syncthreads();  // the neighbour lists
  const int n = count[q];
  for (; t < tiles; t += step, buf ^= 1) {
    load(t + step, buf ^ 1);
    cp_async_wait<1>();
    __syncthreads();
    if (active) {
      const long long f0 = t * FRAMES;
      const int nf = frames - f0 < FRAMES ? (int)(frames - f0) : FRAMES;
      const float* h = smem + buf * tile + lane * VEC;
      typename V::T acc[FRAMES];
      const typename V::T w0 = V::load(ws + q * s + lane * VEC);
#pragma unroll
      for (int f = 0; f < FRAMES; ++f)
        acc[f] = f < nf ? V::mul(V::load(h + (f * j + q) * 2 * s), w0)
                        : V::zero();
      for (int k = 0; k < n; ++k) {
        const int nb = nbr[q * d + k];
        const typename V::T w =
            V::load(wn + (q * d + slot[q * d + k]) * s + lane * VEC);
#pragma unroll
        for (int f = 0; f < FRAMES; ++f)
          if (f < nf)
            acc[f] = V::fma(V::load(h + (f * j + nb) * 2 * s + s), w, acc[f]);
      }
      float* o = out + (f0 * j + q) * 2LL * c + b * c + ch;
#pragma unroll
      for (int f = 0; f < FRAMES; ++f)
        if (f < nf)
          V::store(o + (long long)f * j * 2 * c, V::bn_relu(acc[f], sc, sh));
    }
    __syncthreads();  // before the buffer is loaded again
  }
  cp_async_wait<0>();
}

int sms() {
  static int count = 0;
  if (count == 0) {
    int dev = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e == cudaSuccess)
      e = cudaDeviceGetAttribute(&count, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return -static_cast<int>(e);
  }
  return count;
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

// About one wave of persistent blocks, spread evenly over the slices.
template <int VEC>
int launch(const float* p, long long ldp, float* out, long long frames, int j,
           int c, int d, const float* w_self, const float* w_nbr,
           const int* col, const float* scale, const float* shift,
           cudaStream_t stream) {
  const int nsm = sms();
  if (nsm < 0) return -nsm;
  const int per_row = (c + VEC - 1) / VEC;
  const int lanes = per_row < LANES ? per_row : LANES;
  const int s = lanes * VEC;
  const int slices = (c + s - 1) / s;
  const int threads = j * lanes;
  const size_t smem = sizeof(float) * ((size_t)2 * FRAMES * j * 2 * s +
                                       (size_t)j * s + (size_t)j * d * s) +
                      sizeof(int) * (3 * j * d + j);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        sem_graph_kernel<VEC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  int per_sm = 0;
  cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, sem_graph_kernel<VEC>, threads, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (per_sm < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  const long long tiles = (frames + FRAMES - 1) / FRAMES;
  long long per_slice = (long long)per_sm * nsm / (2 * slices);
  if (per_slice < 1) per_slice = 1;
  if (per_slice > tiles) per_slice = tiles;
  if (tiles > 0) {
    sem_graph_kernel<VEC><<<dim3((unsigned)per_slice, 2 * slices), threads,
                            smem, stream>>>(p, ldp, out, frames, j, c, d,
                                            lanes, slices, w_self, w_nbr, col,
                                            scale, shift);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Launches the 16-byte instantiation if vec16, else the 4-byte one, on
// `stream`; returns cudaGetLastError() after the launch, or
// cudaErrorInvalidValue with no launch for a shape the kernel does not take
// (J > 32, D > 8, rows not whole frames, ldp < 4C) or, with vec16, for C or
// ldp not a multiple of 4 or p or out not 16-byte aligned.
int sem_graph(const void* p, int ldp, void* out, long long rows, int j,
              int c, int d, const void* w_self, const void* w_nbr,
              const void* col, const void* scale, const void* shift,
              void* stream, int vec16) {
  if (rows < 0 || j < 1 || j > MAX_J || d < 1 || d > MAX_D || c < 1 ||
      rows % j != 0 || ldp < 4 * c ||
      (vec16 && (c % 4 != 0 || ldp % 4 != 0 || !aligned16(p) ||
                 !aligned16(out))))
    return static_cast<int>(cudaErrorInvalidValue);
  const auto run = vec16 ? launch<4> : launch<1>;
  return run(static_cast<const float*>(p), ldp, static_cast<float*>(out),
             rows / j, j, c, d, static_cast<const float*>(w_self),
             static_cast<const float*>(w_nbr), static_cast<const int*>(col),
             static_cast<const float*>(scale),
             static_cast<const float*>(shift),
             static_cast<cudaStream_t>(stream));
}

const char* error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
