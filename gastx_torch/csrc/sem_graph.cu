// Semantic graph aggregation of the GAB's local branch, for sm_90a.
//
// Replaces the aggregation loop of gastx/ops/pallas/fused_gab.py
// `_local_branch` (per-joint static-index FMAs over the masked-softmax
// edge weights). For both branches b (0 = sym, 1 = con) and each row
// r = frame * J + q, channel c:
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
// degree D with zero weights) are built on the host, as
// `_local_weight_tables` does. The output is (rows, 2C) = [sym | con], the
// operand of the 2C->C local cat product.
//
// Bound on this card: about 2*(1+D) loads and FMAs per output, with
// the neighbour rows hot in L1/L2, so device-memory bytes bound it: read
// the 4C projection columns once, write 2C. Design: one thread per output
// element, consecutive threads on consecutive channels so every load and
// store is coalesced.
#include <cuda_runtime.h>

namespace {

__global__ void sem_graph_kernel(const float* __restrict__ p, int ldp,
                                 float* __restrict__ out, long long rows,
                                 int j, int c, int d,
                                 const float* __restrict__ w_self,
                                 const float* __restrict__ w_nbr,
                                 const int* __restrict__ col,
                                 const float* __restrict__ scale,
                                 const float* __restrict__ shift) {
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const int c2 = 2 * c;
  if (idx >= rows * c2) return;
  const long long r = idx / c2;
  const int cc = (int)(idx - r * c2);
  const int b = cc / c;
  const int ch = cc - b * c;
  const int q = (int)(r % j);
  const long long base = r - q;
  const int bq = b * j + q;

  const float* h0 = p + b * c2 + ch;
  const float* h1 = p + b * c2 + c + ch;
  float acc = h0[r * ldp] * w_self[(long long)bq * c + ch];
  for (int dd = 0; dd < d; ++dd) {
    const int nb = col[bq * d + dd];
    acc = fmaf(h1[(base + nb) * ldp], w_nbr[((long long)bq * d + dd) * c + ch],
               acc);
  }
  out[r * c2 + cc] = fmaxf(acc * scale[cc] + shift[cc], 0.f);
}

}  // namespace

extern "C" {

// Launches on `stream`; returns cudaGetLastError() after the launch.
int sem_graph(const void* p, int ldp, void* out, long long rows, int j,
              int c, int d, const void* w_self, const void* w_nbr,
              const void* col, const void* scale, const void* shift,
              void* stream) {
  const long long total = rows * 2 * c;
  if (total > 0) {
    const int threads = 256;
    const long long blocks = (total + threads - 1) / threads;
    sem_graph_kernel<<<(unsigned)blocks, threads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(p), ldp, static_cast<float*>(out), rows,
        j, c, d, static_cast<const float*>(w_self),
        static_cast<const float*>(w_nbr), static_cast<const int*>(col),
        static_cast<const float*>(scale), static_cast<const float*>(shift));
  }
  return static_cast<int>(cudaGetLastError());
}

const char* error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
