// Multi-head attention over the joints of one frame, for sm_90a.
//
// Replaces the score/softmax/apply chain of gastx/ops/pallas/fused_gab.py
// `_global_branch` (the TPU kernel's per-head rank-1 score dots, grouped
// LeakyReLU/softmax chains and per-head apply dots). For each frame and
// head k, with theta/phi/g the head's columns of the projection output:
//
//   sa[q] = theta_k[q] . p_theta[k]      sb[m] = phi_k[m] . p_phi[k]
//   f[q, m] = LeakyReLU_0.2(sa[q] + sb[m])
//   attn[q, m] = softmax_m(f[q, :])[m] + C_k[k, q, m]   (row max subtracted)
//   out[q, k*G + g] = sum_m attn[q, m] * g_k[m, g]      (head-major)
//
// Bound on this card: per frame it reads 3C projection values per joint
// and writes C (16*J*C bytes) for about J*C*(J + 2) FMAs, about 2.4
// operations per byte, under the card's float32 ridge of ~20, so
// device-memory bytes bound it. Design: one block per frame, one warp per
// head; the head's J x J scores, its sa/sb vectors and its J x G slab of g
// live in shared memory, so each projection value is read from device
// memory once. The score dots are warp reductions, the softmax runs one
// lane per query joint (J <= 32), and the apply loop puts consecutive
// lanes on consecutive output channels.
#include <cuda_runtime.h>
#include <math.h>

namespace {

__global__ void joint_attention_kernel(const float* __restrict__ theta,
                                       const float* __restrict__ phi,
                                       const float* __restrict__ g, int ldp,
                                       const float* __restrict__ proj_t,
                                       const float* __restrict__ proj_p,
                                       const float* __restrict__ c_k,
                                       float* __restrict__ out, int j,
                                       int inter, int g_ch, int heads) {
  extern __shared__ float smem[];
  const int k = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const long long frame = blockIdx.x;
  const int per_head = j * j + 2 * j + j * g_ch;
  float* s = smem + k * per_head;
  float* sa = s + j * j;
  float* sb = sa + j;
  float* gs = sb + j;

  const long long row0 = frame * j;
  const float* th = theta + row0 * ldp + k * inter;
  const float* ph = phi + row0 * ldp + k * inter;
  const float* gk = g + row0 * ldp + k * g_ch;
  const float* pt = proj_t + k * inter;
  const float* pp = proj_p + k * inter;

  for (int q = 0; q < j; ++q) {
    float s1 = 0.f, s2 = 0.f;
    for (int i = lane; i < inter; i += 32) {
      s1 = fmaf(th[(long long)q * ldp + i], pt[i], s1);
      s2 = fmaf(ph[(long long)q * ldp + i], pp[i], s2);
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      s1 += __shfl_xor_sync(0xffffffffu, s1, o);
      s2 += __shfl_xor_sync(0xffffffffu, s2, o);
    }
    if (lane == 0) {
      sa[q] = s1;
      sb[q] = s2;
    }
  }
  for (int idx = lane; idx < j * g_ch; idx += 32) {
    const int m = idx / g_ch;
    gs[idx] = gk[(long long)m * ldp + (idx - m * g_ch)];
  }
  __syncwarp();

  if (lane < j) {
    const int q = lane;
    const float a = sa[q];
    float mx = -INFINITY;
    for (int m = 0; m < j; ++m) {
      float f = a + sb[m];
      f = f > 0.f ? f : 0.2f * f;
      s[q * j + m] = f;
      mx = fmaxf(mx, f);
    }
    float sum = 0.f;
    for (int m = 0; m < j; ++m) {
      const float e = expf(s[q * j + m] - mx);
      s[q * j + m] = e;
      sum += e;
    }
    const float* ck = c_k + ((long long)k * j + q) * j;
    for (int m = 0; m < j; ++m) s[q * j + m] = s[q * j + m] / sum + ck[m];
  }
  __syncwarp();

  const int kg = heads * g_ch;
  for (int c = lane; c < g_ch; c += 32) {
    for (int q = 0; q < j; ++q) {
      float acc = 0.f;
      for (int m = 0; m < j; ++m)
        acc = fmaf(s[q * j + m], gs[m * g_ch + c], acc);
      out[(row0 + q) * kg + k * g_ch + c] = acc;
    }
  }
}

}  // namespace

extern "C" {

// Launches on `stream`; returns cudaGetLastError() after the launch.
int joint_attention(const void* theta, const void* phi, const void* g,
                    int ldp, const void* proj_t, const void* proj_p,
                    const void* c_k, void* out, long long frames, int j,
                    int inter, int g_ch, int heads, void* stream) {
  const size_t smem = sizeof(float) * heads * (j * j + 2 * j + j * g_ch);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        joint_attention_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  if (frames > 0) {
    joint_attention_kernel<<<(unsigned)frames, 32 * heads, smem,
                             static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(theta), static_cast<const float*>(phi),
        static_cast<const float*>(g), ldp,
        static_cast<const float*>(proj_t), static_cast<const float*>(proj_p),
        static_cast<const float*>(c_k), static_cast<float*>(out), j, inter,
        g_ch, heads);
  }
  return static_cast<int>(cudaGetLastError());
}

const char* error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
