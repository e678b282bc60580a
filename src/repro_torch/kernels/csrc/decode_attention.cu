// Decode attention for Hopper (sm_90a): one query token per batch row
// against the KV cache, with sliding window, logit softcap, GQA and
// per-row q_offset / kv_len (the continuous engine's ragged slot pool).
//
// Replaces the Pallas TPU kernel src/repro/kernels/decode_attention.py
// (decode_attention, body _decode_kernel).
//
// Bound on an H100: bytes. Each step reads every kept K/V entry once,
// sum_b kv_len_b * Hkv * (Dk + Dv) * sizeof(T), for 4 * G FLOPs per K/V
// element pair: a few FLOPs per byte, far below the ridge.
//
// Design: one thread block per (batch row, kv head). The block handles the
// group's G query heads together, so each K/V entry is read from device
// memory once per group, not once per q head. The loop runs only over the
// row's own keys, [max(0, pos - window + 1), min(kv_len, Smax)), never to
// Smax. The 8 warps split those keys into interleaved 32-key chunks and
// each keeps its own fp32 (acc, m, l) online-softmax state; the warps'
// states are merged through shared memory at the end. For QK^T a lane owns
// one key, for PV a lane owns Dv/32 output columns. The grid is B x Hkv
// blocks (32 at 8 slots x 4 kv heads on 132 SMs): a split-KV second level
// across blocks is the next step (see PERF.md).
#include <stdint.h>

#include "common.cuh"

namespace repro_torch {
namespace {

constexpr int kWarps = 8;
constexpr int kChunk = 32;

size_t decode_smem_bytes(int G, int Dk, int Dv) {
  return sizeof(float) * (static_cast<size_t>(G) * Dk + kWarps * G * kChunk + 2 * kWarps * G +
                          static_cast<size_t>(kWarps) * G * Dv);
}

template <typename T, int G, int NC>  // G q heads per kv head, NC = Dv / 32
__global__ void __launch_bounds__(kWarps * 32)
decode_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
              T* __restrict__ o, const int32_t* __restrict__ q_offset,
              const int32_t* __restrict__ kv_len, int Smax, int Hkv, int Dk, int window,
              float softcap, float scale) {
  constexpr int Dv = NC * 32;
  extern __shared__ float smem[];
  float* qs = smem;                        // G x Dk
  float* ps = qs + G * Dk;                 // kWarps x G x kChunk
  float* ms = ps + kWarps * G * kChunk;    // kWarps x G
  float* ls = ms + kWarps * G;             // kWarps x G
  float* accs = ls + kWarps * G;           // kWarps x G x Dv

  const int hk = blockIdx.x;
  const int b = blockIdx.y;
  const int H = Hkv * G;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;

  for (int i = tid; i < G * Dk; i += blockDim.x)
    qs[i] = to_float(q[(static_cast<size_t>(b) * H + hk * G) * Dk + i]);
  __syncthreads();

  const int qpos = q_offset[b];
  const int k_hi = min(kv_len[b], Smax);
  const int k_lo = window > 0 ? max(0, qpos - window + 1) : 0;

  float m[G], l[G], acc[G][NC];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    m[g] = kNegInf;
    l[g] = 0.f;
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[g][c] = 0.f;
  }
  float* pw = ps + warp * G * kChunk;
  const size_t row_stride = static_cast<size_t>(Hkv) * Dk;
  const size_t vrow_stride = static_cast<size_t>(Hkv) * Dv;
  const T* kb = k + static_cast<size_t>(b) * Smax * row_stride + hk * Dk;
  const T* vb = v + static_cast<size_t>(b) * Smax * vrow_stride + hk * Dv;

  for (int kt = k_lo + warp * kChunk; kt < k_hi; kt += kWarps * kChunk) {
    const int kpos = kt + lane;
    const bool keep = kpos < k_hi;  // kpos >= k_lo keeps the window
    float s[G];
#pragma unroll
    for (int g = 0; g < G; ++g) s[g] = 0.f;
    if (keep) {
      const T* kr = kb + kpos * row_stride;
      for (int d = 0; d < Dk; ++d) {
        const float kd = to_float(kr[d]);
#pragma unroll
        for (int g = 0; g < G; ++g) s[g] = fmaf(qs[g * Dk + d], kd, s[g]);
      }
    }
#pragma unroll
    for (int g = 0; g < G; ++g) {
      const float x = keep ? apply_softcap(s[g] * scale, softcap) : kNegInf;
      const float m_new = fmaxf(m[g], warp_max(x));
      const float corr = expf(m[g] - m_new);
      const float p = keep ? expf(x - m_new) : 0.f;
      l[g] = l[g] * corr + warp_sum(p);
      m[g] = m_new;
#pragma unroll
      for (int c = 0; c < NC; ++c) acc[g][c] *= corr;
      pw[g * kChunk + lane] = p;
    }
    __syncwarp();
    const int nj = min(kChunk, k_hi - kt);
    for (int j = 0; j < nj; ++j) {
      const T* vr = vb + (kt + j) * vrow_stride;
      float vv[NC];
#pragma unroll
      for (int c = 0; c < NC; ++c) vv[c] = to_float(vr[lane + 32 * c]);
#pragma unroll
      for (int g = 0; g < G; ++g) {
        const float p = pw[g * kChunk + j];
#pragma unroll
        for (int c = 0; c < NC; ++c) acc[g][c] = fmaf(p, vv[c], acc[g][c]);
      }
    }
    __syncwarp();
  }

  // merge the warps' partial softmax states
#pragma unroll
  for (int g = 0; g < G; ++g) {
    if (lane == 0) {
      ms[warp * G + g] = m[g];
      ls[warp * G + g] = l[g];
    }
#pragma unroll
    for (int c = 0; c < NC; ++c) accs[(warp * G + g) * Dv + lane + 32 * c] = acc[g][c];
  }
  __syncthreads();
  for (int i = tid; i < G * Dv; i += blockDim.x) {
    const int g = i / Dv, d = i - g * Dv;
    float mx = kNegInf;
    for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, ms[w * G + g]);
    float lsum = 0.f, osum = 0.f;
    for (int w = 0; w < kWarps; ++w) {
      const float f = expf(ms[w * G + g] - mx);
      lsum += ls[w * G + g] * f;
      osum += accs[(w * G + g) * Dv + d] * f;
    }
    // no kept key: lsum == 0 and osum == 0, the row writes 0
    store(o + (static_cast<size_t>(b) * H + hk * G + g) * Dv + d, osum / fmaxf(lsum, 1e-30f));
  }
}

template <typename T, int G, int NC>
int launch(const void* q, const void* k, const void* v, void* o, const void* q_offset,
           const void* kv_len, int B, int Smax, int Hkv, int Dk, int window, float softcap,
           float scale, cudaStream_t stream) {
  const size_t smem = decode_smem_bytes(G, Dk, NC * 32);
  const cudaError_t attr = allow_smem(decode_kernel<T, G, NC>, smem);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const dim3 grid(Hkv, B);
  decode_kernel<T, G, NC><<<grid, kWarps * 32, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), static_cast<const int32_t*>(q_offset),
      static_cast<const int32_t*>(kv_len), Smax, Hkv, Dk, window, softcap, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int G>
int dispatch_dv(int Dv, const void* q, const void* k, const void* v, void* o,
                const void* q_offset, const void* kv_len, int B, int Smax, int Hkv, int Dk,
                int window, float softcap, float scale, cudaStream_t stream) {
  switch (Dv) {
    case 64:
      return launch<T, G, 2>(q, k, v, o, q_offset, kv_len, B, Smax, Hkv, Dk, window, softcap,
                             scale, stream);
    case 128:
      return launch<T, G, 4>(q, k, v, o, q_offset, kv_len, B, Smax, Hkv, Dk, window, softcap,
                             scale, stream);
    case 256:
      return launch<T, G, 8>(q, k, v, o, q_offset, kv_len, B, Smax, Hkv, Dk, window, softcap,
                             scale, stream);
    default:
      return -1;
  }
}

template <typename T>
int dispatch(int G, int Dv, const void* q, const void* k, const void* v, void* o,
             const void* q_offset, const void* kv_len, int B, int Smax, int Hkv, int Dk,
             int window, float softcap, float scale, cudaStream_t stream) {
  switch (G) {
    case 1:
      return dispatch_dv<T, 1>(Dv, q, k, v, o, q_offset, kv_len, B, Smax, Hkv, Dk, window,
                               softcap, scale, stream);
    case 2:
      return dispatch_dv<T, 2>(Dv, q, k, v, o, q_offset, kv_len, B, Smax, Hkv, Dk, window,
                               softcap, scale, stream);
    case 4:
      return dispatch_dv<T, 4>(Dv, q, k, v, o, q_offset, kv_len, B, Smax, Hkv, Dk, window,
                               softcap, scale, stream);
    case 8:
      return dispatch_dv<T, 8>(Dv, q, k, v, o, q_offset, kv_len, B, Smax, Hkv, Dk, window,
                               softcap, scale, stream);
    default:
      return -1;
  }
}

}  // namespace
}  // namespace repro_torch

// q (B,1,H,Dk), k (B,Smax,Hkv,Dk), v (B,Smax,Hkv,Dv), o (B,1,H,Dv), all
// contiguous and of one dtype, H = G * Hkv; q_offset and kv_len (B,) int32
// on the device. window <= 0 means no window, softcap <= 0 no softcap.
// Returns the CUDA error of the launch, or -1 for a shape the kernel does
// not take.
extern "C" int decode_attention_fwd(const void* q, const void* k, const void* v, void* o,
                                    const void* q_offset, const void* kv_len, int B, int Smax,
                                    int H, int Hkv, int Dk, int Dv, int window, float softcap,
                                    float scale, int dtype, void* stream) {
  using namespace repro_torch;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int G = H / Hkv;
  if (dtype == kFloat32)
    return dispatch<float>(G, Dv, q, k, v, o, q_offset, kv_len, B, Smax, Hkv, Dk, window,
                           softcap, scale, st);
  if (dtype == kBFloat16)
    return dispatch<__nv_bfloat16>(G, Dv, q, k, v, o, q_offset, kv_len, B, Smax, Hkv, Dk,
                                   window, softcap, scale, st);
  return -1;
}
