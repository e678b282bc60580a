// Prefill attention for Hopper (sm_90a), the fp32 route: blockwise
// online-softmax attention with causal mask, sliding window, logit softcap,
// GQA and per-row q_offset / kv_len, in exact fp32 on the CUDA cores. It
// serves the fp32 parity checks, which need 1e-4 and must not run in TF32;
// bf16, the serving dtype, goes to the tensor-core kernel in
// flash_attention_bf16.cu and never here.
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attention.py
// (flash_attention, body _flash_kernel), for fp32 inputs.
//
// Bound on an H100: operations (4*B*H*D FLOPs per kept (query, key) pair,
// hundreds of FLOPs per byte), here against the 67 TFLOP/s fp32 CUDA-core
// peak, since exact fp32 has no tensor-core path.
//
// Design: one thread block per (batch row, q head, 64-row q tile). The
// TPU's sequential KV grid axis becomes a loop over 32-key K/V tiles staged
// in shared memory; the loop starts and stops at the window, causal and
// kv_len edges of the q tile, so masked-out tiles are never read. Each of
// the 8 warps owns 8 query rows: for QK^T a lane owns one key of the tile,
// for PV a lane owns Dv/32 output columns, and the (acc, m, l) state lives
// in registers. GQA reads kv head h / G directly, with no repeated-KV copy.
// A value width that is not a multiple of 32 (kimi-k2's 112) takes
// ceil(Dv / 32) column slots per lane; the last slot is live only on the
// lanes whose column is below Dv, and only those read V or write O there.
#include <stdint.h>

#include "common.cuh"

namespace repro_torch {
namespace {

constexpr int kBlockQ = 64;
constexpr int kBlockK = 32;
constexpr int kWarps = 8;
constexpr int kRows = kBlockQ / kWarps;  // query rows per warp

size_t flash_smem_bytes(int Dk, int Dv) {
  return sizeof(float) * (static_cast<size_t>(kBlockQ) * Dk + kBlockK * (Dk + 1) +
                          kBlockK * Dv + kWarps * kRows * kBlockK);
}

template <int DV>
__global__ void __launch_bounds__(kWarps * 32)
flash_fwd_fp32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                      const float* __restrict__ v, float* __restrict__ o,
                      const int32_t* __restrict__ q_offset,
                      const int32_t* __restrict__ kv_len, int Sq, int Sk, int H, int Hkv,
                      int Dk, int causal, int window, float softcap, float scale) {
  constexpr int Dv = DV;
  constexpr int NC = (DV + 31) / 32;  // output column slots per lane: column lane + 32 c
  static_assert(32 * NC >= DV && 32 * (NC - 1) < DV, "the slots cover each column once");
  extern __shared__ float smem[];
  const int ldk = Dk + 1;  // pad: lane j reads row j, conflict-free
  float* qs = smem;                    // kBlockQ x Dk
  float* ks = qs + kBlockQ * Dk;       // kBlockK x (Dk + 1)
  float* vs = ks + kBlockK * ldk;      // kBlockK x Dv
  float* ps = vs + kBlockK * Dv;       // kWarps x kRows x kBlockK

  const int q0 = blockIdx.x * kBlockQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (H / Hkv);
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int row0 = warp * kRows;
  // slot c of this lane holds a column below Dv (always, but for the last
  // slot of a width that is not a multiple of 32)
  auto live = [lane](int c) { return DV % 32 == 0 || lane + 32 * c < DV; };
  const int qoff = q_offset[b];
  const int klen = min(kv_len[b], Sk);

  for (int i = tid; i < kBlockQ * Dk; i += blockDim.x) {
    const int r = i / Dk, d = i - r * Dk;
    const int sq = q0 + r;
    qs[i] = sq < Sq ? q[((static_cast<size_t>(b) * Sq + sq) * H + h) * Dk + d] : 0.f;
  }

  // keys any row of this tile can keep: [k_lo, k_hi)
  const int q_last = min(q0 + kBlockQ, Sq) - 1;
  int k_hi = klen;
  if (causal) k_hi = min(k_hi, qoff + q_last + 1);
  int k_lo = window > 0 ? max(0, qoff + q0 - window + 1) : 0;
  k_lo = (k_lo / kBlockK) * kBlockK;

  float m[kRows], l[kRows], acc[kRows][NC];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    m[r] = kNegInf;
    l[r] = 0.f;
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[r][c] = 0.f;
  }
  float* pw = ps + warp * kRows * kBlockK;

  for (int kt = k_lo; kt < k_hi; kt += kBlockK) {
    __syncthreads();  // Q staged / previous K-V tile consumed
    for (int i = tid; i < kBlockK * Dk; i += blockDim.x) {
      const int j = i / Dk, d = i - j * Dk;
      const int sk = kt + j;
      ks[j * ldk + d] =
          sk < Sk ? k[((static_cast<size_t>(b) * Sk + sk) * Hkv + hk) * Dk + d] : 0.f;
    }
    for (int i = tid; i < kBlockK * Dv; i += blockDim.x) {
      const int j = i / Dv, d = i - j * Dv;
      const int sk = kt + j;
      vs[i] = sk < Sk ? v[((static_cast<size_t>(b) * Sk + sk) * Hkv + hk) * Dv + d] : 0.f;
    }
    __syncthreads();

    // S = Q K^T for this warp's rows; lane owns key kt + lane
    float s[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) s[r] = 0.f;
    const float* kr = ks + lane * ldk;
    const float* qr = qs + row0 * Dk;
    for (int d = 0; d < Dk; ++d) {
      const float kd = kr[d];
#pragma unroll
      for (int r = 0; r < kRows; ++r) s[r] = fmaf(qr[r * Dk + d], kd, s[r]);
    }

    const int kpos = kt + lane;
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int qpos = qoff + q0 + row0 + r;
      bool keep = kpos < klen;
      if (causal) keep = keep && kpos <= qpos;
      if (window > 0) keep = keep && (qpos - kpos) < window;
      const float x = keep ? apply_softcap(s[r] * scale, softcap) : kNegInf;
      const float m_new = fmaxf(m[r], warp_max(x));
      const float corr = expf(m[r] - m_new);
      const float p = keep ? expf(x - m_new) : 0.f;
      l[r] = l[r] * corr + warp_sum(p);
      m[r] = m_new;
#pragma unroll
      for (int c = 0; c < NC; ++c) acc[r][c] *= corr;
      pw[r * kBlockK + lane] = p;
    }
    __syncwarp();

    // O += P V; lane owns columns lane + 32 c
    for (int j = 0; j < kBlockK; ++j) {
      float vv[NC];
#pragma unroll
      for (int c = 0; c < NC; ++c) vv[c] = live(c) ? vs[j * Dv + lane + 32 * c] : 0.f;
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const float p = pw[r * kBlockK + j];
#pragma unroll
        for (int c = 0; c < NC; ++c) acc[r][c] = fmaf(p, vv[c], acc[r][c]);
      }
    }
    __syncwarp();
  }

#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int sq = q0 + row0 + r;
    if (sq >= Sq) continue;
    // a row that kept no key has l == 0 and acc == 0: it writes 0
    const float denom = fmaxf(l[r], 1e-30f);
    float* orow = o + ((static_cast<size_t>(b) * Sq + sq) * H + h) * Dv;
#pragma unroll
    for (int c = 0; c < NC; ++c)
      if (live(c)) orow[lane + 32 * c] = acc[r][c] / denom;
  }
}

template <int DV>
int launch(const void* q, const void* k, const void* v, void* o, const void* q_offset,
           const void* kv_len, int B, int Sq, int Sk, int H, int Hkv, int Dk, int causal,
           int window, float softcap, float scale, cudaStream_t stream) {
  const size_t smem = flash_smem_bytes(Dk, DV);
  const cudaError_t attr = allow_smem(flash_fwd_fp32_kernel<DV>, smem);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const dim3 grid((Sq + kBlockQ - 1) / kBlockQ, H, B);
  flash_fwd_fp32_kernel<DV><<<grid, kWarps * 32, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<float*>(o), static_cast<const int32_t*>(q_offset),
      static_cast<const int32_t*>(kv_len), Sq, Sk, H, Hkv, Dk, causal, window, softcap, scale);
  return static_cast<int>(cudaGetLastError());
}

int dispatch(int Dv, const void* q, const void* k, const void* v, void* o, const void* q_offset,
             const void* kv_len, int B, int Sq, int Sk, int H, int Hkv, int Dk, int causal,
             int window, float softcap, float scale, cudaStream_t stream) {
  switch (Dv) {
    case 32:
      return launch<32>(q, k, v, o, q_offset, kv_len, B, Sq, Sk, H, Hkv, Dk, causal, window,
                        softcap, scale, stream);
    case 64:
      return launch<64>(q, k, v, o, q_offset, kv_len, B, Sq, Sk, H, Hkv, Dk, causal, window,
                        softcap, scale, stream);
    case 112:
      return launch<112>(q, k, v, o, q_offset, kv_len, B, Sq, Sk, H, Hkv, Dk, causal, window,
                         softcap, scale, stream);
    case 128:
      return launch<128>(q, k, v, o, q_offset, kv_len, B, Sq, Sk, H, Hkv, Dk, causal, window,
                         softcap, scale, stream);
    case 256:
      return launch<256>(q, k, v, o, q_offset, kv_len, B, Sq, Sk, H, Hkv, Dk, causal, window,
                         softcap, scale, stream);
    default:
      return -1;
  }
}

}  // namespace
}  // namespace repro_torch

// q (B,Sq,H,Dk), k (B,Sk,Hkv,Dk), v (B,Sk,Hkv,Dv), o (B,Sq,H,Dv), all
// contiguous fp32; q_offset and kv_len (B,) int32 on the device. window <= 0
// means no window, softcap <= 0 no softcap. Returns the CUDA error of the
// launch, or -1 for a shape the kernel does not take.
extern "C" int flash_attention_fwd_fp32(const void* q, const void* k, const void* v, void* o,
                                        const void* q_offset, const void* kv_len, int B, int Sq,
                                        int Sk, int H, int Hkv, int Dk, int Dv, int causal,
                                        int window, float softcap, float scale, void* stream) {
  return repro_torch::dispatch(Dv, q, k, v, o, q_offset, kv_len, B, Sq, Sk, H, Hkv, Dk, causal,
                               window, softcap, scale, static_cast<cudaStream_t>(stream));
}
