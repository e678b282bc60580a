// Decode attention at the absorbed-MLA shape for Hopper (sm_90a): one
// query token per batch row, G = 16 query heads on one latent KV head of
// width Dk = 576 (kv_lora_rank 512 + qk_rope_dim 64), values of width
// Dv = 512, split across blocks along the KV axis like decode_attention.cu.
// DeepSeek-V2-Lite's absorbed decode (src/repro/models/attention.py,
// mla_decode) reaches this shape.
//
// Replaces the Pallas TPU kernel src/repro/kernels/decode_attention.py
// (decode_attention, body _decode_kernel) at that shape, which the general
// decode kernel's layout cannot hold: G * Dv / 32 = 256 fp32 accumulators
// per lane, and a 32 KB ring stage holds only 15 keys of 2176 bytes.
//
// Bound on an H100: bytes. The serving path's values are the first 512
// columns of the same latent rows as the keys (v_shared), so each step
// reads every kept latent row once: sum_b kept_b * Hkv * Dk * sizeof(T)
// (+ q and o), ~5.6 MB at 8 slots x 1024 bf16, ~1.7 us. Its work is
// 2 * G * (Dk + Dv) FLOPs per key, ~30 FLOPs per byte, above the fp32
// CUDA cores' ~20 FLOP/byte ridge, so this CUDA-core design is bound by
// its FMAs, not by the bytes; the tensor cores (16 heads are one m16 row
// tile of mma.sync m16n8k16) are the next step.
//
// Design (simple first):
// - Grid (n_splits, Hkv, B) from decode_attention.plan_splits; 8 warps per
//   block. A block takes one split for all 16 heads, so each latent row is
//   read from device memory once.
// - Latent tiles (32 keys bf16, 16 fp32) go through a two-stage
//   shared-memory ring filled by 16-byte cp.async copies; with v_shared
//   the V tile is the K tile's first 512 columns, else a V tile is copied
//   beside it.
// - Per tile: (1) scores, one key per warp at a time, each lane 18 of the
//   576 products per head against q in fp32 shared memory, reduced by
//   shuffles; (2) the fp32 online softmax in powers of two, two heads per
//   warp, one key per lane; (3) P V, each warp owning 64 value columns,
//   each lane 2 columns of all 16 heads: 32 fp32 accumulators.
// - The splits merge as in decode_attention.cu: a row whose kept keys lie
//   in one split writes its output directly, otherwise the last block of
//   the (row, kv head) to finish (an atomic counter) merges the splits'
//   fp32 (m, l, acc) and resets its counter to 0. Masked keys are never
//   read; a row that keeps no key writes 0.
#include <stdint.h>

#include "common.cuh"

namespace repro_torch {
namespace {

constexpr int kG = 16;      // query heads per latent head
constexpr int kDk = 576;    // kv_lora_rank + qk_rope_dim
constexpr int kDv = 512;    // kv_lora_rank
constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kColsPerWarp = kDv / kWarps;  // 64: two value columns per lane
constexpr int kHeadsPerWarp = kG / kWarps;  // the softmax step's heads
constexpr int kPairs = kDk / 64;            // 9 column pairs per lane per key
constexpr int kPart = kDv + 4;              // one split's partial: m, l, pad, acc[kDv]

template <typename T>
struct Tile;  // keys per ring stage; at most 32 (one key per lane in the softmax)
template <>
struct Tile<__nv_bfloat16> {
  static constexpr int kKeys = 32;
};
template <>
struct Tile<float> {
  static constexpr int kKeys = 16;
};

__device__ __forceinline__ float2 load2(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}
__device__ __forceinline__ float2 load2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}

template <typename T>
size_t smem_bytes(bool v_shared) {
  constexpr int tile = Tile<T>::kKeys;
  const size_t ring = 2 * static_cast<size_t>(tile) * (kDk + (v_shared ? 0 : kDv)) * sizeof(T);
  return sizeof(float) * kG * kDk + ring + sizeof(float) * (kG * tile + 3 * kG);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
mla_decode_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                  T* __restrict__ o, const int32_t* __restrict__ q_offset,
                  const int32_t* __restrict__ kv_len, float* __restrict__ part,
                  int* __restrict__ counters, int Smax, int Hkv, int k_row, int v_row,
                  int v_head, int v_shared, int window, float softcap, float scale,
                  int split_len) {
  constexpr int TILE = Tile<T>::kKeys;
  constexpr int VEC = 16 / sizeof(T);  // elements per 16-byte copy
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ int is_last;
  const int vw = v_shared ? 0 : kDv;  // V columns copied per key
  float* qs = reinterpret_cast<float*>(smem_raw);  // kG x kDk
  T* ring = reinterpret_cast<T*>(qs + kG * kDk);   // 2 x TILE x (kDk + vw)
  float* ps = reinterpret_cast<float*>(ring + 2 * TILE * (kDk + vw));  // kG x TILE
  float* m_s = ps + kG * TILE;
  float* l_s = m_s + kG;
  float* c_s = l_s + kG;

  const int split = blockIdx.x, hk = blockIdx.y, b = blockIdx.z;
  const int n_splits = gridDim.x;
  const int H = Hkv * kG;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int qpos = q_offset[b];
  const int k_hi = min(kv_len[b], Smax);
  const int k_lo = window > 0 ? max(0, qpos - window + 1) : 0;
  T* ob = o + (static_cast<size_t>(b) * H + hk * kG) * kDv;  // the group's 16 output rows

  if (k_hi <= k_lo) {  // the row keeps no key: it writes 0
    if (split == 0)
      for (int i = tid; i < kG * kDv; i += kThreads) store(ob + i, 0.f);
    return;
  }
  const int s_first = k_lo / split_len, s_last = (k_hi - 1) / split_len;
  if (split < s_first || split > s_last) return;
  const int n_live = s_last - s_first + 1;
  const int s0 = max(split * split_len, k_lo), s1 = min((split + 1) * split_len, k_hi);

  const T* kb = k + static_cast<size_t>(b) * Smax * k_row + static_cast<size_t>(hk) * kDk;
  const T* vb = v + static_cast<size_t>(b) * Smax * v_row + static_cast<size_t>(hk) * v_head;
  auto load = [&](int stage, int t0) {
    T* ks = ring + static_cast<size_t>(stage) * TILE * (kDk + vw);
    T* vs = ks + TILE * kDk;
    const int nk = min(TILE, s1 - t0);
    constexpr int kch = kDk / VEC, vch = kDv / VEC;
    for (int i = tid; i < nk * kch; i += kThreads) {
      const int r = i / kch, c = i - r * kch;
      cp_async16(ks + r * kDk + c * VEC, kb + static_cast<size_t>(t0 + r) * k_row + c * VEC, 16);
    }
    if (!v_shared)
      for (int i = tid; i < nk * vch; i += kThreads) {
        const int r = i / vch, c = i - r * vch;
        cp_async16(vs + r * kDv + c * VEC, vb + static_cast<size_t>(t0 + r) * v_row + c * VEC,
                   16);
      }
  };

  load(0, s0);  // the first tile's copy is in flight while q loads
  cp_async_commit();
  for (int i = tid; i < kG * kDk; i += kThreads)
    qs[i] = to_float(q[(static_cast<size_t>(b) * H + hk * kG) * kDk + i]);
  if (tid < kG) {
    m_s[tid] = kNegInf;
    l_s[tid] = 0.f;
  }
  const float scale_log2 = scale * kLog2e;
  const int col = warp * kColsPerWarp + 2 * lane;  // this lane's two value columns
  float acc[kG][2];
#pragma unroll
  for (int g = 0; g < kG; ++g) acc[g][0] = acc[g][1] = 0.f;

  const int n_tiles = (s1 - s0 + TILE - 1) / TILE;
  for (int it = 0; it < n_tiles; ++it) {
    const int t0 = s0 + it * TILE;
    if (it + 1 < n_tiles) {
      load((it + 1) & 1, t0 + TILE);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const T* ks = ring + static_cast<size_t>(it & 1) * TILE * (kDk + vw);
    const T* vs = v_shared ? ks : ks + TILE * kDk;
    const int vstride = v_shared ? kDk : kDv;
    const int nk = min(TILE, s1 - t0);

    // (1) scores in log2 units, softcap(s * scale) * log2(e), into ps
    for (int j = warp; j < nk; j += kWarps) {
      float2 kv[kPairs];
#pragma unroll
      for (int i = 0; i < kPairs; ++i) kv[i] = load2(ks + j * kDk + 2 * (lane + 32 * i));
      float mine = 0.f;
#pragma unroll
      for (int g = 0; g < kG; ++g) {
        float s = 0.f;
#pragma unroll
        for (int i = 0; i < kPairs; ++i) {
          const float2 qv = *reinterpret_cast<const float2*>(qs + g * kDk + 2 * (lane + 32 * i));
          s = fmaf(qv.x, kv[i].x, fmaf(qv.y, kv[i].y, s));
        }
        s = warp_sum(s);
        if (lane == g) mine = s;
      }
      if (lane < kG)
        ps[lane * TILE + j] = softcap > 0.f ? softcap * kLog2e * tanhf(mine * scale / softcap)
                                            : mine * scale_log2;
    }
    __syncthreads();

    // (2) online softmax: each warp two heads, each lane one key
#pragma unroll
    for (int hh = 0; hh < kHeadsPerWarp; ++hh) {
      const int g = warp * kHeadsPerWarp + hh;
      const float x = lane < nk ? ps[g * TILE + lane] : kNegInf;
      const float m_old = m_s[g], l_old = l_s[g];
      const float mn = fmaxf(m_old, warp_max(x));  // finite: the tile keeps a key
      const float p = lane < nk ? fast_exp2(x - mn) : 0.f;
      const float psum = warp_sum(p);
      if (lane < TILE) ps[g * TILE + lane] = p;
      if (lane == 0) {
        const float corr = fast_exp2(m_old - mn);
        m_s[g] = mn;
        l_s[g] = l_old * corr + psum;
        c_s[g] = corr;
      }
    }
    __syncthreads();

    // (3) acc = acc * corr + P V over this warp's 64 columns
#pragma unroll
    for (int g = 0; g < kG; ++g) {
      const float corr = c_s[g];
      acc[g][0] *= corr;
      acc[g][1] *= corr;
    }
    for (int j = 0; j < nk; ++j) {
      const float2 vv = load2(vs + j * vstride + col);
#pragma unroll
      for (int g = 0; g < kG; ++g) {
        const float p = ps[g * TILE + j];
        acc[g][0] = fmaf(p, vv.x, acc[g][0]);
        acc[g][1] = fmaf(p, vv.y, acc[g][1]);
      }
    }
    __syncthreads();  // this stage and ps are consumed before the next tile
  }

  float* pb = part + (static_cast<size_t>(b) * Hkv + hk) * n_splits * kG * kPart;
  if (n_live == 1) {
#pragma unroll
    for (int g = 0; g < kG; ++g) {
      const float inv = 1.f / fmaxf(l_s[g], 1e-30f);
      store(ob + g * kDv + col, acc[g][0] * inv);
      store(ob + g * kDv + col + 1, acc[g][1] * inv);
    }
    return;
  }
#pragma unroll
  for (int g = 0; g < kG; ++g) {
    float* pp = pb + (static_cast<size_t>(split) * kG + g) * kPart;
    if (tid == 0) {
      pp[0] = m_s[g];
      pp[1] = l_s[g];
    }
    pp[4 + col] = acc[g][0];
    pp[4 + col + 1] = acc[g][1];
  }

  // the last live split of this (row, kv head) to finish merges them all
  __threadfence();
  __syncthreads();
  if (tid == 0) is_last = atomicAdd(counters + b * Hkv + hk, 1) == n_live - 1;
  __syncthreads();
  if (!is_last) return;
  __threadfence();
  // one pass over the live splits with a running (max, sum, acc), 16 bytes
  // of acc per thread per split; __ldcg reads L2, where the others wrote
  constexpr int NV = kDv / 4;
  for (int i = tid; i < kG * NV; i += kThreads) {
    const int g = i / NV, c = i - g * NV;
    float mx = kNegInf, lsum = 0.f;
    float4 os = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 4
    for (int s = s_first; s <= s_last; ++s) {
      const float* pp = pb + (static_cast<size_t>(s) * kG + g) * kPart;
      const float ms_ = __ldcg(pp), ls_ = __ldcg(pp + 1);
      const float4 a = __ldcg(reinterpret_cast<const float4*>(pp + 4) + c);
      const float mn = fmaxf(mx, ms_);
      const float fo = fast_exp2(mx - mn), fs = fast_exp2(ms_ - mn);
      mx = mn;
      lsum = lsum * fo + ls_ * fs;
      os.x = os.x * fo + a.x * fs;
      os.y = os.y * fo + a.y * fs;
      os.z = os.z * fo + a.z * fs;
      os.w = os.w * fo + a.w * fs;
    }
    const float inv = 1.f / fmaxf(lsum, 1e-30f);
    T* op = ob + g * kDv + 4 * c;
    store(op, os.x * inv);
    store(op + 1, os.y * inv);
    store(op + 2, os.z * inv);
    store(op + 3, os.w * inv);
  }
  if (tid == 0) counters[b * Hkv + hk] = 0;
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* o, const void* q_offset,
           const void* kv_len, void* part, void* counters, int B, int Smax, int Hkv, int k_row,
           int v_row, int v_head, int v_shared, int window, int n_splits, int split_len,
           float softcap, float scale, cudaStream_t stream) {
  const size_t smem = smem_bytes<T>(v_shared != 0);
  const cudaError_t attr = allow_smem(mla_decode_kernel<T>, smem);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const dim3 grid(n_splits, Hkv, B);
  mla_decode_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), static_cast<const int32_t*>(q_offset),
      static_cast<const int32_t*>(kv_len), static_cast<float*>(part), static_cast<int*>(counters),
      Smax, Hkv, k_row, v_row, v_head, v_shared, window, softcap, scale, split_len);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
}  // namespace repro_torch

// q (B,1,H,576) contiguous, H = 16 * Hkv; k: rows of (Hkv, 576), row b, s
// at k + (b * Smax + s) * k_row; v: rows of (Hkv, 512) at v + (b * Smax +
// s) * v_row + h * v_head. v_shared != 0 says that v is the first 512
// columns of k's rows (the latent cache), which the kernel then reads
// once. o (B,1,H,512) contiguous; all of one dtype, 16-byte aligned, the
// strides multiples of 16 bytes; q_offset and kv_len (B,) int32 on the
// device. part: fp32 scratch of B * Hkv * n_splits * 16 * 516; counters:
// B * Hkv int32, all 0 (the kernel leaves them 0). Split s covers keys
// [s * split_len, (s + 1) * split_len). window <= 0 means no window,
// softcap <= 0 no softcap. Returns the CUDA error of the launch, or -1 for
// a shape the kernel does not take.
extern "C" int decode_attention_mla_fwd(const void* q, const void* k, const void* v, void* o,
                                        const void* q_offset, const void* kv_len, void* part,
                                        void* counters, int B, int Smax, int H, int Hkv, int Dk,
                                        int Dv, int k_row, int v_row, int v_head, int v_shared,
                                        int window, int n_splits, int split_len, float softcap,
                                        float scale, int dtype, void* stream) {
  using namespace repro_torch;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (Hkv < 1 || H != kG * Hkv || Dk != kDk || Dv != kDv || n_splits < 1 || split_len < 1)
    return -1;
  if (dtype == kFloat32)
    return launch<float>(q, k, v, o, q_offset, kv_len, part, counters, B, Smax, Hkv, k_row,
                         v_row, v_head, v_shared, window, n_splits, split_len, softcap, scale,
                         st);
  if (dtype == kBFloat16)
    return launch<__nv_bfloat16>(q, k, v, o, q_offset, kv_len, part, counters, B, Smax, Hkv,
                                 k_row, v_row, v_head, v_shared, window, n_splits, split_len,
                                 softcap, scale, st);
  return -1;
}
