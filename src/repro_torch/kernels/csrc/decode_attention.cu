// Decode attention for Hopper (sm_90a): one query token per batch row
// against the KV cache, with sliding window, logit softcap, GQA and
// per-row q_offset / kv_len (the continuous engine's ragged slot pool),
// split across blocks along the KV axis (flash-decoding).
//
// Replaces the Pallas TPU kernel src/repro/kernels/decode_attention.py
// (decode_attention, body _decode_kernel).
//
// Bound on an H100: bytes. Each step reads every kept K/V entry once,
// sum_b kept_b * Hkv * (Dk + Dv) * sizeof(T), for 4 * G FLOPs per K/V
// element pair: a few FLOPs per byte, far below the ridge. At the serve's
// shapes the bound is 1-7 us, near the cost of one launch, so what counts
// is how many bytes are in flight at once across the card.
//
// Design:
// - Grid (n_splits, Hkv, B). The host sizes n_splits from Smax, B and Hkv
//   alone (never from the positions, which stay on the device), so that
//   the grid fills several waves of the 132 SMs. A block takes one split
//   of split_len keys for the G q heads of its kv head, so each K/V entry
//   is read from device memory once per group. Blocks whose split holds no
//   key of the row's [k_lo, kv_len) exit at once.
// - K and V tiles go through a two-stage shared-memory ring filled by
//   16-byte cp.async copies, neighbouring threads on neighbouring
//   addresses (a key's D-vector is contiguous: 128 B at D 64 bf16), so
//   tile j + 1 streams in while tile j is computed.
// - A lane group of 8-32 lanes takes two keys per pass (8 lanes at the
//   serve's shapes: 32 keys in flight per block, two independent chains
//   per lane): each lane reads 16-byte slices of the keys' K rows from
//   shared memory, the group sums its partial dot products with shuffles,
//   and each lane updates its own fp32 online softmax state, in powers of
//   two (one ex2 per probability), and its slices of the output. The
//   groups' states merge through shared memory at the end of the split.
//   The split's work is latency-bound (a block runs 4 warps, often alone
//   on its SM), so instruction-level parallelism is what shortens it.
// - A row whose kept keys lie in one split writes its output directly.
//   Otherwise each live split writes its fp32 (m, l, acc) to scratch, and
//   the last block of the (row, kv head) to finish, found with an atomic
//   counter, merges them and resets its counter to 0. One launch per call.
// - Masked keys are never read; a row that keeps no key writes 0, and no
//   merge ever computes inf - inf (live splits have a finite m).
#include <stdint.h>

#include <algorithm>

#include "common.cuh"

namespace repro_torch {
namespace {

constexpr int kThreads = 128;
constexpr int kStageBytes = 32 * 1024;  // one K/V stage of the ring

__device__ __forceinline__ void load_vec(float (&out)[8], const __nv_bfloat16* p) {
  const uint4 raw = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    out[2 * i] = f.x;
    out[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ void load_vec(float (&out)[4], const float* p) {
  const float4 f = *reinterpret_cast<const float4*>(p);
  out[0] = f.x;
  out[1] = f.y;
  out[2] = f.z;
  out[3] = f.w;
}

// A lane group of kLanes lanes takes one key at a time. Fewer lanes per
// key mean shorter shuffle reductions and more keys in flight, more lanes
// fewer accumulators per lane (G * DV / kLanes): the fewest lanes, 8 or
// more, that keep 64 or fewer accumulators.
template <typename T, int G, int DV>
struct Shape {
  static constexpr int kVec = 16 / sizeof(T);  // elements per 16-byte load
  static constexpr int kWant = G * DV / 64 < 8 ? 8 : G * DV / 64 > 32 ? 32 : G * DV / 64;
  static constexpr int kLanes = kWant < DV / kVec ? kWant : DV / kVec;  // lanes per key
  static constexpr int kVecs = DV / (kVec * kLanes);  // V vectors per lane
  static constexpr int kGroups = kThreads / kLanes;   // keys in flight per block
};

template <typename T, int G, int DV>
size_t smem_bytes(int Dk, int tile) {
  using S = Shape<T, G, DV>;
  const size_t ring = 2 * static_cast<size_t>(tile) * (Dk + DV) * sizeof(T);
  const size_t merge = sizeof(float) * S::kGroups * G * (DV + 2);
  return sizeof(float) * G * Dk + (ring > merge ? ring : merge);
}

template <typename T, int G, int DV>
__global__ void __launch_bounds__(kThreads)
decode_split_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                    T* __restrict__ o, const int32_t* __restrict__ q_offset,
                    const int32_t* __restrict__ kv_len, float* __restrict__ part,
                    int* __restrict__ counters, int Smax, int Hkv, int Dk, int window,
                    float softcap, float scale, int split_len, int tile) {
  using S = Shape<T, G, DV>;
  constexpr int VEC = S::kVec, LPK = S::kLanes, NVV = S::kVecs, NG = S::kGroups;
  constexpr int kPart = DV + 4;  // one split's partial: m, l, 2 floats of padding, acc[DV]
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ int is_last;
  float* qs = reinterpret_cast<float*>(smem_raw);  // G x Dk
  T* ring = reinterpret_cast<T*>(qs + G * Dk);      // 2 x tile x (Dk + DV)

  const int split = blockIdx.x, hk = blockIdx.y, b = blockIdx.z;
  const int n_splits = gridDim.x;
  const int H = Hkv * G;
  const int tid = threadIdx.x;
  const int qpos = q_offset[b];
  const int k_hi = min(kv_len[b], Smax);
  const int k_lo = window > 0 ? max(0, qpos - window + 1) : 0;
  T* ob = o + (static_cast<size_t>(b) * H + hk * G) * DV;  // the group's G output rows

  if (k_hi <= k_lo) {  // the row keeps no key: it writes 0
    if (split == 0)
      for (int i = tid; i < G * DV; i += kThreads) store(ob + i, 0.f);
    return;
  }
  const int s_first = k_lo / split_len, s_last = (k_hi - 1) / split_len;
  if (split < s_first || split > s_last) return;
  const int n_live = s_last - s_first + 1;
  const int s0 = max(split * split_len, k_lo), s1 = min((split + 1) * split_len, k_hi);

  const size_t kstride = static_cast<size_t>(Hkv) * Dk;
  const size_t vstride = static_cast<size_t>(Hkv) * DV;
  const T* kb = k + static_cast<size_t>(b) * Smax * kstride + hk * Dk;
  const T* vb = v + static_cast<size_t>(b) * Smax * vstride + hk * DV;
  const int kch = Dk / VEC;
  auto load = [&](int stage, int t0) {
    T* ks = ring + static_cast<size_t>(stage) * tile * (Dk + DV);
    T* vs = ks + tile * Dk;
    const int nk = min(tile, s1 - t0);
    for (int i = tid; i < nk * kch; i += kThreads) {
      const int r = i / kch, c = i - r * kch;
      cp_async16(ks + r * Dk + c * VEC, kb + (t0 + r) * kstride + c * VEC, 16);
    }
    for (int i = tid; i < nk * (DV / VEC); i += kThreads) {
      const int r = i / (DV / VEC), c = i - r * (DV / VEC);
      cp_async16(vs + r * DV + c * VEC, vb + (t0 + r) * vstride + c * VEC, 16);
    }
  };

  const int grp = tid / LPK, sub = tid % LPK;
  const float scale_log2 = scale * kLog2e;
  float m[G], l[G], acc[G][NVV * VEC];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    m[g] = kNegInf;
    l[g] = 0.f;
#pragma unroll
    for (int e = 0; e < NVV * VEC; ++e) acc[g][e] = 0.f;
  }

  const int n_tiles = (s1 - s0 + tile - 1) / tile;
  load(0, s0);  // the first tile's copy is in flight while q loads
  cp_async_commit();
  for (int i = tid; i < G * Dk; i += kThreads)
    qs[i] = to_float(q[(static_cast<size_t>(b) * H + hk * G) * Dk + i]);
  for (int it = 0; it < n_tiles; ++it) {
    const int t0 = s0 + it * tile;
    if (it + 1 < n_tiles) {
      load((it + 1) & 1, t0 + tile);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const T* ks = ring + static_cast<size_t>(it & 1) * tile * (Dk + DV);
    const T* vs = ks + tile * Dk;
    const int nk = min(tile, s1 - t0);
    // each group takes two keys per pass (two independent chains); the trip
    // count is the same for every lane, so the shuffles see whole warps
    for (int j0 = 0; j0 < nk; j0 += 2 * NG) {
      const int ja = j0 + grp, jb = ja + NG;
      const bool va = ja < nk, vb = jb < nk;
      const int ra = va ? ja : 0, rb = vb ? jb : 0;  // a past-the-end key reads row 0
      float sa[G], sb[G];
#pragma unroll
      for (int g = 0; g < G; ++g) sa[g] = sb[g] = 0.f;
      for (int c = sub; c < kch; c += LPK) {
        float ka[VEC], kb2[VEC];
        load_vec(ka, ks + ra * Dk + c * VEC);
        load_vec(kb2, ks + rb * Dk + c * VEC);
#pragma unroll
        for (int g = 0; g < G; ++g) {
          const float* qv = qs + g * Dk + c * VEC;
#pragma unroll
          for (int e = 0; e < VEC; ++e) {
            sa[g] = fmaf(qv[e], ka[e], sa[g]);
            sb[g] = fmaf(qv[e], kb2[e], sb[g]);
          }
        }
      }
#pragma unroll
      for (int g = 0; g < G; ++g)
#pragma unroll
        for (int off = LPK / 2; off > 0; off >>= 1) {
          sa[g] += __shfl_xor_sync(0xffffffffu, sa[g], off);
          sb[g] += __shfl_xor_sync(0xffffffffu, sb[g], off);
        }
      if (!va) continue;  // then key b lies past the end too
      float wa[NVV][VEC], wb[NVV][VEC];
#pragma unroll
      for (int i = 0; i < NVV; ++i) {
        load_vec(wa[i], vs + ra * DV + (sub + i * LPK) * VEC);
        load_vec(wb[i], vs + rb * DV + (sub + i * LPK) * VEC);
      }
#pragma unroll
      for (int g = 0; g < G; ++g) {
        // scores in log2 units: softcap(s * scale) * log2(e)
        const float xa = softcap > 0.f ? softcap * kLog2e * tanhf(sa[g] * scale / softcap)
                                       : sa[g] * scale_log2;
        const float xb = !vb ? kNegInf
                         : softcap > 0.f ? softcap * kLog2e * tanhf(sb[g] * scale / softcap)
                                         : sb[g] * scale_log2;
        const float mn = fmaxf(m[g], fmaxf(xa, xb));  // finite: key a is kept
        const float corr = fast_exp2(m[g] - mn);
        const float pa = fast_exp2(xa - mn), pb = fast_exp2(xb - mn);  // pb = 0 past the end
        l[g] = l[g] * corr + pa + pb;
        m[g] = mn;
#pragma unroll
        for (int i = 0; i < NVV; ++i)
#pragma unroll
          for (int e = 0; e < VEC; ++e)
            acc[g][i * VEC + e] =
                fmaf(pb, wb[i][e], fmaf(pa, wa[i][e], acc[g][i * VEC + e] * corr));
      }
    }
    __syncthreads();  // this stage is consumed before the next copy overwrites it
  }

  // merge the lane groups' states through shared memory (over the ring)
  float* ms = reinterpret_cast<float*>(ring);  // NG x G
  float* ls = ms + NG * G;                     // NG x G
  float* accs = ls + NG * G;                   // NG x G x DV
#pragma unroll
  for (int g = 0; g < G; ++g) {
    if (sub == 0) {
      ms[grp * G + g] = m[g];
      ls[grp * G + g] = l[g];
    }
#pragma unroll
    for (int i = 0; i < NVV; ++i)
#pragma unroll
      for (int e = 0; e < VEC; ++e)
        accs[(grp * G + g) * DV + (sub + i * LPK) * VEC + e] = acc[g][i * VEC + e];
  }
  __syncthreads();
  float* pb = part + (static_cast<size_t>(b) * Hkv + hk) * n_splits * G * kPart;
  for (int i = tid; i < G * DV; i += kThreads) {
    const int g = i / DV, d = i - g * DV;
    float mx = kNegInf;
    for (int w = 0; w < NG; ++w) mx = fmaxf(mx, ms[w * G + g]);
    float lsum = 0.f, osum = 0.f;
    for (int w = 0; w < NG; ++w) {
      const float f = fast_exp2(ms[w * G + g] - mx);  // a group that saw no key has l = acc = 0
      lsum += ls[w * G + g] * f;
      osum += accs[(w * G + g) * DV + d] * f;
    }
    if (n_live == 1) {
      store(ob + i, osum / fmaxf(lsum, 1e-30f));
    } else {
      float* pp = pb + (static_cast<size_t>(split) * G + g) * kPart;
      if (d == 0) {
        pp[0] = mx;
        pp[1] = lsum;
      }
      pp[4 + d] = osum;
    }
  }
  if (n_live == 1) return;

  // the last live split of this (row, kv head) to finish merges them all
  __threadfence();
  __syncthreads();
  if (tid == 0) is_last = atomicAdd(counters + b * Hkv + hk, 1) == n_live - 1;
  __syncthreads();
  if (!is_last) return;
  __threadfence();
  // one pass over the live splits with a running (max, sum, acc), 16 bytes
  // of acc per thread per split, unrolled so that several splits' loads
  // are in flight at once; __ldcg reads L2, where the other blocks wrote
  constexpr int NV = DV / 4;
  for (int i = tid; i < G * NV; i += kThreads) {
    const int g = i / NV, c = i - g * NV;
    float mx = kNegInf, lsum = 0.f;
    float4 os = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 4
    for (int s = s_first; s <= s_last; ++s) {
      const float* pp = pb + (static_cast<size_t>(s) * G + g) * kPart;
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
    T* op = ob + g * DV + 4 * c;
    store(op, os.x * inv);
    store(op + 1, os.y * inv);
    store(op + 2, os.z * inv);
    store(op + 3, os.w * inv);
  }
  if (tid == 0) counters[b * Hkv + hk] = 0;
}

template <typename T, int G, int DV>
int launch(const void* q, const void* k, const void* v, void* o, const void* q_offset,
           const void* kv_len, void* part, void* counters, int B, int Smax, int Hkv, int Dk,
           int window, int n_splits, int split_len, float softcap, float scale,
           cudaStream_t stream) {
  if (Dk % Shape<T, G, DV>::kVec != 0) return -1;
  const int per_key = (Dk + DV) * static_cast<int>(sizeof(T));
  const int tile = std::max(16, std::min(64, kStageBytes / per_key));
  const size_t smem = smem_bytes<T, G, DV>(Dk, tile);
  const cudaError_t attr = allow_smem(decode_split_kernel<T, G, DV>, smem);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const dim3 grid(n_splits, Hkv, B);
  decode_split_kernel<T, G, DV><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), static_cast<const int32_t*>(q_offset),
      static_cast<const int32_t*>(kv_len), static_cast<float*>(part), static_cast<int*>(counters),
      Smax, Hkv, Dk, window, softcap, scale, split_len, tile);
  return static_cast<int>(cudaGetLastError());
}

#define REPRO_DECODE_ARGS \
  q, k, v, o, q_offset, kv_len, part, counters, B, Smax, Hkv, Dk, window, n_splits, split_len, \
      softcap, scale, stream

template <typename T, int G>
int dispatch_dv(int Dv, const void* q, const void* k, const void* v, void* o,
                const void* q_offset, const void* kv_len, void* part, void* counters, int B,
                int Smax, int Hkv, int Dk, int window, int n_splits, int split_len,
                float softcap, float scale, cudaStream_t stream) {
  switch (Dv) {
    case 64:
      return launch<T, G, 64>(REPRO_DECODE_ARGS);
    case 128:
      return launch<T, G, 128>(REPRO_DECODE_ARGS);
    case 256:
      return launch<T, G, 256>(REPRO_DECODE_ARGS);
    default:
      return -1;
  }
}

template <typename T>
int dispatch(int G, int Dv, const void* q, const void* k, const void* v, void* o,
             const void* q_offset, const void* kv_len, void* part, void* counters, int B,
             int Smax, int Hkv, int Dk, int window, int n_splits, int split_len, float softcap,
             float scale, cudaStream_t stream) {
  switch (G) {
    case 1:
      return dispatch_dv<T, 1>(Dv, REPRO_DECODE_ARGS);
    case 2:
      return dispatch_dv<T, 2>(Dv, REPRO_DECODE_ARGS);
    case 4:
      return dispatch_dv<T, 4>(Dv, REPRO_DECODE_ARGS);
    case 8:
      return dispatch_dv<T, 8>(Dv, REPRO_DECODE_ARGS);
    default:
      return -1;
  }
}

#undef REPRO_DECODE_ARGS

}  // namespace
}  // namespace repro_torch

// q (B,1,H,Dk), k (B,Smax,Hkv,Dk), v (B,Smax,Hkv,Dv), o (B,1,H,Dv), all
// contiguous, 16-byte aligned and of one dtype, H = G * Hkv, Dk a multiple
// of 16 bytes; q_offset and kv_len (B,) int32 on the device. part: fp32
// scratch of B * Hkv * n_splits * G * (Dv + 4); counters: B * Hkv int32,
// all 0 (the kernel leaves them 0). Split s covers keys
// [s * split_len, (s + 1) * split_len). window <= 0 means no window,
// softcap <= 0 no softcap. Returns the CUDA error of the launch, or -1 for
// a shape the kernel does not take.
extern "C" int decode_attention_fwd(const void* q, const void* k, const void* v, void* o,
                                    const void* q_offset, const void* kv_len, void* part,
                                    void* counters, int B, int Smax, int H, int Hkv, int Dk,
                                    int Dv, int window, int n_splits, int split_len,
                                    float softcap, float scale, int dtype, void* stream) {
  using namespace repro_torch;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int G = H / Hkv;
  if (n_splits < 1 || split_len < 1) return -1;
  if (dtype == kFloat32)
    return dispatch<float>(G, Dv, q, k, v, o, q_offset, kv_len, part, counters, B, Smax, Hkv,
                           Dk, window, n_splits, split_len, softcap, scale, st);
  if (dtype == kBFloat16)
    return dispatch<__nv_bfloat16>(G, Dv, q, k, v, o, q_offset, kv_len, part, counters, B, Smax,
                                   Hkv, Dk, window, n_splits, split_len, softcap, scale, st);
  return -1;
}
