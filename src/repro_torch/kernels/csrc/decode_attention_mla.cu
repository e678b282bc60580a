// Absorbed-MLA attention on the CUDA cores for Hopper (sm_90a), fp32: G =
// 16, 8, 4, 2 or 1 query heads per latent KV head of width Dk = 576
// (kv_lora_rank 512 + qk_rope_dim 64; 8, 4, 2 and 1 are a rank's heads of
// DeepSeek-V2-Lite's 16 on a model axis of 2, 4, 8 and 16), values of width Dv = 512, T >= 1 query positions per
// batch row, split across blocks along the KV axis like
// decode_attention.cuh. It is the exact fp32 route (the parity checks run
// through it); bf16 runs on the tensor cores in mla_attention_bf16.cu.
// DeepSeek-V2-Lite's absorbed decode (T = 1) and its speculative verify
// (T > 1) reach this shape (src/repro/models/attention.py, mla_decode).
//
// Replaces the Pallas TPU kernels src/repro/kernels/decode_attention.py
// (decode_attention, body _decode_kernel) and, at T > 1,
// src/repro/kernels/flash_attention.py (flash_attention, body
// _flash_kernel) at this shape, which the general kernels' layouts cannot
// hold: G * Dv / 32 = 256 fp32 accumulators per lane, and a 32 KB ring
// stage holds only 15 keys of 2176 bytes.
//
// Bound on an H100: each kept latent row is read once per query position
// (sum_b kept_b * Hkv * Dk * 4 B + q and o), for 2 * G * (Dk + Dv) FLOPs per
// key and position, ~15 FLOPs per byte in fp32, near the fp32 CUDA cores'
// ~20 FLOP/byte ridge: this design is bound by its FMAs, which read q
// from shared memory.
//
// Design (simple first):
// - Grid (Hkv * T, n_splits, B) with the splits of
//   decode_attention.plan_splits; 8 warps per block. A block takes one
//   split for the G heads at one query position t (G a template
//   parameter): its rows share the
//   mask [k_lo, k_hi), k_hi = min(kv_len, Smax, q_offset + t + 1 if
//   causal), so a row's arithmetic does not depend on T.
// - Latent tiles of 16 keys go through a two-stage shared-memory ring
//   filled by 16-byte cp.async copies; with v_shared the V tile is the K
//   tile's first 512 columns, else a V tile is copied beside it.
// - Per tile: (1) scores, one key per warp at a time, each lane 18 of the
//   576 products per head against q in fp32 shared memory, reduced by
//   shuffles; (2) the fp32 online softmax in powers of two, head g on warp
//   g mod 8 (two heads per warp at G = 16, one at 8, warps G..7 idle below
//   8: correct, not fast, at G = 2 and 1),
//   one key per lane; (3) P V, each warp owning 64 value columns, each lane
//   2 columns of all G heads: 2 G fp32 accumulators.
// - The splits merge as in decode_attention.cuh: a row whose kept keys lie
//   in one split writes its output directly, otherwise the last block of
//   the (row group, kv head) to finish (an atomic counter) merges the
//   splits' fp32 (m, l, acc) and resets its counter to 0. Masked keys are
//   never read; a row that keeps no key writes 0.
//
// Piece mode (mla_attention_piece_fwd_fp32, the PIECE instance at G = 16):
// the latent is one rank's piece of a sequence cut over the ranks, its row
// j at global position k_start + j; q_offset, kv_len and the window stay
// global, and the block maps its rows' kept range into the piece. It
// writes each (position, head)'s fp32 output normalised over the piece's
// kept keys and its log-sum-exp m + log l (natural log) for the merge
// across the ranks (sharding/collectives.py); rows that keep no key of the
// piece write o = 0 and lse = -1e30, as decode_attention.cuh's piece mode
// does, so one merge serves both. The whole-cache entry runs k_start 0.
#include <stdint.h>

#include "common.cuh"

namespace repro_torch {
namespace {

constexpr int kDk = 576;    // kv_lora_rank + qk_rope_dim
constexpr int kDv = 512;    // kv_lora_rank
constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kColsPerWarp = kDv / kWarps;  // 64: two value columns per lane
constexpr int kPairs = kDk / 64;            // 9 column pairs per lane per key
constexpr int kPart = kDv + 4;              // one split's partial: m, l, pad, acc[kDv]
constexpr int kTile = 16;                   // keys per ring stage (at most 32: one per lane)

size_t smem_bytes(int G, bool v_shared) {
  const size_t ring = 2 * static_cast<size_t>(kTile) * (kDk + (v_shared ? 0 : kDv));
  return sizeof(float) * (G * kDk + ring + G * kTile + 3 * G);
}

// G: query heads per latent head, 16, 8, 4, 2 or 1; PIECE: the piece mode
template <int G, bool PIECE>
__global__ void __launch_bounds__(kThreads)
mla_attention_fp32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                          const float* __restrict__ v, float* __restrict__ o,
                          const int32_t* __restrict__ q_offset,
                          const int32_t* __restrict__ kv_len, float* __restrict__ lse,
                          float* __restrict__ part, int* __restrict__ counters, int T, int Smax,
                          int k_start, int Hkv, int k_row, int v_row, int v_head, int v_shared,
                          int causal, int window, float softcap, float scale, int split_len) {
  constexpr int VEC = 4;  // floats per 16-byte copy
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ int is_last;
  const int vw = v_shared ? 0 : kDv;  // V columns copied per key
  static_assert(G >= 1 && G <= 32, "one head per lane in the score step");
  float* qs = reinterpret_cast<float*>(smem_raw);  // G x kDk
  float* ring = qs + G * kDk;                       // 2 x kTile x (kDk + vw)
  float* ps = ring + 2 * kTile * (kDk + vw);        // G x kTile
  float* m_s = ps + G * kTile;
  float* l_s = m_s + G;
  float* c_s = l_s + G;

  const int rg = blockIdx.x;  // hk * T + t
  const int hk = rg / T, t = rg - hk * T;
  const int split = blockIdx.y, b = blockIdx.z;
  const int n_splits = gridDim.y;
  const int H = Hkv * G;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int qpos = q_offset[b] + t;
  // the rows' kept keys as indices of this cache (of the piece: global
  // position minus k_start, which is 0 for a whole cache)
  int k_hi = min(kv_len[b] - k_start, Smax);
  if (causal) k_hi = min(k_hi, qpos + 1 - k_start);
  const int k_lo = window > 0 ? max(0, qpos - window + 1 - k_start) : 0;
  const size_t row0 = (static_cast<size_t>(b) * T + t) * H + static_cast<size_t>(hk) * G;
  float* ob = o + row0 * kDv;  // the block's G output rows
  float* lb = PIECE ? lse + row0 : nullptr;  // their G log-sum-exps

  if (k_hi <= k_lo) {  // the rows keep no key: they write 0 (and lse -1e30)
    if (split == 0) {
      for (int i = tid; i < G * kDv; i += kThreads) ob[i] = 0.f;
      if (PIECE && tid < G) lb[tid] = kNegInf;
    }
    return;
  }
  const int s_first = k_lo / split_len, s_last = (k_hi - 1) / split_len;
  if (split < s_first || split > s_last) return;
  const int n_live = s_last - s_first + 1;
  const int s0 = max(split * split_len, k_lo), s1 = min((split + 1) * split_len, k_hi);

  const float* kb = k + static_cast<size_t>(b) * Smax * k_row + static_cast<size_t>(hk) * kDk;
  const float* vb = v + static_cast<size_t>(b) * Smax * v_row + static_cast<size_t>(hk) * v_head;
  auto load = [&](int stage, int t0) {
    float* ks = ring + static_cast<size_t>(stage) * kTile * (kDk + vw);
    float* vs = ks + kTile * kDk;
    const int nk = min(kTile, s1 - t0);
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
  for (int i = tid; i < G * kDk; i += kThreads) qs[i] = q[row0 * kDk + i];
  if (tid < G) {
    m_s[tid] = kNegInf;
    l_s[tid] = 0.f;
  }
  const float scale_log2 = scale * kLog2e;
  const int col = warp * kColsPerWarp + 2 * lane;  // this lane's two value columns
  float acc[G][2];
#pragma unroll
  for (int g = 0; g < G; ++g) acc[g][0] = acc[g][1] = 0.f;

  const int n_tiles = (s1 - s0 + kTile - 1) / kTile;
  for (int it = 0; it < n_tiles; ++it) {
    const int t0 = s0 + it * kTile;
    if (it + 1 < n_tiles) {
      load((it + 1) & 1, t0 + kTile);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const float* ks = ring + static_cast<size_t>(it & 1) * kTile * (kDk + vw);
    const float* vs = v_shared ? ks : ks + kTile * kDk;
    const int vstride = v_shared ? kDk : kDv;
    const int nk = min(kTile, s1 - t0);

    // (1) scores in log2 units, softcap(s * scale) * log2(e), into ps
    for (int j = warp; j < nk; j += kWarps) {
      float2 kv[kPairs];
#pragma unroll
      for (int i = 0; i < kPairs; ++i)
        kv[i] = *reinterpret_cast<const float2*>(ks + j * kDk + 2 * (lane + 32 * i));
      float mine = 0.f;
#pragma unroll
      for (int g = 0; g < G; ++g) {
        float s = 0.f;
#pragma unroll
        for (int i = 0; i < kPairs; ++i) {
          const float2 qv = *reinterpret_cast<const float2*>(qs + g * kDk + 2 * (lane + 32 * i));
          s = fmaf(qv.x, kv[i].x, fmaf(qv.y, kv[i].y, s));
        }
        s = warp_sum(s);
        if (lane == g) mine = s;
      }
      if (lane < G)
        ps[lane * kTile + j] = softcap > 0.f ? softcap * kLog2e * tanhf(mine * scale / softcap)
                                             : mine * scale_log2;
    }
    __syncthreads();

    // (2) online softmax: head g on warp g mod 8, each lane one key
    for (int g = warp; g < G; g += kWarps) {
      const float x = lane < nk ? ps[g * kTile + lane] : kNegInf;
      const float m_old = m_s[g], l_old = l_s[g];
      const float mn = fmaxf(m_old, warp_max(x));  // finite: the tile keeps a key
      const float p = lane < nk ? fast_exp2(x - mn) : 0.f;
      const float psum = warp_sum(p);
      if (lane < kTile) ps[g * kTile + lane] = p;
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
    for (int g = 0; g < G; ++g) {
      const float corr = c_s[g];
      acc[g][0] *= corr;
      acc[g][1] *= corr;
    }
    for (int j = 0; j < nk; ++j) {
      const float2 vv = *reinterpret_cast<const float2*>(vs + j * vstride + col);
#pragma unroll
      for (int g = 0; g < G; ++g) {
        const float p = ps[g * kTile + j];
        acc[g][0] = fmaf(p, vv.x, acc[g][0]);
        acc[g][1] = fmaf(p, vv.y, acc[g][1]);
      }
    }
    __syncthreads();  // this stage and ps are consumed before the next tile
  }

  if (n_live == 1) {
#pragma unroll
    for (int g = 0; g < G; ++g) {
      const float inv = 1.f / fmaxf(l_s[g], 1e-30f);
      *reinterpret_cast<float2*>(ob + g * kDv + col) = make_float2(acc[g][0] * inv,
                                                                    acc[g][1] * inv);
    }
    if (PIECE && tid < G) lb[tid] = (m_s[tid] + log2f(l_s[tid])) * kLn2;
    return;
  }
  const size_t rgi = static_cast<size_t>(b) * gridDim.x + rg;  // (b, hk, t): counter and scratch
  float* pb = part + rgi * n_splits * G * kPart;  // one partial per (row group, split)
#pragma unroll
  for (int g = 0; g < G; ++g) {
    float* pp = pb + (static_cast<size_t>(split) * G + g) * kPart;
    if (tid == 0) {
      pp[0] = m_s[g];
      pp[1] = l_s[g];
    }
    pp[4 + col] = acc[g][0];
    pp[4 + col + 1] = acc[g][1];
  }

  // the last live split of this row group to finish merges them all
  __threadfence();
  __syncthreads();
  if (tid == 0) is_last = atomicAdd(counters + rgi, 1) == n_live - 1;
  __syncthreads();
  if (!is_last) return;
  __threadfence();
  // one pass over the live splits with a running (max, sum, acc), 16 bytes
  // of acc per thread per split; __ldcg reads L2, where the others wrote
  constexpr int NV = kDv / 4;
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
    *reinterpret_cast<float4*>(ob + g * kDv + 4 * c) =
        make_float4(os.x * inv, os.y * inv, os.z * inv, os.w * inv);
    if (PIECE && c == 0) lb[g] = (mx + log2f(lsum)) * kLn2;
  }
  if (tid == 0) counters[rgi] = 0;
}

template <int G, bool PIECE>
int launch_fp32(const void* q, const void* k, const void* v, void* o, const void* q_offset,
                const void* kv_len, void* lse, void* part, void* counters, int B, int T, int Smax,
                int k_start, int Hkv, int k_row, int v_row, int v_head, int v_shared, int causal,
                int window, int n_splits, int split_len, float softcap, float scale,
                void* stream) {
  const size_t smem = smem_bytes(G, v_shared != 0);
  const cudaError_t attr = allow_smem(mla_attention_fp32_kernel<G, PIECE>, smem);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const dim3 grid(Hkv * T, n_splits, B);
  mla_attention_fp32_kernel<G, PIECE>
      <<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
          static_cast<const float*>(q), static_cast<const float*>(k),
          static_cast<const float*>(v), static_cast<float*>(o),
          static_cast<const int32_t*>(q_offset), static_cast<const int32_t*>(kv_len),
          static_cast<float*>(lse), static_cast<float*>(part), static_cast<int*>(counters), T,
          Smax, k_start, Hkv, k_row, v_row, v_head, v_shared, causal, window, softcap, scale,
          split_len);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
}  // namespace repro_torch

// The fp32 counterpart of mla_attention_fwd_bf16 (mla_attention_bf16.cu),
// with the same arguments and layout: q (B,T,H,576), o (B,T,H,512), all
// fp32; part and counters sized for B * Hkv * T row groups. Returns the
// CUDA error of the launch, or -1 for a shape the kernel does not take.
extern "C" int mla_attention_fwd_fp32(const void* q, const void* k, const void* v, void* o,
                                      const void* q_offset, const void* kv_len, void* part,
                                      void* counters, int B, int T, int Smax, int H, int Hkv,
                                      int Dk, int Dv, int k_row, int v_row, int v_head,
                                      int v_shared, int causal, int window, int n_splits,
                                      int split_len, float softcap, float scale, void* stream) {
  using namespace repro_torch;
  if (B < 1 || T < 1 || Smax < 1 || Hkv < 1 || H % Hkv != 0 || Dk != kDk || Dv != kDv ||
      n_splits < 1 || split_len < 1)
    return -1;
  const int G = H / Hkv;  // one instance per head group the port serves
  const decltype(&launch_fp32<16, false>) launch = G == 16 ? launch_fp32<16, false>
                                                   : G == 8 ? launch_fp32<8, false>
                                                   : G == 4 ? launch_fp32<4, false>
                                                   : G == 2 ? launch_fp32<2, false>
                                                   : G == 1 ? launch_fp32<1, false>
                                                            : nullptr;
  if (launch == nullptr) return -1;
  return launch(q, k, v, o, q_offset, kv_len, nullptr, part, counters, B, T, Smax, 0, Hkv, k_row,
                v_row, v_head, v_shared, causal, window, n_splits, split_len, softcap, scale,
                stream);
}

// The piece mode (file comment): k, v hold the Smax latent rows at global
// positions [k_start, k_start + Smax) of each row; q_offset, kv_len global.
// o (B,T,H,512) and lse (B,T,H) fp32. G = 16 only (a kv group's gathered
// heads). The rest as mla_attention_fwd_fp32.
extern "C" int mla_attention_piece_fwd_fp32(const void* q, const void* k, const void* v, void* o,
                                            const void* q_offset, const void* kv_len, void* lse,
                                            void* part, void* counters, int B, int T, int Smax,
                                            int k_start, int H, int Hkv, int Dk, int Dv,
                                            int k_row, int v_row, int v_head, int v_shared,
                                            int causal, int window, int n_splits, int split_len,
                                            float softcap, float scale, void* stream) {
  using namespace repro_torch;
  if (B < 1 || T < 1 || Smax < 1 || Hkv < 1 || H != 16 * Hkv || Dk != kDk || Dv != kDv ||
      n_splits < 1 || split_len < 1)
    return -1;
  return launch_fp32<16, true>(q, k, v, o, q_offset, kv_len, lse, part, counters, B, T, Smax,
                               k_start, Hkv, k_row, v_row, v_head, v_shared, causal, window,
                               n_splits, split_len, softcap, scale, stream);
}
