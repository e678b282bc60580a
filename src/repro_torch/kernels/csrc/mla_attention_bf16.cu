// Absorbed-MLA attention on the tensor cores for Hopper (sm_90a), bf16:
// G = 16, 8, 4, 2 or 1 query heads per latent KV head of width Dk = 576
// (kv_lora_rank 512 + qk_rope_dim 64), values of width Dv = 512 (the
// latent rows' first 512 columns, or a tensor of their own), T >= 1 query
// positions per batch row, per-row q_offset / kv_len, causal mask, sliding
// window and logit softcap. DeepSeek-V2-Lite's absorbed decode (T = 1) and
// its speculative verify and draft catch-up (T > 1) reach this shape
// (src/repro/models/attention.py, mla_decode): G = 16 unsharded, and a
// rank's 8, 4, 2 or 1 of the 16 heads on a model axis of 2, 4, 8 or 16.
// The fp32 route
// is decode_attention_mla.cu (CUDA cores, exact fp32 for the parity checks).
//
// Replaces the Pallas TPU kernels src/repro/kernels/decode_attention.py
// (decode_attention, body _decode_kernel) at this shape, and
// src/repro/kernels/flash_attention.py (flash_attention, body
// _flash_kernel) at this shape with Sq = T > 1.
//
// Bound on an H100: bytes, at every T. Each kept latent row is 576 * 2 B
// and carries 2 * 16 * T * (576 + 512) FLOPs of tensor-core work, ~30 * T
// FLOPs per byte, far under the ~295 FLOP/byte bf16 ridge: the bound is
// sum_b kept_b * 576 * 2 B (+ q and o) over 3.35 TB/s, ~1.4 us at 8 slots
// x 1024. The CUDA-core kernel before this one was bound by its FMAs
// (30 FLOP/byte is above the fp32 CUDA cores' ridge); here the products run
// on the tensor cores and shared memory feeds them.
//
// Design:
// - One block of 8 warps per (latent head, query position t, split of the
//   cache, batch row): its G rows are the G heads at one position, held in
//   one m16 row tile of mma.sync.m16n8k16 (a template parameter; at G < 16
//   rows G..15 of the tile are zero-filled q rows whose scores,
//   probabilities and sums are computed and never stored, merged or
//   written: the kernel is bound by the latent rows it reads, which all G
//   share, so the idle rows cost tensor-core work only). All rows share one mask,
//   [k_lo, k_hi) with k_hi = min(kv_len, Smax, q_offset + t + 1 if
//   causal), so the block reads only kept latent rows. A row's key tiles,
//   their order, its split and its merge depend on its position alone:
//   a verify row and a decode step at the same position run the same
//   arithmetic, whatever T is. The T blocks of one split run side by side
//   (t is the grid's fastest index), so the second to T-th read of each
//   latent row hits L2. O (16 x 512 fp32) fits in registers for any T:
//   each warp owns 64 value columns, 32 accumulators per lane.
// - The split plan and the merge are decode_attention.cuh's
//   (decode_attention.plan_splits, from the shapes alone): a row whose kept
//   keys lie in one split writes its output directly, otherwise each live
//   split writes its fp32 (m, l, acc) to scratch and the last block of the
//   (row group, latent head) to finish, found with an atomic counter,
//   merges them and resets its counter to 0. A row that keeps no key
//   writes 0; masked keys are never read. A split's partial is 33 KB here
//   (16 rows x 512 columns), nearly half its 64 latent rows' bytes, so the
//   merging block reads in two passes: the splits' (m, l) into shared
//   memory and their weights 2^(m_s - M), then sum_s w_s acc_s with each
//   thread's 8 float4 of every split loaded together (on an H100, 22.5 us
//   against 28.4 for a running merge at 8 slots x 1024; PERF.md,
//   chip_smoke.py --phases mla_parts).
// - Tiles of 64 latent rows go through a shared-memory ring filled by
//   16-byte cp.async copies (two stages when a split holds more than one
//   tile and the values are the latent rows, else one: at one stage two
//   blocks fit an SM). Rows are padded by 16 bytes, so the 8 rows of each
//   ldmatrix fall on distinct bank groups; rows past the split's end are
//   filled with zeros.
// - S = Q K^T: the 36 k-steps of Dk split in four quarters, the 64 keys in
//   two halves; each warp takes one quarter of one half (4 x 9 mma), so Q
//   is read from shared memory twice per tile, not eight times. The four
//   fp32 partial sums meet in shared memory, summed in a fixed order.
// - The online softmax runs two rows per warp, two keys per lane, in fp32
//   and in powers of two (scale * log2(e) folded in, softcap c * tanh(s / c)
//   before the mask); P goes to shared memory as bf16, the A operand of
//   O += P V, whose B operand is read by ldmatrix.trans straight from the
//   latent tile (its first 512 columns).
//
// Piece mode (mla_attention_piece_fwd_bf16, the PIECE instance at G = 16):
// the latent is one rank's piece of a sequence cut over the ranks, its row
// j at global position k_start + j; q_offset, kv_len and the window stay
// global, and the block maps its rows' kept range [k_lo, k_hi) into the
// piece. In place of the bf16 output it writes each (position, head)'s
// fp32 output normalised over the piece's kept keys and its log-sum-exp
// m + log l (natural log) for the merge across the ranks
// (sharding/collectives.py); rows that keep no key of the piece write o = 0
// and lse = -1e30, as decode_attention.cuh's piece mode does, so one merge
// serves both. Its P V takes P as two bf16 parts, hi + lo (two products),
// so that the fp32 output is fp32-accurate (the plain version's tolerance),
// where the whole-cache instance rounds P once to bf16; the rest of its
// arithmetic is the whole-cache instance's, which runs k_start 0.
#include <stdint.h>

#include <type_traits>

#include "common.cuh"

namespace repro_torch {
namespace {

using bf16 = __nv_bfloat16;

constexpr int kG = 16;      // rows of the m16 tile: the G <= 16 query heads of a latent head
constexpr int kDk = 576;    // kv_lora_rank + qk_rope_dim
constexpr int kDv = 512;    // kv_lora_rank
constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kKeys = 64;              // latent rows per tile
constexpr int kLdk = kDk + 8;          // q and latent rows in shared memory, padded
constexpr int kLdv = kDv + 8;          // separate value rows, padded
constexpr int kLds = kKeys + 8;        // fp32 score partial rows
constexpr int kLdp = kKeys + 8;        // bf16 probability rows
constexpr int kKSplit = 4;             // quarters of Dk's k-steps
constexpr int kKSteps = kDk / 16 / kKSplit;              // 9 k-steps per quarter
constexpr int kKeysPerWarp = kKeys * kKSplit / kWarps;   // 32 keys per warp
constexpr int kColsPerWarp = kDv / kWarps;               // 64 value columns per warp
constexpr int kPart = kDv + 4;  // one split's partial: m, l, 2 floats of padding, acc[kDv]

__host__ __device__ inline size_t stage_elems(bool v_shared) {  // bf16 per ring stage
  return static_cast<size_t>(kKeys) * (kLdk + (v_shared ? 0 : kLdv));
}

// the piece mode keeps P's low halves beside it (``piece``)
size_t smem_bytes(int stages, bool v_shared, bool piece) {
  return sizeof(bf16) * (kG * kLdk + stages * stage_elems(v_shared)) +
         sizeof(float) * kKSplit * kG * kLds + sizeof(bf16) * kG * kLdp * (piece ? 2 : 1) +
         sizeof(float) * 3 * kG;
}

// the output's element type: bf16, or fp32 in the piece mode
template <bool PIECE>
using OutT = std::conditional_t<PIECE, float, bf16>;

// G: query heads per latent head, 16, 8, 4, 2 or 1; PIECE: the piece mode
template <int G, bool PIECE>
__global__ void __launch_bounds__(kThreads, 2)
mla_attention_bf16_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                          const bf16* __restrict__ v, OutT<PIECE>* __restrict__ o,
                          const int32_t* __restrict__ q_offset,
                          const int32_t* __restrict__ kv_len, float* __restrict__ lse,
                          float* __restrict__ part, int* __restrict__ counters, int T, int Smax,
                          int k_start, int Hkv, int k_row, int v_row, int v_head, int v_shared,
                          int causal, int window, float softcap, float scale, int split_len,
                          int stages) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ int is_last;
  const int stage = static_cast<int>(stage_elems(v_shared != 0));
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);                   // kG x kLdk
  bf16* ring = qs + kG * kLdk;                                     // stages x stage
  float* spart = reinterpret_cast<float*>(ring + stages * stage);  // kKSplit x kG x kLds
  bf16* ps = reinterpret_cast<bf16*>(spart + kKSplit * kG * kLds);  // kG x kLdp
  bf16* pl = ps + kG * kLdp;  // the piece mode's low halves of P, kG x kLdp
  float* c_s = reinterpret_cast<float*>(ps + (PIECE ? 2 : 1) * kG * kLdp);  // per row: rescale
  float* l_s = c_s + kG;
  float* m_s = l_s + kG;

  const int rg = blockIdx.x;  // hk * T + t
  const int hk = rg / T, t = rg - hk * T;
  const int split = blockIdx.y, b = blockIdx.z;
  const int n_splits = gridDim.y;
  static_assert(G >= 1 && G <= kG, "G heads in one m16 tile");
  const int H = Hkv * G;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tq = lane & 3;   // mma fragment: rows g, g + 8; columns 2tq, 2tq + 1
  const int mi = lane >> 3, mr = lane & 7;  // ldmatrix: the matrix and row this lane addresses
  const int qpos = q_offset[b] + t;
  // the rows' kept keys as indices of this cache (of the piece: global
  // position minus k_start, which is 0 for a whole cache)
  int k_hi = min(kv_len[b] - k_start, Smax);
  if (causal) k_hi = min(k_hi, qpos + 1 - k_start);
  const int k_lo = window > 0 ? max(0, qpos - window + 1 - k_start) : 0;
  const size_t row0 = (static_cast<size_t>(b) * T + t) * H + static_cast<size_t>(hk) * G;
  OutT<PIECE>* ob = o + row0 * kDv;  // the block's G output rows
  float* lb = PIECE ? lse + row0 : nullptr;  // their G log-sum-exps

  if (k_hi <= k_lo) {  // the rows keep no key: they write 0 (and lse -1e30)
    if (split == 0) {
      if constexpr (PIECE) {
        for (int i = tid; i < G * kDv; i += kThreads) ob[i] = 0.f;
        if (tid < G) lb[tid] = kNegInf;
      } else {
        for (int i = tid; i < G * kDv / 2; i += kThreads) reinterpret_cast<uint32_t*>(ob)[i] = 0u;
      }
    }
    return;
  }
  const int s_first = k_lo / split_len, s_last = (k_hi - 1) / split_len;
  if (split < s_first || split > s_last) return;
  const int n_live = s_last - s_first + 1;
  const int s0 = max(split * split_len, k_lo), s1 = min((split + 1) * split_len, k_hi);
  const int n_tiles = (s1 - s0 + kKeys - 1) / kKeys;

  const bf16* kb = k + static_cast<size_t>(b) * Smax * k_row + static_cast<size_t>(hk) * kDk;
  const bf16* vb = v + static_cast<size_t>(b) * Smax * v_row + static_cast<size_t>(hk) * v_head;
  auto load = [&](int st, int t0) {  // latent rows [t0, t0 + 64) into stage st; zeros past s1
    bf16* ks = ring + st * stage;
    const int nk = min(kKeys, s1 - t0);
    constexpr int kch = kDk / 8, vch = kDv / 8;  // 16-byte chunks per row
    for (int i = tid; i < kKeys * kch; i += kThreads) {
      const int r = i / kch, c = i - r * kch;
      const bool ok = r < nk;
      cp_async16(ks + r * kLdk + c * 8, ok ? kb + static_cast<size_t>(t0 + r) * k_row + c * 8 : kb,
                 ok ? 16 : 0);
    }
    if (!v_shared) {
      bf16* vs = ks + kKeys * kLdk;
      for (int i = tid; i < kKeys * vch; i += kThreads) {
        const int r = i / vch, c = i - r * vch;
        const bool ok = r < nk;
        cp_async16(vs + r * kLdv + c * 8,
                   ok ? vb + static_cast<size_t>(t0 + r) * v_row + c * 8 : vb, ok ? 16 : 0);
      }
    }
  };

  {  // q's G rows with the first tile; rows G..15 of the tile zero-filled
    const bf16* qb = q + row0 * kDk;
    constexpr int qch = kDk / 8;
    for (int i = tid; i < kG * qch; i += kThreads) {
      const int r = i / qch, c = i - r * qch;
      const bool ok = r < G;
      cp_async16(qs + r * kLdk + c * 8, ok ? qb + r * kDk + c * 8 : qb, ok ? 16 : 0);
    }
  }
  load(0, s0);
  cp_async_commit();

  const int kq = warp % kKSplit, kh = warp / kKSplit;  // this warp's k quarter and key half
  const float scale_log2 = scale * kLog2e;
  float m_row[2] = {kNegInf, kNegInf}, l_row[2] = {0.f, 0.f};  // rows 2 warp, 2 warp + 1
  float acc[kColsPerWarp / 8][4];
#pragma unroll
  for (int j = 0; j < kColsPerWarp / 8; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;

  for (int it = 0; it < n_tiles; ++it) {
    const int t0 = s0 + it * kKeys;
    const int nk = min(kKeys, s1 - t0);
    cp_async_wait<0>();  // tile it (and q) landed
    __syncthreads();     // ... for every thread, and tile it - 1 is consumed
    if (stages == 2 && it + 1 < n_tiles) {
      load((it + 1) & 1, t0 + kKeys);
      cp_async_commit();
    }
    const bf16* ks = ring + (stages == 2 ? (it & 1) : 0) * stage;
    const bf16* vs = v_shared ? ks : ks + kKeys * kLdk;
    const int ldv = v_shared ? kLdk : kLdv;

    // (1) partial scores: k-steps [9 kq, 9 kq + 9) of keys [32 kh, 32 kh + 32)
    float s[kKeysPerWarp / 8][4];
#pragma unroll
    for (int j = 0; j < kKeysPerWarp / 8; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
    for (int i = 0; i < kKSteps; ++i) {
      const int kk = kq * kKSteps + i;
      uint32_t a[4];
      ldmatrix_x4(a, qs + (lane & 15) * kLdk + kk * 16 + (lane >> 4) * 8);
#pragma unroll
      for (int nb = 0; nb < kKeysPerWarp / 16; ++nb) {
        uint32_t bk[4];
        ldmatrix_x4(bk, ks + (kh * kKeysPerWarp + nb * 16 + mr + (mi >> 1) * 8) * kLdk + kk * 16 +
                            (mi & 1) * 8);
        mma_bf16_16816(s[2 * nb], a, bk[0], bk[1]);
        mma_bf16_16816(s[2 * nb + 1], a, bk[2], bk[3]);
      }
    }
    float* sp = spart + kq * kG * kLds;
#pragma unroll
    for (int j = 0; j < kKeysPerWarp / 8; ++j) {
      const int col = kh * kKeysPerWarp + j * 8 + 2 * tq;
      *reinterpret_cast<float2*>(sp + g * kLds + col) = make_float2(s[j][0], s[j][1]);
      *reinterpret_cast<float2*>(sp + (g + 8) * kLds + col) = make_float2(s[j][2], s[j][3]);
    }
    __syncthreads();

    // (2) online softmax of rows 2 warp + rr, keys lane and lane + 32
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      const int row = 2 * warp + rr;
      float x[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int j = lane + 32 * h;
        float sum = spart[row * kLds + j];
#pragma unroll
        for (int qq = 1; qq < kKSplit; ++qq) sum += spart[(qq * kG + row) * kLds + j];
        const float xs = softcap > 0.f ? softcap * kLog2e * tanhf(sum * scale / softcap)
                                       : sum * scale_log2;
        x[h] = j < nk ? xs : kNegInf;
      }
      const float mn = fmaxf(m_row[rr], warp_max(fmaxf(x[0], x[1])));  // finite: key 0 is kept
      const float p0 = fast_exp2(x[0] - mn), p1 = fast_exp2(x[1] - mn);
      const float corr = fast_exp2(m_row[rr] - mn);
      l_row[rr] = l_row[rr] * corr + warp_sum(p0 + p1);
      m_row[rr] = mn;
      const bf16 h0 = __float2bfloat16(p0), h1 = __float2bfloat16(p1);
      ps[row * kLdp + lane] = h0;
      ps[row * kLdp + lane + 32] = h1;
      if constexpr (PIECE) {  // P = hi + lo, each bf16: P V to ~2^-17 of P
        pl[row * kLdp + lane] = __float2bfloat16(p0 - __bfloat162float(h0));
        pl[row * kLdp + lane + 32] = __float2bfloat16(p1 - __bfloat162float(h1));
      }
      if (lane == 0) {
        c_s[row] = corr;
        l_s[row] = l_row[rr];
        m_s[row] = mn;
      }
    }
    __syncthreads();

    // (3) acc = acc * corr + P V over this warp's 64 value columns
    const float c0 = c_s[g], c1 = c_s[g + 8];
#pragma unroll
    for (int j = 0; j < kColsPerWarp / 8; ++j) {
      acc[j][0] *= c0;
      acc[j][1] *= c0;
      acc[j][2] *= c1;
      acc[j][3] *= c1;
    }
#pragma unroll
    for (int kk = 0; kk < kKeys / 16; ++kk) {
      uint32_t a[4], al[4];
      ldmatrix_x4(a, ps + (lane & 15) * kLdp + kk * 16 + (lane >> 4) * 8);
      if constexpr (PIECE) ldmatrix_x4(al, pl + (lane & 15) * kLdp + kk * 16 + (lane >> 4) * 8);
#pragma unroll
      for (int nd = 0; nd < kColsPerWarp / 16; ++nd) {
        uint32_t bv[4];
        ldmatrix_x4_trans(bv, vs + (kk * 16 + mr + (mi & 1) * 8) * ldv + warp * kColsPerWarp +
                                  nd * 16 + (mi >> 1) * 8);
        mma_bf16_16816(acc[2 * nd], a, bv[0], bv[1]);
        mma_bf16_16816(acc[2 * nd + 1], a, bv[2], bv[3]);
        if constexpr (PIECE) {
          mma_bf16_16816(acc[2 * nd], al, bv[0], bv[1]);
          mma_bf16_16816(acc[2 * nd + 1], al, bv[2], bv[3]);
        }
      }
    }
    if (stages == 1 && it + 1 < n_tiles) {  // the one stage is consumed: refill it
      __syncthreads();
      load(0, t0 + kKeys);
      cp_async_commit();
    }
  }

  // l_s and m_s were last written before the last tile's second barrier
  const int col = warp * kColsPerWarp + 2 * tq;
  if (n_live == 1) {
    const float inv0 = 1.f / fmaxf(l_s[g], 1e-30f), inv1 = 1.f / fmaxf(l_s[g + 8], 1e-30f);
    OutT<PIECE>* o0 = ob + g * kDv + col;
    OutT<PIECE>* o1 = o0 + 8 * kDv;
#pragma unroll
    for (int j = 0; j < kColsPerWarp / 8; ++j) {
      if constexpr (PIECE) {
        if (g < G)
          *reinterpret_cast<float2*>(o0 + j * 8) = make_float2(acc[j][0] * inv0, acc[j][1] * inv0);
        if (g + 8 < G)
          *reinterpret_cast<float2*>(o1 + j * 8) = make_float2(acc[j][2] * inv1, acc[j][3] * inv1);
      } else {
        if (g < G)
          *reinterpret_cast<uint32_t*>(o0 + j * 8) = pack_bf16(acc[j][0] * inv0, acc[j][1] * inv0);
        if (g + 8 < G)
          *reinterpret_cast<uint32_t*>(o1 + j * 8) = pack_bf16(acc[j][2] * inv1, acc[j][3] * inv1);
      }
    }
    if (PIECE && tid < G) lb[tid] = (m_s[tid] + log2f(l_s[tid])) * kLn2;
    return;
  }
  // one partial per (row group, split): G rows of kPart floats
  const size_t rgi = static_cast<size_t>(b) * gridDim.x + rg;  // (b, hk, t): counter and scratch
  float* pb = part + rgi * n_splits * G * kPart;
  float* pp = pb + static_cast<size_t>(split) * G * kPart;
  if (tid < G) {
    pp[tid * kPart] = m_s[tid];
    pp[tid * kPart + 1] = l_s[tid];
  }
#pragma unroll
  for (int j = 0; j < kColsPerWarp / 8; ++j) {
    if (g < G)
      *reinterpret_cast<float2*>(pp + g * kPart + 4 + col + j * 8) =
          make_float2(acc[j][0], acc[j][1]);
    if (g + 8 < G)
      *reinterpret_cast<float2*>(pp + (g + 8) * kPart + 4 + col + j * 8) =
          make_float2(acc[j][2], acc[j][3]);
  }

  // the last live split of this row group to finish merges them all
  __threadfence();
  __syncthreads();
  if (tid == 0) is_last = atomicAdd(counters + rgi, 1) == n_live - 1;
  __syncthreads();
  if (!is_last) return;
  __threadfence();
  // weights w_s = 2^(m_s - M) of each (row, split), M the row's largest
  // m_s, then o = sum_s w_s acc_s / sum_s w_s l_s; the ring is consumed and
  // holds the m_s and l_s of the G rows
  float* mw = reinterpret_cast<float*>(ring);  // G x n_live: m_s, then w_s
  float* lw = mw + G * n_live;                 // G x n_live: l_s
  for (int i = tid; i < G * n_live; i += kThreads) {
    const int r = i / n_live, sj = i - r * n_live;
    const float* src = pb + (static_cast<size_t>(s_first + sj) * G + r) * kPart;
    mw[i] = __ldcg(src);
    lw[i] = __ldcg(src + 1);
  }
  __syncthreads();
  if (tid < G) {
    float M = kNegInf;
    for (int sj = 0; sj < n_live; ++sj) M = fmaxf(M, mw[tid * n_live + sj]);
    float L = 0.f;
    for (int sj = 0; sj < n_live; ++sj) {
      const float w = fast_exp2(mw[tid * n_live + sj] - M);
      L += w * lw[tid * n_live + sj];
      mw[tid * n_live + sj] = w;
    }
    c_s[tid] = 1.f / fmaxf(L, 1e-30f);
    if (PIECE) lb[tid] = (M + log2f(L)) * kLn2;
  }
  __syncthreads();
  constexpr int NV = kDv / 4;  // float4 per row
  // float4 per thread, loaded per split: 8, 4, 2 or 1; at G = 1 the row's
  // 128 float4 leave threads 128..255 of the block without one (``live``)
  constexpr int kItems = (G * NV + kThreads - 1) / kThreads;
  float4 os[kItems];
#pragma unroll
  for (int e = 0; e < kItems; ++e) os[e] = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 2
  for (int sj = 0; sj < n_live; ++sj) {
    const float* src = pb + static_cast<size_t>(s_first + sj) * G * kPart + 4;
    float4 a[kItems];
#pragma unroll
    for (int e = 0; e < kItems; ++e) {
      const int i = tid + e * kThreads, r = i / NV, c = i - r * NV;
      a[e] = i < G * NV ? __ldcg(reinterpret_cast<const float4*>(src + r * kPart) + c)
                        : make_float4(0.f, 0.f, 0.f, 0.f);
    }
#pragma unroll
    for (int e = 0; e < kItems; ++e) {
      const int i = tid + e * kThreads;
      const float w = i < G * NV ? mw[(i / NV) * n_live + sj] : 0.f;
      os[e].x += w * a[e].x;
      os[e].y += w * a[e].y;
      os[e].z += w * a[e].z;
      os[e].w += w * a[e].w;
    }
  }
#pragma unroll
  for (int e = 0; e < kItems; ++e) {
    const int i = tid + e * kThreads, r = i / NV, c = i - r * NV;
    if (i >= G * NV) continue;
    const float inv = c_s[r];
    if constexpr (PIECE)
      *reinterpret_cast<float4*>(ob + r * kDv + 4 * c) =
          make_float4(os[e].x * inv, os[e].y * inv, os[e].z * inv, os[e].w * inv);
    else
      *reinterpret_cast<uint2*>(ob + r * kDv + 4 * c) = make_uint2(
          pack_bf16(os[e].x * inv, os[e].y * inv), pack_bf16(os[e].z * inv, os[e].w * inv));
  }
  if (tid == 0) counters[rgi] = 0;
}

template <int G, bool PIECE>
int launch_bf16(const void* q, const void* k, const void* v, void* o, const void* q_offset,
                const void* kv_len, void* lse, void* part, void* counters, int B, int T, int Smax,
                int k_start, int Hkv, int k_row, int v_row, int v_head, int v_shared, int causal,
                int window, int n_splits, int split_len, float softcap, float scale,
                void* stream) {
  // the merge keeps every split's (m, l) of its G rows in one ring stage
  const size_t merge_bytes = static_cast<size_t>(n_splits) * 2 * G * sizeof(float);
  if (merge_bytes > stage_elems(v_shared != 0) * sizeof(bf16)) return -1;
  const int stages = v_shared && split_len > kKeys ? 2 : 1;
  const size_t smem = smem_bytes(stages, v_shared != 0, PIECE);
  const cudaError_t attr = allow_smem(mla_attention_bf16_kernel<G, PIECE>, smem);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const dim3 grid(Hkv * T, n_splits, B);
  mla_attention_bf16_kernel<G, PIECE>
      <<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
          static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
          static_cast<OutT<PIECE>*>(o), static_cast<const int32_t*>(q_offset),
          static_cast<const int32_t*>(kv_len), static_cast<float*>(lse),
          static_cast<float*>(part), static_cast<int*>(counters), T, Smax, k_start, Hkv, k_row,
          v_row, v_head, v_shared, causal, window, softcap, scale, split_len, stages);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
}  // namespace repro_torch

// q (B,T,H,576) contiguous, H = G * Hkv with G in {16, 8, 4, 2, 1}; k: rows of (Hkv, 576), row b, s
// at k + (b * Smax + s) * k_row; v: rows of (Hkv, 512) at v + (b * Smax +
// s) * v_row + h * v_head. v_shared != 0 says that v is the first 512
// columns of k's rows (the latent cache), which the kernel then reads
// once per tile. o (B,T,H,512) contiguous; all bf16, 16-byte aligned, the
// strides multiples of 16 bytes; q_offset and kv_len (B,) int32 on the
// device: query t of row b sits at position q_offset[b] + t and keeps key
// j < min(kv_len[b], Smax), j <= its position if causal, and position - j
// < window if window > 0. part: fp32 scratch of B * Hkv * T * n_splits *
// G * 516; counters: B * Hkv * T int32, all 0 (the kernel leaves them 0).
// Split s covers keys [s * split_len, (s + 1) * split_len). softcap <= 0
// means no softcap. Returns the CUDA error of the launch, or -1 for a
// shape the kernel does not take.
extern "C" int mla_attention_fwd_bf16(const void* q, const void* k, const void* v, void* o,
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
  const decltype(&launch_bf16<16, false>) launch = G == 16 ? launch_bf16<16, false>
                                                   : G == 8 ? launch_bf16<8, false>
                                                   : G == 4 ? launch_bf16<4, false>
                                                   : G == 2 ? launch_bf16<2, false>
                                                   : G == 1 ? launch_bf16<1, false>
                                                            : nullptr;
  if (launch == nullptr) return -1;
  return launch(q, k, v, o, q_offset, kv_len, nullptr, part, counters, B, T, Smax, 0, Hkv, k_row,
                v_row, v_head, v_shared, causal, window, n_splits, split_len, softcap, scale,
                stream);
}

// The piece mode (file comment): k, v hold the Smax latent rows at global
// positions [k_start, k_start + Smax) of each row; q_offset, kv_len global.
// o (B,T,H,512) and lse (B,T,H) fp32, q, k, v bf16. G = 16 only (a kv
// group's gathered heads). The rest as mla_attention_fwd_bf16.
extern "C" int mla_attention_piece_fwd_bf16(const void* q, const void* k, const void* v, void* o,
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
  return launch_bf16<16, true>(q, k, v, o, q_offset, kv_len, lse, part, counters, B, T, Smax,
                               k_start, Hkv, k_row, v_row, v_head, v_shared, causal, window,
                               n_splits, split_len, softcap, scale, stream);
}
