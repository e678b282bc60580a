// Prefill attention on the tensor cores for Hopper (sm_90a), bf16:
// blockwise online-softmax attention with causal mask, sliding window,
// logit softcap, GQA and per-row q_offset / kv_len. The fp32 route is
// flash_attention.cu (CUDA cores, exact fp32 for the parity checks).
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attention.py
// (flash_attention, body _flash_kernel).
//
// Bound on an H100: near the card's ~295 FLOP/byte bf16 ridge at the
// serving path's prefill shapes. Each kept (query, key) pair costs 4 * D
// FLOPs per q head against (q + k + v + o) bytes read or written once:
// causal tinyllama heads at S = 512 do ~230 FLOPs per byte (bytes bound
// it, just), at S = 1024 ~460 (operations). Either way the bound is tens
// of microseconds, which no CUDA-core design reaches (67 TFLOP/s fp32
// against 989 TFLOP/s bf16 on the tensor cores).
//
// Design (the FlashAttention-2 shape):
// - One block of 8 warps per (q head, 128-row q tile, batch row); each
//   warp owns 16 query rows. The grid runs the q heads fastest, so the G q
//   heads of one kv head run side by side and share its K/V tiles in L2.
//   Q tiles run in reverse, the longest causal rows first.
// - S = Q K^T and O += P V are mma.sync.m16n8k16 products, bf16 in and
//   fp32 accumulate, with the operands read from shared memory by ldmatrix
//   (.trans for V); Q's fragments stay in registers when Dk <= 128.
// - P never leaves registers: the fp32 S accumulator of two 8-key blocks
//   is the A operand of the next PV product once packed to bf16.
// - m, l and the rescale stay in fp32 registers; row maxima reduce within
//   the quad of lanes that share a row (two shuffles). Softcap
//   (c * tanh(s / c)) applies to S in registers before the mask. Softmax
//   runs in powers of two (scale * log2(e) folded into S, one ex2 per
//   probability); masked scores are -1e30 and give p = 0, so a row that
//   keeps no key writes 0.
// - K/V tiles of 64 keys go through a two-stage ring in shared memory,
//   filled by 16-byte cp.async copies: tile j + 1 loads while tile j is
//   computed, one barrier per tile. Rows are padded by 16 bytes, so the 8
//   rows of each ldmatrix fall on distinct bank groups. Keys at or past
//   kv_len and head-dim columns past Dk are filled with zeros by the copy.
// - Tiles run only from the window edge of the q tile's first row to the
//   causal and kv_len edge of its last row; a warp skips the products of a
//   tile that all its rows mask (the causal diagonal, the window edge), and
//   only a tile that straddles an edge for a warp's rows pays for the mask.
// - Why these sizes (measured on an H100, PERF.md): occupancy decides.
//   At Dk = Dv = 64 ptxas fits the 8-warp block in 128 registers (a 12-byte
//   spill), two blocks per SM; 4-warp blocks, 32 rows per warp (half the
//   ldmatrix traffic per product, 250 registers), 128-key tiles, a
//   three-stage ring, or 158 registers without the spill at one block per
//   SM all ran slower. Shared memory still feeds the tensor cores: each
//   warp reads the whole K and V tile (16 KB per 64x64 tile for 262 KFLOP)
//   by ldmatrix and the register file; wgmma, which takes its B operand
//   straight from shared memory, is the next step.
#include <stdint.h>

#include "common.cuh"

namespace repro_torch {
namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kBlockQ = kWarps * 16;  // query rows per block, 16 per warp
constexpr int kBlockK = 64;           // keys per K/V tile
constexpr int kStages = 2;            // K/V tiles in the shared-memory ring
constexpr int kPad = 8;               // bf16 of padding per shared-memory row

using bf16 = __nv_bfloat16;

// DK: head dim padded to a multiple of 32; DV: value head dim.
template <int DK, int DV>
struct Tile {
  static constexpr bool kQRegs = DK <= 128;  // Q's fragments stay in registers
  static constexpr int ldk = DK + kPad;      // Q and K rows
  static constexpr int ldv = DV + kPad;
  static constexpr int q_elems = kBlockQ * ldk;
  static constexpr int kv_elems = kBlockK * (ldk + ldv);  // one stage: K tile, then V tile
  static constexpr size_t bytes = sizeof(bf16) * (q_elems + kStages * kv_elems);
};

// rows [0, ROWS) of a (row, D) tile at src + row * stride; rows at or past
// `rows` and columns at or past `cols` are filled with zeros
template <int ROWS, int D>
__device__ __forceinline__ void load_tile(bf16* dst, int ld, const bf16* src, size_t stride,
                                          int rows, int cols, int tid) {
  constexpr int kChunks = D / 8;  // 16-byte chunks per row
#pragma unroll 4
  for (int i = tid; i < ROWS * kChunks; i += kThreads) {
    const int r = i / kChunks, c = i - r * kChunks;
    const bool ok = r < rows && c * 8 < cols;
    cp_async16(dst + r * ld + c * 8, ok ? src + r * stride + c * 8 : src, ok ? 16 : 0);
  }
}

template <int DK, int DV>
__global__ void __launch_bounds__(kThreads)
flash_fwd_bf16_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                      const bf16* __restrict__ v, bf16* __restrict__ o,
                      const int32_t* __restrict__ q_offset, const int32_t* __restrict__ kv_len,
                      int Sq, int Sk, int H, int Hkv, int Dk, int causal, int window,
                      float softcap, float scale) {
  using L = Tile<DK, DV>;
  constexpr int NB = kBlockK / 8;  // 8-key blocks of S per tile
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);
  bf16* kv = qs + L::q_elems;

  const int h = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBlockQ;
  const int b = blockIdx.z;
  const int hk = h / (H / Hkv);
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;  // the thread's rows in the warp's 16: g and g + 8
  const int t = lane & 3;   // its column pair in each 8-column block
  const int r0 = warp * 16;
  const int qoff = q_offset[b];
  const int klen = min(kv_len[b], Sk);

  // keys any row of this tile can keep: [k_lo, k_hi)
  const int q_last = min(q0 + kBlockQ, Sq) - 1;
  int k_hi = klen;
  if (causal) k_hi = min(k_hi, qoff + q_last + 1);
  int k_lo = window > 0 ? max(0, qoff + q0 - window + 1) : 0;
  k_lo = (k_lo / kBlockK) * kBlockK;
  const int n_tiles = k_hi > k_lo ? (k_hi - k_lo + kBlockK - 1) / kBlockK : 0;

  const size_t kstride = static_cast<size_t>(Hkv) * Dk;
  const size_t vstride = static_cast<size_t>(Hkv) * DV;
  const bf16* kb = k + static_cast<size_t>(b) * Sk * kstride + hk * Dk;
  const bf16* vb = v + static_cast<size_t>(b) * Sk * vstride + hk * DV;
  auto load_kv = [&](int it) {  // tile it into its stage of the ring
    const int kt = k_lo + it * kBlockK;
    bf16* ks = kv + (it % kStages) * L::kv_elems;
    load_tile<kBlockK, DK>(ks, L::ldk, kb + kt * kstride, kstride, klen - kt, Dk, tid);
    load_tile<kBlockK, DV>(ks + kBlockK * L::ldk, L::ldv, vb + kt * vstride, vstride, klen - kt,
                           DV, tid);
  };
  if (n_tiles > 0) {  // Q with the first tile, then the rest of the ring
    const size_t qstride = static_cast<size_t>(H) * Dk;
    load_tile<kBlockQ, DK>(qs, L::ldk, q + (static_cast<size_t>(b) * Sq + q0) * qstride + h * Dk,
                           qstride, Sq - q0, Dk, tid);
#pragma unroll
    for (int st = 0; st < kStages - 1; ++st) {
      if (st < n_tiles) load_kv(st);
      cp_async_commit();
    }
  }

  float acc[DV / 8][4];
#pragma unroll
  for (int j = 0; j < DV / 8; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
  float m0 = kNegInf, m1 = kNegInf, l0 = 0.f, l1 = 0.f;  // rows g and g + 8, log2 domain
  uint32_t qf[L::kQRegs ? DK / 16 : 1][4];
  const int wq_first = qoff + q0 + r0;  // the warp's first query position
  const int wq_last = wq_first + 15;    // and its last
  const int mi = lane >> 3, mr = lane & 7;  // ldmatrix: matrix and row this lane addresses
  const float scale_log2 = scale * kLog2e;

  for (int it = 0; it < n_tiles; ++it) {
    const int kt = k_lo + it * kBlockK;
    cp_async_wait<kStages - 2>();  // tile it (and Q) landed
    __syncthreads();  // ... for every thread, and tile it - 1 is consumed
    if (it + kStages - 1 < n_tiles) load_kv(it + kStages - 1);  // into tile it - 1's stage
    cp_async_commit();
    if constexpr (L::kQRegs) {
      if (it == 0) {
#pragma unroll
        for (int kk = 0; kk < DK / 16; ++kk)
          ldmatrix_x4(qf[kk], qs + (r0 + (lane & 15)) * L::ldk + kk * 16 + (lane >> 4) * 8);
      }
    }
    // a tile that every row of this warp masks out changes nothing: skip it
    // (the causal diagonal, the window edge, rows past Sq); the barriers
    // stay uniform
    const bool warp_skips = q0 + r0 >= Sq || (causal && kt > wq_last) ||
                            (window > 0 && kt + kBlockK - 1 < wq_first - window + 1);
    if (warp_skips) continue;
    const bf16* ks = kv + (it % kStages) * L::kv_elems;
    const bf16* vs = ks + kBlockK * L::ldk;

    // S = Q K^T: 16 rows x kBlockK keys per warp, in blocks of 8 keys
    float s[NB][4];
#pragma unroll
    for (int j = 0; j < NB; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < DK / 16; ++kk) {
      uint32_t a[4];
      if constexpr (L::kQRegs) {
#pragma unroll
        for (int e = 0; e < 4; ++e) a[e] = qf[kk][e];
      } else {
        ldmatrix_x4(a, qs + (r0 + (lane & 15)) * L::ldk + kk * 16 + (lane >> 4) * 8);
      }
#pragma unroll
      for (int nb = 0; nb < kBlockK / 16; ++nb) {
        uint32_t bk[4];
        ldmatrix_x4(bk, ks + (nb * 16 + mr + (mi >> 1) * 8) * L::ldk + kk * 16 + (mi & 1) * 8);
        mma_bf16_16816(s[2 * nb], a, bk[0], bk[1]);
        mma_bf16_16816(s[2 * nb + 1], a, bk[2], bk[3]);
      }
    }

    // softcap, mask (only on a tile that straddles an edge of this warp's
    // rows), online softmax in the log2 domain
    const bool need_mask = kt + kBlockK > klen || (causal && kt + kBlockK - 1 > wq_first) ||
                           (window > 0 && kt < wq_last - window + 1);
    float mx0 = kNegInf, mx1 = kNegInf;
#pragma unroll
    for (int j = 0; j < NB; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        // x = softcap(s * scale) * log2(e): softmax in powers of two
        float x = softcap > 0.f ? softcap * kLog2e * tanhf(s[j][e] * scale / softcap)
                                : s[j][e] * scale_log2;
        if (need_mask) {
          const int key = kt + j * 8 + 2 * t + (e & 1);
          const int qp = wq_first + g + (e >> 1) * 8;
          const bool keep =
              key < klen && (!causal || key <= qp) && (window <= 0 || qp - key < window);
          x = keep ? x : kNegInf;
        }
        s[j][e] = x;
      }
      mx0 = fmaxf(mx0, fmaxf(s[j][0], s[j][1]));
      mx1 = fmaxf(mx1, fmaxf(s[j][2], s[j][3]));
    }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
    }
    const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
    // exp2(-1e30 - m) is 0 for a masked score; a row that has kept no key
    // yet (m = -1e30) subtracts 0 instead, so that holds there too
    const float mb0 = mn0 == kNegInf ? 0.f : mn0, mb1 = mn1 == kNegInf ? 0.f : mn1;
    const float c0 = fast_exp2(m0 - mb0), c1 = fast_exp2(m1 - mb1);
    m0 = mn0;
    m1 = mn1;
    float ps0 = 0.f, ps1 = 0.f;
#pragma unroll
    for (int j = 0; j < NB; ++j) {
      s[j][0] = fast_exp2(s[j][0] - mb0);
      s[j][1] = fast_exp2(s[j][1] - mb0);
      s[j][2] = fast_exp2(s[j][2] - mb1);
      s[j][3] = fast_exp2(s[j][3] - mb1);
      ps0 += s[j][0] + s[j][1];
      ps1 += s[j][2] + s[j][3];
    }
    l0 = l0 * c0 + ps0;  // per-thread partial sums; the quad reduces them at the end
    l1 = l1 * c1 + ps1;
#pragma unroll
    for (int j = 0; j < DV / 8; ++j) {
      acc[j][0] *= c0;
      acc[j][1] *= c0;
      acc[j][2] *= c1;
      acc[j][3] *= c1;
    }

    // O += P V: P from the S registers, packed to bf16
#pragma unroll
    for (int kk = 0; kk < kBlockK / 16; ++kk) {
      const uint32_t a[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                             pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                             pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                             pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int nd = 0; nd < DV / 16; ++nd) {
        uint32_t bv[4];
        ldmatrix_x4_trans(bv, vs + (kk * 16 + mr + (mi & 1) * 8) * L::ldv + nd * 16 + (mi >> 1) * 8);
        mma_bf16_16816(acc[2 * nd], a, bv[0], bv[1]);
        mma_bf16_16816(acc[2 * nd + 1], a, bv[2], bv[3]);
      }
    }
  }
  cp_async_wait<0>();  // no copy outlives the block

#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, off);
    l1 += __shfl_xor_sync(0xffffffffu, l1, off);
  }
  // a row that kept no key has l == 0 and acc == 0: it writes 0
  const float inv0 = 1.f / fmaxf(l0, 1e-30f), inv1 = 1.f / fmaxf(l1, 1e-30f);
  const int sq0 = q0 + r0 + g, sq1 = sq0 + 8;
  bf16* o0 = o + ((static_cast<size_t>(b) * Sq + sq0) * H + h) * DV + 2 * t;
  bf16* o1 = o0 + static_cast<size_t>(8) * H * DV;
#pragma unroll
  for (int j = 0; j < DV / 8; ++j) {
    if (sq0 < Sq) *reinterpret_cast<uint32_t*>(o0 + j * 8) = pack_bf16(acc[j][0] * inv0, acc[j][1] * inv0);
    if (sq1 < Sq) *reinterpret_cast<uint32_t*>(o1 + j * 8) = pack_bf16(acc[j][2] * inv1, acc[j][3] * inv1);
  }
}

template <int DK, int DV>
int launch(const void* q, const void* k, const void* v, void* o, const void* q_offset,
           const void* kv_len, int B, int Sq, int Sk, int H, int Hkv, int Dk, int causal,
           int window, float softcap, float scale, cudaStream_t stream) {
  using L = Tile<DK, DV>;
  const cudaError_t attr = allow_smem(flash_fwd_bf16_kernel<DK, DV>, L::bytes);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const dim3 grid(H, (Sq + kBlockQ - 1) / kBlockQ, B);
  flash_fwd_bf16_kernel<DK, DV><<<grid, kThreads, L::bytes, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<bf16*>(o), static_cast<const int32_t*>(q_offset),
      static_cast<const int32_t*>(kv_len), Sq, Sk, H, Hkv, Dk, causal, window, softcap, scale);
  return static_cast<int>(cudaGetLastError());
}

template <int DK>
int dispatch_dv(int Dv, const void* q, const void* k, const void* v, void* o,
                const void* q_offset, const void* kv_len, int B, int Sq, int Sk, int H, int Hkv,
                int Dk, int causal, int window, float softcap, float scale, cudaStream_t st) {
  switch (Dv) {
    case 32:
      return launch<DK, 32>(q, k, v, o, q_offset, kv_len, B, Sq, Sk, H, Hkv, Dk, causal, window,
                            softcap, scale, st);
    case 64:
      return launch<DK, 64>(q, k, v, o, q_offset, kv_len, B, Sq, Sk, H, Hkv, Dk, causal, window,
                            softcap, scale, st);
    case 128:
      return launch<DK, 128>(q, k, v, o, q_offset, kv_len, B, Sq, Sk, H, Hkv, Dk, causal,
                             window, softcap, scale, st);
    case 256:
      return launch<DK, 256>(q, k, v, o, q_offset, kv_len, B, Sq, Sk, H, Hkv, Dk, causal,
                             window, softcap, scale, st);
    default:
      return -1;
  }
}

}  // namespace
}  // namespace repro_torch

// q (B,Sq,H,Dk), k (B,Sk,Hkv,Dk), v (B,Sk,Hkv,Dv), o (B,Sq,H,Dv), all
// contiguous bf16; q_offset and kv_len (B,) int32 on the device. Dk a
// multiple of 16 up to 256, Dv in {32, 64, 128, 256}. window <= 0 means no
// window, softcap <= 0 no softcap. Returns the CUDA error of the launch,
// or -1 for a shape the kernel does not take.
extern "C" int flash_attention_fwd_bf16(const void* q, const void* k, const void* v, void* o,
                                        const void* q_offset, const void* kv_len, int B, int Sq,
                                        int Sk, int H, int Hkv, int Dk, int Dv, int causal,
                                        int window, float softcap, float scale, void* stream) {
  using namespace repro_torch;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (Dk <= 0 || Dk % 16 != 0 || Dk > 256) return -1;
  if (Dk <= 32)
    return dispatch_dv<32>(Dv, q, k, v, o, q_offset, kv_len, B, Sq, Sk, H, Hkv, Dk, causal,
                           window, softcap, scale, st);
  if (Dk <= 64)
    return dispatch_dv<64>(Dv, q, k, v, o, q_offset, kv_len, B, Sq, Sk, H, Hkv, Dk, causal,
                           window, softcap, scale, st);
  if (Dk <= 128)
    return dispatch_dv<128>(Dv, q, k, v, o, q_offset, kv_len, B, Sq, Sk, H, Hkv, Dk, causal,
                            window, softcap, scale, st);
  return dispatch_dv<256>(Dv, q, k, v, o, q_offset, kv_len, B, Sq, Sk, H, Hkv, Dk, causal,
                          window, softcap, scale, st);
}
