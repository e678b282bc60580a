// Mamba2 SSD chunked scan on the tensor cores for Hopper (sm_90a), bf16.
// The fp32 route is ssd_scan.cu (CUDA cores, exact fp32 for the parity
// checks).
//
// Replaces the Pallas TPU kernel src/repro/kernels/ssd_scan.py (ssd_scan,
// body _ssd_kernel). Per batch row b, head h and chunk of Q positions, with
// cum the running sum of dA over the chunk:
//   y_i = sum_{j<=i} exp(cum_i - cum_j) (C_i . B_j) dt_j x_j + exp(cum_i) C_i . h_in
//   h  <- exp(cum_last) h + sum_j exp(cum_last - cum_j) dt_j x_j (x) B_j
// x (B,S,H,P), B/C (B,S,N) shared by all heads (ngroups 1), y bf16; dA, dt
// (B,S,H) and the final state (B,H,P,N) fp32.
//
// Bound on an H100: bytes at the serving shapes. mamba2-2.7b at B=8 S=512
// (H 80, P 64, N 128, chunk 256) reads x, dA, dt, B, C and writes y and the
// state in 0.0327 ms at 3.35 TB/s, against 0.0165 ms for its 16.3 GFLOP
// of unique work at the 989 TFLOP/s bf16 peak. Neither is near: the work
// is split across many small products and a sequential chunk recurrence.
//
// Design: the SSD decomposition of the Mamba2 paper (arXiv:2405.21060 §7)
// in two launches, every product an mma.sync m16n8k16 (bf16 in, fp32
// accumulate) fed by ldmatrix from tiles that 16-byte cp.async copies fill
// through a two-stage ring, each B, C and x tile read once per block.
// 1. ssd_state_bf16_kernel, one block of 4 warps per (64-column half of
//    the state, head, row): the chunk loop inside the block, the P x 64
//    state slice in fp32 accumulators (each warp 16 rows). Per chunk it
//    scans dA (block scan), hands on the state entering the chunk (bf16 hi
//    + lo parts, for the output pass), decays it and adds
//    sum_j w_j x_j (x) B_j, w_j x_j formed in registers from the x
//    fragments and split into a bf16 hi part and a bf16 lo part (two
//    products), so the carried state keeps ~16 bits, not bf16's 8. It
//    writes cum (in log2 units) and dt per head for pass 2. 160 blocks at
//    B=1 (mamba2-2.7b's 80 heads), five per SM.
// 2. ssd_out_bf16_kernel, one block of 8 warps per (pair of heads, 128-row
//    tile of a chunk, chunk and row), each warp 16 rows: the inter-chunk
//    term C_i . h_in (h_in as hi + lo), then for each 64-column tile j the
//    16 x 64 tile C_i . B_j^T per warp, formed once in fp32 registers for
//    both heads, each head's masked decay matrix
//    M = CB exp2(cum_i - cum_j) dt_j split into bf16 hi and lo in registers
//    (the A operands), times x_j. A warp skips the 16-column groups that lie
//    past its last row. 160 blocks at B=1 S=512, two per SM (128 registers,
//    110.6 KB of shared memory each).
// Rounding M or h to a single bf16 put y at up to 1.9x the 3e-2 check at
// dt ~ 0.7 (tests/test_torch_ssd_split.py has the twin); hi + lo keeps
// both within a bf16 ulp of y, for ~7% of the time. Why these sizes
// (measured on an H100, PERF.md): 8-warp output blocks at 128 registers
// beat 4-warp blocks at 168 (0.239 against 0.281 ms at B=8 S=512); a
// three-stage ring or 8 warps in the state pass ran slower. Positions past
// S read as zeros (dA = dt = 0 there), as the TPU kernel's zero padding
// does. The wrapper allocates the scratch (h_in, cum/dt); the kernels
// allocate nothing.
#include <stdint.h>

#include "common.cuh"

namespace repro_torch {
namespace {

using bf16 = __nv_bfloat16;

constexpr int kWarps = 4;  // state pass: one warp per 16 state rows
constexpr int kThreads = kWarps * 32;
constexpr int kStages = 2;  // state pass: tiles in the shared-memory ring
constexpr int kOutWarps = 8;  // output pass: one warp per 16 rows of a row tile
constexpr int kOutThreads = kOutWarps * 32;
constexpr int kOutMinBlocks = 2;  // output blocks per SM asked of ptxas
constexpr int kRows = kOutWarps * 16;  // rows of an output row tile
constexpr int kT = 64;    // positions per column tile of a chunk
constexpr int kP = 64;    // head dim the tiles hold (P <= kP, zero-filled past P)
constexpr int kN = 128;   // state dim the tiles hold
constexpr int kQ = 256;   // longest chunk
constexpr int kNh = 64;   // state columns per block of the state pass
constexpr int kHG = 2;    // heads per block of the output pass
constexpr int kPad = 8;   // bf16 of padding per shared-memory row
constexpr int kLdP = kP + kPad;
constexpr int kLdNh = kNh + kPad;
constexpr int kLdN = kN + kPad;

// state pass: a ring stage holds an x tile (j, p) and a B tile (j, n half)
constexpr int kStateStage = kT * kLdP + kT * kLdNh;
constexpr size_t kStateSmem = sizeof(bf16) * kStages * kStateStage + sizeof(float) * 2 * kQ;
// output pass: C_i, then a region that first holds h_in (hi, lo per head)
// and then the ring of B_j and x_j tiles, then cum and dt per head
constexpr int kHElems = kHG * 2 * kP * kLdN;
constexpr int kRingElems = 2 * (kT * kLdN + kHG * kT * kLdP);
constexpr int kRegion = kHElems > kRingElems ? kHElems : kRingElems;
constexpr size_t kOutSmem =
    sizeof(bf16) * (kRows * kLdN + kRegion) + sizeof(float) * 2 * kHG * kQ;

// rows [0, ROWS) of a (row, COLS) tile at src + row * stride into dst (row
// pitch ld), by THREADS threads; rows at or past `rows` and columns at or
// past `cols` are zero-filled (their source is `base`, never read)
template <int ROWS, int COLS, int THREADS>
__device__ __forceinline__ void load_tile(bf16* dst, int ld, const bf16* src, const bf16* base,
                                          size_t stride, int rows, int cols, int tid) {
  constexpr int kChunks = COLS / 8;  // 16-byte chunks per row
#pragma unroll 4
  for (int i = tid; i < ROWS * kChunks; i += THREADS) {
    const int r = i / kChunks, c = i - r * kChunks;
    const bool ok = r < rows && c * 8 < cols;
    cp_async16(dst + r * ld + c * 8, ok ? src + r * stride + c * 8 : base, ok ? 16 : 0);
  }
}

__device__ __forceinline__ uint32_t as_u32(__nv_bfloat162 v) {
  return *reinterpret_cast<const uint32_t*>(&v);
}

// (a, b) as a bf16x2 hi part and the bf16x2 of what it leaves (lo)
__device__ __forceinline__ void split_bf16(float a, float b, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  const float2 f = __bfloat1622float2(h);
  hi = as_u32(h);
  lo = pack_bf16(a - f.x, b - f.y);
}

__global__ void __launch_bounds__(kThreads)
ssd_state_bf16_kernel(const bf16* __restrict__ x, const float* __restrict__ dA,
                      const float* __restrict__ dt, const bf16* __restrict__ Bm,
                      bf16* __restrict__ h_in, float* __restrict__ h_out,
                      float* __restrict__ cdt, int S, int H, int P, int N, int Q, int nc) {
  constexpr int kPer = kQ / kThreads;  // chunk positions per thread in the scan
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* ring = reinterpret_cast<bf16*>(smem_raw);
  float* cum = reinterpret_cast<float*>(ring + kStages * kStateStage);  // [kQ]
  float* ws = cum + kQ;  // exp(cum_last - cum_j) dt_j, [kQ]
  __shared__ float warp_tot[kWarps];

  const int nh = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int n0 = nh * kNh;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int mi = lane >> 3, mr = lane & 7;  // ldmatrix: matrix and row this lane addresses
  const int p0 = warp * 16;                 // the warp's 16 state rows
  const int nt = (Q + kT - 1) / kT;
  const int total = nc * nt;
  const size_t xstride = static_cast<size_t>(H) * P;
  const bf16* xb = x + static_cast<size_t>(b) * S * xstride + static_cast<size_t>(h) * P;
  const bf16* bb = Bm + static_cast<size_t>(b) * S * N + n0;
  const size_t cdt_row = (static_cast<size_t>(b) * H + h) * nc * Q;
  const size_t cdt_plane = static_cast<size_t>(gridDim.z) * H * nc * Q;

  auto load = [&](int k) {  // tile k = (chunk, tile) into its ring stage
    const int c = k / nt, jt = k - c * nt;
    const int s = c * Q + jt * kT;
    const int rows = min(Q - jt * kT, S - s);
    bf16* st = ring + (k % kStages) * kStateStage;
    load_tile<kT, kP, kThreads>(st, kLdP, xb + static_cast<size_t>(s) * xstride, x, xstride,
                                rows, P, tid);
    load_tile<kT, kNh, kThreads>(st + kT * kLdP, kLdNh, bb + static_cast<size_t>(s) * N, Bm, N,
                                 rows, N - n0, tid);
  };

  float acc[kNh / 8][4];
#pragma unroll
  for (int j = 0; j < kNh / 8; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;

#pragma unroll
  for (int st = 0; st < kStages - 1; ++st) {
    if (st < total) load(st);
    cp_async_commit();
  }
  for (int k = 0; k < total; ++k) {
    const int c = k / nt, jt = k - c * nt;
    if (jt == 0) {
      // cum over chunk c: kPer positions per thread, a block scan of their sums
      __syncthreads();  // the previous chunk's ws and warp_tot are consumed
      const int s0 = c * Q;
      float a[kPer], d[kPer], v = 0.f;
#pragma unroll
      for (int e = 0; e < kPer; ++e) {
        const int i = kPer * tid + e;
        a[e] = d[e] = 0.f;
        if (i < Q && s0 + i < S) {
          const size_t idx = (static_cast<size_t>(b) * S + s0 + i) * H + h;
          a[e] = dA[idx];
          d[e] = dt[idx];
        }
        v += a[e];
      }
      const float own = v;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const float u = __shfl_up_sync(0xffffffffu, v, o);
        if (lane >= o) v += u;
      }
      if (lane == 31) warp_tot[warp] = v;
      __syncthreads();
      float run = v - own;  // the sum before this thread's positions
      for (int w = 0; w < warp; ++w) run += warp_tot[w];
#pragma unroll
      for (int e = 0; e < kPer; ++e) {
        run += a[e];
        cum[kPer * tid + e] = run;
      }
      __syncthreads();
      const float last = cum[Q - 1];
#pragma unroll
      for (int e = 0; e < kPer; ++e) {
        const int i = kPer * tid + e;
        ws[i] = i < Q ? expf(last - cum[i]) * d[e] : 0.f;
        if (nh == 0 && i < Q) {  // cum (log2 units) and dt for the output pass
          cdt[cdt_row + s0 + i] = cum[i] * kLog2e;
          cdt[cdt_plane + cdt_row + s0 + i] = d[e];
        }
      }
      if (c > 0) {  // the state entering chunk c, as bf16 hi and lo parts
        bf16* hb = h_in + ((static_cast<size_t>(b) * (nc - 1) + c - 1) * H + h) * 2 * P * N;
#pragma unroll
        for (int j = 0; j < kNh / 8; ++j) {
          const int n = n0 + j * 8 + 2 * t;
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            const int p = p0 + g + 8 * r;
            if (p < P && n < N) {
              uint32_t hi, lo;
              split_bf16(acc[j][2 * r], acc[j][2 * r + 1], hi, lo);
              *reinterpret_cast<uint32_t*>(hb + p * N + n) = hi;
              *reinterpret_cast<uint32_t*>(hb + static_cast<size_t>(P) * N + p * N + n) = lo;
            }
          }
        }
      }
      const float decay = expf(last);
#pragma unroll
      for (int j = 0; j < kNh / 8; ++j) {
        acc[j][0] *= decay;
        acc[j][1] *= decay;
        acc[j][2] *= decay;
        acc[j][3] *= decay;
      }
    }
    cp_async_wait<kStages - 2>();  // tile k landed
    __syncthreads();  // ... for every thread; tile k - 1 and ws are settled
    if (k + kStages - 1 < total) load(k + kStages - 1);  // into tile k - 1's stage
    cp_async_commit();

    const bf16* xt = ring + (k % kStages) * kStateStage;
    const bf16* bt = xt + kT * kLdP;
    const float* w = ws + jt * kT;
#pragma unroll
    for (int kk = 0; kk < kT / 16; ++kk) {
      // A = (w x)^T: rows p, columns j, from the (j, p) x tile
      uint32_t xa[4];
      ldmatrix_x4_trans(xa, xt + (kk * 16 + mr + (mi >> 1) * 8) * kLdP + p0 + (mi & 1) * 8);
      const float2 wa = *reinterpret_cast<const float2*>(w + kk * 16 + 2 * t);
      const float2 wb = *reinterpret_cast<const float2*>(w + kk * 16 + 8 + 2 * t);
      uint32_t hi[4], lo[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float2 xf = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&xa[e]));
        const float2 we = e < 2 ? wa : wb;
        split_bf16(xf.x * we.x, xf.y * we.y, hi[e], lo[e]);
      }
#pragma unroll
      for (int nb = 0; nb < kNh / 16; ++nb) {
        uint32_t bv[4];
        ldmatrix_x4_trans(bv, bt + (kk * 16 + mr + (mi & 1) * 8) * kLdNh + nb * 16 + (mi >> 1) * 8);
        mma_bf16_16816(acc[2 * nb], hi, bv[0], bv[1]);
        mma_bf16_16816(acc[2 * nb + 1], hi, bv[2], bv[3]);
        mma_bf16_16816(acc[2 * nb], lo, bv[0], bv[1]);
        mma_bf16_16816(acc[2 * nb + 1], lo, bv[2], bv[3]);
      }
    }
  }
  cp_async_wait<0>();  // no copy outlives the block

  float* ho = h_out + (static_cast<size_t>(b) * H + h) * P * N;
#pragma unroll
  for (int j = 0; j < kNh / 8; ++j) {
    const int n = n0 + j * 8 + 2 * t;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int p = p0 + g + 8 * r;
      if (p < P && n < N)
        *reinterpret_cast<float2*>(ho + p * N + n) = make_float2(acc[j][2 * r], acc[j][2 * r + 1]);
    }
  }
}

__global__ void __launch_bounds__(kOutThreads, kOutMinBlocks)
ssd_out_bf16_kernel(const bf16* __restrict__ x, const bf16* __restrict__ Bm,
                    const bf16* __restrict__ Cm, const bf16* __restrict__ h_in,
                    const float* __restrict__ cdt, bf16* __restrict__ y, int S, int H, int P,
                    int N, int Q, int nc) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* cs = reinterpret_cast<bf16*>(smem_raw);  // C_i, (i, n)
  bf16* region = cs + kRows * kLdN;
  float* cl = reinterpret_cast<float*>(region + kRegion);  // cum (log2 units), [kHG][kQ]
  float* dts = cl + kHG * kQ;                               // dt, [kHG][kQ]
  // the region: h_in of head hh (hi, lo) at hs(hh, part); later the ring
  auto hs = [&](int hh, int part) { return region + (hh * 2 + part) * kP * kLdN; };
  auto bring = [&](int st) { return region + st * kT * kLdN; };
  auto xring = [&](int st, int hh) {
    return region + 2 * kT * kLdN + (st * kHG + hh) * kT * kLdP;
  };

  const int h0 = blockIdx.x * kHG;
  const int nhd = min(kHG, H - h0);
  const int it = gridDim.y - 1 - blockIdx.y;  // the longest row tiles first
  const int b = blockIdx.z / nc, c = blockIdx.z - b * nc;
  const int s0 = c * Q, i0 = it * kRows;
  const int rows_i = min(Q - i0, S - s0 - i0);
  if (rows_i <= 0) return;  // a tile past S in a short last chunk
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int mi = lane >> 3, mr = lane & 7;
  const int r0 = warp * 16;  // the warp's 16 rows of the tile
  const size_t xstride = static_cast<size_t>(H) * P;
  const size_t cdt_plane = static_cast<size_t>(gridDim.z / nc) * H * nc * Q;

  // cum and dt of the chunk up to the tile's last row, zero past Q
  const int jn = i0 + kRows;
  for (int e = tid; e < kHG * jn; e += kOutThreads) {
    const int hh = e / jn, j = e - hh * jn;
    float cv = 0.f, dv = 0.f;
    if (hh < nhd && j < Q) {
      const size_t row = (static_cast<size_t>(b) * H + h0 + hh) * nc * Q + s0 + j;
      cv = cdt[row];
      dv = cdt[cdt_plane + row];
    }
    cl[hh * kQ + j] = cv;
    dts[hh * kQ + j] = dv;
  }
  load_tile<kRows, kN, kOutThreads>(cs, kLdN, Cm + (static_cast<size_t>(b) * S + s0 + i0) * N,
                                    Cm, N, rows_i, N, tid);
  if (c > 0) {
    for (int hh = 0; hh < nhd; ++hh) {
      const bf16* hb =
          h_in + ((static_cast<size_t>(b) * (nc - 1) + c - 1) * H + h0 + hh) * 2 * P * N;
      for (int part = 0; part < 2; ++part)
        load_tile<kP, kN, kOutThreads>(hs(hh, part), kLdN, hb + static_cast<size_t>(part) * P * N,
                                       h_in, N, P, N, tid);
    }
  }
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  float acc[kHG][kP / 8][4];
#pragma unroll
  for (int hh = 0; hh < kHG; ++hh)
#pragma unroll
    for (int j = 0; j < kP / 8; ++j)
      acc[hh][j][0] = acc[hh][j][1] = acc[hh][j][2] = acc[hh][j][3] = 0.f;

  // inter-chunk term: exp(cum_i) C_i . h_in, with h_in as hi + lo
  if (c > 0) {
#pragma unroll
    for (int kk = 0; kk < kN / 16; ++kk) {
      uint32_t a[4];
      ldmatrix_x4(a, cs + (r0 + (lane & 15)) * kLdN + kk * 16 + (lane >> 4) * 8);
#pragma unroll
      for (int hh = 0; hh < kHG; ++hh) {
        if (hh >= nhd) continue;
#pragma unroll
        for (int part = 0; part < 2; ++part) {
          const bf16* hp = hs(hh, part);
#pragma unroll
          for (int q = 0; q < kP / 16; ++q) {
            uint32_t bh[4];
            ldmatrix_x4(bh, hp + (q * 16 + mr + (mi >> 1) * 8) * kLdN + kk * 16 + (mi & 1) * 8);
            mma_bf16_16816(acc[hh][2 * q], a, bh[0], bh[1]);
            mma_bf16_16816(acc[hh][2 * q + 1], a, bh[2], bh[3]);
          }
        }
      }
    }
#pragma unroll
    for (int hh = 0; hh < kHG; ++hh) {
      const float e0 = fast_exp2(cl[hh * kQ + i0 + r0 + g]);
      const float e1 = fast_exp2(cl[hh * kQ + i0 + r0 + g + 8]);
#pragma unroll
      for (int j = 0; j < kP / 8; ++j) {
        acc[hh][j][0] *= e0;
        acc[hh][j][1] *= e0;
        acc[hh][j][2] *= e1;
        acc[hh][j][3] *= e1;
      }
    }
    __syncthreads();  // h_in's region is free for the ring
  }

  // intra-chunk term over the column tiles j <= i
  auto load_j = [&](int jt) {
    const int s = s0 + jt * kT;
    const int rows = min(Q - jt * kT, S - s);  // > 0: the tile starts at or before a valid row
    load_tile<kT, kN, kOutThreads>(bring(jt & 1), kLdN, Bm + (static_cast<size_t>(b) * S + s) * N,
                                   Bm, N, rows, N, tid);
    const bf16* xs = x + (static_cast<size_t>(b) * S + s) * xstride + static_cast<size_t>(h0) * P;
    for (int hh = 0; hh < nhd; ++hh)
      load_tile<kT, kP, kOutThreads>(xring(jt & 1, hh), kLdP, xs + hh * P, x, xstride, rows, P,
                                     tid);
  };
  load_j(0);
  cp_async_commit();
  const int ia = i0 + r0 + g, ib = ia + 8;  // the thread's two rows, chunk positions
  const int jt_last = (i0 + rows_i - 1) / kT;  // the column tile of the last valid row
  for (int jt = 0; jt <= jt_last; ++jt) {
    cp_async_wait<0>();
    __syncthreads();
    if (jt < jt_last) load_j(jt + 1);
    cp_async_commit();
    const bf16* bs = bring(jt & 1);
    // 16-column groups of this tile the warp needs: none past its last row
    const int lim = i0 + r0 + 15 - jt * kT;
    const int ngrp = lim < 0 ? 0 : min(kT / 16, lim / 16 + 1);
    if (ngrp == 0) continue;  // the barriers above stay uniform

    // C_i . B_j^T for the warp's 16 rows, once for both heads
    float cb[kT / 8][4];
#pragma unroll
    for (int j = 0; j < kT / 8; ++j) cb[j][0] = cb[j][1] = cb[j][2] = cb[j][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < kN / 16; ++kk) {
      uint32_t a[4];
      ldmatrix_x4(a, cs + (r0 + (lane & 15)) * kLdN + kk * 16 + (lane >> 4) * 8);
#pragma unroll
      for (int q = 0; q < kT / 16; ++q) {
        if (q >= ngrp) continue;
        uint32_t bk[4];
        ldmatrix_x4(bk, bs + (q * 16 + mr + (mi >> 1) * 8) * kLdN + kk * 16 + (mi & 1) * 8);
        mma_bf16_16816(cb[2 * q], a, bk[0], bk[1]);
        mma_bf16_16816(cb[2 * q + 1], a, bk[2], bk[3]);
      }
    }

#pragma unroll
    for (int hh = 0; hh < kHG; ++hh) {
      if (hh >= nhd) continue;
      const float* clh = cl + hh * kQ;
      const float* dth = dts + hh * kQ;
      const float ca = clh[ia], cbv = clh[ib];
      const bf16* xs = xring(jt & 1, hh);
#pragma unroll
      for (int kk = 0; kk < kT / 16; ++kk) {
        if (kk >= ngrp) continue;
        // A = M over columns kk*16 .. +15, split into bf16 hi and lo
        uint32_t ah[4], al[4];
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int jb = 2 * kk + half;
          const int j = jt * kT + jb * 8 + 2 * t;  // chunk positions j, j + 1
          const float2 cj = *reinterpret_cast<const float2*>(clh + j);
          const float2 dj = *reinterpret_cast<const float2*>(dth + j);
          const float m00 = j <= ia ? cb[jb][0] * fast_exp2(ca - cj.x) * dj.x : 0.f;
          const float m01 = j + 1 <= ia ? cb[jb][1] * fast_exp2(ca - cj.y) * dj.y : 0.f;
          const float m10 = j <= ib ? cb[jb][2] * fast_exp2(cbv - cj.x) * dj.x : 0.f;
          const float m11 = j + 1 <= ib ? cb[jb][3] * fast_exp2(cbv - cj.y) * dj.y : 0.f;
          split_bf16(m00, m01, ah[2 * half], al[2 * half]);
          split_bf16(m10, m11, ah[2 * half + 1], al[2 * half + 1]);
        }
#pragma unroll
        for (int nd = 0; nd < kP / 16; ++nd) {
          uint32_t bv[4];
          ldmatrix_x4_trans(bv,
                            xs + (kk * 16 + mr + (mi & 1) * 8) * kLdP + nd * 16 + (mi >> 1) * 8);
          mma_bf16_16816(acc[hh][2 * nd], ah, bv[0], bv[1]);
          mma_bf16_16816(acc[hh][2 * nd + 1], ah, bv[2], bv[3]);
          mma_bf16_16816(acc[hh][2 * nd], al, bv[0], bv[1]);
          mma_bf16_16816(acc[hh][2 * nd + 1], al, bv[2], bv[3]);
        }
      }
    }
  }
  cp_async_wait<0>();  // no copy outlives the block

#pragma unroll
  for (int hh = 0; hh < kHG; ++hh) {
    if (hh >= nhd) continue;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int i = ia + 8 * r;
      if (i >= Q || s0 + i >= S) continue;
      bf16* yr = y + (static_cast<size_t>(b) * S + s0 + i) * xstride +
                 static_cast<size_t>(h0 + hh) * P;
#pragma unroll
      for (int j = 0; j < kP / 8; ++j) {
        const int p = j * 8 + 2 * t;
        if (p < P)
          *reinterpret_cast<uint32_t*>(yr + p) =
              pack_bf16(acc[hh][j][2 * r], acc[hh][j][2 * r + 1]);
      }
    }
  }
}

}  // namespace
}  // namespace repro_torch

// x (B,S,H,P), Bm/Cm (B,S,N) and y (B,S,H,P) contiguous bf16; dA, dt (B,S,H)
// and h_out (B,H,P,N) contiguous fp32. Scratch from the caller: h_in
// (B, nc - 1, H, 2, P, N) bf16 (may be empty when nc == 1) and cdt
// (2, B, H, nc * Q) fp32, nc = ceil(S / Q). Q = chunk length (<= 256,
// <= S); P a multiple of 16 up to 64, N a multiple of 16 up to 128.
// Two launches on the stream. Returns the CUDA error of the launches, or
// -1 for a shape the kernels do not take.
extern "C" int ssd_scan_fwd_bf16(const void* x, const void* dA, const void* dt, const void* Bm,
                                 const void* Cm, void* y, void* h_out, void* h_in, void* cdt,
                                 int B, int S, int H, int P, int N, int Q, void* stream) {
  using namespace repro_torch;
  if (B <= 0 || S <= 0 || H <= 0 || Q <= 0 || Q > kQ || Q > S || P <= 0 || P % 16 ||
      P > kP || N <= 0 || N % 16 || N > kN)
    return -1;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int nc = (S + Q - 1) / Q;
  cudaError_t err = allow_smem(ssd_state_bf16_kernel, kStateSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = allow_smem(ssd_out_bf16_kernel, kOutSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  ssd_state_bf16_kernel<<<dim3((N + kNh - 1) / kNh, H, B), kThreads, kStateSmem, st>>>(
      static_cast<const bf16*>(x), static_cast<const float*>(dA), static_cast<const float*>(dt),
      static_cast<const bf16*>(Bm), static_cast<bf16*>(h_in), static_cast<float*>(h_out),
      static_cast<float*>(cdt), S, H, P, N, Q, nc);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 out_grid((H + kHG - 1) / kHG, (Q + kRows - 1) / kRows, B * nc);
  ssd_out_bf16_kernel<<<out_grid, kOutThreads, kOutSmem, st>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(Bm), static_cast<const bf16*>(Cm),
      static_cast<const bf16*>(h_in), static_cast<const float*>(cdt), static_cast<bf16*>(y), S, H,
      P, N, Q, nc);
  return static_cast<int>(cudaGetLastError());
}
