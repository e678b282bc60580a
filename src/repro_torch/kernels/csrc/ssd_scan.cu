// Mamba2 SSD chunked scan for Hopper (sm_90a), fp32 on the CUDA cores: the
// exact route, for the fp32 parity checks. The bf16 route, which the
// serving path runs, is ssd_scan_bf16.cu (tensor cores).
//
// Replaces the Pallas TPU kernel src/repro/kernels/ssd_scan.py (ssd_scan,
// body _ssd_kernel). For each (batch row b, head h) and each chunk of Q
// positions, with cum the running sum of dA over the chunk:
//   y_i  = sum_{j<=i} exp(cum_i - cum_j) (C_i . B_j) dt_j x_j   (intra-chunk)
//        + exp(cum_i) C_i . h                                 (inter-chunk)
//   h   <- exp(cum_last) h + sum_j exp(cum_last - cum_j) dt_j x_j (x) B_j
// x (B,S,H,P), y, dA and dt (B,S,H), B/C (B,S,N) shared by all heads
// (ngroups = 1) and the final state (B,H,P,N), all fp32.
//
// Bound on an H100: operations in fp32. mamba2-2.7b at B=8 S=512
// (H 80, P 64, N 128, chunk 256) moves its inputs and outputs once in
// 0.058 ms in fp32 at 3.35 TB/s, against 0.243 ms for its 16.3 GFLOP of
// unique work at the 67 TFLOP/s fp32 peak: in fp32, operations bound it.
// This design recomputes C.B^T per head (43% of its work) and runs far
// from either bound; it is kept for exactness, not speed.
//
// Design: one thread block per (b, h); the TPU's sequential chunk grid axis
// becomes a loop inside the block, and the running P x N fp32 state (32 KB
// at P 64, N 128) stays in shared memory across chunks. The TPU block stages
// the whole chunk (B and C at Q x N, the Q x Q decay matrix); that does not
// fit in the 227 KB a block may use, so the chunk is cut into 64-row tiles:
// for each row tile i the block stages C_i, starts the accumulator with the
// inter-chunk term, then walks the column tiles j <= i, staging B_j and x_j,
// forming the masked decay tile M_ij = (C_i B_j^T) * exp(cum_i - cum_j) * dt_j
// in shared memory and accumulating M_ij x_j. cum comes from a block scan
// in fp64: at dt ~0.7 and A = -16 it reaches -2900 over a chunk, where an
// fp32 ulp (2.4e-4) in cum_i - cum_j would put an error of that size on
// each decay factor, and so ~1e-3 on y, the whole of its tolerance.
// 256 threads as a 16 x 16 grid each own a 4 x 4 (rows strided by 16)
// micro-tile, so every shared-memory read is a broadcast or conflict-free
// (rows padded to N + 1 and 64 + 1 floats). Positions past S (a tail
// chunk) read as zeros: dA = dt = 0 there, so they neither decay nor write
// the state, as the TPU kernel's zero padding does.
#include <stdint.h>

#include "common.cuh"

namespace repro_torch {
namespace {

constexpr int kTile = 64;  // rows (i) and columns (j) of a chunk tile
constexpr int kMaxP = 64;
constexpr int kMaxN = 128;
constexpr int kMaxQ = 256;
constexpr int kThreads = 256;  // a 16 x 16 grid
constexpr int kLdN = kMaxN + 1;
constexpr int kLdT = kTile + 1;

size_t ssd_smem_bytes() {
  return sizeof(float) * (static_cast<size_t>(kMaxP) * kLdN  // state h (p, n)
                          + 2 * kTile * kLdN                 // C rows, B rows
                          + 2 * kTile * kLdT                 // x rows (j, p), M tile (i, j)
                          + 2 * kMaxQ);                      // dt, state weights
}

// dst[r * ld + k] = src[base + (s0 + r) * stride + k] for the tile's rows
// r < kTile and k < cols; rows past `rows` or past S read as zero.
__device__ void load_rows(float* dst, int ld, const float* __restrict__ src, size_t base,
                          size_t stride, int s0, int S, int rows, int cols) {
  for (int i = threadIdx.x; i < kTile * cols; i += kThreads) {
    const int r = i / cols, k = i - r * cols;
    const int s = s0 + r;
    dst[r * ld + k] = (r < rows && s < S) ? src[base + s * stride + k] : 0.f;
  }
}

__global__ void __launch_bounds__(kThreads)
ssd_scan_fp32_kernel(const float* __restrict__ x, const float* __restrict__ dA,
                     const float* __restrict__ dt, const float* __restrict__ Bm,
                     const float* __restrict__ Cm, float* __restrict__ y,
                     float* __restrict__ h_out, int S, int H, int P, int N, int Q) {
  extern __shared__ float smem[];
  float* hs = smem;                // state, kMaxP x kLdN
  float* cs = hs + kMaxP * kLdN;   // C rows of the row tile
  float* bs = cs + kTile * kLdN;   // B rows of the column tile
  float* xs = bs + kTile * kLdN;   // x rows of the column tile, (j, p)
  float* ms = xs + kTile * kLdT;   // masked decay tile, (i, j)
  float* dts = ms + kTile * kLdT;  // dt over the chunk
  float* ws = dts + kMaxQ;         // exp(cum_last - cum_j) dt_j
  __shared__ double cum[kMaxQ];    // inclusive sum of dA over the chunk
  __shared__ double warp_tot[kThreads / 32];

  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;
  const int lane = tid & 31, warp = tid >> 5;
  const int nc = (S + Q - 1) / Q;
  const int nt = (Q + kTile - 1) / kTile;
  const size_t bc_base = static_cast<size_t>(b) * S * N;                 // B, C rows
  const size_t x_base = (static_cast<size_t>(b) * S * H + h) * P;        // x, y rows
  const size_t x_stride = static_cast<size_t>(H) * P;

  for (int i = tid; i < kMaxP * kLdN; i += kThreads) hs[i] = 0.f;

  for (int c = 0; c < nc; ++c) {
    const int s0 = c * Q;
    __syncthreads();  // the previous chunk's state update and scan are done
    // cum: inclusive scan of dA over the chunk, one position per thread
    double a = 0.0;
    if (tid < Q) {
      const int s = s0 + tid;
      const size_t k = (static_cast<size_t>(b) * S + s) * H + h;
      a = s < S ? dA[k] : 0.f;
      dts[tid] = s < S ? dt[k] : 0.f;
    }
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const double v = __shfl_up_sync(0xffffffffu, a, o);
      if (lane >= o) a += v;
    }
    if (lane == 31) warp_tot[warp] = a;
    __syncthreads();
    for (int w = 0; w < warp; ++w) a += warp_tot[w];
    if (tid < Q) cum[tid] = a;
    __syncthreads();
    const double cum_last = cum[Q - 1];
    if (tid < Q) ws[tid] = expf(static_cast<float>(cum_last - cum[tid])) * dts[tid];

    for (int it = 0; it < nt; ++it) {
      const int i0 = it * kTile;
      load_rows(cs, kLdN, Cm, bc_base, N, s0 + i0, S, Q - i0, N);
      __syncthreads();
      // inter-chunk term: acc[i][p] = exp(cum_i) C_i . h_p
      float acc[4][4];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[r][q] = 0.f;
      for (int n = 0; n < N; ++n) {
        float cv[4], hv[4];
#pragma unroll
        for (int r = 0; r < 4; ++r) cv[r] = cs[(ty + 16 * r) * kLdN + n];
#pragma unroll
        for (int q = 0; q < 4; ++q) hv[q] = hs[(tx + 16 * q) * kLdN + n];
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int q = 0; q < 4; ++q) acc[r][q] = fmaf(cv[r], hv[q], acc[r][q]);
      }
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int i = i0 + ty + 16 * r;
        const float e = i < Q ? expf(static_cast<float>(cum[i])) : 0.f;
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[r][q] *= e;
      }

      // intra-chunk term over the column tiles j <= i
      for (int jt = 0; jt <= it; ++jt) {
        const int j0 = jt * kTile;
        __syncthreads();  // the previous tiles' readers are done
        load_rows(bs, kLdN, Bm, bc_base, N, s0 + j0, S, Q - j0, N);
        load_rows(xs, kLdT, x, x_base, x_stride, s0 + j0, S, Q - j0, P);
        __syncthreads();
        float m[4][4];
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int q = 0; q < 4; ++q) m[r][q] = 0.f;
        for (int n = 0; n < N; ++n) {
          float cv[4], bv[4];
#pragma unroll
          for (int r = 0; r < 4; ++r) cv[r] = cs[(ty + 16 * r) * kLdN + n];
#pragma unroll
          for (int q = 0; q < 4; ++q) bv[q] = bs[(tx + 16 * q) * kLdN + n];
#pragma unroll
          for (int r = 0; r < 4; ++r)
#pragma unroll
            for (int q = 0; q < 4; ++q) m[r][q] = fmaf(cv[r], bv[q], m[r][q]);
        }
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int i = i0 + ty + 16 * r;
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const int j = j0 + tx + 16 * q;
            // j <= i < Q: the causal lower triangle; exp never sees cum_i > cum_j
            ms[(ty + 16 * r) * kLdT + tx + 16 * q] =
                (j <= i && i < Q) ? m[r][q] * expf(static_cast<float>(cum[i] - cum[j])) * dts[j]
                              : 0.f;
          }
        }
        __syncthreads();
        for (int jj = 0; jj < kTile; ++jj) {
          float mv[4], xv[4];
#pragma unroll
          for (int r = 0; r < 4; ++r) mv[r] = ms[(ty + 16 * r) * kLdT + jj];
#pragma unroll
          for (int q = 0; q < 4; ++q) xv[q] = xs[jj * kLdT + tx + 16 * q];
#pragma unroll
          for (int r = 0; r < 4; ++r)
#pragma unroll
            for (int q = 0; q < 4; ++q) acc[r][q] = fmaf(mv[r], xv[q], acc[r][q]);
        }
      }
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int i = i0 + ty + 16 * r;
        const int s = s0 + i;
        if (i >= Q || s >= S) continue;
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int p = tx + 16 * q;
          if (p < P) y[x_base + s * x_stride + p] = acc[r][q];
        }
      }
      __syncthreads();  // cs, bs, xs, ms are free again
    }

    // state update: thread owns h[p][n] for p = ty + 16 r, n = tx + 16 q
    float u[4][8];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int q = 0; q < 8; ++q) u[r][q] = 0.f;
    for (int jt = 0; jt < nt; ++jt) {
      const int j0 = jt * kTile;
      __syncthreads();
      load_rows(bs, kLdN, Bm, bc_base, N, s0 + j0, S, Q - j0, N);
      load_rows(xs, kLdT, x, x_base, x_stride, s0 + j0, S, Q - j0, P);
      __syncthreads();
      const int jn = min(kTile, Q - j0);
      for (int jj = 0; jj < jn; ++jj) {
        const float w = ws[j0 + jj];
        float xv[4], bv[8];
#pragma unroll
        for (int r = 0; r < 4; ++r) xv[r] = xs[jj * kLdT + ty + 16 * r] * w;
#pragma unroll
        for (int q = 0; q < 8; ++q) bv[q] = bs[jj * kLdN + tx + 16 * q];
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int q = 0; q < 8; ++q) u[r][q] = fmaf(xv[r], bv[q], u[r][q]);
      }
    }
    const float decay = expf(static_cast<float>(cum_last));
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int p = ty + 16 * r;
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        const int n = tx + 16 * q;
        if (p < P && n < N) hs[p * kLdN + n] = decay * hs[p * kLdN + n] + u[r][q];
      }
    }
  }

  __syncthreads();
  float* hb = h_out + (static_cast<size_t>(b) * H + h) * P * N;
  for (int i = tid; i < P * N; i += kThreads) {
    const int p = i / N, n = i - p * N;
    hb[i] = hs[p * kLdN + n];
  }
}

int launch(const void* x, const void* dA, const void* dt, const void* Bm, const void* Cm,
           void* y, void* h_out, int B, int S, int H, int P, int N, int Q,
           cudaStream_t stream) {
  const size_t smem = ssd_smem_bytes();
  const cudaError_t attr = allow_smem(ssd_scan_fp32_kernel, smem);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const dim3 grid(H, B);
  ssd_scan_fp32_kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(x), static_cast<const float*>(dA), static_cast<const float*>(dt),
      static_cast<const float*>(Bm), static_cast<const float*>(Cm), static_cast<float*>(y),
      static_cast<float*>(h_out), S, H, P, N, Q);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
}  // namespace repro_torch

// x (B,S,H,P), Bm/Cm (B,S,N), y (B,S,H,P), dA, dt (B,S,H) and h_out
// (B,H,P,N), all contiguous fp32. Q = chunk length (<= 256, <= S);
// P <= 64, N <= 128. Returns the CUDA error of the launch, or -1 for a
// shape the kernel does not take.
extern "C" int ssd_scan_fwd_fp32(const void* x, const void* dA, const void* dt, const void* Bm,
                                 const void* Cm, void* y, void* h_out, int B, int S, int H, int P,
                                 int N, int Q, void* stream) {
  using namespace repro_torch;
  if (B <= 0 || S <= 0 || Q <= 0 || Q > kMaxQ || P <= 0 || P > kMaxP || N <= 0 || N > kMaxN)
    return -1;
  return launch(x, dA, dt, Bm, Cm, y, h_out, B, S, H, P, N, Q, static_cast<cudaStream_t>(stream));
}
