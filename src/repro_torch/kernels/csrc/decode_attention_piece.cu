// The piece-mode entry of the decode attention kernel (decode_attention.cuh):
// one rank's piece of a KV cache cut on its sequence, fp32 output and
// log-sum-exp for the merge across the ranks.
#include "decode_attention.cuh"

// Piece mode: k, v hold the Smax keys at global positions [k_start,
// k_start + Smax) of each row; q_offset, kv_len global. o (B,1,H,Dv) and
// lse (B,1,H) fp32. The rest as decode_attention_fwd.
extern "C" int decode_attention_piece_fwd(const void* q, const void* k, const void* v, void* o,
                                          const void* q_offset, const void* kv_len, void* lse,
                                          void* part, void* counters, int B, int Smax,
                                          int k_start, int H, int Hkv, int Dk, int Dv,
                                          int window, int n_splits, int split_len,
                                          float softcap, float scale, int dtype, void* stream) {
  using namespace repro_torch;
  return dispatch_dtype<true>(dtype, H / Hkv, Dv, q, k, v, o, q_offset, kv_len, lse, part,
                              counters, B, Smax, k_start, Hkv, Dk, window, n_splits, split_len,
                              softcap, scale, static_cast<cudaStream_t>(stream));
}
