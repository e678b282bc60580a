// The whole-cache entry of the decode attention kernel (decode_attention.cuh
// says what it replaces, what bounds it and how it is designed).
#include "decode_attention.cuh"

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
  return dispatch_dtype<false>(dtype, H / Hkv, Dv, q, k, v, o, q_offset, kv_len, nullptr, part,
                               counters, B, Smax, 0, Hkv, Dk, window, n_splits, split_len,
                               softcap, scale, static_cast<cudaStream_t>(stream));
}
