// Blind rotation from the compact (prepared-limb) key for Hopper (sm_90a).
//
// Replaces the TPU kernel tfhe_tpu/ops/pallas_cmux.py:_compact_megakernel
// (entry blind_rotate_pallas_compact), with its bodies _expand_entries_body
// and _leaf_dots_resident.
//
// What it computes. The key is int8[n, 4, P, K, 2N]: per step the four
// balanced bytes of the doubled words [t, -t] of every key polynomial. For
// each of the n steps:
//   1. expand_kernel (cmux_kernels.cuh): rebuild the int32 doubled words
//      from their 4 bytes;
//      for each row r of the bake (per leaf, entries reversed) sum the
//      2T-word windows of the row's blocks, window d starting at d*T - T
//      (mod 2N, so block 0 wraps below zero), in uint32 with wraparound;
//      split the sums into balanced bytes; write the Toeplitz block
//      W[u, w] = C[T + w - u] of every (r, p, k) into the scratch operand
//      int8[R*P*T, K*4*T], rows (r, p, u), columns (k, limb, w): the bytes
//      bake_karatsuba would have stored for this step;
//   2. the rotate/decompose/combos launch and the dots launch of
//      cmux_kernels.cuh, reading that scratch as the step's key rows.
//
// Where the expanded operand lives. The TPU kernel keeps it in VMEM next
// to a resident accumulator. An SM has 228 KB of shared memory and the
// operand is 9.8 MB (128_fast) to 28 MB (N = 1024, depth 2), needed by
// every batch tile, so it goes to one scratch buffer in device memory that
// every step rewrites. The buffer is smaller than the 50 MB L2, the dots
// launch that follows reads it at once, and device memory holds only the
// compact key (T/2 times smaller than the bake) plus this scratch: the
// property the TPU kernel exists for. The three launches of a step run in
// stream order, so the expansion of step s+1 waits for the dots of step s;
// a second scratch buffer to overlap them is later work.
//
// What bounds it: as blind_rotate.cu, the int8 dots; the expansion adds a
// write of R*P*T * K*4*T bytes per step that does not depend on the batch.

#include "cmux_kernels.cuh"

extern "C" {

// One step's compact limbs int8[4, P, K, 2N] -> int8[R*P*T, K*4*T].
int tfhe_expand_step(const int8_t* limbs_step, const int32_t* entry_masks,
                     int8_t* out, int total_rows, int p_rows, int k1, int n,
                     void* stream) {
  return (int)launch_expand(limbs_step, entry_masks, out, total_rows, p_rows,
                            k1, n, static_cast<cudaStream_t>(stream));
}

// The whole rotation from the compact key: 3 launches per step on `stream`,
// acc updated in place, `scratch` (R*P*T * K*4*T bytes) rewritten per step.
int tfhe_blind_rotate_compact(int32_t* acc, const int8_t* limbs,
                              const int32_t* bara_t, int8_t* lhs,
                              int8_t* scratch, const int32_t* entry_masks,
                              const int32_t* combos, int n_combos,
                              const int32_t* terms,
                              const int32_t* term_start, int batch, int k1,
                              int n, int l, int b, int m, int n_steps,
                              int lhs_rows, int total_rows, int offset,
                              void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Params p = make_params(batch, k1, n, l, b, m, lhs_rows, offset);
  cudaError_t err = allow_digit_smem(p);
  if (err != cudaSuccess) return (int)err;
  const int p_rows = k1 * l;
  const size_t limbs_step = (size_t)4 * p_rows * k1 * 2 * n;
  for (int s = 0; s < n_steps; ++s) {
    err = launch_expand(limbs + (size_t)s * limbs_step, entry_masks, scratch,
                        total_rows, p_rows, k1, n, st);
    if (err != cudaSuccess) return (int)err;
    err = launch_step(acc, scratch, bara_t + (size_t)s * batch, lhs, combos,
                      n_combos, terms, term_start, p, st);
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}

}  // extern "C"
