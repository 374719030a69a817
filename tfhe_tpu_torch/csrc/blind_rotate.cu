// Baked block-Karatsuba blind rotation for Hopper (sm_90a).
//
// Replaces the TPU kernels tfhe_tpu/ops/pallas_cmux.py:
//   _blind_rotate_pipelined_kernel (entry blind_rotate_pallas_pipelined) and
//   _blind_rotate_megakernel (entry blind_rotate_pallas_karatsuba),
// which compute the same function from the bodies _rotate_decompose_body,
// _combo_body and _leaf_dots_core under the plan lowering _kernel_plan.
//
// What it computes, for each of the n steps s (acc int32[B, K, N], baked key
// int8[n, R*P*T, K*4*T], bara_t int32[n, B]):
//   1. rotate acc by X^bara (bara reduced with & (2N-1), so values from
//      [-N, N) work);
//   2. subtract acc, add the decomposition offset;
//   3. cut l signed b-bit digits into int8 blocks, lane order
//      (block i, poly j, level i_l, coeff u);
//   4. form the Karatsuba digit combos, one int8 limb or two (shifts 0, 7);
//   5. run the leaf dots against the step's key rows (int8 mma.sync, int32);
//   6. recombine the four key limbs (<< 8*limb);
//   7. fold with the z^M = -1 sign and add into acc.
// The plan arrives as tables (tfhe_tpu_torch/ops/blind_rotate.py:
// kernel_tables): combo writes for step 4, and per output block a list of
// terms sign * 2^shift * (digit segments . key segments) for steps 5-7.
// The kernels themselves are in cmux_kernels.cuh, shared with the compact
// and dense entry points. Raw digits of a base above 2^8 do not fit a byte:
// they are held as int16 in shared memory, and every leaf then reads
// two-limb combos (the plan gives each leaf shifts (0, 7) at such a base).
//
// Where the accumulator lives. The TPU kernels keep a batch tile's
// accumulator resident in VMEM for all n steps. An SM has 228 KB of shared
// memory, and every step's dots need the whole key slice (9.8 MB at
// 128_fast) against the whole batch, so a resident-accumulator kernel would
// either stream the full 6.2 GB key once per small batch tile or need a grid
// barrier per step. This kernel keeps the accumulator in device memory
// (21 MB at B=4096, 128_fast) and runs each step as two launches on one
// stream: rotate+decompose+combos (one block per ciphertext), then the dots
// over (output column tile x output block x batch tile), which add into acc
// in place. The accumulator, the digit operand and the step's key slice
// together fit the 50 MB L2, so the step's key slice is read from device
// memory about once and served to all batch tiles from L2.
//
// What bounds it on the H100: int8 tensor-core work. At 128_fast one gate
// needs ~8.3 G int8 MACs; this first kernel recomputes a dot for each output
// block it feeds (6 dot units per step instead of 4 at 128_fast) and uses
// mma.sync m16n8k32 from shared memory without cp.async pipelining, far
// below wgmma's rate. Moving to wgmma with TMA, and computing each dot once,
// is later work.

#include "cmux_kernels.cuh"

extern "C" {

// The whole rotation: 2 launches per step on `stream`, acc updated in place.
// Returns the first CUDA error (0 = none); does not synchronise.
int tfhe_blind_rotate(int32_t* acc, const int8_t* key, const int32_t* bara_t,
                      int8_t* lhs, const int32_t* combos, int n_combos,
                      const int32_t* terms, const int32_t* term_start,
                      int batch, int k1, int n, int l, int b, int m,
                      int n_steps, int lhs_rows, int total_rows, int offset,
                      void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Params p = make_params(batch, k1, n, l, b, m, lhs_rows, offset);
  const size_t key_step = (size_t)total_rows * p.pt * p.cols;  // > 2^31
  cudaError_t err = allow_digit_smem(p);
  if (err != cudaSuccess) return (int)err;
  for (int s = 0; s < n_steps; ++s) {
    err = launch_step(acc, key + (size_t)s * key_step,
                      bara_t + (size_t)s * batch, lhs, combos, n_combos,
                      terms, term_start, p, st);
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}

const char* tfhe_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
