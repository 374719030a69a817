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
//   5. run the leaf dots against the step's key rows (int8 wgmma, int32);
//   6. recombine the four key limbs (<< 8*limb);
//   7. fold with the z^M = -1 sign and add into acc.
// The plan arrives as tables (tfhe_tpu_torch/ops/blind_rotate.py:
// kernel_tables for the combo writes of step 4, product_tables for steps
// 5-7: every distinct product sign * 2^shift * (digit segments . key
// segments) once, with the output blocks it feeds). The kernels themselves
// are in cmux_kernels.cuh and dots_sm90.cuh, shared with the compact and
// dense entry points. Raw digits of a base above 2^8 do not fit a byte:
// they stay in registers, and every leaf then reads two-limb combos (the
// plan gives each leaf shifts (0, 7) at such a base).
//
// The key arrives K-major (ops/dots.py:to_kmajor), int8[n, K, 4, T, R*P*T]:
// relaid once when it reaches the card, so the dots kernel's TMA loads put
// it in shared memory as wgmma reads it.
//
// Where the accumulator lives. The TPU kernels keep a batch tile's
// accumulator resident in VMEM for all n steps. An SM has 228 KB of shared
// memory, and every step's dots need the whole key slice (9.8 MB at
// 128_fast) against the whole batch, so a resident-accumulator kernel would
// either stream the full 6.2 GB key once per small batch tile or need a grid
// barrier per step. This kernel keeps the accumulator in device memory
// (21 MB at B=4096, 128_fast) and runs each step as two launches on one
// stream: rotate+decompose+combos (one block per ciphertext row), then the
// dots over (work item x batch tile), which add into acc in place. The
// accumulator, the digit operand and the step's key slice together fit the
// 50 MB L2, so the step's key slice is read from device memory about once
// and served to all batch tiles from L2.
//
// What bounds it on the H100: int8 tensor-core work, each product once (see
// dots_sm90.cuh).

#include "cmux_kernels.cuh"

extern "C" {

// The first launch of a step alone: acc int32[B, K, N], bara int32[B] ->
// the digit operand lhs int8[B, lhs_rows*P*T] (for b > 8 its raw segments
// [0, M) are left unwritten).
int tfhe_rotate_decompose_rows(const int32_t* acc, const int32_t* bara,
                               int8_t* lhs, const StepSizes* sizes,
                               void* stream) {
  Params p;
  cudaError_t err = make_params(p, *sizes);
  if (err != cudaSuccess) return (int)err;
  return (int)launch_rotate_decompose(acc, bara, lhs, p,
                                      static_cast<cudaStream_t>(stream));
}

// The whole rotation: 2 launches per step on `stream`, acc updated in place.
// Returns the first CUDA error (0 = none); does not synchronise.
int tfhe_blind_rotate(int32_t* acc, const int8_t* key, const int32_t* bara_t,
                      int8_t* lhs, const StepSizes* sizes,
                      const DotsArgs* tables, int n_steps, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  Params p;
  cudaError_t err = make_params(p, *sizes);
  if (err != cudaSuccess) return (int)err;
  DotsLaunch dots;
  err = make_dots(dots, *tables, p, lhs, key, sizes->total_rows * p.pt, p.k1,
                  n_steps);
  if (err != cudaSuccess) return (int)err;
  err = allow_dots_smem(dots);
  if (err != cudaSuccess) return (int)err;
  for (int s = 0; s < n_steps; ++s) {
    err = launch_step(acc, dots, s, false, bara_t + (size_t)s * p.batch, lhs,
                      p, st);
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}

const char* tfhe_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
