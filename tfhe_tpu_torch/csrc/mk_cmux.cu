// The multi-key blind rotation for Hopper (sm_90a): the sparse-block CMUX
// step, a chunk of steps, and a party's whole loop from the compact key.
//
// Replaces the TPU kernels of tfhe_tpu/ops/pallas_cmux.py:
//   _sparse_mk_kernel      (entry cmux_step_pallas_sparse),
//   _sparse_mk_megakernel  (entry mk_blind_rotate_pallas_chunk),
//   _mk_compact_megakernel (entry mk_blind_rotate_pallas_compact),
// with their bodies _rotate_decompose_body, _combo_body and _unit_dots_body
// under the plan lowering _sparse_plan.
//
// What a step computes (acc int32[B, K, N] with K the active components of
// the triangular rotation; e_step int8[R*NZ*l*T, 4*T], the sparse expansion
// of the step's NZ nonzero (block row j, output column k) blocks; bara
// int32[B]):
//   1. rotate acc by X^bara, subtract acc, add the decomposition offset, cut
//      l signed digits per word, form the Karatsuba digit combos: the
//      single-key rotate_decompose_kernel with K polynomials, digit row of
//      lhs_rows segments of P*T bytes, P = K*l;
//   2. the unit dots (mk_unit_dots_kernel): for every (leaf, nonzero block)
//      the leaf's linear convolution of the block's own j-slice (l*T bytes
//      of each digit segment) with the block's entry tiles [l*T, 4*T], digit
//      limb shift, << 8*limb recombination, z^M = -1 fold, added into acc
//      column k only.
// The plan arrives as tables (tfhe_tpu_torch/ops/mk_cmux.py:mk_kernel_tables):
// the single-key combo writes, and per (column k, output block) the terms of
// mk_unit_dots_kernel. Single-limb digit sums, which the TPU bodies add
// inline because Mosaic has no int8 vector add, are combo segments here.
//
// Where things live. The TPU kernels keep a batch tile's accumulator, or the
// whole group's, in VMEM across a chunk or a party's loop. At B = 4096 with
// K = 3 the accumulator is 50 MB, the digit rows 141 MB and one step's
// operand 41 MB (236 MB at 8 parties): nothing of that fits an SM, and not
// even the 50 MB L2 holds it, so, as in blind_rotate.cu, the accumulator
// stays in device memory and every step is launches on one stream. A chunk
// and a party's loop are one C call each that enqueues its steps. The
// rotation is not split into batch groups: every group would have to expand
// each step again, while the traffic it would save is small beside the dots
// at this kernel's rate (worst case every 64-row batch tile streams the whole
// 41 MB operand from device memory: 2.6 GB, under 1 ms of a step that takes
// several). The compact loop writes each step's operand into one scratch
// buffer, so device memory holds the compact key and that scratch only.
//
// What bounds it: the int8 dots, 9 leaves x NZ blocks x 4 products of
// [B, l*T] x [l*T, 4*T] per step at N = 1024, depth 2. This kernel computes
// a product once for every output block it feeds (leaf contributions fold to
// up to 4 blocks) and uses mma.sync from shared memory; computing each
// product once, wgmma and TMA are later work.

#include "cmux_kernels.cuh"

extern "C" {

// One step. acc is updated in place; 2 launches on `stream`.
int tfhe_mk_cmux_step(int32_t* acc, const int8_t* e_step,
                      const int32_t* bara, int8_t* lhs, const int32_t* combos,
                      int n_combos, const int32_t* terms,
                      const int32_t* term_start, int batch, int k1, int n,
                      int l, int b, int m, int lhs_rows, int nzn, int offset,
                      void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Params p = make_params(batch, k1, n, l, b, m, lhs_rows, offset);
  cudaError_t err = allow_digit_smem(p);
  if (err != cudaSuccess) return (int)err;
  return (int)launch_mk_step(acc, e_step, bara, lhs, combos, n_combos, terms,
                             term_start, p, nzn, st);
}

// A chunk of n_steps steps against e_chunk int8[n_steps, R*NZ*l*T, 4*T]
// and bara_t int32[n_steps, B]: 2 launches per step on `stream`.
int tfhe_mk_blind_rotate_chunk(int32_t* acc, const int8_t* e_chunk,
                               const int32_t* bara_t, int8_t* lhs,
                               const int32_t* combos, int n_combos,
                               const int32_t* terms,
                               const int32_t* term_start, int batch, int k1,
                               int n, int l, int b, int m, int n_steps,
                               int lhs_rows, int total_rows, int nzn,
                               int offset, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Params p = make_params(batch, k1, n, l, b, m, lhs_rows, offset);
  cudaError_t err = allow_digit_smem(p);
  if (err != cudaSuccess) return (int)err;
  const size_t e_step = (size_t)total_rows * nzn * l * kT * 4 * kT;
  for (int s = 0; s < n_steps; ++s) {
    err = launch_mk_step(acc, e_chunk + (size_t)s * e_step,
                         bara_t + (size_t)s * batch, lhs, combos, n_combos,
                         terms, term_start, p, nzn, st);
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}

// A party's n_steps steps from its nz-selected compact limbs
// int8[n_steps, 4, NZ, l, 2N]: per step the expansion into `scratch`
// (R*NZ*l*T * 4*T bytes, rewritten every step), then the step's 2 launches.
int tfhe_mk_blind_rotate_compact(int32_t* acc, const int8_t* limbs,
                                 const int32_t* bara_t, int8_t* lhs,
                                 int8_t* scratch, const int32_t* entry_masks,
                                 const int32_t* combos, int n_combos,
                                 const int32_t* terms,
                                 const int32_t* term_start, int batch, int k1,
                                 int n, int l, int b, int m, int n_steps,
                                 int lhs_rows, int total_rows, int nzn,
                                 int offset, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Params p = make_params(batch, k1, n, l, b, m, lhs_rows, offset);
  cudaError_t err = allow_digit_smem(p);
  if (err != cudaSuccess) return (int)err;
  const size_t limbs_step = (size_t)4 * nzn * l * 2 * n;  // x 4000 steps > 2^31
  for (int s = 0; s < n_steps; ++s) {
    err = launch_expand(limbs + (size_t)s * limbs_step, entry_masks, scratch,
                        total_rows, nzn * l, 1, n, st);
    if (err != cudaSuccess) return (int)err;
    err = launch_mk_step(acc, scratch, bara_t + (size_t)s * batch, lhs,
                         combos, n_combos, terms, term_start, p, nzn, st);
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}

}  // extern "C"
