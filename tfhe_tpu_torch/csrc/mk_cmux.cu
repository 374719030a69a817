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
// The plan arrives as tables (tfhe_tpu_torch/ops/mk_cmux.py): the
// single-key combo writes, and mk_product_tables' products, each of nseg
// pieces (digit segment stride P*T, operand stride NZ*l*T) with the output
// blocks of column k it feeds, computed once. Single-limb digit sums, which
// the TPU bodies add inline because Mosaic has no int8 vector add, are
// combo segments here. The operand is read K-major, int8[4, T, R*NZ*l*T]:
// the compact loop's expansion writes its scratch so, and the expansion
// the step and chunk entries are handed (ops/mk_cmux.py:expand_sparse on the
// card) is written so too.
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
// [B, l*T] x [l*T, 4*T] per step at N = 1024, depth 2, each computed once
// (see dots_sm90.cuh).

#include "cmux_kernels.cuh"

namespace {

// The unit dots of every step of one call: the digit rows `lhs`, an
// operand int8[n_steps, 4, T, R*NZ*l*T] (K = 1), pieces strided by P*T in
// the digits and NZ*l*T in the operand.
cudaError_t make_mk_dots(DotsLaunch& dots, const DotsArgs& tables,
                         const Params& p, const int8_t* lhs,
                         const int8_t* operand, int n_steps, int total_rows,
                         int nzn) {
  const int lt = p.l * kT;
  cudaError_t err = make_dots(dots, tables, p, lhs, operand,
                              total_rows * nzn * lt, 1, n_steps, p.pt,
                              nzn * lt);
  if (err != cudaSuccess) return err;
  return allow_dots_smem(dots);
}

}  // namespace

extern "C" {

// One step against e_step int8[4, T, R*NZ*l*T]. acc is updated in place; 2
// launches on `stream`.
int tfhe_mk_cmux_step(int32_t* acc, const int8_t* e_step,
                      const int32_t* bara, int8_t* lhs,
                      const StepSizes* sizes, const DotsArgs* tables, int nzn,
                      void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  Params p;
  cudaError_t err = make_params(p, *sizes);
  if (err != cudaSuccess) return (int)err;
  DotsLaunch dots;
  err = make_mk_dots(dots, *tables, p, lhs, e_step, 1, sizes->total_rows,
                     nzn);
  if (err != cudaSuccess) return (int)err;
  return (int)launch_step(acc, dots, 0, true, bara, lhs, p, st);
}

// A chunk of n_steps steps against e_chunk int8[n_steps, 4, T, R*NZ*l*T]
// and bara_t int32[n_steps, B]: 2 launches per step on `stream`.
int tfhe_mk_blind_rotate_chunk(int32_t* acc, const int8_t* e_chunk,
                               const int32_t* bara_t, int8_t* lhs,
                               const StepSizes* sizes,
                               const DotsArgs* tables, int n_steps, int nzn,
                               void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  Params p;
  cudaError_t err = make_params(p, *sizes);
  if (err != cudaSuccess) return (int)err;
  DotsLaunch dots;
  err = make_mk_dots(dots, *tables, p, lhs, e_chunk, n_steps,
                     sizes->total_rows, nzn);
  if (err != cudaSuccess) return (int)err;
  for (int s = 0; s < n_steps; ++s) {
    err = launch_step(acc, dots, s, true, bara_t + (size_t)s * p.batch, lhs,
                      p, st);
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}

// A party's n_steps steps from its nz-selected compact limbs
// int8[n_steps, 4, NZ, l, 2N]: per step the expansion into `scratch`
// (R*NZ*l*T * 4*T bytes, K-major, rewritten every step), then the step's 2
// launches.
int tfhe_mk_blind_rotate_compact(int32_t* acc, const int8_t* limbs,
                                 const int32_t* bara_t, int8_t* lhs,
                                 int8_t* scratch, const int32_t* entry_masks,
                                 const StepSizes* sizes,
                                 const DotsArgs* tables, int n_steps, int nzn,
                                 void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  Params p;
  cudaError_t err = make_params(p, *sizes);
  if (err != cudaSuccess) return (int)err;
  DotsLaunch dots;
  err = make_mk_dots(dots, *tables, p, lhs, scratch, 1, sizes->total_rows,
                     nzn);
  if (err != cudaSuccess) return (int)err;
  // x 4000 steps > 2^31
  const size_t limbs_step = (size_t)4 * nzn * p.l * 2 * p.n;
  for (int s = 0; s < n_steps; ++s) {
    err = launch_expand(limbs + (size_t)s * limbs_step, entry_masks, scratch,
                        sizes->total_rows, nzn * p.l, 1, p.n, true, st);
    if (err != cudaSuccess) return (int)err;
    err = launch_step(acc, dots, 0, true, bara_t + (size_t)s * p.batch, lhs,
                      p, st);
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}

}  // extern "C"
