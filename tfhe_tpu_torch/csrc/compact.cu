// Blind rotation from the compact (prepared-limb) key for Hopper (sm_90a).
//
// Replaces the TPU kernel tfhe_tpu/ops/pallas_cmux.py:_compact_megakernel
// (entry blind_rotate_pallas_compact), with its bodies _expand_entries_body
// and _leaf_dots_resident.
//
// What it computes. The key is int8[n, 4, P, K, 2N]: per step the four
// balanced bytes of the doubled words [t, -t] of every key polynomial. For
// each of the n steps:
//   1. expand_kernel: rebuild the int32 doubled words from their 4 bytes;
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

namespace {

// One block per (row r, key row p, output polynomial k): 4 * T * T bytes.
__global__ void __launch_bounds__(kThreads)
expand_kernel(const int8_t* __restrict__ limbs_step,
              const int32_t* __restrict__ entry_masks,
              int8_t* __restrict__ out, int p_rows, int k1, int n) {
  __shared__ __align__(4) int8_t cl[4][2 * kT];  // balanced bytes of C[j]
  const int r = blockIdx.x, pj = blockIdx.y, k = blockIdx.z;
  const uint32_t n2_mask = 2u * (uint32_t)n - 1u;
  const size_t plane = (size_t)p_rows * k1 * 2 * n;  // one limb of the step
  const int8_t* src = limbs_step + ((size_t)pj * k1 + k) * 2 * n;
  const uint32_t mask = (uint32_t)entry_masks[r];

  for (int j = threadIdx.x; j < 2 * kT; j += blockDim.x) {
    uint32_t sum = 0u;
    for (int d = 0; d < 32; ++d) {
      if (!((mask >> d) & 1u)) continue;
      const uint32_t idx = ((uint32_t)(d * kT - kT + j)) & n2_mask;
      // sign-extended bytes, recombined mod 2^32
      const uint32_t word = (uint32_t)(int32_t)src[idx] +
                            ((uint32_t)(int32_t)src[plane + idx] << 8) +
                            ((uint32_t)(int32_t)src[2 * plane + idx] << 16) +
                            ((uint32_t)(int32_t)src[3 * plane + idx] << 24);
      sum += word;
    }
    uint32_t cur = sum;
#pragma unroll
    for (int limb = 0; limb < 4; ++limb) {
      const int32_t lo = (int32_t)((cur & 255u) ^ 128u) - 128;  // balanced
      cl[limb][j] = (int8_t)lo;
      // cur - lo is a multiple of 256; the shift is arithmetic
      cur = (uint32_t)((int32_t)(cur - (uint32_t)lo) >> 8);
    }
  }
  __syncthreads();

  const int cols = k1 * 4 * kT;
  int8_t* dst = out + ((size_t)r * p_rows + pj) * kT * cols + (size_t)k * 4 * kT;
  for (int x = threadIdx.x; x < kT * 4 * (kT / 4); x += blockDim.x) {
    const int w = (x % (kT / 4)) * 4;
    const int limb = (x / (kT / 4)) % 4;
    const int u = x / kT;
    const int8_t* c = &cl[limb][kT + w - u];
    const uint32_t word = (uint32_t)(uint8_t)c[0] |
                          ((uint32_t)(uint8_t)c[1] << 8) |
                          ((uint32_t)(uint8_t)c[2] << 16) |
                          ((uint32_t)(uint8_t)c[3] << 24);
    *reinterpret_cast<uint32_t*>(dst + (size_t)u * cols + limb * kT + w) =
        word;
  }
}

cudaError_t launch_expand(const int8_t* limbs_step,
                          const int32_t* entry_masks, int8_t* out,
                          int total_rows, int p_rows, int k1, int n,
                          cudaStream_t st) {
  expand_kernel<<<dim3(total_rows, p_rows, k1), kThreads, 0, st>>>(
      limbs_step, entry_masks, out, p_rows, k1, n);
  return cudaGetLastError();
}

}  // namespace

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
  const int p_rows = k1 * l;
  const size_t limbs_step = (size_t)4 * p_rows * k1 * 2 * n;
  for (int s = 0; s < n_steps; ++s) {
    cudaError_t err =
        launch_expand(limbs + (size_t)s * limbs_step, entry_masks, scratch,
                      total_rows, p_rows, k1, n, st);
    if (err != cudaSuccess) return (int)err;
    err = launch_step(acc, scratch, bara_t + (size_t)s * batch, lhs, combos,
                      n_combos, terms, term_start, p, st);
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}

}  // extern "C"
