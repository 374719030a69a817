// The dense depth-0 CMUX step for Hopper (sm_90a).
//
// Replaces the TPU kernels tfhe_tpu/ops/pallas_cmux.py:
//   _rotate_decompose_kernel and _cmux_matmul_kernel
// (both under the entry cmux_step_pallas).
//
// rotate_decompose_dense_kernel: rotate acc by X^bara, subtract acc, add the
// decomposition offset, cut l signed b-bit digits, and store them as S int8
// limbs in lane order (block i, poly j, level, coeff): S = 1 for b <= 8;
// for b >= 9 the digit is held as an int and split base 16,
// lo = ((d & 15) ^ 8) - 8, hi = (d - lo) >> 4 (shifts 0 and 4). The front
// half is rotate_decompose_kernel's (cmux_kernels.cuh: a block per row, the
// row read once into shared memory, 4-byte stores of full lines); the
// digits go straight to device memory as int8[B, S, M*P*T] (the wrapper
// hands them on as [S, B, M*P*T]). What bounds it: bytes, acc read once
// and S*M*P*T bytes a row written once.
//
// The matmul: for output block o one int8 dot of the digits against the
// contiguous window e[(M-1-o)*P*T : (2M-1-o)*P*T] of the permuted
// block-Toeplitz key, digit-limb shift, << 8*limb recombination, add into
// acc. The bake stores block shifts permuted so that the window never
// wraps, and the negacyclic sign is already in the baked bytes, so there is
// no fold. This is one product of leaf_dots_kernel (cmux_kernels.cuh) per
// digit limb and output block: (digit segment s*M, key segment M-1-o, M
// segments, shift of limb s) with the one target (o, +1), so the dense
// matmul is that kernel driven by a dense product table
// (ops/cmux_step.py:dense_product_tables), every block product computed
// once. The key step arrives K-major, int8[K, 4, T, 2M*P*T].
//
// What bounds it: the int8 dots, M^2 block products per digit limb and
// step, as blind_rotate.cu.

#include "cmux_kernels.cuh"

namespace {

// Per ciphertext row S limbs of M*P*T digit bytes, lane order (block i,
// poly j, level, coeff), from the front half the Karatsuba steps' kernel
// shares (cmux_kernels.cuh:rotate_rows: one staged read of the row, a warp
// per (poly, level), a lane per 4 coefficients of all M blocks, full-line
// 4-byte stores).
template <int M>
__global__ void __launch_bounds__(kMaxRowWarps * 32)
rotate_decompose_dense_kernel(const int32_t* __restrict__ acc,
                              const int32_t* __restrict__ bara_step,
                              int8_t* __restrict__ digits,
                              const __grid_constant__ Params p,
                              int s_limbs) {
  rotate_rows<M>(acc, bara_step, p, [&](int row, int j, int il, int lane,
                                         auto shifted) {
    const uint32_t mask = (1u << p.b) - 1u;
    const int half = 1 << (p.b - 1);
    const int shift = 32 - (il + 1) * p.b;
    const size_t limb_stride = (size_t)M * p.pt;
    int8_t* dst = digits + (size_t)row * p.lhs_stride +
                  (size_t)(j * p.l + il) * kT + 4 * lane;
#pragma unroll
    for (int i = 0; i < M; ++i) {
      int d[4];
      cut4(shifted(i), shift, mask, half, d);
      if (s_limbs == 1) {
        store4(dst + (size_t)i * p.pt, pack4(d[0], d[1], d[2], d[3]));
      } else {
        int hi[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int lo = ((d[e] & 15) ^ 8) - 8;  // in [-8, 7]
          hi[e] = (d[e] - lo) >> 4;              // exact: d - lo is 16 * hi
          d[e] = lo;
        }
        store4(dst + (size_t)i * p.pt, pack4(d[0], d[1], d[2], d[3]));
        store4(dst + limb_stride + (size_t)i * p.pt,
               pack4(hi[0], hi[1], hi[2], hi[3]));
      }
    }
  });
}

template <int M>
struct RotateDecomposeDense {
  static cudaError_t run(const Params& p, const int32_t* acc,
                         const int32_t* bara_step, int8_t* digits,
                         int s_limbs, cudaStream_t st) {
    const size_t smem = row_smem(p);
    if (smem > 48 * 1024) {
      cudaError_t err = cudaFuncSetAttribute(
          rotate_decompose_dense_kernel<M>,
          cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
      if (err != cudaSuccess) return err;
    }
    rotate_decompose_dense_kernel<M><<<p.batch, row_threads(p), smem, st>>>(
        acc, bara_step, digits, p, s_limbs);
    return cudaGetLastError();
  }
};

}  // namespace

extern "C" {

// acc int32[B, K, N], bara_step int32[B] -> digits int8[B, S, M*P*T]: the
// digit row is the S limbs' M blocks, sizes->lhs_rows = S*M segments.
int tfhe_rotate_decompose(const int32_t* acc, const int32_t* bara_step,
                          int8_t* digits, const StepSizes* sizes,
                          void* stream) {
  Params p;
  cudaError_t err = make_params(p, *sizes);
  if (err != cudaSuccess) return (int)err;
  return (int)launch_by_m<RotateDecomposeDense>(
      p, acc, bara_step, digits, sizes->lhs_rows / sizes->m,
      static_cast<cudaStream_t>(stream));
}

// acc += recombine(digits (x) e_step), in place. digits int8[B, S, M*P*T],
// e_step int8[K, 4, T, 2M*P*T] (K-major), the dense product table.
int tfhe_cmux_matmul(int32_t* acc, const int8_t* digits, const int8_t* e_step,
                     const StepSizes* sizes, const DotsArgs* tables,
                     void* stream) {
  Params p;
  cudaError_t err = make_params(p, *sizes);
  if (err != cudaSuccess) return (int)err;
  DotsLaunch dots;
  err = make_dots(dots, *tables, p, digits, e_step, 2 * p.m * p.pt, p.k1, 1);
  if (err != cudaSuccess) return (int)err;
  err = allow_dots_smem(dots);
  if (err != cudaSuccess) return (int)err;
  return (int)launch_dots(acc, dots, 0, false,
                          static_cast<cudaStream_t>(stream));
}

}  // extern "C"
