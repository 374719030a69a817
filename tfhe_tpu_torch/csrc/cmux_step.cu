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
// lo = ((d & 15) ^ 8) - 8, hi = (d - lo) >> 4 (shifts 0 and 4). One block
// per ciphertext, digits written straight to device memory as
// int8[B, S, M*P*T] (the wrapper hands them on as [S, B, M*P*T]).
//
// The matmul: for output block o one int8 dot of the digits against the
// contiguous window e[(M-1-o)*P*T : (2M-1-o)*P*T] of the permuted
// block-Toeplitz key, digit-limb shift, << 8*limb recombination, add into
// acc. The bake stores block shifts permuted so that the window never
// wraps, and the negacyclic sign is already in the baked bytes, so there is
// no fold. This is exactly one term of leaf_dots_kernel (cmux_kernels.cuh)
// per digit limb: (posm = o, digit segment s*M, key segment M-1-o, M
// segments, shift of limb s, sign +1), so the dense matmul is that kernel
// driven by a dense term table (ops/cmux_step.py:dense_tables), with every
// block product computed once.
//
// What bounds it: the int8 dots, M^2 block products per digit limb and
// step, as blind_rotate.cu.

#include "cmux_kernels.cuh"

namespace {

__global__ void __launch_bounds__(kThreads)
rotate_decompose_dense_kernel(const int32_t* __restrict__ acc,
                              const int32_t* __restrict__ bara_step,
                              int8_t* __restrict__ digits, Params p,
                              int s_limbs) {
  const int row = blockIdx.x;
  const int n = p.n;
  const uint32_t s = (uint32_t)bara_step[row] & (2u * (uint32_t)n - 1u);
  const int32_t* a = acc + (size_t)row * p.k1 * n;
  const uint32_t digit_mask = (1u << p.b) - 1u;
  const int half = 1 << (p.b - 1);
  int8_t* dst_row = digits + (size_t)row * p.lhs_stride;
  const size_t limb_stride = (size_t)p.m * p.pt;

  for (int idx = threadIdx.x; idx < p.k1 * n; idx += blockDim.x) {
    const int j = idx / n;
    const int r = idx - j * n;
    const uint32_t shifted =
        rotated_minus_acc(a + (size_t)j * n, n, r, s, (uint32_t)p.offset);
    const int i = r / kT;
    const int u = r - i * kT;
    int8_t* out = dst_row + (size_t)i * p.pt + (size_t)j * p.l * kT + u;
    for (int il = 0; il < p.l; ++il) {
      const int d =
          (int)((shifted >> (32 - (il + 1) * p.b)) & digit_mask) - half;
      if (s_limbs == 1) {
        out[il * kT] = (int8_t)d;
      } else {
        const int lo = ((d & 15) ^ 8) - 8;  // in [-8, 7]
        const int hi = (d - lo) >> 4;       // exact: d - lo is 16 * hi
        out[il * kT] = (int8_t)lo;
        out[limb_stride + il * kT] = (int8_t)hi;
      }
    }
  }
}

}  // namespace

extern "C" {

// acc int32[B, K, N], bara_step int32[B] -> digits int8[B, S, M*P*T].
int tfhe_rotate_decompose(const int32_t* acc, const int32_t* bara_step,
                          int8_t* digits, int batch, int k1, int n, int l,
                          int b, int m, int s_limbs, int offset,
                          void* stream) {
  const Params p = make_params(batch, k1, n, l, b, m, s_limbs * m, offset);
  rotate_decompose_dense_kernel<<<batch, kThreads, 0,
                                  static_cast<cudaStream_t>(stream)>>>(
      acc, bara_step, digits, p, s_limbs);
  return (int)cudaGetLastError();
}

// acc += recombine(digits (x) e_step), in place. digits int8[B, S, M*P*T],
// e_step int8[2M*P*T, K*4*T], terms the dense table.
int tfhe_cmux_matmul(int32_t* acc, const int8_t* digits, const int8_t* e_step,
                     const int32_t* terms, const int32_t* term_start,
                     int batch, int k1, int n, int l, int b, int m,
                     int s_limbs, void* stream) {
  const Params p = make_params(batch, k1, n, l, b, m, s_limbs * m, 0);
  const dim3 grid(k1 * (kT / kWB), m, (batch + kBM - 1) / kBM);
  leaf_dots_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      acc, digits, e_step, terms, term_start, p);
  return (int)cudaGetLastError();
}

}  // extern "C"
