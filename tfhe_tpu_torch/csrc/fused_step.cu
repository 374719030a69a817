// One fused block-Karatsuba CMUX step for Hopper (sm_90a), in one launch.
//
// Replaces the TPU kernel tfhe_tpu/ops/pallas_cmux.py:
//   _fused_karatsuba_kernel (entry cmux_step_pallas_karatsuba).
//
// What it computes (acc int32[B, K, N], e_step int8[R*P*T, K*4*T] a step of
// the Karatsuba-baked key in the reference layout, not the K-major layout
// the whole-rotation kernels read, bara int32[B] -> out int32[B, K, N]; acc is not
// modified), the seven steps of blind_rotate.cu for a single step:
//   1. rotate acc by X^bara;  2. subtract acc, add the decomposition
//   offset;  3. cut l signed b-bit digits;  4. form the Karatsuba digit
//   combos;  5. leaf dots against the key rows (int8 mma.sync, int32);
//   6. recombine the four key limbs;  7. fold with the z^M = -1 sign and
//   add acc.
// Unlike tfhe_blind_rotate at n_steps = 1 (two launches, with the digit
// operand written to and read back from device memory) the digits never
// leave the SM.
//
// Who owns what. One block owns kFM = 16 batch rows for the whole step.
//   Phase A: the block rotates and decomposes its rows into shared memory:
//     raw digits only, M*P*T per row (int8, or int16 for b > 8).
//   __syncthreads().
//   Phase B: the block loops over its K*M output groups (output polynomial
//     k, output block posm), T = 128 coefficients x 4 key limbs = 512 key
//     columns each, and runs the group's terms from the plan's table
//     (ops/blind_rotate.py:kernel_tables): sign * 2^shift * (digit segments
//     . key segments). Each of the 8 warps owns 16 coefficients of the
//     group for all 4 limbs, so the limb recombination happens in
//     registers (the mma.sync fragment layout). The group's words are
//     added to acc's and written to `out`: a separate buffer, because a
//     row's rotation reads the whole input row, and other blocks never
//     touch this block's rows, so no atomics.
//
// Combos. A 16-row tile of raw digits fits shared memory at every
// single-key preset (at most 131,072 bytes: N = 1024, l = 4 or b = 10); the
// combo rows would triple that. So a combo segment is formed while the A
// tile is staged: the segment table (ops/fused_step.py:fused_tables) gives
// for each digit segment the mask of raw blocks to sum and which limb of
// the sum to take (the sum as it is, its low 7-bit limb, or its high limb
// at shift 7). A raw segment is the case of a one-block mask.
//
// What bounds it on the H100: int8 tensor-core work, as blind_rotate.cu.
// What this design costs: every block streams the step's whole key slice
// from L2 (B/16 blocks; 256 at B = 4096 on 132 SMs, under two full waves),
// one block of 8 warps per SM, staging without cp.async, and a combo
// segment is summed again for every term that reads it. A step of the
// whole-rotation kernel is faster; this entry point exists for callers
// that hold one step's key slice.

#include "cmux_kernels.cuh"

namespace {

constexpr int kKC = 64;         // contraction chunk staged in shared memory
constexpr int kLDS = kKC + 16;  // padded smem row: conflict-free fragments

__device__ __forceinline__ void mma_s8(int (&c)[4], uint32_t a0, uint32_t a1,
                                       uint32_t a2, uint32_t a3, uint32_t b0,
                                       uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// Stages kKC rows of the key, from key_row on, by 4 * W columns into Bs,
// transposed (column-major for the mma B operand) by 4x4 byte transposes.
// The tile's column for (limb, w), w < W, is key_col0 + limb * kT + w. The
// key step is in the reference layout int8[R*P*T, K*4*T].
template <int W>
__device__ __forceinline__ void stage_key_tile(
    int8_t* Bs, const int8_t* __restrict__ key, int key_cols, int key_row,
    int key_col0) {
  for (int q = threadIdx.x; q < (kKC / 4) * W; q += kThreads) {
    const int ng = (q % 8) + 8 * ((q / 32) % (W / 8));
    const int kg = ((q / 8) % 4) + 4 * (q / (4 * W));
    const int n0 = ng * 4;
    const int limb = n0 / W;
    const int w = n0 - limb * W;
    const size_t col = (size_t)key_col0 + limb * kT + w;
    const int8_t* src = key + (size_t)(key_row + kg * 4) * key_cols + col;
    const uint32_t r0 = *reinterpret_cast<const uint32_t*>(src);
    const uint32_t r1 = *reinterpret_cast<const uint32_t*>(src + key_cols);
    const uint32_t r2 =
        *reinterpret_cast<const uint32_t*>(src + 2 * (size_t)key_cols);
    const uint32_t r3 =
        *reinterpret_cast<const uint32_t*>(src + 3 * (size_t)key_cols);
    const uint32_t lo01 = __byte_perm(r0, r1, 0x5140);
    const uint32_t hi01 = __byte_perm(r0, r1, 0x7362);
    const uint32_t lo23 = __byte_perm(r2, r3, 0x5140);
    const uint32_t hi23 = __byte_perm(r2, r3, 0x7362);
    int8_t* dst = Bs + n0 * kLDS + kg * 4;
    *reinterpret_cast<uint32_t*>(dst) = __byte_perm(lo01, lo23, 0x5410);
    *reinterpret_cast<uint32_t*>(dst + kLDS) = __byte_perm(lo01, lo23, 0x7632);
    *reinterpret_cast<uint32_t*>(dst + 2 * kLDS) =
        __byte_perm(hi01, hi23, 0x5410);
    *reinterpret_cast<uint32_t*>(dst + 3 * kLDS) =
        __byte_perm(hi01, hi23, 0x7632);
  }
}

// part += the warp's 16 staged digit rows (from a_rows on) . the staged key
// tile, over one kKC chunk. Fragment layout of part: [limb * 2 + half][mma
// register], the warp's 16 coefficients being wcol .. wcol + 15 of the W
// that the tile holds for each limb.
template <int W>
__device__ __forceinline__ void mma_chunk(int (&part)[8][4],
                                          const int8_t* a_rows,
                                          const int8_t* Bs, int wcol) {
  const int lane = threadIdx.x % 32;
  const int g = lane >> 2, tig = lane & 3;
#pragma unroll
  for (int kk = 0; kk < kKC; kk += 32) {
    const int8_t* ap = a_rows + g * kLDS + kk + tig * 4;
    const uint32_t a0 = *reinterpret_cast<const uint32_t*>(ap);
    const uint32_t a1 = *reinterpret_cast<const uint32_t*>(ap + 8 * kLDS);
    const uint32_t a2 = *reinterpret_cast<const uint32_t*>(ap + 16);
    const uint32_t a3 = *reinterpret_cast<const uint32_t*>(ap + 8 * kLDS + 16);
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      const int ncol = (nt >> 1) * W + wcol + (nt & 1) * 8 + g;
      const int8_t* bp = Bs + ncol * kLDS + kk + tig * 4;
      const uint32_t b0 = *reinterpret_cast<const uint32_t*>(bp);
      const uint32_t b1 = *reinterpret_cast<const uint32_t*>(bp + 16);
      mma_s8(part[nt], a0, a1, a2, a3, b0, b1);
    }
  }
}

__device__ __forceinline__ void clear_part(int (&part)[8][4]) {
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int r = 0; r < 4; ++r) part[i][r] = 0;
}

// total += sign * (part << shift), mod 2^32.
__device__ __forceinline__ void add_part(uint32_t (&total)[8][4],
                                         const int (&part)[8][4], int shift,
                                         int sign) {
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const uint32_t v = (uint32_t)part[i][r] << shift;
      total[i][r] = sign > 0 ? total[i][r] + v : total[i][r] - v;
    }
}

constexpr int kFM = 16;            // batch rows per block: one mma m16 tile
constexpr int kFN = 4 * kT;        // key columns per group: 4 limbs x T
constexpr int kFAs = kFM * kLDS;   // staged digit tile, bytes
constexpr int kFBs = kFN * kLDS;   // staged key tile (transposed), bytes

// part += digits[kFM rows, segment run] . key[key_row0 : +width, key_col0 :
// +kFN]. The digit operand is formed from the raw digits in shared memory
// through the segment table; seg0 is the run's first segment.
template <typename Dig>
__device__ __forceinline__ void fused_tile_dot(
    int (&part)[8][4], int8_t* As, int8_t* Bs, const Dig* dig, int dig_stride,
    const int32_t* __restrict__ seg_table, int seg0, int pt, int m,
    const int8_t* __restrict__ key, int key_cols, int key_row0, int key_col0,
    int width) {
  const int tid = threadIdx.x;
  for (int kc = 0; kc < width; kc += kKC) {
    {  // digit tile: kFM rows x kKC bytes, 4 bytes per thread; a chunk
       // lies inside one segment (kKC divides P*T)
      const int r = tid / 16, c4 = (tid % 16) * 4;
      const int seg = seg0 + kc / pt;
      const int x0 = kc % pt + c4;
      const uint32_t mask = (uint32_t)seg_table[2 * seg];
      const int mode = seg_table[2 * seg + 1];
      const Dig* row = dig + (size_t)r * dig_stride + x0;
      uint32_t packed = 0u;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        int v = 0;
        for (int blk = 0; blk < m; ++blk)
          if ((mask >> blk) & 1u) v += row[blk * pt + e];
        if (mode != 0) {
          const int lo = ((v & 127) ^ 64) - 64;  // in [-64, 63]
          v = mode == 1 ? lo : (v - lo) / 128;   // exact: v - lo = 128 * hi
        }
        packed |= (uint32_t)(uint8_t)(int8_t)v << (8 * e);
      }
      *reinterpret_cast<uint32_t*>(As + r * kLDS + c4) = packed;
    }
    stage_key_tile<kT>(Bs, key, key_cols, key_row0 + kc, key_col0);
    __syncthreads();
    // each warp: 16 coefficients of the group, all 4 limbs
    mma_chunk<kT>(part, As, Bs, (tid / 32) * 16);
    __syncthreads();
  }
}

template <typename Dig>
__global__ void __launch_bounds__(kThreads)
fused_step_kernel(const int32_t* __restrict__ acc,
                  const int32_t* __restrict__ bara,
                  const int8_t* __restrict__ key_step,
                  const int32_t* __restrict__ seg_table,
                  const int32_t* __restrict__ terms,
                  const int32_t* __restrict__ term_start,
                  int32_t* __restrict__ out, Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  int8_t* As = reinterpret_cast<int8_t*>(smem);
  int8_t* Bs = As + kFAs;
  Dig* dig = reinterpret_cast<Dig*>(Bs + kFBs);  // kFM rows x m * pt digits
  const int n = p.n;
  const int dig_stride = p.m * p.pt;
  const int row0 = blockIdx.x * kFM;

  // Phase A: rotate, subtract, decompose; rows past the batch hold zeros.
  const uint32_t digit_mask = (1u << p.b) - 1u;
  const int half = 1 << (p.b - 1);
  for (int r = 0; r < kFM; ++r) {
    Dig* drow = dig + (size_t)r * dig_stride;
    const int row = row0 + r;
    if (row >= p.batch) {
      for (int x = threadIdx.x; x < dig_stride; x += blockDim.x)
        drow[x] = (Dig)0;
      continue;
    }
    const uint32_t s = (uint32_t)bara[row] & (2u * (uint32_t)n - 1u);
    const int32_t* a = acc + (size_t)row * p.k1 * n;
    for (int idx = threadIdx.x; idx < p.k1 * n; idx += blockDim.x) {
      const int j = idx / n;
      const int c = idx - j * n;
      const uint32_t shifted =
          rotated_minus_acc(a + (size_t)j * n, n, c, s, (uint32_t)p.offset);
      const int i = c / kT;
      const int u = c - i * kT;
      Dig* dst = drow + (size_t)i * p.pt + (size_t)j * p.l * kT + u;
      for (int il = 0; il < p.l; ++il) {
        const uint32_t d = (shifted >> (32 - (il + 1) * p.b)) & digit_mask;
        dst[il * kT] = (Dig)((int)d - half);
      }
    }
  }
  __syncthreads();

  // Phase B: the block's K * M output groups.
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, tig = lane & 3;
  for (int k = 0; k < p.k1; ++k) {
    for (int posm = 0; posm < p.m; ++posm) {
      uint32_t total[8][4];  // [limb * 2 + half][fragment register]
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int r = 0; r < 4; ++r) total[i][r] = 0u;

      for (int ti = term_start[posm]; ti < term_start[posm + 1]; ++ti) {
        const int32_t* tm = terms + 6 * ti;
        int part[8][4];
        clear_part(part);
        fused_tile_dot<Dig>(part, As, Bs, dig, dig_stride, seg_table, tm[1],
                            p.pt, p.m, key_step, p.cols, tm[2] * p.pt,
                            k * kFN, tm[3] * p.pt);
        add_part(total, part, tm[4], tm[5]);
      }

#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          uint32_t word = 0u;
#pragma unroll
          for (int limb = 0; limb < 4; ++limb)
            word += total[limb * 2 + h][r] << (8 * limb);
          const int row = row0 + g + (r >= 2 ? 8 : 0);
          const int w = warp * 16 + h * 8 + tig * 2 + (r & 1);
          if (row < p.batch) {
            const size_t at = ((size_t)row * p.k1 + k) * n + posm * kT + w;
            out[at] = (int32_t)((uint32_t)acc[at] + word);
          }
        }
    }
  }
}

template <typename Dig>
cudaError_t launch_fused(const int32_t* acc, const int32_t* bara,
                         const int8_t* key_step, const int32_t* seg_table,
                         const int32_t* terms, const int32_t* term_start,
                         int32_t* out, const Params& p, cudaStream_t st) {
  const size_t smem =
      (size_t)kFAs + kFBs + (size_t)kFM * p.m * p.pt * sizeof(Dig);
  cudaError_t err = cudaFuncSetAttribute(
      fused_step_kernel<Dig>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  fused_step_kernel<Dig><<<(p.batch + kFM - 1) / kFM, kThreads, smem, st>>>(
      acc, bara, key_step, seg_table, terms, term_start, out, p);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// One fused step in one launch on `stream`: out = acc + key_step (x)
// [(X^bara - 1) * acc]. Returns the first CUDA error (0 = none); does not
// synchronise.
int tfhe_cmux_step_karatsuba(const int32_t* acc, const int8_t* key_step,
                             const int32_t* bara, int32_t* out,
                             const int32_t* seg_table, const int32_t* terms,
                             const int32_t* term_start, int batch, int k1,
                             int n, int l, int b, int m, int lhs_rows,
                             int offset, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  Params p;
  make_params(p, batch, k1, n, l, b, m, lhs_rows, offset);
  if (b > 8)
    return (int)launch_fused<int16_t>(acc, bara, key_step, seg_table, terms,
                                      term_start, out, p, st);
  return (int)launch_fused<int8_t>(acc, bara, key_step, seg_table, terms,
                                   term_start, out, p, st);
}

}  // extern "C"
