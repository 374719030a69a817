// Device code shared by the blind-rotation entry points (blind_rotate.cu,
// compact.cu, cmux_step.cu, mk_cmux.cu): the per-step rotate/decompose/combos
// kernel, the table-driven int8 dots kernels (single-key leaves and multi-key
// units, over one tile product `tile_dot`), and the compact key's expansion
// kernel. Each source that includes this file gets its own copy of the
// kernels (anonymous namespace).
//
// All mod-2^32 arithmetic is done in uint32_t, where wraparound is defined;
// int32_t appears only where signedness is meant (digits, arithmetic
// shifts).

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kT = 128;         // Toeplitz block size
constexpr int kBM = 64;         // dot tile rows (ciphertexts)
constexpr int kWB = 32;         // dot tile width in coefficients, per limb
constexpr int kBN = 4 * kWB;    // dot tile columns: 4 limbs x kWB
constexpr int kKC = 64;         // contraction chunk staged in shared memory
constexpr int kLDS = kKC + 16;  // padded smem row: conflict-free fragments
constexpr int kThreads = 256;

struct Params {
  int batch, k1, n, l, b, m, pt, lhs_stride, cols, offset;
};

// ((X^bara - 1) * acc)[j][r] + offset for one ciphertext: a = acc row
// [k1, n], s = bara & (2N-1).
__device__ __forceinline__ uint32_t rotated_minus_acc(
    const int32_t* __restrict__ poly, int n, int r, uint32_t s,
    uint32_t offset) {
  // (X^s * poly)[r] = doubled[(r - s) mod 2N], doubled = [poly, -poly]
  const uint32_t two_n_mask = 2u * (uint32_t)n - 1u;
  const uint32_t src = ((uint32_t)r - s) & two_n_mask;
  const uint32_t rot = src < (uint32_t)n ? (uint32_t)poly[src]
                                         : 0u - (uint32_t)poly[src - n];
  return rot - (uint32_t)poly[r] + offset;
}

// Steps 1-4 for one ciphertext row per block. Dig is the type the raw
// digits are held in: int8_t for b <= 8, when they are also the operand of
// the singleton leaves and are copied to lhs segments [0, M); int16_t for
// b > 8, when they do not fit a byte, every leaf reads two-limb combos and
// the raw segments of lhs are left unwritten (no term reads them).
template <typename Dig>
__global__ void __launch_bounds__(kThreads)
rotate_decompose_kernel(const int32_t* __restrict__ acc,
                        const int32_t* __restrict__ bara_step,
                        int8_t* __restrict__ lhs, Params p,
                        const int32_t* __restrict__ combos, int n_combos) {
  extern __shared__ __align__(16) unsigned char dig_raw[];
  Dig* dig = reinterpret_cast<Dig*>(dig_raw);  // m * pt raw digits
  const int row = blockIdx.x;
  const int n = p.n;
  const uint32_t s = (uint32_t)bara_step[row] & (2u * (uint32_t)n - 1u);
  const int32_t* a = acc + (size_t)row * p.k1 * n;
  const uint32_t digit_mask = (1u << p.b) - 1u;
  const int half = 1 << (p.b - 1);

  for (int idx = threadIdx.x; idx < p.k1 * n; idx += blockDim.x) {
    const int j = idx / n;
    const int r = idx - j * n;
    const uint32_t shifted =
        rotated_minus_acc(a + (size_t)j * n, n, r, s, (uint32_t)p.offset);
    const int i = r / kT;
    const int u = r - i * kT;
    Dig* out = dig + (size_t)i * p.pt + (size_t)j * p.l * kT + u;
    for (int il = 0; il < p.l; ++il) {
      // The mask keeps only bits the shift brought down, so a logical
      // shift gives the same digit as the reference's arithmetic one.
      const uint32_t d = (shifted >> (32 - (il + 1) * p.b)) & digit_mask;
      out[il * kT] = (Dig)((int)d - half);
    }
  }
  __syncthreads();

  int8_t* dst_row = lhs + (size_t)row * p.lhs_stride;
  if (sizeof(Dig) == 1) {
    const int raw_words = p.m * p.pt / 4;
    for (int x = threadIdx.x; x < raw_words; x += blockDim.x)
      reinterpret_cast<int32_t*>(dst_row)[x] =
          reinterpret_cast<const int32_t*>(dig)[x];
  }

  for (int c = 0; c < n_combos; ++c) {
    const int dst = combos[4 * c + 0];
    const uint32_t src_mask = (uint32_t)combos[4 * c + 1];
    const int two_limb = combos[4 * c + 2];
    const int hi_dst = combos[4 * c + 3];
    for (int x = threadIdx.x; x < p.pt; x += blockDim.x) {
      int v = 0;
      for (int blk = 0; blk < p.m; ++blk)
        if ((src_mask >> blk) & 1u) v += dig[blk * p.pt + x];
      if (!two_limb) {
        dst_row[(size_t)dst * p.pt + x] = (int8_t)v;
      } else {
        const int lo = ((v & 127) ^ 64) - 64;  // in [-64, 63]
        const int hi = (v - lo) / 128;         // exact: v - lo is 128 * hi
        dst_row[(size_t)dst * p.pt + x] = (int8_t)lo;
        dst_row[(size_t)hi_dst * p.pt + x] = (int8_t)hi;
      }
    }
  }
}

__device__ __forceinline__ void mma_s8(int (&c)[4], uint32_t a0, uint32_t a1,
                                       uint32_t a2, uint32_t a3, uint32_t b0,
                                       uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// part += lhs[row0 : row0 + kBM, lhs_col0 : lhs_col0 + width] .
//         key[key_row0 : key_row0 + width, the tile's 4 * kWB columns],
// the tile's column for (limb, w) being key_col0 + limb * kT + w. Both
// operands are staged through shared memory kKC bytes of the contraction at
// a time; rows past `batch` read as zero. `width` is a multiple of kKC.
// Fragment layout of part: [limb * 2 + half][mma register], for the thread's
// warp (wr: 16 rows, wc: 16 of the kWB coefficients).
__device__ __forceinline__ void tile_dot(
    int (&part)[8][4], int8_t* As, int8_t* Bs, const int8_t* __restrict__ lhs,
    int lhs_stride, int batch, int row0, int lhs_col0,
    const int8_t* __restrict__ key, int key_cols, int key_row0, int key_col0,
    int width) {
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int wr = warp % 4, wc = warp / 4;
  const int g = lane >> 2, tig = lane & 3;
  for (int kc = 0; kc < width; kc += kKC) {
    {  // digit tile: kBM rows x kKC bytes, 16 bytes per thread
      const int r = tid / 4, c16 = (tid % 4) * 16;
      const int grow = row0 + r;
      int4 v = make_int4(0, 0, 0, 0);
      if (grow < batch)
        v = *reinterpret_cast<const int4*>(
            lhs + (size_t)grow * lhs_stride + lhs_col0 + kc + c16);
      *reinterpret_cast<int4*>(As + r * kLDS + c16) = v;
    }
    // key tile: kKC rows x kBN columns, stored transposed (column-major
    // for the mma B operand) by 4x4 byte transposes
    for (int q = tid; q < (kKC / 4) * (kBN / 4); q += kThreads) {
      const int ng = (q % 8) + 8 * ((q / 32) % 4);
      const int kg = ((q / 8) % 4) + 4 * (q / 128);
      const int n0 = ng * 4;
      const int limb = n0 / kWB;
      const int w = n0 - limb * kWB;
      const size_t col = (size_t)key_col0 + limb * kT + w;
      const int8_t* src =
          key + (size_t)(key_row0 + kc + kg * 4) * key_cols + col;
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
      *reinterpret_cast<uint32_t*>(dst + kLDS) =
          __byte_perm(lo01, lo23, 0x7632);
      *reinterpret_cast<uint32_t*>(dst + 2 * kLDS) =
          __byte_perm(hi01, hi23, 0x5410);
      *reinterpret_cast<uint32_t*>(dst + 3 * kLDS) =
          __byte_perm(hi01, hi23, 0x7632);
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kKC; kk += 32) {
      const int8_t* ap = As + (wr * 16 + g) * kLDS + kk + tig * 4;
      const uint32_t a0 = *reinterpret_cast<const uint32_t*>(ap);
      const uint32_t a1 = *reinterpret_cast<const uint32_t*>(ap + 8 * kLDS);
      const uint32_t a2 = *reinterpret_cast<const uint32_t*>(ap + 16);
      const uint32_t a3 =
          *reinterpret_cast<const uint32_t*>(ap + 8 * kLDS + 16);
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        const int ncol = (nt >> 1) * kWB + wc * 16 + (nt & 1) * 8 + g;
        const int8_t* bp = Bs + ncol * kLDS + kk + tig * 4;
        const uint32_t b0 = *reinterpret_cast<const uint32_t*>(bp);
        const uint32_t b1 = *reinterpret_cast<const uint32_t*>(bp + 16);
        mma_s8(part[nt], a0, a1, a2, a3, b0, b1);
      }
    }
    __syncthreads();
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

// Limb recombination (<< 8 * limb) of the thread's fragments and the
// in-place add into acc[:, k, posm*T + wt*kWB + w].
__device__ __forceinline__ void add_words(int32_t* __restrict__ acc,
                                          const uint32_t (&total)[8][4],
                                          const Params& p, int k, int posm,
                                          int wt, int row0) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wr = warp % 4, wc = warp / 4;
  const int g = lane >> 2, tig = lane & 3;
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      uint32_t word = 0u;
#pragma unroll
      for (int limb = 0; limb < 4; ++limb)
        word += total[limb * 2 + h][r] << (8 * limb);
      const int row = row0 + wr * 16 + g + (r >= 2 ? 8 : 0);
      const int w = wt * kWB + wc * 16 + h * 8 + tig * 2 + (r & 1);
      if (row < p.batch) {
        int32_t* dst = acc + ((size_t)row * p.k1 + k) * p.n + posm * kT + w;
        *dst = (int32_t)((uint32_t)*dst + word);
      }
    }
}

// Steps 5-7 for one (column tile, output block, batch tile). The column
// tile is one output polynomial k and kWB coefficients, for all 4 key limbs,
// so the limb recombination happens in registers. 8 warps: 4 along the
// rows (16 each) by 2 along the coefficients (16 each, all 4 limbs).
__global__ void __launch_bounds__(kThreads)
leaf_dots_kernel(int32_t* __restrict__ acc, const int8_t* __restrict__ lhs,
                 const int8_t* __restrict__ key_step,
                 const int32_t* __restrict__ terms,
                 const int32_t* __restrict__ term_start, Params p) {
  __shared__ __align__(16) int8_t As[kBM * kLDS];
  __shared__ __align__(16) int8_t Bs[kBN * kLDS];

  const int tiles_per_poly = kT / kWB;
  const int k = blockIdx.x / tiles_per_poly;
  const int wt = blockIdx.x - k * tiles_per_poly;
  const int posm = blockIdx.y;
  const int row0 = blockIdx.z * kBM;

  uint32_t total[8][4];  // [limb * 2 + half][fragment register]
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int r = 0; r < 4; ++r) total[i][r] = 0u;

  for (int ti = term_start[posm]; ti < term_start[posm + 1]; ++ti) {
    const int32_t* tm = terms + 6 * ti;
    int part[8][4];
    clear_part(part);
    tile_dot(part, As, Bs, lhs, p.lhs_stride, p.batch, row0, tm[1] * p.pt,
             key_step, p.cols, tm[2] * p.pt, k * 4 * kT + wt * kWB,
             tm[3] * p.pt);
    add_part(total, part, tm[4], tm[5]);
  }
  add_words(acc, total, p, k, posm, wt, row0);
}

// The multi-key unit dots for one (column tile, output block, batch tile).
// The step's operand is the sparse expansion int8[R*NZ*l*T, 4*T]: rows
// (bake row r, nonzero block z, l', u), columns (limb, w) of that block's
// one output polynomial. A term (group, lhs_off, e_row, nseg, shift, sign)
// adds sign * 2^shift * sum over nseg pieces of
//   lhs[:, lhs_off + i*P*T : +l*T] . operand[e_row + i*NZ*l*T : +l*T, :]
// to the output block group = k * M + posm: piece i reads the j-slice (l*T
// bytes) of digit segment i of a leaf's entry run and entry tile i of the
// block. All terms of one (k, posm) belong to this block alone, so the add
// into acc needs no atomics.
__global__ void __launch_bounds__(kThreads)
mk_unit_dots_kernel(int32_t* __restrict__ acc, const int8_t* __restrict__ lhs,
                    const int8_t* __restrict__ e_step,
                    const int32_t* __restrict__ terms,
                    const int32_t* __restrict__ term_start, Params p,
                    int nzn) {
  __shared__ __align__(16) int8_t As[kBM * kLDS];
  __shared__ __align__(16) int8_t Bs[kBN * kLDS];

  const int tiles_per_poly = kT / kWB;
  const int k = blockIdx.x / tiles_per_poly;
  const int wt = blockIdx.x - k * tiles_per_poly;
  const int posm = blockIdx.y;
  const int row0 = blockIdx.z * kBM;
  const int lt = p.l * kT;
  const int group = k * p.m + posm;

  uint32_t total[8][4];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int r = 0; r < 4; ++r) total[i][r] = 0u;

  for (int ti = term_start[group]; ti < term_start[group + 1]; ++ti) {
    const int32_t* tm = terms + 6 * ti;
    int part[8][4];
    clear_part(part);
    for (int i = 0; i < tm[3]; ++i)
      tile_dot(part, As, Bs, lhs, p.lhs_stride, p.batch, row0,
               tm[1] + i * p.pt, e_step, 4 * kT, tm[2] + i * nzn * lt,
               wt * kWB, lt);
    add_part(total, part, tm[4], tm[5]);
  }
  add_words(acc, total, p, k, posm, wt, row0);
}

// The expansion of one step's compact limbs int8[4, P, K, 2N] into the
// Karatsuba operand int8[R*P*T, K*4*T]; one block per (bake row r, key row
// pj, output polynomial k): 4 * T * T bytes. A multi-key step's nonzero
// blocks int8[4, NZ, l, 2N] are the case P = NZ*l, K = 1.
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

inline cudaError_t launch_expand(const int8_t* limbs_step,
                                 const int32_t* entry_masks, int8_t* out,
                                 int total_rows, int p_rows, int k1, int n,
                                 cudaStream_t st) {
  expand_kernel<<<dim3(total_rows, p_rows, k1), kThreads, 0, st>>>(
      limbs_step, entry_masks, out, p_rows, k1, n);
  return cudaGetLastError();
}

// A row's raw digits past 48 KB of shared memory (8 parties: 73,728 bytes)
// need the opt-in limit; every entry point calls this once before it
// launches its steps.
inline cudaError_t allow_digit_smem(const Params& p) {
  const size_t bytes = (size_t)p.m * p.pt * (p.b > 8 ? 2 : 1);
  if (bytes <= 48 * 1024) return cudaSuccess;
  if (p.b > 8)
    return cudaFuncSetAttribute(rotate_decompose_kernel<int16_t>,
                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                (int)bytes);
  return cudaFuncSetAttribute(rotate_decompose_kernel<int8_t>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

inline cudaError_t launch_rotate_decompose(const int32_t* acc,
                                           const int32_t* bara_step,
                                           int8_t* lhs, const int32_t* combos,
                                           int n_combos, const Params& p,
                                           cudaStream_t st) {
  if (p.b > 8) {
    rotate_decompose_kernel<int16_t>
        <<<p.batch, kThreads, (size_t)p.m * p.pt * 2, st>>>(
            acc, bara_step, lhs, p, combos, n_combos);
  } else {
    rotate_decompose_kernel<int8_t>
        <<<p.batch, kThreads, (size_t)p.m * p.pt, st>>>(
            acc, bara_step, lhs, p, combos, n_combos);
  }
  return cudaGetLastError();
}

// One CMUX step against `key_step` (the step's baked or expanded rows): the
// rotate/decompose/combos launch, then the dots launch, which adds into acc
// in place. Returns the first launch error.
inline cudaError_t launch_step(int32_t* acc, const int8_t* key_step,
                               const int32_t* bara_step, int8_t* lhs,
                               const int32_t* combos, int n_combos,
                               const int32_t* terms,
                               const int32_t* term_start, const Params& p,
                               cudaStream_t st) {
  cudaError_t err =
      launch_rotate_decompose(acc, bara_step, lhs, combos, n_combos, p, st);
  if (err != cudaSuccess) return err;
  const dim3 dots_grid(p.k1 * (kT / kWB), p.m, (p.batch + kBM - 1) / kBM);
  leaf_dots_kernel<<<dots_grid, kThreads, 0, st>>>(acc, lhs, key_step, terms,
                                                   term_start, p);
  return cudaGetLastError();
}

// One multi-key CMUX step against the step's sparse expansion `e_step`.
inline cudaError_t launch_mk_step(int32_t* acc, const int8_t* e_step,
                                  const int32_t* bara_step, int8_t* lhs,
                                  const int32_t* combos, int n_combos,
                                  const int32_t* terms,
                                  const int32_t* term_start, const Params& p,
                                  int nzn, cudaStream_t st) {
  cudaError_t err =
      launch_rotate_decompose(acc, bara_step, lhs, combos, n_combos, p, st);
  if (err != cudaSuccess) return err;
  const dim3 dots_grid(p.k1 * (kT / kWB), p.m, (p.batch + kBM - 1) / kBM);
  mk_unit_dots_kernel<<<dots_grid, kThreads, 0, st>>>(
      acc, lhs, e_step, terms, term_start, p, nzn);
  return cudaGetLastError();
}

inline Params make_params(int batch, int k1, int n, int l, int b, int m,
                          int lhs_rows, int offset) {
  Params p;
  p.batch = batch;
  p.k1 = k1;
  p.n = n;
  p.l = l;
  p.b = b;
  p.m = m;
  p.pt = k1 * l * kT;
  p.lhs_stride = lhs_rows * p.pt;
  p.cols = k1 * 4 * kT;
  p.offset = offset;
  return p;
}

}  // namespace
