// Device code shared by the blind-rotation entry points (blind_rotate.cu,
// compact.cu, cmux_step.cu, mk_cmux.cu): the per-step rotate/decompose/combos
// kernel, the two int8 dots kernels (single-key leaves and multi-key units,
// one Hopper design in dots_sm90.cuh), and the compact key's expansion
// kernel. Each source that includes this file gets its own copy of the
// kernels (anonymous namespace).
//
// All mod-2^32 arithmetic is done in uint32_t, where wraparound is defined;
// int32_t appears only where signedness is meant (digits, arithmetic
// shifts).

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "dots_sm90.cuh"

// A rotation C entry's sizes and combo table, as ops/blind_rotate.py:
// rotation_launch fills them (its ctypes mirror StepSizes): the batch, K,
// N, the gadget l and b, M = N/T, the digit row's segments of P*T bytes
// (lhs_rows), the key's rows of P*T bytes a step (total_rows), the
// decomposition offset, and n_combos packed words (Params) in host memory,
// which make_params copies into the launches' parameters. A parameter type
// of the C entries, so outside the anonymous namespace.
struct StepSizes {
  int batch, k1, n, l, b, m, lhs_rows, total_rows, offset, n_combos;
  const int32_t* combos;
};

namespace {

constexpr int kT = 128;  // Toeplitz block size
constexpr int kCols = kT / 4;  // four-coefficient columns of a block: a warp
constexpr int kMaxCombos = 64;
constexpr int kMaxRowWarps = 16;  // a rotate/decompose block's warps

// What the rotate/decompose launches take. combos[c] packs one combo write of
// ops/blind_rotate.py:kernel_tables: src_block_mask | two_limb << 16 |
// dst_seg << 17 | hi_seg << 24. It travels in the launch's parameters
// (__grid_constant__), so every thread reads it from the constant cache.
struct Params {
  int batch, k1, n, l, b, m, pt, lhs_stride, cols, offset;
  int n_combos;
  uint32_t combos[kMaxCombos];
};

// The rotate/decompose front half, shared by rotate_decompose_kernel (the
// digit operand of the Karatsuba, compact and multi-key steps) and
// rotate_decompose_dense_kernel (cmux_step.cu): for each ciphertext row,
// ((X^bara - 1) * acc)[j][r] + offset, cut into l signed b-bit digits.
//
// Design, for a function that moves bytes: one block per ciphertext row.
// The row (K*N words) is read from device memory once, by 16-byte
// cp.async copies into shared memory; the rotation's gather then reads that
// staged copy. A warp owns one polynomial j (or one (j, level) item,
// see per_level_items), and lane u4 the coefficients [4*u4, 4*u4 + 4) of
// every block i: it holds the same lanes (j, il, u) of all M blocks in
// registers, so each raw digit and each combo (a sum over masked blocks at
// one lane) is register arithmetic, with no digit buffer and no barrier
// after the staging. Each store is the 4 bytes of 4 consecutive u of one
// (segment, j, il), the warp's 32 lanes on one 128-byte line: every segment
// byte is written once, by full-line stores. Per-level items give a row
// K*l warps (up to 16; more loop) and keep a lane's registers to one
// level's digits; the rotation is then recomputed per level from shared
// memory.
//
// The gather: source word src = (r - s) mod 2N of the doubled polynomial
// [poly, -poly]. For 4 consecutive r the sources are consecutive, at an
// offset o = src & 3 that is the same for the whole warp; the lane reads
// the aligned 16-byte words q = src >> 2 and q + 1 (32 lanes on 32
// consecutive 16-byte words: no bank conflict) and keeps words o..o+3.

// Four words of the doubled polynomial [poly, -poly], from word 4q.
__device__ __forceinline__ uint4 doubled4(const uint4* __restrict__ poly4,
                                          uint32_t q, uint32_t n4) {
  const bool neg = q >= n4;
  uint4 v = poly4[neg ? q - n4 : q];
  if (neg) v = make_uint4(0u - v.x, 0u - v.y, 0u - v.z, 0u - v.w);
  return v;
}

// ((X^s - 1) * poly)[4c .. 4c+3] + offset from the staged polynomial.
__device__ __forceinline__ uint4 rotated_minus4(
    const uint4* __restrict__ poly4, uint32_t n4, uint32_t s, uint32_t c,
    uint32_t offset) {
  const uint32_t src = (4u * c - s) & (8u * n4 - 1u);
  const uint32_t q = src >> 2, o = src & 3u;
  const uint4 lo = doubled4(poly4, q, n4);
  uint4 rot = lo;
  if (o != 0u) {
    const uint4 hi = doubled4(poly4, (q + 1u) & (2u * n4 - 1u), n4);
    if (o == 1u)
      rot = make_uint4(lo.y, lo.z, lo.w, hi.x);
    else if (o == 2u)
      rot = make_uint4(lo.z, lo.w, hi.x, hi.y);
    else
      rot = make_uint4(lo.w, hi.x, hi.y, hi.z);
  }
  const uint4 a = poly4[c];
  return make_uint4(rot.x - a.x + offset, rot.y - a.y + offset,
                    rot.z - a.z + offset, rot.w - a.w + offset);
}

// The signed digit at `shift` in each of the 4 words. The mask keeps only
// bits the shift brought down, so a logical shift gives the same digit as
// the reference's arithmetic one.
__device__ __forceinline__ void cut4(const uint4& w, int shift,
                                     uint32_t mask, int half, int (&d)[4]) {
  d[0] = (int)((w.x >> shift) & mask) - half;
  d[1] = (int)((w.y >> shift) & mask) - half;
  d[2] = (int)((w.z >> shift) & mask) - half;
  d[3] = (int)((w.w >> shift) & mask) - half;
}

// The low bytes of four ints as one little-endian word.
__device__ __forceinline__ uint32_t pack4(int a, int b, int c, int d) {
  return __byte_perm(__byte_perm(a, b, 0x0040), __byte_perm(c, d, 0x0040),
                     0x5410);
}

__device__ __forceinline__ void store4(int8_t* dst, uint32_t word) {
  *reinterpret_cast<uint32_t*>(dst) = word;
}

// A warp's item: one (poly j, level il) from M = 8 blocks on, else one
// poly j and all its levels. Measured on the H100 (PERF.md, PR 6): per-level
// items were faster at M = 8 (more warps a row, fewer registers a lane) and
// slower at M <= 4, where the rotation recomputed per level costs more
// than the level's own work.
__host__ __device__ constexpr bool per_level_items(int m) { return m >= 8; }

// Stage `count` ciphertext rows from `row0` on (K*N words each) into
// rows_s by 16-byte cp.async copies and wait for this thread's copies; the
// caller's barrier makes them visible to the block.
__device__ __forceinline__ void stage_acc_rows(
    const int32_t* __restrict__ acc, int row0, int count, int row16,
    uint4* rows_s) {
  const uint4* src =
      reinterpret_cast<const uint4*>(acc) + (size_t)row0 * row16;
  for (int x = threadIdx.x; x < count * row16; x += blockDim.x) {
    const uint32_t dst = (uint32_t)__cvta_generic_to_shared(rows_s + x);
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
                 "l"(src + x)
                 : "memory");
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// The front half on `count` staged rows (row row0 + r at rows_s + r*K*N/4):
// for every (row, j, il) of the warps' items call back(row, j, il, lane,
// shifted), where shifted(i) gives the lane's four words of block i. The
// block's warps share the items of all the rows.
template <int M, typename Back>
__device__ __forceinline__ void rotate_items(const uint4* __restrict__ rows_s,
                                             const int32_t* __restrict__ bara,
                                             int row0, int count,
                                             const Params& p, Back back) {
  constexpr int n = M * kT, n4 = n / 4;
  const int lane = threadIdx.x & 31;
  const uint32_t offset = (uint32_t)p.offset;
  const int per_row = per_level_items(M) ? p.k1 * p.l : p.k1;
  for (int item = threadIdx.x >> 5; item < count * per_row;
       item += blockDim.x >> 5) {
    const int r = item / per_row, x = item - r * per_row;
    const int row = row0 + r;
    const uint32_t s = (uint32_t)bara[row] & (2u * n - 1u);
    if constexpr (per_level_items(M)) {
      const int j = x / p.l;
      const uint4* poly4 = rows_s + ((size_t)r * p.k1 + j) * n4;
      back(row, j, x - j * p.l, lane, [&](int i) {
        return rotated_minus4(poly4, n4, s, i * kCols + lane, offset);
      });
    } else {
      const uint4* poly4 = rows_s + ((size_t)r * p.k1 + x) * n4;
      uint4 sh[M];
#pragma unroll
      for (int i = 0; i < M; ++i)
        sh[i] = rotated_minus4(poly4, n4, s, i * kCols + lane, offset);
      for (int il = 0; il < p.l; ++il)
        back(row, x, il, lane, [&](int i) { return sh[i]; });
    }
  }
}

// The front half of one block per ciphertext row: stage the block's row,
// then its items.
template <int M, typename Back>
__device__ __forceinline__ void rotate_rows(const int32_t* __restrict__ acc,
                                            const int32_t* __restrict__ bara,
                                            const Params& p, Back back) {
  extern __shared__ __align__(16) uint4 row_s[];
  stage_acc_rows(acc, blockIdx.x, 1, p.k1 * (M * kT / 4), row_s);
  __syncthreads();
  rotate_items<M>(row_s, bara, blockIdx.x, 1, p, back);
}

// Steps 1-4 of a step: the digit operand, per ciphertext lhs_rows segments
// of P*T bytes, [seg][j][level][u]. Segments [0, M) are the raw digits for
// b <= 8; for b > 8 the digits do not fit a byte, every leaf reads
// two-limb combos, and the raw segments are left unwritten (no product
// reads them). Each combo segment is the sum of its masked blocks, one
// int8 limb (wrapped), or lo = ((v & 127) ^ 64) - 64 and hi = (v - lo) / 128.
//
// For b <= 8 a lane's digits travel two to a word: the biased digit
// u = d + 2^(b-1), in [0, 2^b), in each 16-bit half. A combo's sum of up
// to 16 such halves stays below 2^12, so one add serves two lanes without a
// carry between them; the bias comes off, with 4096 added to keep each half
// positive, before the bytes are cut out. For b > 8 (Wide) each lane is an
// int.
//
// store_digits is the back half for one (row, j, il) of a warp: the lane's
// 4 bytes of every raw block and every combo segment.
template <int M, bool Wide, typename Shifted>
__device__ __forceinline__ void store_digits(const Params& p,
                                             int8_t* __restrict__ lhs,
                                             int row, int j, int il, int lane,
                                             Shifted shifted) {
  const uint32_t mask = (1u << p.b) - 1u;
  const int half = 1 << (p.b - 1);
  const int shift = 32 - (il + 1) * p.b;
  int8_t* dst = lhs + (size_t)row * p.lhs_stride +
                (size_t)(j * p.l + il) * kT + 4 * lane;
  if constexpr (Wide) {
    int d[M][4];
#pragma unroll
    for (int i = 0; i < M; ++i) cut4(shifted(i), shift, mask, half, d[i]);
    for (int c = 0; c < p.n_combos; ++c) {
      const uint32_t cw = p.combos[c];
      int v[4] = {0, 0, 0, 0}, hi[4];
#pragma unroll
      for (int i = 0; i < M; ++i) {
        if ((cw >> i) & 1u) {
#pragma unroll
          for (int e = 0; e < 4; ++e) v[e] += d[i][e];
        }
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) {  // the plan makes every combo two-limb
        const int lo = ((v[e] & 127) ^ 64) - 64;  // in [-64, 63]
        hi[e] = (v[e] - lo) >> 7;  // exact: v - lo is 128 * hi
        v[e] = lo;
      }
      store4(dst + (size_t)((cw >> 17) & 127u) * p.pt,
             pack4(v[0], v[1], v[2], v[3]));
      store4(dst + (size_t)((cw >> 24) & 127u) * p.pt,
             pack4(hi[0], hi[1], hi[2], hi[3]));
    }
  } else {
    uint32_t e[M][2];  // biased digits of lanes (0, 1) and (2, 3)
    // u - half, kept positive in each half: its low byte is the digit
    const uint32_t raw_bias = (0x100u - (uint32_t)half) * 0x10001u;
#pragma unroll
    for (int i = 0; i < M; ++i) {
      const uint4 w = shifted(i);
      e[i][0] = __byte_perm((w.x >> shift) & mask, (w.y >> shift) & mask,
                            0x5410);
      e[i][1] = __byte_perm((w.z >> shift) & mask, (w.w >> shift) & mask,
                            0x5410);
      store4(dst + (size_t)i * p.pt,
             __byte_perm(e[i][0] + raw_bias, e[i][1] + raw_bias, 0x6420));
    }
    for (int c = 0; c < p.n_combos; ++c) {
      const uint32_t cw = p.combos[c];
      // v + 4096 in each half: v = sum of u - popc * half
      const uint32_t bias =
          (0x1000u - (uint32_t)__popc(cw & 0xFFFFu) * half) * 0x10001u;
      uint32_t w0 = bias, w1 = bias;
#pragma unroll
      for (int i = 0; i < M; ++i) {
        if ((cw >> i) & 1u) {
          w0 += e[i][0];
          w1 += e[i][1];
        }
      }
      int8_t* out = dst + (size_t)((cw >> 17) & 127u) * p.pt;
      if (!((cw >> 16) & 1u)) {
        store4(out, __byte_perm(w0, w1, 0x6420));
      } else {
        // x = (v & 127) ^ 64, lo = x - 64; hi = (v + 4096 - x + 64) / 128
        // - 32, exact; each half stays in [0, 2^16)
        const uint32_t x0 = (w0 & 0x007F007Fu) ^ 0x00400040u;
        const uint32_t x1 = (w1 & 0x007F007Fu) ^ 0x00400040u;
        const uint32_t h0 = ((w0 - x0 + 0x00400040u) >> 7) & 0x007F007Fu;
        const uint32_t h1 = ((w1 - x1 + 0x00400040u) >> 7) & 0x007F007Fu;
        store4(out, __byte_perm(x0 + 0x00C000C0u, x1 + 0x00C000C0u, 0x6420));
        store4(dst + (size_t)((cw >> 24) & 127u) * p.pt,
               __byte_perm(h0 + 0x00E000E0u, h1 + 0x00E000E0u, 0x6420));
      }
    }
  }
}

template <int M, bool Wide>
__global__ void __launch_bounds__(kMaxRowWarps * 32)
rotate_decompose_kernel(const int32_t* __restrict__ acc,
                        const int32_t* __restrict__ bara_step,
                        int8_t* __restrict__ lhs,
                        const __grid_constant__ Params p) {
  rotate_rows<M>(acc, bara_step, p, [&](int row, int j, int il, int lane,
                                         auto shifted) {
    store_digits<M, Wide>(p, lhs, row, j, il, lane, shifted);
  });
}

// The dots launch of a step (dots_sm90.cuh): one block per unit (work item,
// batch tile of WG x 64 rows) in the order of d.t.items, in clusters of
// d.t.cluster blocks along the batch tile. The two kernels share one body
// and differ in where the key's poly coordinate comes from: a single-key
// step's key holds every output poly k, a multi-key step's operand one (K =
// 1). WG = 1: two blocks an SM where shared memory allows; WG = 2: one
// block an SM (ops/dots.py:row_tile).
template <int WG>
__global__ void __launch_bounds__(dot_threads(WG), WG == 1 ? 2 : 1)
leaf_dots_kernel(const __grid_constant__ CUtensorMap a_map,
                 const __grid_constant__ CUtensorMap b_map,
                 int32_t* __restrict__ acc, const int32_t* __restrict__ products,
                 const int32_t* __restrict__ targets,
                 const int32_t* __restrict__ units, DotsParams p) {
  dots_body<true, false, WG>(&a_map, &b_map, acc, acc, products, targets,
                             OneItem<WG>{units}, p);
}

template <int WG>
__global__ void __launch_bounds__(dot_threads(WG), WG == 1 ? 2 : 1)
mk_unit_dots_kernel(const __grid_constant__ CUtensorMap a_map,
                    const __grid_constant__ CUtensorMap b_map,
                    int32_t* __restrict__ acc,
                    const int32_t* __restrict__ products,
                    const int32_t* __restrict__ targets,
                    const int32_t* __restrict__ units, DotsParams p) {
  dots_body<false, false, WG>(&a_map, &b_map, acc, acc, products, targets,
                              OneItem<WG>{units}, p);
}

// The dots kernels of WG warpgroups a block, and their launch: a block per
// unit, in clusters of d.t.cluster blocks; at d.t.cluster = 1 the launch
// carries no attribute, a plain launch.
template <int WG>
struct DotsKernels {
  // Shared memory past 48 KB needs the opt-in.
  static cudaError_t allow(size_t smem) {
    cudaError_t err = cudaFuncSetAttribute(
        leaf_dots_kernel<WG>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return err;
    return cudaFuncSetAttribute(mk_unit_dots_kernel<WG>,
                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                (int)smem);
  }

  static cudaError_t launch(int32_t* acc, const DotsLaunch& d,
                            bool multi_key, cudaStream_t st) {
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = d.t.cluster;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(d.t.n_items, 1, 1);
    cfg.blockDim = dim3(dot_threads(WG), 1, 1);
    cfg.dynamicSmemBytes = d.smem;
    cfg.stream = st;
    cfg.attrs = attr;
    cfg.numAttrs = d.t.cluster > 1 ? 1 : 0;
    const cudaError_t err = cudaLaunchKernelEx(
        &cfg, multi_key ? mk_unit_dots_kernel<WG> : leaf_dots_kernel<WG>,
        d.a_map, d.b_map, acc, d.t.products, d.t.targets, d.t.items, d.p);
    if (err != cudaSuccess) return err;
    return cudaGetLastError();
  }
};

// Every entry point calls this once before it launches its steps.
inline cudaError_t allow_dots_smem(const DotsLaunch& d) {
  return d.wg == 2 ? DotsKernels<2>::allow(d.smem)
                   : DotsKernels<1>::allow(d.smem);
}

inline cudaError_t launch_dots(int32_t* acc, DotsLaunch& d, int step,
                               bool multi_key, cudaStream_t st) {
  d.p.step = step;
  return d.wg == 2 ? DotsKernels<2>::launch(acc, d, multi_key, st)
                   : DotsKernels<1>::launch(acc, d, multi_key, st);
}

// The expansion of one step's compact limbs int8[4, P, K, 2N] into the
// Karatsuba operand, rows R*P*T (bake row r, key row pj, u) by columns
// K*4*T (poly k, limb, w). For each (r, pj, k) the sums C[j], j < 2T, of
// the doubled words at d*T - T + j (mod 2N) over the blocks d of row r's
// entry mask are split into four balanced bytes, and limb `limb` of the
// Toeplitz block is W[u, w] = C_limb[T + w - u]. KMajor = false writes the
// reference layout int8[R*P*T, K*4*T] (bake_karatsuba's); KMajor = true
// the layout the dots kernels read, int8[K, 4, T, R*P*T]
// (ops/dots.py:to_kmajor). A multi-key step's nonzero blocks
// int8[4, NZ, l, 2N] are the case P = NZ*l, K = 1.
//
// What bounds it: the bytes it writes, R*P*T * K*4*T a step (10.8 MB at
// 128_fast8, 41.3 MB at the 2-party MK party 1), against a few KB of sums.
// The design, for that:
// * One block of 128 threads per unit (r, pj, k, limb): 16 KB of output,
//   so there are 4x as many blocks as units of (r, pj, k) and every SM gets
//   an even share (162 blocks of 64 KB at 128_fast8 left 30 SMs with
//   twice the bytes of the others).
// * The sums: thread q < 64 owns C[4q .. 4q + 3] and reads each plane's 4
//   bytes of a block as one aligned word (d*T - T + 4q is a multiple of 4,
//   and so is 2N). Every unit of (r, pj, k) sums the same words again, a
//   few KB from L1 and L2 beside 16 KB written.
// * The limb's 2T bytes go to shared memory in the order a line reads
//   them. Reference: line (u, limb) is C[T - u .. T - u + 127], forward.
//   K-major: line (limb, w) is C[T + w - u] for u = 0 .. 127, reversed, so
//   the bytes are stored reversed (R[i] = C[2T - 1 - i]) and the line is
//   R[T - 1 - w .. T - 1 - w + 127], forward. A thread writes 16 bytes a
//   store, funnel-shifted out of five aligned words; a warp writes four
//   whole 128-byte lines.
constexpr int kExpandThreads = 128;

template <bool KMajor>
__global__ void __launch_bounds__(kExpandThreads)
expand_kernel(const int8_t* __restrict__ limbs_step,
              const int32_t* __restrict__ entry_masks,
              int8_t* __restrict__ out, int p_rows, int k1, int n) {
  __shared__ __align__(16) uint32_t cw[2 * kT / 4 + 4];  // the limb's bytes
  const int limb = blockIdx.x & 3, k = blockIdx.x >> 2;
  const int pj = blockIdx.y, r = blockIdx.z;
  const int tid = threadIdx.x;

  if (tid < 2 * kT / 4) {
    const uint32_t n2_mask = 2u * (uint32_t)n - 1u;
    const size_t plane = (size_t)p_rows * k1 * 2 * n;  // a limb's plane
    const int8_t* src = limbs_step + ((size_t)pj * k1 + k) * 2 * n;
    const uint32_t mask = (uint32_t)entry_masks[r];
    uint32_t sum[4] = {0u, 0u, 0u, 0u};
    for (uint32_t bits = mask; bits; bits &= bits - 1) {
      const int d = __ffs(bits) - 1;
      const uint32_t idx = ((uint32_t)(d * kT - kT + 4 * tid)) & n2_mask;
#pragma unroll
      for (int pl = 0; pl < 4; ++pl) {
        const uint32_t x =
            *reinterpret_cast<const uint32_t*>(src + pl * plane + idx);
#pragma unroll
        for (int e = 0; e < 4; ++e)  // sign-extended bytes, mod 2^32
          sum[e] += (uint32_t)(int32_t)(int8_t)(x >> (8 * e)) << (8 * pl);
      }
    }
    uint32_t word = 0u;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      uint32_t cur = sum[e];
      for (int x = 0; x < limb; ++x) {  // drop the lower balanced limbs
        const int32_t lo = (int32_t)((cur & 255u) ^ 128u) - 128;
        cur = (uint32_t)((int32_t)(cur - (uint32_t)lo) >> 8);
      }
      word |= (cur & 255u) << (8 * e);  // the balanced byte's bits
    }
    if (KMajor)
      cw[2 * kT / 4 - 1 - tid] = __byte_perm(word, 0u, 0x0123);
    else
      cw[tid] = word;
  } else if (tid < 2 * kT / 4 + 4) {
    cw[tid] = 0u;  // read (shifted out) by the last line's fifth word
  }
  __syncthreads();

  const size_t rows = (size_t)gridDim.z * p_rows * kT;  // R*P*T
  const size_t row0 = ((size_t)r * p_rows + pj) * kT;   // the unit's first
#pragma unroll
  for (int i = 0; i < kT * kT / 16 / kExpandThreads; ++i) {
    const int x = tid + i * kExpandThreads;
    const int line = x >> 3, v = x & 7;  // 8 stores of 16 bytes a line
    const int start = (KMajor ? kT - 1 - line : kT - line) + 16 * v;
    const uint32_t* src = cw + (start >> 2);
    const uint32_t sh = 8u * (uint32_t)(start & 3);
    uint4 o;
    o.x = __funnelshift_r(src[0], src[1], sh);
    o.y = __funnelshift_r(src[1], src[2], sh);
    o.z = __funnelshift_r(src[2], src[3], sh);
    o.w = __funnelshift_r(src[3], src[4], sh);
    int8_t* dst;
    if (KMajor)  // [k][limb][w = line][row0 + u]
      dst = out + (((size_t)k * 4 + limb) * kT + line) * rows + row0 + 16 * v;
    else  // [row0 + u = line][k][limb][w]
      dst = out + (row0 + line) * ((size_t)k1 * 4 * kT) +
            ((size_t)k * 4 + limb) * kT + 16 * v;
    *reinterpret_cast<uint4*>(dst) = o;
  }
}

inline cudaError_t launch_expand(const int8_t* limbs_step,
                                 const int32_t* entry_masks, int8_t* out,
                                 int total_rows, int p_rows, int k1, int n,
                                 bool kmajor, cudaStream_t st) {
  const dim3 grid(4 * k1, p_rows, total_rows);
  if (kmajor)
    expand_kernel<true><<<grid, kExpandThreads, 0, st>>>(
        limbs_step, entry_masks, out, p_rows, k1, n);
  else
    expand_kernel<false><<<grid, kExpandThreads, 0, st>>>(
        limbs_step, entry_masks, out, p_rows, k1, n);
  return cudaGetLastError();
}

// The rotate/decompose launches' shape: one block per ciphertext row, one
// warp per item (at most kMaxRowWarps), the row staged in shared memory.
inline int row_threads(const Params& p) {
  const int items = per_level_items(p.m) ? p.k1 * p.l : p.k1;
  return 32 * (items < kMaxRowWarps ? items : kMaxRowWarps);
}

inline size_t row_smem(const Params& p) { return (size_t)p.k1 * p.n * 4; }

// Launch kernel<M> for the step's M (1 to 16 blocks), with the opt-in to
// more than 48 KB of staged rows where a row needs it.
template <template <int> class Launch, typename... Args>
inline cudaError_t launch_by_m(const Params& p, Args... args) {
  switch (p.m) {
    case 1: return Launch<1>::run(p, args...);
    case 2: return Launch<2>::run(p, args...);
    case 4: return Launch<4>::run(p, args...);
    case 8: return Launch<8>::run(p, args...);
    case 16: return Launch<16>::run(p, args...);
    default: return cudaErrorInvalidValue;
  }
}

template <int M>
struct RotateDecompose {
  static cudaError_t run(const Params& p, const int32_t* acc,
                         const int32_t* bara_step, int8_t* lhs,
                         cudaStream_t st) {
    auto kernel = p.b > 8 ? rotate_decompose_kernel<M, true>
                          : rotate_decompose_kernel<M, false>;
    const size_t smem = row_smem(p);
    if (smem > 48 * 1024) {
      cudaError_t err = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
      if (err != cudaSuccess) return err;
    }
    kernel<<<p.batch, row_threads(p), smem, st>>>(acc, bara_step, lhs, p);
    return cudaGetLastError();
  }
};

inline cudaError_t launch_rotate_decompose(const int32_t* acc,
                                           const int32_t* bara_step,
                                           int8_t* lhs, const Params& p,
                                           cudaStream_t st) {
  return launch_by_m<RotateDecompose>(p, acc, bara_step, lhs, st);
}

// One CMUX step: the rotate/decompose/combos launch, then the dots launch
// (step `step` of the dots' key map), which adds into acc in place. Returns
// the first launch error.
inline cudaError_t launch_step(int32_t* acc, DotsLaunch& dots, int step,
                               bool multi_key, const int32_t* bara_step,
                               int8_t* lhs, const Params& p,
                               cudaStream_t st) {
  cudaError_t err = launch_rotate_decompose(acc, bara_step, lhs, p, st);
  if (err != cudaSuccess) return err;
  return launch_dots(acc, dots, step, multi_key, st);
}

// The launches' parameters from an entry's sizes; the combos are copied
// in. Returns cudaErrorInvalidValue for more than kMaxCombos combos.
inline cudaError_t make_params(Params& p, const StepSizes& s) {
  if (s.n_combos < 0 || s.n_combos > kMaxCombos) return cudaErrorInvalidValue;
  p.batch = s.batch;
  p.k1 = s.k1;
  p.n = s.n;
  p.l = s.l;
  p.b = s.b;
  p.m = s.m;
  p.pt = s.k1 * s.l * kT;
  p.lhs_stride = s.lhs_rows * p.pt;
  p.cols = s.k1 * 4 * kT;
  p.offset = s.offset;
  p.n_combos = s.n_combos;
  for (int c = 0; c < kMaxCombos; ++c)
    p.combos[c] = c < s.n_combos ? (uint32_t)s.combos[c] : 0u;
  return cudaSuccess;
}

// The dots launches of an entry: its tables t, the digit rows lhs
// (p.lhs_stride bytes a row) against `key`, n_steps steps of key_rows
// contraction rows for key_k1 output polys each; a product's pieces are
// a_stride and b_stride bytes apart (0: one piece).
inline cudaError_t make_dots(DotsLaunch& d, const DotsArgs& t,
                             const Params& p, const int8_t* lhs,
                             const int8_t* key, int key_rows, int key_k1,
                             int n_steps, int a_stride = 0,
                             int b_stride = 0) {
  if (t.row_tile != kDotRows && t.row_tile != 2 * kDotRows)
    return cudaErrorInvalidValue;
  d.wg = t.row_tile / kDotRows;
  const int tiles = (p.batch + t.row_tile - 1) / t.row_tile;
  if ((t.cluster != 1 && t.cluster != 2) || tiles % t.cluster)
    return cudaErrorInvalidValue;
  d.t = t;
  cudaError_t err = make_lhs_map(&d.a_map, lhs, p.batch, p.lhs_stride,
                                 t.row_tile);
  if (err != cudaSuccess) return err;
  err = make_key_map(&d.b_map, key, key_rows, key_k1, n_steps);
  if (err != cudaSuccess) return err;
  d.p.batch = p.batch;
  d.p.k1 = p.k1;
  d.p.n = p.n;
  d.p.m = p.m;
  d.p.a_stride = a_stride;
  d.p.b_stride = b_stride;
  d.p.stages = t.stages;
  d.p.step = 0;
  d.smem = dots_smem_bytes(t.stages, p.m, d.wg);
  return cudaSuccess;
}

}  // namespace
