// The int8 dots of a CMUX step on Hopper (sm_90a): one design for the
// single-key leaf dots (leaf_dots_kernel) and the multi-key unit dots
// (mk_unit_dots_kernel), both in cmux_kernels.cuh.
//
// Replaces the dots of the TPU kernels of tfhe_tpu/ops/pallas_cmux.py:
// _leaf_dots_core (the baked, compact and dense rotations, the dense step's
// _cmux_matmul_kernel) and _unit_dots_body (the three multi-key kernels).
//
// What a launch computes. The step's digit operand lhs int8[B, lhs_stride]
// (written by rotate_decompose_kernel, or the dense step's digits) and the
// step's key operand, K-major: int8[K, 4, T, rows], row = contraction byte,
// for every output column (poly k, limb, coefficient w) the `rows`
// contraction bytes contiguous (ops/dots.py:to_kmajor; the multi-key operand
// is the case K = 1). A product is
//   P = sum over pieces i < npieces of
//       lhs[:, a_off + i*a_stride : + chunks*128] .
//       key[k, :, :, b_off + i*b_stride : + chunks*128]
// and it has a list of targets (output block posm, sign): acc[:, k, posm*T :
// posm*T + T] += sign * 2^shift * recombine(P), recombine = the four key
// limbs' sums << 8*limb, all mod 2^32. The tables come from
// ops/blind_rotate.py:product_tables, ops/mk_cmux.py:mk_product_tables and
// ops/cmux_step.py:dense_product_tables, encoded by ops/dots.py; no product
// appears twice, so each is computed once whatever number of output blocks
// it feeds.
//
// Who owns what. A block owns a work item: one column tile (output poly k,
// 32 coefficients wt*32 .. wt*32+31, all four limbs: the wgmma N = 128) and
// one batch tile of WG x 64 rows, for ALL M output blocks, and a
// contiguous range of the products of its column (single-key: every
// product serves every k; multi-key: the products of output column k). Its
// WG consumer warpgroups own 64 rows each (the wgmma M). Each keeps one
// word sum per (output block, row, coefficient) it owns in shared memory
// (M x 8 KB a warpgroup), and at the end adds each sum into acc once.
//
// Which tile (ops/dots.py:row_tile, from M and the batch alone). WG = 2,
// 128 rows, where the 64-row block is alone on its SM anyway (M = 8: its
// 6-slot ring and 64 KB of sums take 208 KB), two warpgroups' sums (128
// KB) fit beside a ring of 3 slots of 32 KB (229,424 bytes of the 232,448
// a block may opt in to), and the batch has more than one 64-row tile:
// the single-key presets at N = 1024 and every multi-key preset past batch
// 64. The two warpgroups read each key tile once between them, so L2 feeds
// 16 KB per 1 M multiply-adds instead of 24, and one warpgroup's queued
// products keep the tensor cores busy while the other drains its pipeline
// and adds its epilogue. WG = 1 everywhere else: M <= 4, where two 64-row
// blocks share an SM and hide each other's drains (128_fast); M = 16,
// where two warpgroups' sums leave no 3-slot ring; batches of one 64-row
// tile; and the fused step (fused_step.cu), whose units are 64-row tiles.
//
// Enough blocks. Owning all M output blocks shrinks the grid M-fold (8
// parties at B = 256: 144 blocks of 64 rows). The tile stays N = 128 wide
// (a narrower N would reload the digit tile more often per operation);
// instead ops/dots.py:work_items cuts a column's product list into ranges
// wherever the grid would hold less than two waves of resident 64-row
// warpgroups (a 128-row block counts as two), or one column has far more
// products than the others (the last multi-key parties): 8 parties at B =
// 256 run 144-176 blocks of 128 rows, the 80-bit preset at B = 256 144; no
// B = 4096 shape is cut. The items of a cut column add with
// red.global.add: integer adds mod 2^32 give the same words in any order.
// A launch runs its blocks' units (item, batch tile) in the order of a
// table (ops/dots.py:launch_order): the heaviest items first over all
// batch tiles, so that no heavy block starts last (the 2-party key's party
// 1 has 8 items of 540 slots and 4 of 180).
//
// How it is fed. Warps 0 .. 4*WG-1 are the consumer warpgroups; warpgroup
// g runs wgmma.mma_async m64n128k32 s32.s8.s8 (no .satfinite: sums wrap
// mod 2^32 like the reference's int32) on rows 64g .. 64g+63 of the digit
// tile and the whole key tile, both in shared memory. Warp 4*WG is the
// producer, one thread of which keeps TMA loads (cp.async.bulk.tensor,
// 128-byte swizzle) of the digit tile [WG*64 rows x 128 bytes] and the key
// tile [128 columns x 128 bytes] in flight through a ring of `stages` >= 3
// slots, each with a `full` and an `empty` mbarrier; a slot is free again
// once all 4*WG consumer warps have arrived. Rows past the batch are
// zero-filled by TMA (the digit map's outer extent is the batch) and never
// written, a whole warpgroup's in a batch's last tile included. The key
// tile arrives K-major, as wgmma reads 8-bit operands: no transpose on the
// card.
//
// Clusters. Where a launch's batch tiles pair up it runs as thread-block
// clusters of C = 2 blocks along the batch tile (ops/dots.py:cluster_size;
// C = 1 is a plain launch, cmux_kernels.cuh:launch_dots). The two blocks of
// a cluster run one work item on neighbouring tiles and read the same key
// tiles in the same order, and they are scheduled at once on one GPC. The
// body does not know of the cluster: each block loads its whole slots.
//
// What bounds it (an H100 80GB HBM3 at 700 W, the batch-4096 shapes of the
// benchmark; PERF.md): every product is computed once (executed = useful
// operations). In 64-row blocks, one an SM at M = 8, the executed work ran
// at 37-39% of the int8 peak in clusters of 2, with L2 feeding 24 KB per 1
// M multiply-adds (8.6 TB/s); with no key feed at all (a timing-only
// variant) at 41-43%, the rest of the time inside the block (the
// pipeline's drain and the epilogue of each product); at M = 2, two blocks
// an SM, 40%. The 128-row block runs the cggi128 leaf dots and both
// parties' unit dots of the 2-party key at 48-50% (0.335 -> 0.267 ms a
// cggi128 step; 0.489 -> 0.395 and 0.901 -> 0.685 ms the two parties' MK
// steps), with L2 feeding 16 KB per 1 M at 7.5 TB/s: below the 64-row
// block's 8.6, so the feed's bandwidth does not bound it yet.

#pragma once

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

// The dots tables of a C entry's launches, as ops/dots.py:dots_args fills
// them (its ctypes mirror dots.DotsArgs): the product and target rows and
// the blocks' units (n_items rows: a work item of one batch tile each, in
// launch order) on the device, the ring's slots, the blocks of a cluster
// along the batch tile (1 or 2), and the batch rows a block owns (64 or
// 128). A parameter type of the C entries, so outside the anonymous
// namespace.
struct DotsArgs {
  const int32_t *products, *targets, *items;
  int n_items, stages, cluster, row_tile;
};

namespace {

constexpr int kDotRows = 64;               // a warpgroup's rows: wgmma M
constexpr int kDotW = 32;                  // coefficients per column tile
constexpr int kDotN = 4 * kDotW;           // wgmma N: 4 limbs x kDotW
constexpr int kChunk = 128;                // contraction bytes per ring slot
constexpr int kATile = kDotRows * kChunk;  // 8 KB: a warpgroup's digit tile
constexpr int kBTile = kDotN * kChunk;     // 16 KB: the key tile
constexpr int kProductInts = 8;            // ints per product row
constexpr int kItemInts = 4;               // ints per work item row
constexpr int kUnitInts = 5;               // a work item row and its tile

// A block of WG consumer warpgroups (its batch tile is WG x 64 rows): a
// ring slot holds the digit tile of all its rows and one key tile, and its
// threads are the warpgroups and the producer warp.
__host__ __device__ constexpr int dot_slot_bytes(int wg) {
  return wg * kATile + kBTile;
}
__host__ __device__ constexpr int dot_threads(int wg) { return 128 * wg + 32; }

struct DotsParams {
  int batch, k1, n, m;
  int a_stride, b_stride;  // bytes between a product's pieces
  int stages;              // ring slots
  int step;                // the key map's step coordinate
};

// --- PTX wrappers ---

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive_expect_tx(uint32_t bar,
                                                      uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ uint64_t global_ns() {
  uint64_t t;
  asm volatile("mov.u64 %0, %%globaltimer;\n" : "=l"(t));
  return t;
}

// Waits until the phase of parity `parity` has completed. A wait that
// lasts seconds means a fault in the ring (a lost arrival or a transfer
// that never lands): trap, so the launch fails instead of hanging.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  uint64_t t0 = 0;
  for (int spin = 0;; ++spin) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if (spin == 0) {
      t0 = global_ns();
    } else if ((spin & 1023) == 0 && global_ns() - t0 > 4000000000ull) {
      __trap();
    }
  }
}

__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.tile"
      ".mbarrier::complete_tx::bytes [%0], [%1, {%2, %3}], [%4];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void tma_load_5d(uint32_t dst, const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1,
                                            int c2, int c3, int c4) {
  asm volatile(
      "cp.async.bulk.tensor.5d.shared::cluster.global.tile"
      ".mbarrier::complete_tx::bytes [%0], [%1, {%2, %3, %4, %5, %6}], [%7];\n"
      ::"r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1),
      "r"(c2), "r"(c3), "r"(c4), "r"(bar)
      : "memory");
}

// The wgmma descriptor of a K-major tile of 128-byte rows in the 128-byte
// swizzle, 8-row groups 1024 bytes apart (the layout TMA writes with
// CU_TENSOR_MAP_SWIZZLE_128B into a 1024-byte aligned slot). Advancing the
// contraction by 32 bytes inside the row adds 2 to the start address field.
__device__ __forceinline__ uint64_t kmajor_sw128_desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

#define TFHE_R8(i)                                                   \
  "+r"(d[i]), "+r"(d[i + 1]), "+r"(d[i + 2]), "+r"(d[i + 3]),        \
      "+r"(d[i + 4]), "+r"(d[i + 5]), "+r"(d[i + 6]), "+r"(d[i + 7])

// d (+)= A[64 x 32 bytes] . B[32 bytes x 128], int8 in, int32 out, the
// accumulator in the wgmma fragment layout: d[4*j + 2*h + e] is row
// warp*16 + lane/4 + 8*h, column 8*j + 2*(lane%4) + e. scale_d = 0 writes
// the product instead of adding it.
__device__ __forceinline__ void wgmma_m64n128k32_s8(int (&d)[64], uint64_t da,
                                                    uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, "
      "%43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, "
      "%57, %58, %59, %60, %61, %62, %63}, %64, %65, p;\n}\n"
      : TFHE_R8(0), TFHE_R8(8), TFHE_R8(16), TFHE_R8(24), TFHE_R8(32),
        TFHE_R8(40), TFHE_R8(48), TFHE_R8(56)
      : "l"(da), "l"(db), "r"(scale_d));
}

#undef TFHE_R8

// --- the kernel body ---

// A dots launch's block runs one unit: a work item of one batch tile of
// WG x 64 rows, the row units[blockIdx.x] = (k*4 + wt, first product, end
// product, atomic, batch tile), in the launch order of
// ops/dots.py:launch_order. Other bodies hand dots_body a policy of the
// same shape for their own units (fused_step.cu).
template <int WG>
struct OneItem {
  const int32_t* units;
  __device__ int count() const { return 1; }
  __device__ const int32_t* item(int) const {
    return units + (size_t)kUnitInts * blockIdx.x;
  }
  __device__ int row0(int) const {
    return units[(size_t)kUnitInts * blockIdx.x + 4] * WG * kDotRows;
  }
  __device__ void wait(int) const {}  // the producer's wait for the A rows
};

// The block's units u < units.count(), each a work item (units.item(u))
// of the batch tile of WG x 64 rows from units.row0(u) on (see the file
// comment), one after another through one ring; consumer warpgroup g owns
// the tile's rows 64g .. 64g + 63 and its own word sums. `items` rows are
// (k*4 + wt, first product, end product, atomic); `products` rows are
// (a_off, b_off, npieces, chunks, shift, first target, end target, 0);
// `targets` rows are (posm, sign). PolyKey: the key holds every output
// poly and the item's k picks it (single-key); else the key has one poly
// (multi-key, K = 1) and k only picks acc's column. Fresh: every word of
// the unit's column tile, all M output blocks, is written once to out =
// acc + sums (the fused step: out is another buffer, and no other block
// owns the tile); else the touched blocks' sums are added into acc in
// place (out == acc), with atomics for a cut column. The producer calls
// units.wait(u) before it loads unit u's first tiles.
template <bool PolyKey, bool Fresh, int WG, typename Units>
__device__ __forceinline__ void dots_body(
    const CUtensorMap* a_map, const CUtensorMap* b_map,
    const int32_t* acc, int32_t* out, const int32_t* __restrict__ products,
    const int32_t* __restrict__ targets, const Units& units,
    const DotsParams& p) {
  constexpr int kSlot = dot_slot_bytes(WG);
  extern __shared__ __align__(1024) uint8_t dots_smem[];
  uint8_t* ring = dots_smem;  // stages x (A tile, B tile), 1024-aligned
  uint32_t* sums0 = reinterpret_cast<uint32_t*>(ring + p.stages * kSlot);
  uint64_t* bars = reinterpret_cast<uint64_t*>(sums0 + WG * p.m * 16 * 128);
  const uint32_t full0 = smem_u32(bars);
  const uint32_t empty0 = smem_u32(bars + p.stages);
  const uint32_t ring0 = smem_u32(ring);

  if (threadIdx.x == 0) {
    if (ring0 & 1023u) __trap();  // the swizzle needs 1024-aligned slots
    for (int s = 0; s < p.stages; ++s) {
      mbar_init(full0 + 8 * s, 1);  // the producer's expect_tx arrival
      mbar_init(empty0 + 8 * s, 4 * WG);  // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  }
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (warp >= 4 * WG) {  // producer: one thread issues every load; warps
                         // past it (a fused block's phase-1 helpers) leave
    if (warp == 4 * WG && lane == 0) {
      int slot = 0;
      uint32_t phase = 0;
      for (int u = 0; u < units.count(); ++u) {
        const int32_t* item = units.item(u);
        const int row0 = units.row0(u);
        const int key_k = PolyKey ? item[0] >> 2 : 0;
        const int wt = item[0] & 3;
        units.wait(u);
        for (int pi = item[1]; pi < item[2]; ++pi) {
          const int32_t* pr = products + (size_t)kProductInts * pi;
          for (int i = 0; i < pr[2]; ++i) {
            const int a0 = pr[0] + i * p.a_stride;
            const int b0 = pr[1] + i * p.b_stride;
            for (int c = 0; c < pr[3]; ++c) {
              mbar_wait(empty0 + 8 * slot, phase ^ 1u);
              const uint32_t full = full0 + 8 * slot;
              const uint32_t a_dst = ring0 + slot * kSlot;
              mbar_arrive_expect_tx(full, kSlot);
              tma_load_2d(a_dst, a_map, full, a0 + c * kChunk, row0);
              tma_load_5d(a_dst + WG * kATile, b_map, full, b0 + c * kChunk,
                          wt * kDotW, 0, key_k, p.step);
              if (++slot == p.stages) {
                slot = 0;
                phase ^= 1u;
              }
            }
          }
        }
      }
    }
    return;
  }

  // consumer warpgroup g: threads 128g .. 128g + 127; each owns one
  // column of its warpgroup's `sums`, so an item's sums need no barrier
  // between items, and the warpgroups run apart but for the ring
  const int g = threadIdx.x / 128, tid = threadIdx.x % 128;
  uint32_t* sums = sums0 + (size_t)g * p.m * 16 * 128;
  int slot = 0;
  uint32_t phase = 0;
  int d[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) d[i] = 0;
  for (int u = 0; u < units.count(); ++u) {
    const int32_t* item = units.item(u);
    const int row0 = units.row0(u);
    const int k = item[0] >> 2, wt = item[0] & 3;
    const bool atomic = item[3] != 0;
    for (int x = 0; x < p.m * 16; ++x) sums[x * 128 + tid] = 0u;
    uint32_t touched = 0u;
    for (int pi = item[1]; pi < item[2]; ++pi) {
      const int32_t* pr = products + (size_t)kProductInts * pi;
      const int n_slots = pr[2] * pr[3];
      int prev = -1;
      for (int c = 0; c < n_slots; ++c) {
        mbar_wait(full0 + 8 * slot, phase);
        const uint32_t a_addr = ring0 + slot * kSlot;
        const uint64_t da = kmajor_sw128_desc(a_addr + g * kATile);
        const uint64_t db = kmajor_sw128_desc(a_addr + WG * kATile);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kChunk / 32; ++kk)
          wgmma_m64n128k32_s8(d, da + 2 * kk, db + 2 * kk,
                              (c == 0 && kk == 0) ? 0 : 1);
        wgmma_commit();
        wgmma_wait<1>();  // the previous slot's products are done
        if (prev >= 0 && lane == 0) mbar_arrive(empty0 + 8 * prev);
        prev = slot;
        if (++slot == p.stages) {
          slot = 0;
          phase ^= 1u;
        }
      }
      wgmma_wait<0>();
      if (lane == 0) mbar_arrive(empty0 + 8 * prev);

      // limb recombination in registers: words[(h*4 + j)*2 + e]
      uint32_t words[16];
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            uint32_t w = 0u;
#pragma unroll
            for (int limb = 0; limb < 4; ++limb)
              w += (uint32_t)d[(limb * 4 + j) * 4 + 2 * h + e] << (8 * limb);
            words[(h * 4 + j) * 2 + e] = w << pr[4];
          }
      for (int ti = pr[5]; ti < pr[6]; ++ti) {
        const int posm = targets[2 * ti];
        const uint32_t sign = (uint32_t)targets[2 * ti + 1];
        touched |= 1u << posm;
        uint32_t* s = sums + (size_t)posm * 16 * 128 + tid;
#pragma unroll
        for (int x = 0; x < 16; ++x) s[x * 128] += sign * words[x];
      }
    }

    // each sum into acc (or out) once: rows past the batch (a whole
    // warpgroup's, in a batch's last tile) are never written
    const int r_base = row0 + g * kDotRows + (warp % 4) * 16 + lane / 4;
    const int w_base = wt * kDotW + 2 * (lane % 4);
    for (int posm = 0; posm < p.m; ++posm) {
      if (!Fresh && !((touched >> posm) & 1u)) continue;
      const uint32_t* s = sums + (size_t)posm * 16 * 128 + tid;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = r_base + 8 * h;
        if (row >= p.batch) continue;
        const size_t at0 = ((size_t)row * p.k1 + k) * p.n + posm * 128;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const size_t at = at0 + w_base + j * 8;
          const uint32_t w0 = s[((h * 4 + j) * 2 + 0) * 128];
          const uint32_t w1 = s[((h * 4 + j) * 2 + 1) * 128];
          if (!Fresh && atomic) {
            atomicAdd(reinterpret_cast<unsigned int*>(out + at), w0);
            atomicAdd(reinterpret_cast<unsigned int*>(out + at + 1), w1);
          } else {
            uint2 v = *reinterpret_cast<const uint2*>(acc + at);
            v.x += w0;
            v.y += w1;
            *reinterpret_cast<uint2*>(out + at) = v;
          }
        }
      }
    }
  }
}

// --- host side: tensor maps and the launch ---

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType,
                                  cuuint32_t, void*, const cuuint64_t*,
                                  const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave,
                                  CUtensorMapSwizzle, CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled looked up through the runtime's entry-point query:
// no link against libcuda.
inline EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (!fn) {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &ptr, 12000,
                                     cudaEnableDefault, &found);
#else
    cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &ptr, cudaEnableDefault,
                            &found);
#endif
    if (found == cudaDriverEntryPointSuccess) fn = (EncodeTiledFn)ptr;
  }
  return fn;
}

// The digit operand int8[batch, stride]: boxes of `rows` rows (a block's
// batch tile) x 128 bytes.
inline cudaError_t make_lhs_map(CUtensorMap* map, const int8_t* lhs,
                                int batch, int stride, int rows) {
  EncodeTiledFn fn = encode_tiled();
  if (!fn) return cudaErrorNotSupported;
  const cuuint64_t dims[2] = {(cuuint64_t)stride, (cuuint64_t)batch};
  const cuuint64_t strides[1] = {(cuuint64_t)stride};
  const cuuint32_t box[2] = {kChunk, (cuuint32_t)rows};
  const cuuint32_t one[2] = {1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, (void*)lhs,
                        dims, strides, box, one, CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// A K-major key int8[n_steps, k1, 4, T, rows]: boxes of 128 contraction
// bytes x (kDotW coefficients x 4 limbs) of one poly of one step.
inline cudaError_t make_key_map(CUtensorMap* map, const int8_t* key,
                                int rows, int k1, int n_steps) {
  EncodeTiledFn fn = encode_tiled();
  if (!fn) return cudaErrorNotSupported;
  const cuuint64_t r = (cuuint64_t)rows;
  const cuuint64_t dims[5] = {r, 128, 4, (cuuint64_t)k1,
                              (cuuint64_t)n_steps};
  const cuuint64_t strides[4] = {r, r * 128, r * 512, r * 512 * k1};
  const cuuint32_t box[5] = {kChunk, kDotW, 4, 1, 1};
  const cuuint32_t one[5] = {1, 1, 1, 1, 1};
  const CUresult res = fn(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 5, (void*)key,
                          dims, strides, box, one,
                          CU_TENSOR_MAP_INTERLEAVE_NONE,
                          CU_TENSOR_MAP_SWIZZLE_128B,
                          CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                          CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// A block's dynamic shared memory (ops/dots.py:smem_bytes): the ring, each
// warpgroup's M blocks' sums, the barriers.
inline size_t dots_smem_bytes(int stages, int m, int wg) {
  return (size_t)stages * dot_slot_bytes(wg) + (size_t)wg * m * 16 * 128 * 4 +
         (size_t)2 * stages * 8;
}

// Everything a step's dots launch needs besides acc and the step index;
// wg consumer warpgroups a block.
struct DotsLaunch {
  CUtensorMap a_map, b_map;
  DotsParams p;
  DotsArgs t;
  int wg;
  size_t smem;
};

}  // namespace
