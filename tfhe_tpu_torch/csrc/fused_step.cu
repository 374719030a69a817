// One fused block-Karatsuba CMUX step for Hopper (sm_90a), in one launch.
//
// Replaces the TPU kernel tfhe_tpu/ops/pallas_cmux.py:
//   _fused_karatsuba_kernel (entry cmux_step_pallas_karatsuba).
//
// What it computes (acc int32[B, K, N]; key_step int8[K, 4, T, R*P*T], one
// step of the Karatsuba-baked key in the K-major layout every baked key has
// on the card (ops/dots.py:to_kmajor); bara int32[B] -> out int32[B, K, N],
// acc not modified): out = acc + key_step (x) [(X^bara - 1) * acc], the
// seven steps of blind_rotate.cu for a single step. It is built from the
// two bodies the whole-rotation kernels run, inside one launch:
//   phase 1, the rotate/decompose front half (cmux_kernels.cuh:
//     rotate_items + store_digits): rotate, subtract, add the offset, cut l
//     digits, form the Karatsuba combos, written as digit rows into `lhs`,
//     a scratch buffer of B x lhs_rows*P*T bytes;
//   phase 2, the dots body (dots_sm90.cuh:dots_body, Fresh): wgmma
//     m64n128k32 s8 over TMA tiles of those digit rows and of the K-major
//     key step, each distinct product once, limb recombination, the
//     z^M = -1 fold, and out = acc + sums.
//
// Who owns what. The grid is persistent: as many blocks as the card holds
// at once (2 an SM up to M = 4, 1 at M = 8), launched cooperatively so
// that all of them are resident; a block is the dots' 5 warps and more for
// phase 1 (fused_threads). Phase 1: the batch is cut into groups of
// kGroupRows = 16 rows (a quarter of a 64-row batch tile); block i forms
// groups i, i + G, ... and after each one adds 1 to its tile's counter in
// `ready` (int32[tiles], zeroed before the launch). Phase 2: the units are
// the (batch tile, column tile) pairs, column tile = (poly k, 32
// coefficients, all four limbs), tiles x K*4 of them (1,280 at 128_fast,
// B = 4096); block i runs units i, i + G, ..., each over every product,
// and writes each word of the unit's tile once (no atomics). Before a
// unit's first TMA load the producer waits until its tile's counter holds
// all the tile's groups. Each digit is formed once, and the digit rows stay
// in L2 between the phases.
//
// Why this design (measured on an NVIDIA H100 80GB HBM3, 700 W; PERF.md,
// PR 7): a first design gave each 64-row batch tile a thread-block
// cluster of 4 blocks (rows and column tiles shared among the members, a
// cluster barrier between the phases). The card held fewer such clusters
// at once than the 64 tiles of B = 4096, so the tiles ran in two waves up
// to M = 4 and three at M = 8, slower than the two-launch step. The units
// of the persistent grid spread over one wave within 3% (1,280 units on
// 264 blocks at 128_fast, 512 on 132 at N = 1024). Digits of a 64-row
// tile do not fit one SM's shared memory beyond 128_fast (160 KB of raw
// digits at 128_fast, 512 KB at the 80-bit preset, against 227 KB), and
// forming A tiles from acc for each chunk would re-read 64 KB or more of
// acc per 16 KB key tile.
//
// Hazards, and what the code does about them:
// * The digit rows are stored by the generic proxy and read by TMA, the
//   async proxy of other blocks: every writing thread issues
//   fence.proxy.async.global and __threadfence() after its stores, the
//   block barrier gathers them, and one thread then adds to the tile's
//   counter; the producer reads the counter with ld.acquire.gpu and fences
//   the proxies again before its TMA loads.
// * Blocks wait on each other, so all must be resident: the launch is
//   cooperative (cudaLaunchKernelEx with the cooperative attribute fails
//   rather than oversubscribe), sized by the occupancy query.
// * Rows past the batch are never formed and never written: the digit
//   map's outer extent is the batch, so TMA reads zeros for them.
// * out is a new buffer and acc is only read: a row's rotation reads the
//   whole input row, and the dots' epilogue reads acc beside its sums.
// * Phase 1 stages rows in the shared memory the ring and the sums use
//   later; the block barrier after phase 1 and the mbarrier initialisation
//   with its proxy fence (in dots_body) separate the two uses.
//
// What bounds it on the H100: int8 tensor-core work, as blind_rotate.cu,
// plus phase 1, which the dots do not hide: every block forms its groups
// before it runs a unit.

#include "cmux_kernels.cuh"

namespace {

constexpr int kGroupRows = 16;  // rows a block forms at once
constexpr int kTileGroups = kDotRows / kGroupRows;  // groups of a tile

// A block's threads: the dots' consumer warpgroup and producer warp, and
// more warps for phase 1 (they leave when phase 2 starts), as many as the
// registers of the blocks an SM holds allow: 2 blocks of 7 warps (146
// registers a thread) up to M = 4, 1 block of 12 warps (170) at M = 8.
template <int M>
constexpr int fused_threads() {
  return M >= 8 ? 384 : 224;
}
template <int M>
constexpr int fused_blocks_per_sm() {
  return M >= 8 ? 1 : 2;
}

__device__ __forceinline__ void fence_proxy_async_global() {
  asm volatile("fence.proxy.async.global;\n" ::: "memory");
}

__device__ __forceinline__ int load_acquire(const int* p) {
  int v;
  asm volatile("ld.acquire.gpu.global.b32 %0, [%1];\n"
               : "=r"(v)
               : "l"(p)
               : "memory");
  return v;
}

// Phase 2's units for dots_body: (batch tile, column tile) pairs, units
// first, first + stride, ... < total, column tile fastest.
struct FusedUnits {
  const int32_t* items;  // one row per column tile: (k*4 + wt, 0, n, 0)
  const int* ready;      // per batch tile, the groups formed so far
  int n_cols, first, stride, total, batch;
  __device__ int count() const {
    return first < total ? (total - first + stride - 1) / stride : 0;
  }
  __device__ const int32_t* item(int u) const {
    return items + (size_t)kItemInts * ((first + u * stride) % n_cols);
  }
  __device__ int row0(int u) const {
    return (first + u * stride) / n_cols * kDotRows;
  }
  __device__ void wait(int u) const {
    const int tile = (first + u * stride) / n_cols;
    const int rows = min(kDotRows, batch - tile * kDotRows);
    const int groups = (rows + kGroupRows - 1) / kGroupRows;
    while (load_acquire(ready + tile) < groups) __nanosleep(128);
    fence_proxy_async_global();  // the rows, before this thread's TMA reads
  }
};

// One launch of G resident blocks (G = gridDim.x). stage_rows is the
// number of rows phase 1 stages at a time (at least 1).
template <int M, bool Wide>
__global__ void
__launch_bounds__(fused_threads<M>(), fused_blocks_per_sm<M>())
fused_step_kernel(const __grid_constant__ CUtensorMap a_map,
                  const __grid_constant__ CUtensorMap b_map,
                  const int32_t* __restrict__ acc,
                  const int32_t* __restrict__ bara, int8_t* lhs,
                  int32_t* __restrict__ out,
                  const int32_t* __restrict__ products,
                  const int32_t* __restrict__ targets,
                  const int32_t* __restrict__ items, int n_cols,
                  int stage_rows, int* ready,
                  const __grid_constant__ Params p, const DotsParams dp) {
  extern __shared__ __align__(1024) uint4 fused_smem[];
  const int row16 = p.k1 * (M * kT / 4);
  const int groups = (p.batch + kGroupRows - 1) / kGroupRows;

  // phase 1: this block's groups of rows, as digit rows in lhs
  for (int g = blockIdx.x; g < groups; g += gridDim.x) {
    const int last = min((g + 1) * kGroupRows, p.batch);
    for (int r0 = g * kGroupRows; r0 < last; r0 += stage_rows) {
      const int count = min(stage_rows, last - r0);
      stage_acc_rows(acc, r0, count, row16, fused_smem);
      __syncthreads();
      rotate_items<M>(fused_smem, bara, r0, count, p,
                      [&](int row, int j, int il, int lane, auto shifted) {
                        store_digits<M, Wide>(p, lhs, row, j, il, lane,
                                              shifted);
                      });
      __syncthreads();  // the staged rows are read before the next copy
    }
    fence_proxy_async_global();  // these generic stores, before TMA reads
    __threadfence();
    __syncthreads();
    if (threadIdx.x == 0) atomicAdd(ready + g / kTileGroups, 1);
  }

  // phase 2: this block's units
  const int tiles = (p.batch + kDotRows - 1) / kDotRows;
  const FusedUnits units = {items, ready, n_cols, (int)blockIdx.x,
                            (int)gridDim.x, tiles * n_cols, p.batch};
  dots_body<true, true, 1>(&a_map, &b_map, acc, out, products, targets,
                           units, dp);
}

struct FusedArgs {
  const int32_t *acc, *bara;
  int8_t* lhs;
  int32_t* out;
  int* ready;
  int n_cols, stage_rows;
};

template <int M>
struct FusedStep {
  static cudaError_t run(const Params& p, const DotsLaunch& d,
                         const FusedArgs& a, cudaStream_t st) {
    auto kernel = p.b > 8 ? fused_step_kernel<M, true>
                          : fused_step_kernel<M, false>;
    const size_t staged = (size_t)a.stage_rows * p.k1 * p.n * 4;
    const size_t smem = staged > d.smem ? staged : d.smem;
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    int per_sm = 0, sms = 0, dev = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, kernel, fused_threads<M>(), smem);
    if (err != cudaSuccess) return err;
    err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return err;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;
    // as many blocks as phase 1's groups or phase 2's units need, at most
    // what the card holds at once
    const int tiles = (p.batch + kDotRows - 1) / kDotRows;
    const int groups = (p.batch + kGroupRows - 1) / kGroupRows;
    const int units = tiles * a.n_cols;
    const int want = units > groups ? units : groups;
    const int blocks = want < per_sm * sms ? want : per_sm * sms;
    if (blocks < 1) return cudaErrorInvalidConfiguration;
    err = cudaMemsetAsync(a.ready, 0, (size_t)tiles * sizeof(int), st);
    if (err != cudaSuccess) return err;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(blocks, 1, 1);
    cfg.blockDim = dim3(fused_threads<M>(), 1, 1);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = st;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeCooperative;
    attr[0].val.cooperative = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    err = cudaLaunchKernelEx(&cfg, kernel, d.a_map, d.b_map, a.acc, a.bara,
                             a.lhs, a.out, d.t.products, d.t.targets,
                             d.t.items, a.n_cols, a.stage_rows, a.ready, p,
                             d.p);
    if (err != cudaSuccess) return err;
    return cudaGetLastError();
  }
};

}  // namespace

extern "C" {

// One fused step in one launch on `stream` (after a memset of `ready`):
// out = acc + key_step (x) [(X^bara - 1) * acc], key_step K-major
// int8[K, 4, T, total_rows*P*T]. Scratch: lhs, batch x lhs_rows*P*T bytes;
// ready, int32[ceil(batch / 64)]. tables: the items are n_items = K*4 rows
// (k*4 + wt, 0, n_products, 0), one per column tile, in plain launches
// (cluster 1) of 64-row batch tiles (row_tile 64). stage_rows: the rows
// phase 1 stages at a time. Returns the first CUDA error (0 = none); does
// not synchronise.
int tfhe_cmux_step_karatsuba(const int32_t* acc, const int8_t* key_step,
                             const int32_t* bara, int32_t* out, int8_t* lhs,
                             int* ready, const StepSizes* sizes,
                             const DotsArgs* tables, int stage_rows,
                             void* stream) {
  Params p;
  cudaError_t err = make_params(p, *sizes);
  if (err != cudaSuccess) return (int)err;
  if (tables->n_items != p.k1 * 4 || tables->row_tile != kDotRows ||
      stage_rows < 1)
    return (int)cudaErrorInvalidValue;
  DotsLaunch dots;
  err = make_dots(dots, *tables, p, lhs, key_step, sizes->total_rows * p.pt,
                  p.k1, 1);
  if (err != cudaSuccess) return (int)err;
  const FusedArgs a = {acc, bara, lhs, out, ready, tables->n_items,
                       stage_rows};
  return (int)launch_by_m<FusedStep>(p, dots, a,
                                     static_cast<cudaStream_t>(stream));
}

}  // extern "C"
