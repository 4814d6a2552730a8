// Row-gather sum for Hopper (sm_90a): the wrapping uint32 sum of every word
// of table[idx[i]] over all i.
//
// Replaces the Pallas kernel `kern` inside `pallas_gather`
// (tools/bench_gather.py:245-286), a row-gather-rate probe: one TPU core
// walks the scalar-prefetched index vector in order, copies each 128 B row
// from HBM to VMEM with make_async_copy, keeps 8 copies in flight on DMA
// semaphores, and adds each row's words into one int32 accumulator.
//
// What bounds it on the card: bytes. The function must read each row that
// idx names once, D * W * 4 bytes for D distinct rows (D <= min(N, R): a row
// named again can come from cache), plus the N indices, so the least time is
// that over the card's 3.35 TB/s; the additions are nothing beside it. The
// kernel itself asks for all N rows, N * W * 4 bytes, and leaves the repeats
// to the L2 cache, which holds a fifth of a 256 MiB table. A row of
// W = 32 words is 128 B = four full 32 B sectors, and the rows are 128 B
// aligned, so no fetched sector carries an unused byte. Random rows defeat
// DRAM page locality, and hiding that latency takes many loads in flight.
//
// Design: the sequential loop with an 8-deep ring does not carry over; the
// work is spread over thousands of warps instead. One warp per row, rows
// taken grid-stride; lane l loads word l (+ 32 j for wider rows), so a
// 128 B row is one coalesced transaction. Each lane adds into a uint32
// register, the warp folds its 32 partial sums with a __shfl_xor_sync tree,
// and lane 0 makes one atomicAdd per warp on the single output word (a few
// thousand atomics per launch). Every resident warp keeps up to four row
// loads in flight (the row loop is unrolled), which gives the memory-level
// parallelism the DMA ring gave the TPU. Wrapping addition is associative
// and commutative, so the result is the same integer in any order, atomics
// included.
//
// Left for a later change: a cp.async.bulk / TMA ring with mbarriers (the
// true counterpart of make_async_copy + semaphores), which would keep
// several rows in flight per warp without spending registers on them.
//
// Layout: table is (R, W) uint32 words, row-major, W a multiple of 32; idx
// holds N row numbers in [0, R), int32 or int64. `out` is one uint32 word
// that the caller has set to zero on the same stream.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kWarpsPerBlock = 8;
constexpr int kBlocksPerSM = 8;

// WPL = words per lane (W / 32) known at compile time, or 0 for any W: with
// a fixed trip count the row loop unrolls, so the loads of four rows start
// before the first is added.
template <class Index, int WPL>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
gather_rows_sum_kernel(const uint32_t* __restrict__ table,
                       const Index* __restrict__ idx, long long n, int w,
                       uint32_t* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const long long warp =
      static_cast<long long>(blockIdx.x) * kWarpsPerBlock + (threadIdx.x >> 5);
  const long long n_warps = static_cast<long long>(gridDim.x) * kWarpsPerBlock;
  uint32_t acc = 0u;
#pragma unroll 4
  for (long long i = warp; i < n; i += n_warps) {
    const uint32_t* row = table + static_cast<long long>(idx[i]) * w + lane;
    if (WPL > 0) {
#pragma unroll
      for (int j = 0; j < WPL; ++j) acc += __ldg(row + 32 * j);
    } else {
      for (int j = 0; j < w; j += 32) acc += __ldg(row + j);
    }
  }
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) acc += __shfl_xor_sync(kFull, acc, d);
  if (lane == 0 && acc != 0u) atomicAdd(out, acc);
}

template <class Index>
void launch(const uint32_t* table, const void* idx, long long n, int w,
            uint32_t* out, dim3 grid, dim3 block, cudaStream_t s) {
  const Index* ix = static_cast<const Index*>(idx);
  if (w == 32) {
    gather_rows_sum_kernel<Index, 1><<<grid, block, 0, s>>>(table, ix, n, w,
                                                            out);
  } else if (w == 128) {
    gather_rows_sum_kernel<Index, 4><<<grid, block, 0, s>>>(table, ix, n, w,
                                                            out);
  } else {
    gather_rows_sum_kernel<Index, 0><<<grid, block, 0, s>>>(table, ix, n, w,
                                                            out);
  }
}

}  // namespace

// Launches on `stream`; returns the cudaError_t of the launch (0 = success).
// idx_is_64 selects int64 row numbers. `*out` must be zero before the launch.
extern "C" int vgt_gather_rows_sum(const void* table, const void* idx,
                                   long long n, int w, int idx_is_64,
                                   void* out, void* stream) {
  if (n <= 0 || w <= 0 || (w & 31) != 0) return cudaErrorInvalidValue;
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  long long blocks = (n + kWarpsPerBlock - 1) / kWarpsPerBlock;
  const long long cap = static_cast<long long>(sms) * kBlocksPerSM;
  if (blocks > cap) blocks = cap;
  const dim3 grid(static_cast<unsigned>(blocks));
  const dim3 block(kWarpsPerBlock * 32);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint32_t* t = static_cast<const uint32_t*>(table);
  uint32_t* o = static_cast<uint32_t*>(out);
  if (idx_is_64) {
    launch<long long>(t, idx, n, w, o, grid, block, s);
  } else {
    launch<int>(t, idx, n, w, o, grid, block, s);
  }
  return static_cast<int>(cudaGetLastError());
}
