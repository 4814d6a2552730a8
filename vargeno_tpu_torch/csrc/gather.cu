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
// One entry, vgt_gather_rows_sum, and two kernels behind it; the launcher
// picks one from what it can see, the row width and the number of rows
// (uses_ring), as the vote's launcher picks a table from its width.
//
// The ring (gather_ring_kernel) is the counterpart of the TPU kernel's
// make_async_copy ring, spread over the card: a persistent grid, each warp
// with a contiguous run of the indices and its own ring of kStages stages in
// shared memory. A stage holds 32 rows, one a lane, and has one mbarrier. To
// fill a stage the warp loads its 32 indices in one coalesced load, lane 0
// arms the barrier with the stage's bytes (mbarrier.arrive.expect_tx) and
// every lane issues one cp.async.bulk.shared::cluster.global for its own
// row, so one warp instruction puts 32 rows in flight and no register waits
// on them. To drain it the warp waits on the barrier's phase and each lane
// adds up its own slot with 16 B shared-memory loads, starting at a quad
// rotated by its lane number so the 32 slots (a multiple of 128 B apart) hit
// different banks. A lane refills only the slot it has just read, and
// __syncwarp keeps lane 0 from re-arming a barrier that a slower lane still
// waits on. The indices of the next fill are loaded a fill ahead. The rings
// of an SM's warps (one block, 23 warps at 128 B rows) fill kRingBytes of
// its shared memory: about 190 KB of rows in flight an SM, where the direct
// kernel has about 32 KB. It takes rows of 32, 64 or 128 words.
//
// The direct kernel (gather_direct_kernel) has one warp a row, grid-stride,
// lane l loading word l (+ 32 j) straight into a register, the row loop
// unrolled four deep: up to four 128 B loads in flight a warp, 64 warps an
// SM. It takes any width.
//
// Which one, as measured (chip_smoke.py times both on either side of the
// choice, and both over N = 2^16 .. 2^22 at 128 B rows): on 128 B rows the
// ring takes 0.55-0.6 of the direct kernel's time from a million rows up
// and 0.8-0.9 of it at 2^17 (four loads a warp do not cover the latency of
// random 128 B rows); at 2^16 rows and below a launch is all there is and
// the two tie, so the simpler kernel runs (no 190 KB shared-memory
// carve-out to set up). At 512 B rows the direct kernel has 16 loads in
// flight a warp and is level with the ring or 2-5 % ahead, both at about 80 %
// of the memory's rate on distinct rows. So the ring runs W = 32 from
// kRingMinRows rows up and the direct kernel the rest (W = 64, which the
// ring also takes, was not timed). Tried and dropped in the ring: depth
// and piece size as run-time arguments (at N = 65536 that ring took 30 us
// more than the direct kernel; with both as constants it does not; which of
// the two changes did it was not isolated); other depths (with the bytes in
// flight fixed by kRingBytes, depth trades against warps, and warps win: 2
// stages a warp are as fast as 1 or 3, 8 take twice the time); rows cut
// into pieces of 32 or 64 words (no faster at 512 B rows); 64-bit counts in
// the warp's loop (a division for every row showed in its time).
//
// Both fold the lanes' partial sums with a __shfl_xor_sync tree and make one
// atomicAdd per warp on the single output word. Wrapping addition is
// associative and commutative, so the result is the same integer in any
// order, atomics included.
//
// Layout: table is (R, W) uint32 words, row-major, 16 B aligned, W a
// multiple of 32; idx holds N row numbers in [0, R), int32 or int64. `out`
// is one uint32 word that the caller has set to zero on the same stream.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;

// ---------------------------------------------------------------- the ring
constexpr int kStages = 2;              // stages a warp
constexpr int kRingBytes = 192 * 1024;  // shared memory of an SM's rings
constexpr int kMaxRingWarps = 32;       // warps a block
constexpr int kRingMaxWords = 128;      // widest row a slot takes
constexpr long long kRingMinRows = 1 << 17;  // fewer rows: the direct kernel
constexpr int kMaxDevices = 64;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

__device__ __forceinline__ void bulk_copy(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// QUADS = 16 B quads of a row: 8, 16 or 32 (W = 32, 64, 128 words).
template <class Index, int QUADS>
__global__ void __launch_bounds__(kMaxRingWarps * 32)
gather_ring_kernel(const uint32_t* __restrict__ table,
                   const Index* __restrict__ idx, long long n,
                   int rows_per_warp, uint32_t* __restrict__ out) {
  extern __shared__ __align__(128) unsigned char smem[];
  constexpr uint32_t kRowBytes = QUADS * 16u;
  constexpr uint32_t kStageBytes = 32u * kRowBytes;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int warps = blockDim.x >> 5;

  unsigned char* ring =
      smem + static_cast<size_t>(warp) * kStages * kStageBytes;
  uint64_t* bars = reinterpret_cast<uint64_t*>(
                       smem + static_cast<size_t>(warps) * kStages *
                                  kStageBytes) +
                   warp * kStages;
  if (lane < kStages) mbar_init(smem_addr(bars + lane), 1);
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncwarp();

  // this warp's rows [r0, r0 + rows): a 32-bit count (the launcher keeps
  // rows_per_warp under 2^30)
  const long long r0 =
      (static_cast<long long>(blockIdx.x) * warps + warp) * rows_per_warp;
  const int rows = r0 >= n ? 0
                           : (n - r0 < rows_per_warp ? static_cast<int>(n - r0)
                                                     : rows_per_warp);
  const int groups = (rows + 31) / 32;  // stage fills
  const Index* my_idx = idx + r0;

  // lane's row of fill g in the table (loaded a fill ahead), -1 past the end
  auto row_of = [&](int g) -> long long {
    const int r = g * 32 + lane;
    return r < rows ? static_cast<long long>(my_idx[r]) : -1ll;
  };
  auto fill = [&](int s, long long row) {
    const uint32_t bar = smem_addr(bars + s);
    const uint32_t live = __popc(__ballot_sync(kFull, row >= 0));
    if (lane == 0) mbar_expect_tx(bar, live * kRowBytes);
    __syncwarp();
    if (row >= 0) {
      bulk_copy(smem_addr(ring + s * kStageBytes + lane * kRowBytes),
                table + row * (QUADS * 4), kRowBytes, bar);
    }
  };

  int filled = 0;
  long long next_row = row_of(0);
  for (; filled < groups && filled < kStages; ++filled) {
    const long long row = next_row;
    next_row = row_of(filled + 1);
    fill(filled, row);
  }

  uint32_t acc = 0u;
  int s = 0;
  uint32_t parity = 0u;
  for (int g = 0; g < groups; ++g) {
    mbar_wait(smem_addr(bars + s), parity);
    const uint4* slot = reinterpret_cast<const uint4*>(
        ring + s * kStageBytes + lane * kRowBytes);
    if (g * 32 + lane < rows) {
#pragma unroll
      for (int j = 0; j < QUADS; ++j) {
        const uint4 v = slot[(j + lane) & (QUADS - 1)];
        acc += v.x + v.y + v.z + v.w;
      }
    }
    __syncwarp();  // every lane is past the wait before the barrier re-arms
    if (filled < groups) {
      const long long row = next_row;
      next_row = row_of(filled + 1);
      fill(s, row);
      ++filled;
    }
    if (++s == kStages) {
      s = 0;
      parity ^= 1u;
    }
  }

#pragma unroll
  for (int d = 16; d > 0; d >>= 1) acc += __shfl_xor_sync(kFull, acc, d);
  if (lane == 0 && acc != 0u) atomicAdd(out, acc);
}

struct Args {
  const uint32_t* table;
  const void* idx;
  long long n;
  int w, sms, dev;
  uint32_t* out;
  cudaStream_t stream;
};

template <class Index, int QUADS>
cudaError_t launch_ring(const Args& a) {
  constexpr size_t kWarpBytes =
      kStages * (32u * QUADS * 16u + sizeof(uint64_t));
  // as many warps an SM as kRingBytes holds rings for, in one block
  constexpr int kWarps = kRingBytes / kWarpBytes < kMaxRingWarps
                             ? static_cast<int>(kRingBytes / kWarpBytes)
                             : kMaxRingWarps;
  constexpr int kSmem = static_cast<int>(kWarps * kWarpBytes);
  auto kernel = gather_ring_kernel<Index, QUADS>;
  // the attribute sticks to the function on a device: set it once
  static bool smem_set[kMaxDevices] = {};
  if (a.dev < 0 || a.dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (!smem_set[a.dev]) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
    if (err != cudaSuccess) return err;
    smem_set[a.dev] = true;
  }
  // a warp's run of rows is a multiple of 32, so its index loads stay
  // aligned; no more warps than runs
  const long long warps_max = static_cast<long long>(a.sms) * kWarps;
  long long rows_per_warp = (a.n + warps_max - 1) / warps_max;
  rows_per_warp = (rows_per_warp + 31) / 32 * 32;
  if (rows_per_warp >= (1ll << 30)) return cudaErrorInvalidValue;
  const long long warps = (a.n + rows_per_warp - 1) / rows_per_warp;
  const dim3 grid(static_cast<unsigned>((warps + kWarps - 1) / kWarps));
  kernel<<<grid, dim3(kWarps * 32), kSmem, a.stream>>>(
      a.table, static_cast<const Index*>(a.idx), a.n,
      static_cast<int>(rows_per_warp), a.out);
  return cudaGetLastError();
}

template <class Index>
cudaError_t launch_ring_w(const Args& a) {
  if (a.w == 32) return launch_ring<Index, 8>(a);
  if (a.w == 64) return launch_ring<Index, 16>(a);
  if (a.w == 128) return launch_ring<Index, 32>(a);
  return cudaErrorInvalidValue;
}

// -------------------------------------------------------- the direct kernel
constexpr int kWarpsPerBlock = 8;
constexpr int kBlocksPerSM = 8;

// WPL = words per lane (W / 32) known at compile time, or 0 for any W: with
// a fixed trip count the row loop unrolls, so the loads of four rows start
// before the first is added.
template <class Index, int WPL>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
gather_direct_kernel(const uint32_t* __restrict__ table,
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
cudaError_t launch_direct(const Args& a) {
  long long blocks = (a.n + kWarpsPerBlock - 1) / kWarpsPerBlock;
  const long long cap = static_cast<long long>(a.sms) * kBlocksPerSM;
  if (blocks > cap) blocks = cap;
  const dim3 grid(static_cast<unsigned>(blocks));
  const dim3 block(kWarpsPerBlock * 32);
  const Index* ix = static_cast<const Index*>(a.idx);
  if (a.w == 32) {
    gather_direct_kernel<Index, 1><<<grid, block, 0, a.stream>>>(
        a.table, ix, a.n, a.w, a.out);
  } else if (a.w == 128) {
    gather_direct_kernel<Index, 4><<<grid, block, 0, a.stream>>>(
        a.table, ix, a.n, a.w, a.out);
  } else {
    gather_direct_kernel<Index, 0><<<grid, block, 0, a.stream>>>(
        a.table, ix, a.n, a.w, a.out);
  }
  return cudaGetLastError();
}

// The ring for many 128 B rows, the direct kernel for the rest.
bool uses_ring(long long n, int w) { return w == 32 && n >= kRingMinRows; }

}  // namespace

// 1 where vgt_gather_rows_sum launches the ring for N rows of W words, else 0.
extern "C" int vgt_gather_uses_ring(long long n, int w) {
  return uses_ring(n, w) ? 1 : 0;
}

// Launches on `stream` and returns the cudaError_t of the launch (0 =
// success). idx_is_64 selects int64 row numbers. `*out` must be zero before
// the launch. `kernel` = 0 launches the kernel that uses_ring picks, which is
// what the wrapper asks for; 1 the ring (W = 32, 64 or 128) and 2 the direct
// kernel whatever the shape, so that the choice can be measured from both
// sides.
extern "C" int vgt_gather_rows_sum(const void* table, const void* idx,
                                   long long n, int w, int idx_is_64,
                                   void* out, int kernel, void* stream) {
  if (n <= 0 || w <= 0 || (w & 31) != 0 || kernel < 0 || kernel > 2)
    return cudaErrorInvalidValue;
  const bool ring = kernel == 0 ? uses_ring(n, w) : kernel == 1;
  if (ring && (w > kRingMaxWords ||
               (reinterpret_cast<uintptr_t>(table) & 15) != 0))
    return cudaErrorInvalidValue;
  Args a{static_cast<const uint32_t*>(table), idx, n, w, 0, 0,
         static_cast<uint32_t*>(out), static_cast<cudaStream_t>(stream)};
  cudaError_t err = cudaGetDevice(&a.dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&a.sms, cudaDevAttrMultiProcessorCount,
                                 a.dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (ring) {
    err = idx_is_64 ? launch_ring_w<long long>(a) : launch_ring_w<int>(a);
  } else {
    err = idx_is_64 ? launch_direct<long long>(a) : launch_direct<int>(a);
  }
  return static_cast<int>(err);
}
