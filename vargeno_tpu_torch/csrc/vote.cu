// Vote scan for Hopper (sm_90a): the reference's improved_index_table_add
// (qv.cc:132-178) over each read's ordered events.
//
// Replaces vargeno_tpu/engine/pallas_vote.py _vote_kernel, which keeps a
// tile's (C, 512) candidate tables in VMEM and walks the events on-chip.
//
// What bounds it on the card: the per-read event chain is sequential (each
// event reads the candidate table the previous one wrote), and one batch
// reads only about B * E * 10 bytes (~31 MB at B = 32768, E = 96), so the
// kernel is bound by the latency of that chain, not by memory bandwidth.
//
// Design: one warp per read. Lane l owns candidate slots l, l + 32, ...,
// so a match is one __ballot_sync per row of 32 slots, the touched slot's
// freq and kmask come from its owner lane with __shfl_sync, and
// eligibility is one __popc. The best state (has_best, best_freq,
// best_idx, amb) is kept uniform across the warp. Events are loaded 32 at
// a time, one per lane, and broadcast with __shfl_sync, so the loads of a
// 32-event chunk overlap instead of queueing behind the chain. Each warp
// stops at its own read's ev_n (events past it are invalid).
//
// The table lives in registers (RegTable, SPL = ceil(C / 32) slots a lane)
// for C <= kRegMaxC. Overflow escalation doubles C without a bound, so a
// wider table lives in a global workspace of C slots a read (GlobalTable),
// which lane 0 updates and the warp scans 32 slots at a time.
//
// Layout: ev_* are (E, B) events-major, as in the JAX package. idx is the
// uint32 position word; k in [0, 32); isnb/valid are bytes (0/1).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kWarpsPerBlock = 4;
constexpr int kRegMaxC = 512;  // 16 register slots a lane

// C <= 32 * SPL candidate slots in registers, slot s * 32 + l on lane l.
template <int SPL>
struct RegTable {
  uint32_t idx[SPL];
  int32_t freq[SPL];
  uint32_t km[SPL];

  __device__ RegTable(int /*b*/, int /*C*/, uint32_t* /*ws*/, int /*B*/) {
#pragma unroll
    for (int s = 0; s < SPL; ++s) {
      idx[s] = 0u;
      freq[s] = 0;
      km[s] = 0u;
    }
  }

  // The used slot holding x, or -1 (used slots hold distinct idx).
  __device__ int find(uint32_t x, int ncand, int lane) const {
    int slot = -1;
#pragma unroll
    for (int s = 0; s < SPL; ++s) {
      const bool m = (s * 32 + lane < ncand) && (idx[s] == x);
      const unsigned bal = __ballot_sync(kFull, m);
      if (bal != 0u && slot < 0) slot = s * 32 + (__ffs(bal) - 1);
    }
    return slot;
  }

  // The owner lane adds event (x, k) to `slot` (a new one when `fresh`);
  // every lane gets the slot's new freq and kmask.
  __device__ void touch(int slot, bool fresh, uint32_t x, int k, int lane,
                        int& f, uint32_t& kmask) {
    const int own_s = slot >> 5;
    const int own_l = slot & 31;
    int f_mine = 0;
    uint32_t km_mine = 0u;
#pragma unroll
    for (int s = 0; s < SPL; ++s) {
      if (s == own_s) {
        if (lane == own_l) {
          idx[s] = x;
          freq[s] = (fresh ? 0 : freq[s]) + 1;
          km[s] = (fresh ? 0u : km[s]) | (1u << k);
        }
        f_mine = freq[s];
        km_mine = km[s];
      }
    }
    f = __shfl_sync(kFull, f_mine, own_l);
    kmask = __shfl_sync(kFull, km_mine, own_l);
  }
};

// Any C: read b's slots are ws[(0|1|2) * B * C + b * C + s] (idx, freq,
// kmask), uninitialised until inserted.
struct GlobalTable {
  uint32_t* idx;
  int32_t* freq;
  uint32_t* km;

  __device__ GlobalTable(int b, int C, uint32_t* ws, int B) {
    const size_t plane = static_cast<size_t>(B) * C;
    idx = ws + static_cast<size_t>(b) * C;
    freq = reinterpret_cast<int32_t*>(ws + plane) + static_cast<size_t>(b) * C;
    km = ws + 2 * plane + static_cast<size_t>(b) * C;
  }

  __device__ int find(uint32_t x, int ncand, int lane) const {
    for (int s0 = 0; s0 < ncand; s0 += 32) {  // ncand is warp-uniform
      const int s = s0 + lane;
      const unsigned bal = __ballot_sync(kFull, s < ncand && idx[s] == x);
      if (bal != 0u) return s0 + (__ffs(bal) - 1);
    }
    return -1;
  }

  __device__ void touch(int slot, bool fresh, uint32_t x, int k, int lane,
                        int& f, uint32_t& kmask) {
    int f_mine = 0;
    uint32_t km_mine = 0u;
    if (lane == 0) {
      f_mine = (fresh ? 0 : freq[slot]) + 1;
      km_mine = (fresh ? 0u : km[slot]) | (1u << k);
      idx[slot] = x;
      freq[slot] = f_mine;
      km[slot] = km_mine;
    }
    __syncwarp();  // the write is seen by the warp's next find()
    f = __shfl_sync(kFull, f_mine, 0);
    kmask = __shfl_sync(kFull, km_mine, 0);
  }
};

template <class Table>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
vote_kernel(const uint32_t* __restrict__ ev_idx,
            const int32_t* __restrict__ ev_k,
            const uint8_t* __restrict__ ev_isnb,
            const uint8_t* __restrict__ ev_valid,
            const int32_t* __restrict__ ev_n, int E, int B, int C,
            uint32_t* ws, uint8_t* __restrict__ process,
            uint32_t* __restrict__ target, int32_t* __restrict__ ovf) {
  const int lane = threadIdx.x & 31;
  const int b = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (b >= B) return;  // warp-uniform: the whole warp leaves together

  Table table(b, C, ws, B);
  int ncand = 0;
  bool has_best = false;
  int bfreq = 0;
  uint32_t bidx = 0u;
  bool amb = false;
  int covf = 0;

  int n = ev_n[b];
  n = n < 0 ? 0 : (n > E ? E : n);

  for (int e0 = 0; e0 < n; e0 += 32) {
    // one event per lane: idx, and k | isnb << 5 | valid << 6
    uint32_t my_idx = 0u;
    int my_meta = 0;
    const int e_mine = e0 + lane;
    if (e_mine < n) {
      const size_t o = static_cast<size_t>(e_mine) * B + b;
      my_idx = ev_idx[o];
      my_meta = (ev_k[o] & 31) | (ev_isnb[o] ? 32 : 0) | (ev_valid[o] ? 64 : 0);
    }
    const int cnt = (n - e0) < 32 ? (n - e0) : 32;
    for (int j = 0; j < cnt; ++j) {
      const uint32_t x = __shfl_sync(kFull, my_idx, j);
      const int meta = __shfl_sync(kFull, my_meta, j);
      if (!(meta & 64)) continue;  // invalid event: no effect
      const bool nb = (meta & 32) != 0;
      const int k = meta & 31;

      int slot = table.find(x, ncand, lane);
      const bool fresh = slot < 0;
      if (fresh && nb) continue;  // neighbor events only reinforce
      if (fresh) {
        if (ncand < C) {
          slot = ncand++;
        } else {
          ++covf;  // table full: the insert is lost
          continue;
        }
      }
      int f;
      uint32_t km;
      table.touch(slot, fresh, x, k, lane, f, km);

      const bool is_best = has_best && x == bidx;
      if (is_best) bfreq += 1;  // keep the best's frequency live
      if (__popc(km) >= 2) {
        const bool take_new = !has_best || (!is_best && f > bfreq);
        const bool set_amb = has_best && !is_best && f == bfreq;
        const bool clr_amb = is_best || !has_best || f > bfreq;
        if (take_new) {
          bidx = x;
          bfreq = f;
        }
        if (set_amb) {
          amb = true;
        } else if (clr_amb) {
          amb = false;
        }
        has_best = true;
      }
    }
  }

  if (lane == 0) {
    process[b] = (has_best && bfreq > 1 && !amb) ? 1 : 0;
    target[b] = has_best ? bidx : 0u;
    ovf[b] = covf;
  }
}

template <class Table>
void launch(const void* ev_idx, const void* ev_k, const void* ev_isnb,
            const void* ev_valid, const void* ev_n, int E, int B, int C,
            void* ws, void* process, void* target, void* ovf,
            cudaStream_t s) {
  const dim3 block(kWarpsPerBlock * 32);
  const dim3 grid((B + kWarpsPerBlock - 1) / kWarpsPerBlock);
  vote_kernel<Table><<<grid, block, 0, s>>>(
      static_cast<const uint32_t*>(ev_idx), static_cast<const int32_t*>(ev_k),
      static_cast<const uint8_t*>(ev_isnb),
      static_cast<const uint8_t*>(ev_valid), static_cast<const int32_t*>(ev_n),
      E, B, C, static_cast<uint32_t*>(ws), static_cast<uint8_t*>(process),
      static_cast<uint32_t*>(target), static_cast<int32_t*>(ovf));
}

}  // namespace

extern "C" int vgt_vote_reg_max_c() { return kRegMaxC; }

// Launches on `stream`; returns the cudaError_t of the launch (0 = success).
// `ws` holds 3 * B * C uint32 words when C > vgt_vote_reg_max_c(), and may
// be null otherwise.
extern "C" int vgt_vote_scan(const void* ev_idx, const void* ev_k,
                             const void* ev_isnb, const void* ev_valid,
                             const void* ev_n, int E, int B, int C, void* ws,
                             void* process, void* target, void* ovf,
                             void* stream) {
  if (B <= 0 || E < 0 || C < 1 || (C > kRegMaxC && ws == nullptr))
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define VGT_LAUNCH(T) \
  launch<T>(ev_idx, ev_k, ev_isnb, ev_valid, ev_n, E, B, C, ws, process, \
            target, ovf, s)
  if (C <= 32) {
    VGT_LAUNCH(RegTable<1>);
  } else if (C <= 64) {
    VGT_LAUNCH(RegTable<2>);
  } else if (C <= 128) {
    VGT_LAUNCH(RegTable<4>);
  } else if (C <= 256) {
    VGT_LAUNCH(RegTable<8>);
  } else if (C <= kRegMaxC) {
    VGT_LAUNCH(RegTable<16>);
  } else {
    VGT_LAUNCH(GlobalTable);
  }
#undef VGT_LAUNCH
  return static_cast<int>(cudaGetLastError());
}
