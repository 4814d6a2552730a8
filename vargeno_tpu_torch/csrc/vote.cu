// Vote scan for Hopper (sm_90a): the reference's improved_index_table_add
// (qv.cc:132-178) over each read's ordered events.
//
// Replaces vargeno_tpu/engine/pallas_vote.py _vote_kernel, which keeps a
// tile's (C, 512) candidate tables in VMEM and walks the events on-chip.
//
// What bounds it on the card: the per-read event chain is sequential (each
// event reads the candidate table the previous one wrote), and a batch reads
// only 16 B a record (~25 MB at B = 32768 with 48 events a read), so the
// kernel is bound by the instructions it issues for every event (about 60
// a warp, with every scheduler's warps queueing to issue them) and by the
// chain's latency, not by memory bandwidth: its time at 48 events a read did
// not move when the loads were coalesced. Round the kernel, the bound is the
// number of device operations a call costs the launch-bound step.
//
// Design.
// - The kernel reads the step's own event records: two read-major (B, E)
//   views of int64 words with a row stride (E + 1 in the step), idx in the
//   low 32 bits of one word and meta = k | isnb << 5 | valid << 6 | src << 7
//   in the other (bits 7 and up are ignored), plus the unclamped per-read
//   count, which is clamped to E here. It writes `process` as bool bytes and
//   `target` as the zero-extended int64 word the pileup compares, and adds
//   the lost inserts into one int64 with one atomicAdd per warp that has any.
//   So the wrapper allocates and zeroes one word: no elementwise pass, no
//   transpose, no reduction round the launch.
// - A group of G lanes walks one read, 32 / G reads a warp. Lane l of the
//   group loads record e0 + l, so a group's loads are one contiguous run of
//   8 G bytes in each word buffer; the chunk's events are then handed round
//   with __shfl_sync. Lane l owns candidate slots l, l + G, ... (SPL slots a
//   lane, in registers): a match is one __ballot_sync on the group's mask per
//   slot row, the touched slot's freq and kmask come from its owner lane.
//   The best state (has_best, best_freq, best_idx, amb) is uniform across
//   the group. With several reads a warp the event body is predicated, not
//   branched, so the groups stay converged while their events differ and
//   part only where their counts do; with one read a warp an event without
//   effect is skipped by a branch, which is then uniform and free (the
//   predicated body cost 32 lanes a third more time on streams where half
//   the events have no effect).
// - G follows the table's width: a real read has under 8 events and the
//   auto-tuned step launches 8 slots, so width <= 8 runs 8 lanes x 1 slot,
//   four reads a warp, and no lane idles; width <= 16 runs 8 x 2; wider
//   tables run 32 lanes x ceil(width / 32) slots up to kRegMaxC. At width
//   32 both 8 x 4 and 32 x 1 fit. Tried and dropped: 8 x 4 took twice the
//   time of 32 x 1 on 48-event random streams (four ballots an event instead
//   of one, and every group waits for its longest neighbour) and the two
//   tied on real batches of 1.5 events a read, so width 32 runs 32 x 1.
// - Overflow escalation doubles C without a bound, so a table wider than
//   kRegMaxC lives in a global workspace of C slots a read (GlobalTable),
//   one warp a read, lane 0 updating and the warp scanning 32 slots at a
//   time.
// - Asynchronous copies do not pay here. Tried and dropped: loading the
//   next chunk's records into a register pair a lane before the current
//   chunk's chain runs. It moved the kernel's time by 2 % or less at every
//   measured shape, in either direction: with up to 16 warps resident a
//   scheduler, another warp's chain already covers a chunk's load. cp.async
//   into shared memory was not tried after that: it hides the same latency.
//   TMA tiles would fetch mostly padding (a real read fills under 8 of its
//   E + 1 record slots).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kWarpsPerBlock = 4;
constexpr int kRegMaxC = 512;   // 16 register slots a lane at 32 lanes

// The lanes of one read: `mask` names them, `shift` is the first one's
// number, `gl` this lane's place among them.
struct Group {
  unsigned mask;
  int shift;
  int gl;
};

// C <= G * SPL candidate slots in registers, slot s * G + gl on lane gl.
template <int G, int SPL>
struct RegTable {
  static_assert(G == 8 || G == 32, "a group is 8 or 32 lanes");
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
  __device__ int find(uint32_t x, int ncand, const Group& g) const {
    int slot = -1;
#pragma unroll
    for (int s = 0; s < SPL; ++s) {
      const bool m = (s * G + g.gl < ncand) && (idx[s] == x);
      const unsigned bal = __ballot_sync(g.mask, m) >> g.shift;
      if (bal != 0u && slot < 0) slot = s * G + (__ffs(bal) - 1);
    }
    return slot;
  }

  // When `on`, the owner lane adds event (x, k) to `slot` (a new one when
  // `fresh`); every lane gets the slot's freq and kmask (unused when off).
  __device__ void touch(int slot, bool on, bool fresh, uint32_t x, int k,
                        const Group& g, int& f, uint32_t& kmask) {
    // slot may be -1 or C when off: then no s matches, or nothing is written
    const int own_s = slot >> (G == 32 ? 5 : 3);
    const int own_l = slot & (G - 1);
    int f_mine = 0;
    uint32_t km_mine = 0u;
#pragma unroll
    for (int s = 0; s < SPL; ++s) {
      if (s == own_s) {
        if (on && g.gl == own_l) {
          idx[s] = x;
          freq[s] = (fresh ? 0 : freq[s]) + 1;
          km[s] = (fresh ? 0u : km[s]) | (1u << k);
        }
        f_mine = freq[s];
        km_mine = km[s];
      }
    }
    f = __shfl_sync(g.mask, f_mine, own_l, G);
    kmask = __shfl_sync(g.mask, km_mine, own_l, G);
  }
};

// Any C, one warp a read: read b's slots are ws[(0|1|2) * B * C + b * C + s]
// (idx, freq, kmask), uninitialised until inserted.
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

  __device__ int find(uint32_t x, int ncand, const Group& g) const {
    for (int s0 = 0; s0 < ncand; s0 += 32) {  // ncand is warp-uniform
      const int s = s0 + g.gl;
      const unsigned bal = __ballot_sync(kFull, s < ncand && idx[s] == x);
      if (bal != 0u) return s0 + (__ffs(bal) - 1);
    }
    return -1;
  }

  __device__ void touch(int slot, bool on, bool fresh, uint32_t x, int k,
                        const Group& g, int& f, uint32_t& kmask) {
    int f_mine = 0;
    uint32_t km_mine = 0u;
    if (on && g.gl == 0) {
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

// The low 32 bits of record e of a row of int64 words (little-endian).
__device__ __forceinline__ uint32_t low_word(const long long* row, int e) {
  return __ldg(reinterpret_cast<const uint32_t*>(row + e));
}

template <int G, class Table>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
vote_kernel(const long long* __restrict__ ev_idx,
            const long long* __restrict__ ev_meta,
            const long long* __restrict__ ev_total, long long row_stride,
            int E, int B, int C, uint32_t* ws, uint8_t* __restrict__ process,
            long long* __restrict__ target, unsigned long long* ovf) {
  constexpr int kReads = 32 / G;   // reads a warp
  const int lane = threadIdx.x & 31;
  Group g;
  g.gl = lane & (G - 1);
  g.shift = lane - g.gl;
  g.mask = G == 32 ? kFull : (((1u << (G & 31)) - 1u) << g.shift);
  const int warp = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  const int b = warp * kReads + lane / G;
  const bool live = b < B;   // a dead group runs no event and stays to the end

  Table table(live ? b : 0, C, ws, B);
  int ncand = 0;
  bool has_best = false;
  int bfreq = 0;
  uint32_t bidx = 0u;
  bool amb = false;
  int covf = 0;

  int n = 0;
  const long long* row_idx = ev_idx;
  const long long* row_meta = ev_meta;
  if (live) {
    const long long total = ev_total[b];
    n = total < 0 ? 0 : (total > E ? E : static_cast<int>(total));
    row_idx += static_cast<long long>(b) * row_stride;
    row_meta += static_cast<long long>(b) * row_stride;
  }

  // one record per lane: idx, and the low bits k | isnb << 5 | valid << 6
  uint32_t my_idx = 0u;
  int my_meta = 0;
  for (int e0 = 0; e0 < n; e0 += G) {
    if (e0 + g.gl < n) {
      my_idx = low_word(row_idx, e0 + g.gl);
      my_meta = static_cast<int>(low_word(row_meta, e0 + g.gl));
    }
    const int cnt = (n - e0) < G ? (n - e0) : G;
    for (int j = 0; j < cnt; ++j) {
      const uint32_t x = __shfl_sync(g.mask, my_idx, j, G);
      const int meta = __shfl_sync(g.mask, my_meta, j, G);
      // One read a warp (G == 32): an event without effect leaves by a
      // branch, which is uniform, and `on` is then known to be true.
      // Several reads a warp: `on` is a predicate that every group carries.
      const bool valid = (meta & 64) != 0;
      if (G == 32 && !valid) continue;
      const bool nb = (meta & 32) != 0;
      const int k = meta & 31;

      int slot = table.find(x, ncand, g);
      const bool found = slot >= 0;
      if (G == 32 && !found && nb) continue;  // neighbors only reinforce
      const bool room = ncand < C;
      const bool dropped = valid && !found && !nb && !room;  // full table
      covf += dropped ? 1 : 0;
      if (G == 32 && dropped) continue;
      const bool on = G == 32 || (valid && (found || (!nb && room)));
      if (!found) slot = ncand;
      int f;
      uint32_t km;
      table.touch(slot, on, !found, x, k, g, f, km);
      ncand += (on && !found) ? 1 : 0;

      const bool is_best = on && has_best && x == bidx;
      bfreq += is_best ? 1 : 0;  // keep the best's frequency live
      if (on && __popc(km) >= 2) {
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

  if (live && g.gl == 0) {
    process[b] = (has_best && bfreq > 1 && !amb) ? 1 : 0;
    target[b] = has_best ? static_cast<long long>(bidx) : 0ll;
  }
  // the warp's lost inserts, from each group's first lane
  __syncwarp();
  const int lost = __reduce_add_sync(kFull, g.gl == 0 ? covf : 0);
  if (lane == 0 && lost != 0)
    atomicAdd(ovf, static_cast<unsigned long long>(lost));
}

struct Args {
  const void *ev_idx, *ev_meta, *ev_total;
  long long row_stride;
  int E, B, C;
  void *ws, *process, *target, *ovf;
  cudaStream_t stream;
};

template <int G, class Table>
void launch(const Args& a) {
  constexpr int kReadsPerBlock = kWarpsPerBlock * (32 / G);
  const dim3 block(kWarpsPerBlock * 32);
  const dim3 grid((a.B + kReadsPerBlock - 1) / kReadsPerBlock);
  vote_kernel<G, Table><<<grid, block, 0, a.stream>>>(
      static_cast<const long long*>(a.ev_idx),
      static_cast<const long long*>(a.ev_meta),
      static_cast<const long long*>(a.ev_total), a.row_stride, a.E, a.B, a.C,
      static_cast<uint32_t*>(a.ws), static_cast<uint8_t*>(a.process),
      static_cast<long long*>(a.target),
      static_cast<unsigned long long*>(a.ovf));
}

}  // namespace

extern "C" int vgt_vote_reg_max_c() { return kRegMaxC; }

// Launches on `stream`; returns the cudaError_t of the launch (0 = success).
// ev_idx / ev_meta: (B, E) int64 words, `row_stride` words from one read's
// records to the next; ev_total: (B,) int64 counts (clamped to [0, E] here).
// `ws` holds 3 * B * C uint32 words when C > vgt_vote_reg_max_c(), and may be
// null otherwise. process: (B,) bool bytes; target: (B,) int64; `*ovf`, one
// int64 that must be zero before the launch, gets the lost inserts.
extern "C" int vgt_vote_records(const void* ev_idx, const void* ev_meta,
                                const void* ev_total, long long row_stride,
                                int E, int B, int C, void* ws, void* process,
                                void* target, void* ovf, void* stream) {
  if (B <= 0 || E < 0 || C < 1 || row_stride < E ||
      (C > kRegMaxC && ws == nullptr))
    return cudaErrorInvalidValue;
  const Args a{ev_idx, ev_meta, ev_total, row_stride, E, B, C, ws,
               process, target, ovf, static_cast<cudaStream_t>(stream)};
  if (C <= 8) {
    launch<8, RegTable<8, 1>>(a);
  } else if (C <= 16) {
    launch<8, RegTable<8, 2>>(a);
  } else if (C <= 32) {
    launch<32, RegTable<32, 1>>(a);
  } else if (C <= 64) {
    launch<32, RegTable<32, 2>>(a);
  } else if (C <= 128) {
    launch<32, RegTable<32, 4>>(a);
  } else if (C <= 256) {
    launch<32, RegTable<32, 8>>(a);
  } else if (C <= kRegMaxC) {
    launch<32, RegTable<32, 16>>(a);
  } else {
    launch<32, GlobalTable>(a);
  }
  return static_cast<int>(cudaGetLastError());
}
