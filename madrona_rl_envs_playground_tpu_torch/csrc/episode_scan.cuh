// World-order episode allocation and the TEA+LCG episode stream, shared by
// the kernels of the envs whose resets draw an episode index
// (csrc/cartpole.cu, csrc/balance.cu, csrc/acrobot.cu, csrc/hanabi.cu).
//
// The JAX package hands world w that resets at a step the episode index
// `counter + (number of done worlds before w in the batch)` (core/batch.py's
// cumsum; the Pallas kernels carry the counter across their sequential grid
// in SMEM).  CUDA blocks run concurrently and in no fixed order, so the
// kernels here compute the same ranks with a scan whose result depends only
// on the done flags, never on which block ran first:
//
//   * within a block, `block_rank` ranks a flag among the block's threads in
//     thread order: a warp ballot and popcount, then a scan over the warps'
//     counts in shared memory;
//   * across blocks, every block writes its total to a buffer, and after a
//     barrier (the end of a launch, or a grid-wide sync in the persistent
//     kernels) `block_offsets` sums the totals of the blocks before it, and of
//     all blocks, over the whole block;
//   * or, in a kernel of one launch without a grid-wide sync (K3, and the
//     step kernels K5, K7 and K9 through `step_plan` and `step_rank`),
//     `look_back` sums them as each block's predecessors publish them.
//
// The persistent rollouts K6 and K10 rank a step in one pass (`scan_counts`,
// `nth_done`) and take their shape from `rollout_shape`, below; the step
// kernels rank their tile so too.
//
// The world -> (block, slot, thread) map below assigns each block a
// contiguous run of worlds, so (block, slot, thread) order is world order,
// and the loads of one slot are coalesced.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>
#include <map>
#include <mutex>
#include <tuple>

namespace episode {

constexpr unsigned FULL_MASK = 0xFFFFFFFFu;
constexpr int THREADS = 256;           // threads per block of every kernel here
constexpr int MAX_ROLLOUT_SLOTS = 32;  // a thread's done flags fit one word
constexpr int ERR_TOO_MANY_ENVS = -1;  // returned by the launchers

// ---- worlds to blocks -------------------------------------------------------

// Slot s of thread t in block b is world (b * slots + s) * THREADS + t.
__device__ __forceinline__ int world(int slots, int s) {
  return (blockIdx.x * slots + s) * THREADS + threadIdx.x;
}

// Blocks and slots for N worlds: at most `max_blocks` blocks, each owning
// slots * THREADS contiguous worlds.
inline void split(int N, int max_blocks, int* blocks, int* slots) {
  const int need = (N + THREADS - 1) / THREADS;
  const int g = need < max_blocks ? need : max_blocks;
  *slots = (N + g * THREADS - 1) / (g * THREADS);
  *blocks = (N + *slots * THREADS - 1) / (*slots * THREADS);
}

// Blocks of `kernel` that fit on the card at once.
inline cudaError_t resident_blocks(const void* kernel, int device, int* out) {
  int sms = 0, per_sm = 0;
  cudaError_t err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, THREADS, 0);
  if (err != cudaSuccess) return err;
  *out = sms * per_sm;
  return cudaSuccess;
}

// Ints of scratch (block counts, two parities) a launch over N worlds needs.
inline int scratch_ints(int N) { return 2 * ((N + THREADS - 1) / THREADS); }

inline const char* error_string(int err) {
  if (err == ERR_TOO_MANY_ENVS)
    return "too many envs for one resident grid (at most 32 per thread)";
  return cudaGetErrorString((cudaError_t)err);
}

// ---- the episode stream (core/rng.py; reference src/cartpole_env/rng.hpp) --

__device__ __forceinline__ uint32_t lcg_next(uint32_t v) {
  return 1664525u * v + 1013904223u;
}

// [0, 1) from the low 24 bits of an (already advanced) word: exact in f32.
__device__ __forceinline__ float unif(uint32_t v) {
  return __fmul_rn((float)(v & 0x00FFFFFFu), 0x1p-24f);
}

// 8-round TEA of the episode index: the first LCG word of the episode.
__device__ __forceinline__ uint32_t tea_seed(uint32_t idx) {
  uint32_t v0 = idx, v1 = 0u, s0 = 0u;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    s0 += 0x9E3779B9u;
    v0 += ((v1 << 4) + 0xA341316Cu) ^ (v1 + s0) ^ ((v1 >> 5) + 0xC8013EA4u);
    v1 += ((v0 << 4) + 0xAD90777Du) ^ (v0 + s0) ^ ((v0 >> 5) + 0x7E95761Eu);
  }
  return v0;
}

// ---- the scan --------------------------------------------------------------

// Shared memory the two block-wide helpers below need (ints).
constexpr int SCAN_SMEM_INTS = 64;

// Exclusive rank of `flag` among the block's threads in thread order;
// `total` receives the block's count.  Every thread of the block must call it
// (threads past the batch pass false).  Blocks are whole warps.
__device__ __forceinline__ int block_rank(bool flag, int* smem, int* total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  const unsigned ballot = __ballot_sync(FULL_MASK, flag);
  const int in_warp = __popc(ballot & ((1u << lane) - 1u));
  if (lane == 0) smem[warp] = __popc(ballot);
  __syncthreads();
  if (warp == 0) {
    int v = lane < nwarps ? smem[lane] : 0;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int u = __shfl_up_sync(FULL_MASK, v, d);
      if (lane >= d) v += u;
    }
    smem[32 + lane] = v;  // inclusive scan over the warps
  }
  __syncthreads();
  const int before = warp == 0 ? 0 : smem[32 + warp - 1];
  *total = smem[32 + nwarps - 1];
  __syncthreads();  // smem is reused by the next call
  return before + in_warp;
}

__device__ __forceinline__ int warp_sum(int v) {
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) v += __shfl_down_sync(FULL_MASK, v, d);
  return v;
}

// Sum of `totals[0, b)` (the done worlds of the blocks before block b) and of
// `totals[0, G)`, computed by the whole block; uint32 as the episode counter.
// A caller that needs only the first passes G = b and reads no later block.
__device__ __forceinline__ void block_offsets(const int* totals, int b, int G,
                                              int* smem, uint32_t* before,
                                              uint32_t* all) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  int sb = 0, sa = 0;
  for (int i = threadIdx.x; i < G; i += blockDim.x) {
    // past L1: other blocks wrote these since this block last read them
    const int v = __ldcg(totals + i);
    sa += v;
    sb += i < b ? v : 0;
  }
  sb = warp_sum(sb);
  sa = warp_sum(sa);
  if (lane == 0) { smem[warp] = sb; smem[32 + warp] = sa; }
  __syncthreads();
  int tb = 0, ta = 0;
  for (int w = 0; w < nwarps; ++w) { tb += smem[w]; ta += smem[32 + w]; }
  *before = (uint32_t)tb;
  *all = (uint32_t)ta;
  __syncthreads();
}

// ---- the single-pass scan (one launch, no grid-wide sync) -------------------
//
// A kernel whose blocks each own a tile of worlds ranks them in one launch
// by a decoupled look-back (Merrill and Garland, "Single-pass Parallel
// Prefix Scan with Decoupled Look-back"): tile t publishes its count, then
// its inclusive prefix, in flags[t] (status 1 or 2 in the high word, the
// value in the low one); its exclusive prefix sums the counts of the tiles
// before it back to the nearest inclusive prefix.  Tiles are
// numbered by a ticket taken as each block starts, so every tile a block
// waits on belongs to a block that started before it.  The ticket and the
// flags must be zero at launch.

__device__ __forceinline__ unsigned long long take_ticket(unsigned long long* ticket) {
  return atomicAdd(ticket, 1ull);
}

// Tile `tile`'s exclusive prefix of the counts in tile order, for a tile of
// `count`; called by one whole warp, which returns it on every lane.
__device__ __forceinline__ uint32_t look_back(unsigned long long* flags, int tile,
                                              uint32_t count) {
  const int lane = threadIdx.x & 31;
  volatile unsigned long long* f = flags;
  if (lane == 0) f[tile] = (tile == 0 ? 2ull : 1ull) << 32 | count;
  uint32_t before = 0;
  for (int p = tile - 1; p >= 0;) {
    // lane l reads tile p - l; before tile 0 the prefix is 0
    const unsigned long long v = p - lane >= 0 ? f[p - lane] : 2ull << 32;
    const unsigned inc = __ballot_sync(FULL_MASK, (v >> 32) == 2u);
    const unsigned wait = __ballot_sync(FULL_MASK, (v >> 32) == 0u);
    // the lanes up to the nearest inclusive prefix are the ones to add
    const unsigned upto = inc ? ((inc & (0u - inc)) << 1) - 1u : FULL_MASK;
    if (wait & upto) continue;  // a tile has not published yet: read again
    uint32_t s = (upto >> lane) & 1u ? (uint32_t)v : 0u;
#pragma unroll
    for (int d = 16; d > 0; d >>= 1) s += __shfl_xor_sync(FULL_MASK, s, d);
    before += s;
    if (inc) break;
    p -= 32;
  }
  if (lane == 0 && tile > 0) f[tile] = 2ull << 32 | (before + count);
  return before;
}

// ---- the persistent rollouts (K6, K10) --------------------------------------
//
// A rollout runs T steps in one cooperative launch.  Its two kernels run one
// body: with every world's carry in the block's dynamic shared memory (the
// on-chip kernel: blocks of up to ROLLOUT_THREADS threads, sized to spread
// the worlds over every SM, up to ROLLOUT_MAX_SLOTS worlds a thread), or in
// the output arrays in device memory (blocks of THREADS).  Block b owns the
// worlds [b * slots * threads, (b + 1) * slots * threads), slot s of thread
// t being world s * threads + t of them.  A step ranks its resets in one
// pass: a ballot per (slot, warp), whose count lane 0 notes in world order
// at cnt[s * warps + warp]; one block barrier; `scan_counts` by the first
// warp; the block's total to a buffer of the step's parity; one grid-wide
// sync; the counts of the blocks before it; then each warp hands its done
// worlds to its lanes in order (`nth_done`), so a warp draws about one fresh
// episode a lane, not one per slot that holds a reset.

constexpr int ROLLOUT_THREADS = 1024;
constexpr int ROLLOUT_MAX_SLOTS = 8;  // 8,192 worlds a block: 224 KB at 28 B each
constexpr int RANK_COUNTS = 256;      // (slot, warp) counts a step, at most
static_assert(ROLLOUT_MAX_SLOTS * (ROLLOUT_THREADS / 32) <= RANK_COUNTS &&
                  MAX_ROLLOUT_SLOTS * (THREADS / 32) <= RANK_COUNTS,
              "a step's (slot, warp) counts fit the scan");

// The first warp: the exclusive scan of the block's `n` (slot, warp) counts
// in place, RANK_COUNTS / 32 consecutive counts a lane; returns the block's
// total on every lane.
__device__ __forceinline__ int scan_counts(int* cnt, int n) {
  constexpr int PER = RANK_COUNTS / 32;
  const int lane = threadIdx.x & 31;
  int v[PER], sum = 0;
#pragma unroll
  for (int k = 0; k < PER; ++k) {
    const int j = lane * PER + k;
    v[k] = j < n ? cnt[j] : 0;
    sum += v[k];
  }
  int incl = sum;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int u = __shfl_up_sync(FULL_MASK, incl, d);
    if (lane >= d) incl += u;
  }
  int run = incl - sum;
#pragma unroll
  for (int k = 0; k < PER; ++k) {
    const int j = lane * PER + k;
    if (j < n) cnt[j] = run;
    run += v[k];
  }
  return __shfl_sync(FULL_MASK, incl, 31);
}

// The done worlds of the calling warp this step; bit s of `dmask` is the
// lane's done flag in slot s.
__device__ __forceinline__ int warp_resets(uint32_t dmask, int slots) {
  int resets = 0;
  for (int s = 0; s < slots; ++s) resets += __popc(__ballot_sync(FULL_MASK, (dmask >> s) & 1u));
  return resets;
}

// The warp's j-th done world in (slot, lane) order: its index in the block's
// run of worlds, or -1 past the warp's last, and in `rank` its rank in the
// block (`cnt` as scan_counts leaves it).  Called by the whole warp.
__device__ __forceinline__ int nth_done(uint32_t dmask, int slots, const int* cnt, int j,
                                        uint32_t* rank) {
  const int warp = threadIdx.x >> 5, warps = blockDim.x >> 5;
  int i = -1, seen = 0;
  for (int s = 0; s < slots; ++s) {
    const unsigned b = __ballot_sync(FULL_MASK, (dmask >> s) & 1u);
    const int c = __popc(b);
    if (j >= seen && j < seen + c) {
      unsigned rest = b;  // drop the j - seen lowest
      for (int k = 0; k < j - seen; ++k) rest &= rest - 1u;
      i = s * blockDim.x + warp * 32 + __ffs(rest) - 1;
      *rank = (uint32_t)cnt[s * warps + warp] + (uint32_t)(j - seen);
    }
    seen += c;
  }
  return i;
}

// ---- the one-launch step kernels (K5, K7, K9) -------------------------------
//
// A step kernel's block takes a tile of `per` consecutive worlds by ticket,
// world s * THREADS + t of it in slot s of thread t, steps its slots, notes
// each slot's done worlds with a ballot per (slot, warp) in `cnt` (no block
// barrier), then `step_rank` gives the tile's first episode index over the
// batch, and each warp draws its done worlds one a lane (`warp_resets`,
// `nth_done`, above; K5, K9), or each done world is drawn in place in a second
// pass over the tile (K7, csrc/balance.cu).  Scan words (64-bit): the ticket,
// the count of tiles past their look-back, then one look-back word per tile.
// They must be zero at the first launch; the last tile past its look-back
// (when no tile reads a flag any more) zeroes them for the next, so a step is
// one kernel node, with no memset.
constexpr int SCAN_HEAD = 2;

// Ints of scan words for a step over N worlds: at most one tile a THREADS
// worlds (step_plan's tiles are whole rows of at least 128 worlds, spread
// over at most N / THREADS blocks).  ops/_build.py's step_scan_ints mirrors it.
inline int step_scan_ints(int N) { return 2 * (SCAN_HEAD + (N + THREADS - 1) / THREADS); }

// The tile of the calling block, in the order the blocks start, so that every
// tile a look-back waits on belongs to a running block.
__device__ __forceinline__ int step_tile(unsigned long long* scan) {
  __shared__ int tile_s;
  if (threadIdx.x == 0) tile_s = (int)take_ticket(scan);
  __syncthreads();
  return tile_s;
}

// After the tile's slots: the first warp scans the `slots * THREADS / 32`
// (slot, warp) counts in `cnt` in place (world order; `nth_done` reads the
// ranks), takes the tile's offset over the batch by the look-back, and the
// last tile in world order writes the counter after the step; the tile to
// pass its look-back last zeroes the scan words.  Returns the tile's first
// episode index on every thread, after one block barrier.
__device__ __forceinline__ uint32_t step_rank(unsigned long long* scan, int tile, int slots,
                                              int* cnt, const int64_t* cnt_in,
                                              int64_t* cnt_out) {
  __shared__ uint32_t first_s;
  __shared__ bool last_s;
  __syncthreads();
  if (threadIdx.x < 32) {
    const uint32_t total = (uint32_t)scan_counts(cnt, slots * (THREADS / 32));
    const uint32_t before = look_back(scan + SCAN_HEAD, tile, total);
    if (threadIdx.x == 0) {
      first_s = (uint32_t)cnt_in[0] + before;
      if (tile == (int)gridDim.x - 1) cnt_out[0] = (int64_t)(first_s + total);
      __threadfence();  // this tile's reads of the flags come first
      last_s = atomicAdd(scan + 1, 1ull) == gridDim.x - 1u;
    }
  }
  __syncthreads();
  if (last_s) {
    for (int i = threadIdx.x; i < SCAN_HEAD + (int)gridDim.x; i += THREADS) scan[i] = 0ull;
  }
  return first_s;
}

// The sums of `totals[0, b)` and `totals[0, G)` (as block_offsets), taken
// by the first warp alone, 8 loads in flight a lane, and handed to the block
// through `out` with one barrier.  The caller must pass a block barrier
// before the first warp's next call, which rewrites `out`.
__device__ __forceinline__ void first_warp_offsets(const int* totals, int b, int G,
                                                   uint32_t* out, uint32_t* before,
                                                   uint32_t* all) {
  constexpr int PER = 8;
  if (threadIdx.x < 32) {
    int sb = 0, sa = 0;
    for (int i0 = 0; i0 < G; i0 += 32 * PER) {
      int v[PER];
#pragma unroll
      for (int k = 0; k < PER; ++k) {
        const int i = i0 + 32 * k + threadIdx.x;
        v[k] = i < G ? __ldcg(totals + i) : 0;  // past L1: other blocks wrote these
      }
#pragma unroll
      for (int k = 0; k < PER; ++k) {
        sa += v[k];
        sb += i0 + 32 * k + (int)threadIdx.x < b ? v[k] : 0;
      }
    }
#pragma unroll
    for (int d = 16; d > 0; d >>= 1) {
      sb += __shfl_xor_sync(FULL_MASK, sb, d);
      sa += __shfl_xor_sync(FULL_MASK, sa, d);
    }
    if (threadIdx.x == 0) { out[0] = (uint32_t)sb; out[1] = (uint32_t)sa; }
  }
  __syncthreads();
  *before = out[0];
  *all = out[1];
}

// A step kernel's tiles for N worlds and the worlds a tile: the resident grid
// of `kernel` (asked once per kernel and device: the device queries and the
// occupancy calculator cost host time on every call otherwise), each tile a
// whole number of 128-world rows (one warp for each scheduler of an SM) and
// at most MAX_ROLLOUT_SLOTS slots; at most one tile a THREADS worlds.
inline cudaError_t step_plan(const void* kernel, int N, int device, int* tiles, int* per) {
  static std::mutex mu;
  static std::map<std::pair<const void*, int>, int> resident;
  int max_blocks;
  {
    std::lock_guard<std::mutex> lock(mu);
    const auto key = std::make_pair(kernel, device);
    const auto hit = resident.find(key);
    if (hit == resident.end()) {
      const cudaError_t err = resident_blocks(kernel, device, &max_blocks);
      if (err != cudaSuccess) return err;
      resident[key] = max_blocks;
    } else {
      max_blocks = hit->second;
    }
  }
  constexpr int ROW = 128;
  const int need = (N + THREADS - 1) / THREADS;
  const int want = max_blocks < need ? max_blocks : need;
  const int rows = ((N + want - 1) / want + ROW - 1) / ROW;
  *per = rows * ROW < MAX_ROLLOUT_SLOTS * THREADS ? rows * ROW : MAX_ROLLOUT_SLOTS * THREADS;
  *tiles = (N + *per - 1) / *per;
  return cudaSuccess;
}

// A rollout's launch: which kernel, its grid and its dynamic shared memory.
struct Shape {
  bool onchip;
  int blocks, threads, slots;
  size_t smem;
};

// The shape of a rollout over N worlds: the on-chip kernel with the fewest
// slots at which blocks of whole warps (at most ROLLOUT_THREADS) spread the
// worlds over every SM, each block resident with its carry of `carry_bytes`
// a world beside the kernel's static shared memory; else the device-memory
// kernel on the
// resident grid of THREADS-thread blocks.  Computed once per kernel, device
// and N (the device queries and the occupancy calculator cost host time on
// every call otherwise); the on-chip kernel's dynamic shared memory limit is
// raised to all the card allows once per device.
inline cudaError_t rollout_shape(const void* onchip_kernel, const void* device_kernel,
                                 int carry_bytes, int N, int device, Shape* sh) {
  static std::mutex mu;
  static std::map<std::tuple<const void*, int, int>, Shape> shapes;
  static std::map<std::pair<const void*, int>, int> rooms;  // dynamic bytes a block
  std::lock_guard<std::mutex> lock(mu);
  const auto key = std::make_tuple(onchip_kernel, device, N);
  const auto hit = shapes.find(key);
  if (hit != shapes.end()) {
    *sh = hit->second;
    return cudaSuccess;
  }
  int sms = 0, optin = 0;
  cudaError_t err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (err != cudaSuccess) return err;
  if (!rooms.count({onchip_kernel, device})) {
    cudaFuncAttributes attr;
    err = cudaFuncGetAttributes(&attr, onchip_kernel);
    if (err != cudaSuccess) return err;
    const int room = optin - (int)attr.sharedSizeBytes;
    err = cudaFuncSetAttribute(onchip_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, room);
    if (err != cudaSuccess) return err;
    rooms[{onchip_kernel, device}] = room;
  }
  const int room = rooms[{onchip_kernel, device}];
  Shape out{false, 0, THREADS, 0, 0};
  bool found = false;
  for (int k = 1; k <= ROLLOUT_MAX_SLOTS && !found; ++k) {
    const int per_sm = (N + sms * k - 1) / (sms * k);  // threads an SM at k slots
    const int threads = (per_sm + 31) / 32 * 32;
    if (threads > ROLLOUT_THREADS) continue;
    const size_t need = (size_t)k * threads * carry_bytes;
    if (need > (size_t)room) break;
    int resident = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&resident, onchip_kernel, threads, need);
    if (err != cudaSuccess) return err;
    const int g = (N + k * threads - 1) / (k * threads);
    if (g <= resident * sms) {
      out = Shape{true, g, threads, k, need};
      found = true;
    }
  }
  if (!found) {
    int max_blocks = 0;
    err = resident_blocks(device_kernel, device, &max_blocks);
    if (err != cudaSuccess) return err;
    split(N, max_blocks, &out.blocks, &out.slots);
  }
  shapes[key] = out;
  *sh = out;
  return cudaSuccess;
}

}  // namespace episode

// ---- phase stamps (K6, K10) -------------------------------------------------
//
// Compiled in only with -DEPISODE_PHASE_STAMPS (a build apart, by
// chip_smoke.py --phases): every warp of a rollout sums the SM clocks
// (clock64) it spends in each phase of its steps, and block 0 notes the
// global timer and its SM clock at the first and the last step, which gives
// the SM clock under load.  Phases: A (action, physics, done and the
// ballots), the block barrier after A, the counts' scan (the first warp),
// the grid-wide sync, the block's offset over the grid, and the draws.  The
// compiler may move work across a stamp, so neighbouring phases split
// approximately; their sum is the step.
#ifdef EPISODE_PHASE_STAMPS
namespace episode {
enum { PH_A, PH_BARRIER, PH_SCAN, PH_GRID, PH_OFFSETS, PH_DRAWS, PH_PHASES };
// the phases' clocks summed over the warps, then the number of warps
__device__ unsigned long long phase_clocks[PH_PHASES + 1];
// block 0's first thread: global timer (ns) and clock64 before the first
// step and after the last
__device__ long long phase_span[4];

__device__ __forceinline__ long long global_ns() {
  long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// The phase sums of the rollouts since the last call (PH_PHASES clocks and
// the number of warps), zeroed here, and the last rollout's span.
inline int phase_take(unsigned long long* clocks, long long* span) {
  cudaError_t err = cudaDeviceSynchronize();
  if (err == cudaSuccess) err = cudaMemcpyFromSymbol(clocks, phase_clocks, sizeof(phase_clocks));
  if (err == cudaSuccess) err = cudaMemcpyFromSymbol(span, phase_span, sizeof(phase_span));
  const unsigned long long zero[PH_PHASES + 1] = {};
  if (err == cudaSuccess) err = cudaMemcpyToSymbol(phase_clocks, zero, sizeof(zero));
  return (int)err;
}
}  // namespace episode

#define EPISODE_STAMPS_BEGIN                                          \
  long long ph_clocks[episode::PH_PHASES] = {}, ph_last = clock64();  \
  if (blockIdx.x == 0 && threadIdx.x == 0) {                          \
    episode::phase_span[0] = episode::global_ns();                    \
    episode::phase_span[1] = ph_last;                                 \
  }
#define EPISODE_STAMP(k)             \
  do {                               \
    const long long now = clock64(); \
    ph_clocks[k] += now - ph_last;   \
    ph_last = now;                   \
  } while (0)
#define EPISODE_STAMPS_END                                                        \
  if ((threadIdx.x & 31) == 0) {                                                  \
    for (int k = 0; k < episode::PH_PHASES; ++k)                                  \
      atomicAdd(&episode::phase_clocks[k], (unsigned long long)ph_clocks[k]);     \
    atomicAdd(&episode::phase_clocks[episode::PH_PHASES], 1ull);                  \
  }                                                                               \
  if (blockIdx.x == 0 && threadIdx.x == 0) {                                      \
    episode::phase_span[2] = episode::global_ns();                                \
    episode::phase_span[3] = clock64();                                           \
  }
#else
#define EPISODE_STAMPS_BEGIN
#define EPISODE_STAMP(k) \
  do {                   \
  } while (0)
#define EPISODE_STAMPS_END
#endif
