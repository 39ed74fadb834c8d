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
//   * or, in a kernel of one launch without a grid-wide sync (K3),
//     `look_back` sums them as each block's predecessors publish them.
//
// The world -> (block, slot, thread) map below assigns each block a
// contiguous run of worlds, so (block, slot, thread) order is world order,
// and the loads of one slot are coalesced.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

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

}  // namespace episode
