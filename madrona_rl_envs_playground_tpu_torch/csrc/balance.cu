// Balance Beam step kernels for Hopper (sm_90a), bound through a plain C
// interface and loaded with ctypes (ops/balance.py).
//
// K7 `bb_step_kernel` replaces the per-step Pallas kernel
//   madrona_rl_envs_playground_tpu/ops/balance_pallas.py::_build_kernel
//   (body _make_step2, launched by fused_step): the move, the rolling obs
//   history, the reward (colocation, distance, fall-off), termination, the
//   world-order episode index of every world that resets and its TEA+LCG
//   reset draw (2 positions).  One kernel launch, as K5's and K9's (a tile
//   of worlds spread on the resident grid a block, ranked over the batch by
//   a look-back; csrc/episode_scan.cuh), in two passes over the tile (which
//   worlds end; then step, draw and write each world once, in world order),
//   with each warp's obs records staged through shared memory (see K7
//   below).
// K8 `bb_rollout_kernel` replaces the persistent rollout Pallas kernels
//   ops/balance_pallas.py::_build_rollout_kernel and
//   _build_rollout_kernel_packed (fused_rollout): T steps in one cooperative
//   launch with per-(world, seat) LCG actions (a = (u24 * 4) >> 24 of bits
//   8..31 of the advanced word), a per-world done count and checksum
//   ((checksum + f32(sum of the 14 obs values)) + reward) + f32(done) after
//   every step.  Episodes are allocated per step in whole-batch world order,
//   as in csrc/cartpole.cu's K6 (one grid-wide sync per step), so the
//   checksums equal JAX's fused_rollout with one block (block == N) and
//   differ from JAX's at bench.py's block of 16,384.  A world's first two
//   steps run on the full-width state, whose obs history comes from the
//   input; from the third on, on a 24-byte carry (the packed positions
//   word, the time, the action words, the done count and the checksum; see
//   K8's carry below), so any int32 input stays exact.
//
// Layout.  Env-major, the layout the policy reads: loc [N, 2], obs
// [N, 2, 7] (seat-major per world), time [N] and the episode LCG word [N],
// all int32; the reward is f32 [N] (both seats get it).  The per-step
// actions are [N, 2] int32, as the sampler draws them; the rollout's action
// words are [2, N], as JAX's init_action_rng lays them out.  Worlds are
// assigned to blocks and slots as in csrc/cartpole.cu (K7 as K5, K8 as
// episode_scan.cuh's `world`).
//
// What bounds them on an H100.  K7 moves 157 B per world-step (80 B read, 77 B
// written, each once in one launch) for about 60 integer operations, so
// device-memory bytes bound it, and a world's 56-B obs record, 8 B past a 16-B
// boundary at every odd world, is most of them: a warp moves its 32 records as
// whole 16-B words through shared memory.  K8 reads and writes each world once
// per launch and does its operations T times, so operations bound it; its
// carry of 24 B a world (25 MB at 1M worlds) stays in the L2, and a step moves
// about 40 B of it per world there, beside the grid-wide sync per step.

#include <cooperative_groups.h>
#include <cstdint>
#include <cuda_runtime.h>

#include "episode_scan.cuh"

namespace cg = cooperative_groups;
using episode::THREADS;
using episode::world;

namespace {

constexpr int NUM_SPACES = 5;
constexpr int TIME = 3;
constexpr int BUFFER = 2;
constexpr int OBS = 2 * (2 * TIME + 1);  // 14 ints per world
constexpr float SCALE = 0x1.99999ap-3f;   // float32(0.2)

struct Beam {
  int l0, l1, t;
  int obs[OBS];
};

__device__ __forceinline__ Beam load(const int2* loc, const int2* obs, const int32_t* time,
                                     int n) {
  Beam b;
  const int2 l = loc[n];
  b.l0 = l.x;
  b.l1 = l.y;
  b.t = time[n];
#pragma unroll
  for (int k = 0; k < OBS / 2; ++k) {
    const int2 o = obs[(size_t)n * (OBS / 2) + k];
    b.obs[2 * k] = o.x;
    b.obs[2 * k + 1] = o.y;
  }
  return b;
}

__device__ __forceinline__ void store(int2* loc, int2* obs, int32_t* time, int n,
                                      const Beam& b) {
  loc[n] = make_int2(b.l0, b.l1);
  time[n] = b.t;
#pragma unroll
  for (int k = 0; k < OBS / 2; ++k)
    obs[(size_t)n * (OBS / 2) + k] = make_int2(b.obs[2 * k], b.obs[2 * k + 1]);
}

__device__ __forceinline__ int move(int a) {
  return a == 0 ? -2 : a == 1 ? -1 : a == 2 ? 1 : 2;  // MOVES = [-2, -1, 1, 2]
}

// One step; sets the reward and returns done.  Semantics:
// envs/balance_beam.py (both packages).
__device__ __forceinline__ bool transition(Beam& b, int a0, int a1, float* rew) {
  const int l0 = b.l0 + move(a0), l1 = b.l1 + move(a1);
  const int t = b.t - 1;
  const int diff = l0 - l1;
  float r = diff == 0 ? 1.0f : __fmul_rn(-(float)abs(diff), SCALE);
  const bool off = l0 < 0 || l0 >= NUM_SPACES || l1 < 0 || l1 >= NUM_SPACES;
  if (off) r = __fmul_rn(__fmul_rn(-(float)NUM_SPACES, (float)(t + 1)), SCALE);
  *rew = r;
  // rolling history: shift both 3-slots down, write own / partner and time
  int o[OBS];
#pragma unroll
  for (int p = 0; p < 2; ++p) {
    const int r0 = p * (2 * TIME + 1);
    o[r0] = (p == 0 ? l0 : l1) + BUFFER;
    o[r0 + 1] = b.obs[r0];
    o[r0 + 2] = b.obs[r0 + 1];
    o[r0 + 3] = (p == 0 ? l1 : l0) + BUFFER;
    o[r0 + 4] = b.obs[r0 + 3];
    o[r0 + 5] = b.obs[r0 + 4];
    o[r0 + 6] = t;
  }
  b.l0 = l0;
  b.l1 = l1;
  b.t = t;
#pragma unroll
  for (int k = 0; k < OBS; ++k) b.obs[k] = o[k];
  return off || t == 0;
}

// The fresh episode `idx`: TEA seed, then two positions int(5 * rand()).
__device__ __forceinline__ Beam fresh(uint32_t idx, uint32_t* word) {
  const uint32_t v1 = episode::lcg_next(episode::tea_seed(idx));
  const uint32_t v2 = episode::lcg_next(v1);
  Beam b;
  b.l0 = (int)__fmul_rn((float)NUM_SPACES, episode::unif(v1));
  b.l1 = (int)__fmul_rn((float)NUM_SPACES, episode::unif(v2));
  b.t = TIME - 1;
#pragma unroll
  for (int k = 0; k < OBS; ++k) b.obs[k] = 0;
  b.obs[0] = b.l0 + BUFFER;
  b.obs[3] = b.l1 + BUFFER;
  b.obs[6] = b.t;
  b.obs[7] = b.l1 + BUFFER;
  b.obs[10] = b.l0 + BUFFER;
  b.obs[13] = b.t;
  *word = v2;
  return b;
}

__device__ __forceinline__ float obs_sum(const Beam& b) {
  uint32_t s = 0u;  // int32 sum, wrapping as JAX's
#pragma unroll
  for (int k = 0; k < OBS; ++k) s += (uint32_t)b.obs[k];
  return (float)(int32_t)s;
}

__device__ __forceinline__ int action(uint32_t w) {
  return (int)((((w >> 8) & 0x00FFFFFFu) * 4u) >> 24);
}

// ---- K7 ---------------------------------------------------------------------

// 16 bytes from device to shared memory in the background (cp.async): the
// first `bytes` of them read, the rest zero-filled.  A thread's copies
// since its last commit form a group; `copy_wait_all_but_one` returns when
// every group of the thread but the newest has landed.
__device__ __forceinline__ void copy_async(int4* smem, const int4* gmem, int bytes) {
  const unsigned dst = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(gmem), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void copy_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void copy_wait_all_but_one() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

constexpr int WARP_WORDS = 32 * OBS / 4;  // a warp's 32 obs records in 16-B words: 112

// The obs records of the warp's `count` worlds from world `first` (a
// multiple of 32: a 16-B boundary) into `buf`, in whole 16-B words, lane l
// copying words l, l + 32, ...; the last word of an odd count is half
// read.  Every lane commits one group, empty or not.
__device__ __forceinline__ void load_records(int4* buf, const int* obs, int first, int count) {
  const int bytes = count * OBS * 4;
  const int4* src = reinterpret_cast<const int4*>(obs + (size_t)first * OBS);
  for (int k = threadIdx.x & 31; 16 * k < bytes; k += 32)
    copy_async(buf + k, src + k, min(16, bytes - 16 * k));
  copy_commit();
}

// The warp's `count` records in `buf` back to `obs` from world `first`, as
// load_records read them: whole 16-B words, the last one of an odd count
// its first 8-B half.
__device__ __forceinline__ void store_records(int* obs, int first, const int4* buf, int count) {
  const int bytes = count * OBS * 4;
  int4* dst = reinterpret_cast<int4*>(obs + (size_t)first * OBS);
  for (int k = threadIdx.x & 31; 16 * k < bytes; k += 32) {
    const int4 v = buf[k];
    if (bytes - 16 * k >= 16) {
      dst[k] = v;
    } else {
      *reinterpret_cast<int2*>(dst + k) = make_int2(v.x, v.y);
    }
  }
}

// Whether a world's step ends its episode (transition's result), from its
// positions, time and actions alone.
__device__ __forceinline__ bool ends(int2 l, int t, int2 a) {
  const int l0 = l.x + move(a.x), l1 = l.y + move(a.y);
  return l0 < 0 || l0 >= NUM_SPACES || l1 < 0 || l1 >= NUM_SPACES || t - 1 == 0;
}

// A tile is `per` consecutive worlds (episode::step_plan), in two passes.
// Pass 1 reads loc, time and the actions, notes which worlds end (`ends`)
// with a ballot per (slot, warp), and the tile is ranked (step_rank).  Pass
// 2 steps every world, draws each done world's fresh episode in place (its
// rank: its (slot, warp)'s count before it and the lanes before it), and
// writes every output once, in world order: each warp stages its 32 worlds'
// obs records a slot in shared memory, two buffers a warp (the next slot's
// records are copied in while this slot steps; each thread reads and
// writes its own record there), and stores them as whole 16-B words;
// loc, time, the episode word and the actions of the next slot are loaded
// into registers meanwhile.  Pass 2 reads loc, time and the actions again,
// from L2.  (Compacted draws after one pass, as K5's and K9's, write a done
// world's record apart from its live neighbours', after the look-back, for
// 68 % of worlds at 3-step episodes; on an H100 that ran several times
// slower at 1M worlds: PERF.md, PR 9.)
__global__ void __launch_bounds__(THREADS)
bb_step_kernel(const int2* __restrict__ loc_in, const int* __restrict__ obs_in,
               const int32_t* __restrict__ time_in, const int32_t* __restrict__ rng_in,
               const int2* __restrict__ act, const int64_t* __restrict__ cnt_in,
               int2* __restrict__ loc_out, int* __restrict__ obs_out,
               int32_t* __restrict__ time_out, int32_t* __restrict__ rng_out,
               float* __restrict__ rew_out, bool* __restrict__ done_out,
               int64_t* __restrict__ cnt_out, unsigned long long* __restrict__ scan, int N,
               int per) {
  constexpr int WARPS = THREADS / 32;
  __shared__ int4 stage[WARPS][2][WARP_WORDS];  // 28,672 B
  __shared__ int cnt[episode::RANK_COUNTS];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int tile = episode::step_tile(scan);
  const int first = tile * per, slots = (per + THREADS - 1) / THREADS;
  const int last = min(per, N - first);  // worlds in this tile
  // the warp's worlds of slot s: first + s * THREADS + warp * 32 + [0, count)
  const auto count = [&](int s) { return min(32, max(0, last - (s * THREADS + warp * 32))); };
  // pass 1: which worlds end
  int2 nx_loc = make_int2(0, 0), nx_act = make_int2(0, 0);
  int nx_time = 0;
  if (tid < last) {
    nx_loc = loc_in[first + tid];
    nx_time = time_in[first + tid];
    nx_act = act[first + tid];
  }
  for (int s = 0; s < slots; ++s) {
    const int i = s * THREADS + tid, n = first + i;
    const bool done = i < last && ends(nx_loc, nx_time, nx_act);
    if (i + THREADS < last) {
      nx_loc = loc_in[n + THREADS];
      nx_time = time_in[n + THREADS];
      nx_act = act[n + THREADS];
    }
    const unsigned b = __ballot_sync(episode::FULL_MASK, done);
    if (lane == 0) cnt[s * WARPS + warp] = __popc(b);
  }
  // the first slot's records are copied in during the look-back
  load_records(stage[warp][0], obs_in, first + warp * 32, count(0));
  const uint32_t next = episode::step_rank(scan, tile, slots, cnt, cnt_in, cnt_out);
  // pass 2: step, draw, write
  int nx_rng = 0;
  if (tid < last) {
    nx_loc = loc_in[first + tid];
    nx_time = time_in[first + tid];
    nx_act = act[first + tid];
    nx_rng = rng_in[first + tid];
  }
  for (int s = 0; s < slots; ++s) {
    const int i = s * THREADS + tid, n = first + i, wfirst = first + s * THREADS + warp * 32;
    int4* buf = stage[warp][s & 1];
    Beam b;
    b.l0 = nx_loc.x;
    b.l1 = nx_loc.y;
    b.t = nx_time;
    const int2 a = nx_act;
    int rng = nx_rng;
    load_records(stage[warp][(s + 1) & 1], obs_in, wfirst + THREADS, count(s + 1));
    if (i + THREADS < last) {
      nx_loc = loc_in[n + THREADS];
      nx_time = time_in[n + THREADS];
      nx_act = act[n + THREADS];
      nx_rng = rng_in[n + THREADS];
    }
    copy_wait_all_but_one();
    __syncwarp();  // every lane's copies of this slot have landed
    int2* rec = reinterpret_cast<int2*>(reinterpret_cast<int*>(buf) + lane * OBS);
    bool done = false;
    float r = 0.0f;
    if (i < last) {
#pragma unroll
      for (int k = 0; k < OBS / 2; ++k) {
        const int2 o = rec[k];
        b.obs[2 * k] = o.x;
        b.obs[2 * k + 1] = o.y;
      }
      done = transition(b, a.x, a.y, &r);
    }
    const unsigned db = __ballot_sync(episode::FULL_MASK, done);
    if (i < last) {
      if (done) {
        uint32_t w;
        const uint32_t rank = (uint32_t)cnt[s * WARPS + warp] + __popc(db & ((1u << lane) - 1u));
        b = fresh(next + rank, &w);
        rng = (int32_t)w;
      }
      rew_out[n] = r;
      done_out[n] = done;
      loc_out[n] = make_int2(b.l0, b.l1);
      time_out[n] = b.t;
      rng_out[n] = rng;
#pragma unroll
      for (int k = 0; k < OBS / 2; ++k) rec[k] = make_int2(b.obs[2 * k], b.obs[2 * k + 1]);
    }
    __syncwarp();  // every lane's record is in the buffer
    store_records(obs_out, wfirst, buf, count(s));
    __syncwarp();  // the buffer is read before the slot after next is copied in
  }
}

// ---- K8 ---------------------------------------------------------------------

// K8's carry after a world's first two steps: one word of positions, the
// int32 time and the action words, done count and checksum (the last three
// are the outputs themselves), 24 B a world.  After two steps the obs
// history of a world is fixed by its positions: each seat's t-1 and t-2
// slots hold earlier positions + BUFFER (or the zeros of a fresh episode),
// and seat 1's history repeats seat 0's (obs[8] = obs[4], obs[9] = obs[5],
// obs[11] = obs[1], obs[12] = obs[2]).  The word holds l0, l1 and seat 0's
// history o1 = obs[1], o2 = obs[2], o4 = obs[4], o5 = obs[5], a nibble each
// (positions 0..4, history 0 or 2..6).  A done world's word holds its
// reward's bits until phase B replaces it with the fresh episode.
constexpr int NIB = 4;

__device__ __forceinline__ int nib(uint32_t w, int i) { return (int)((w >> (NIB * i)) & 0xFu); }

__device__ __forceinline__ uint32_t pack_pos(int l0, int l1, int o1, int o2, int o4, int o5) {
  // masked: at the switch o2 and o5 may still hold launch-time values, which
  // the next step drops (see the header)
  const uint32_t v[6] = {(uint32_t)l0, (uint32_t)l1, (uint32_t)o1, (uint32_t)o2, (uint32_t)o4,
                         (uint32_t)o5};
  uint32_t w = 0u;
#pragma unroll
  for (int i = 0; i < 6; ++i) w |= (v[i] & 0xFu) << (NIB * i);
  return w;
}

// The full-width world of a packed one.
__device__ __forceinline__ Beam unpack_pos(uint32_t w, int t) {
  Beam b;
  b.l0 = nib(w, 0);
  b.l1 = nib(w, 1);
  b.t = t;
  const int o[OBS] = {b.l0 + BUFFER, nib(w, 2), nib(w, 3), b.l1 + BUFFER, nib(w, 4), nib(w, 5), t,
                      b.l1 + BUFFER, nib(w, 4), nib(w, 5), b.l0 + BUFFER, nib(w, 2), nib(w, 3), t};
#pragma unroll
  for (int k = 0; k < OBS; ++k) b.obs[k] = o[k];
  return b;
}

// The reward of a move to (l0, l1) with t steps left after it (transition's).
__device__ __forceinline__ float reward(int l0, int l1, int t) {
  const int diff = l0 - l1;
  float r = diff == 0 ? 1.0f : __fmul_rn(-(float)abs(diff), SCALE);
  if (l0 < 0 || l0 >= NUM_SPACES || l1 < 0 || l1 >= NUM_SPACES)
    r = __fmul_rn(__fmul_rn(-(float)NUM_SPACES, (float)(t + 1)), SCALE);
  return r;
}

// One step of a packed world: sets the reward and the int32 sum of the new
// obs (the 14 values, wrapping as JAX's), and returns done.
__device__ __forceinline__ bool packed_step(uint32_t& w, int& t, int a0, int a1, float* rew,
                                            float* sum) {
  const int l0 = nib(w, 0), l1 = nib(w, 1);
  const int n0 = l0 + move(a0), n1 = l1 + move(a1);
  t -= 1;
  *rew = reward(n0, n1, t);
  // both seats see n0, l0, o1, n1, l1, o4 (+ BUFFER on positions) and t
  const uint32_t half = (uint32_t)(n0 + l0 + n1 + l1 + 4 * BUFFER + nib(w, 2) + nib(w, 4)) +
                        (uint32_t)t;
  *sum = (float)(int32_t)(2u * half);
  w = pack_pos(n0, n1, l0 + BUFFER, nib(w, 2), l1 + BUFFER, nib(w, 4));
  return n0 < 0 || n0 >= NUM_SPACES || n1 < 0 || n1 >= NUM_SPACES || t == 0;
}

__global__ void __launch_bounds__(THREADS)
bb_rollout_kernel(const int2* __restrict__ loc_in, const int2* __restrict__ obs_in,
                  const int32_t* __restrict__ time_in, const int32_t* __restrict__ rng_in,
                  const int32_t* __restrict__ arng_in, const int64_t* __restrict__ cnt_in,
                  int2* __restrict__ loc, int2* __restrict__ obs, int32_t* __restrict__ time,
                  int32_t* __restrict__ rng, int32_t* __restrict__ arng,
                  int32_t* __restrict__ dcnt, float* __restrict__ chk,
                  int64_t* __restrict__ cnt_out, uint32_t* __restrict__ pos,
                  int* __restrict__ totals, int N, int T, int slots) {
  __shared__ int smem[episode::SCAN_SMEM_INTS];
  cg::grid_group grid = cg::this_grid();
  const int G = gridDim.x;
  // the outputs are the working state, each world touched only by its owner:
  // the full-width loc, obs and time for the first two steps, whose obs
  // history comes from the input, then the packed word and time
  for (int s = 0; s < slots; ++s) {
    const int n = world(slots, s);
    if (n < N) {
      store(loc, obs, time, n, load(loc_in, obs_in, time_in, n));
      rng[n] = rng_in[n];
      arng[n] = arng_in[n];
      arng[N + n] = arng_in[N + n];
      dcnt[n] = 0;
      chk[n] = 0.0f;
    }
  }
  uint32_t base = (uint32_t)cnt_in[0];
  for (int t = 0; t < T; ++t) {
    const bool wide = t < 2;
    int* step_totals = totals + (t & 1) * G;
    // phase A: actions, step, done; live worlds are final for this step
    uint32_t dmask = 0u;
    int count = 0;
    for (int s = 0; s < slots; ++s) {
      const int n = world(slots, s);
      bool done = false;
      if (n < N) {
        const uint32_t w0 = episode::lcg_next((uint32_t)arng[n]);
        const uint32_t w1 = episode::lcg_next((uint32_t)arng[N + n]);
        arng[n] = (int32_t)w0;
        arng[N + n] = (int32_t)w1;
        float r, sum;
        if (wide) {
          Beam b = load(loc, obs, time, n);
          done = transition(b, action(w0), action(w1), &r);
          if (!done) store(loc, obs, time, n, b);
          sum = obs_sum(b);
        } else {
          uint32_t w = t == 2 ? pack_pos(loc[n].x, loc[n].y, obs[(size_t)n * (OBS / 2)].y,
                                         obs[(size_t)n * (OBS / 2) + 1].x,
                                         obs[(size_t)n * (OBS / 2) + 2].x,
                                         obs[(size_t)n * (OBS / 2) + 2].y)
                              : pos[n];
          int tt = time[n];
          done = packed_step(w, tt, action(w0), action(w1), &r, &sum);
          if (!done) {
            pos[n] = w;
            time[n] = tt;
          }
        }
        if (done) {
          pos[n] = __float_as_uint(r);  // phase B adds it after the fresh obs
          dcnt[n] += 1;
        } else {
          chk[n] = __fadd_rn(__fadd_rn(__fadd_rn(chk[n], sum), r), 0.0f);
        }
      }
      dmask |= (uint32_t)done << s;
      count += __syncthreads_count(done);
    }
    if (threadIdx.x == 0) step_totals[blockIdx.x] = count;
    grid.sync();  // parity buffers: one sync a step (see csrc/cartpole.cu)
    // phase B: rank this step's resets over the whole batch and draw them
    uint32_t before, all;
    episode::block_offsets(step_totals, blockIdx.x, G, smem, &before, &all);
    uint32_t next = base + before;
    for (int s = 0; s < slots; ++s) {
      const int n = world(slots, s);
      const bool done = (dmask >> s) & 1u;
      int total;
      const int rank = episode::block_rank(done, smem, &total);
      if (done) {
        uint32_t w;
        const Beam b = fresh(next + (uint32_t)rank, &w);
        const float r = __uint_as_float(pos[n]);
        if (wide) {
          store(loc, obs, time, n, b);
        } else {
          pos[n] = pack_pos(b.l0, b.l1, 0, 0, 0, 0);
          time[n] = b.t;
        }
        rng[n] = (int32_t)w;
        chk[n] = __fadd_rn(__fadd_rn(__fadd_rn(chk[n], obs_sum(b)), r), 1.0f);
      }
      next += (uint32_t)total;
    }
    base += all;
  }
  if (T > 2) {  // the last packed words back into loc and obs
    for (int s = 0; s < slots; ++s) {
      const int n = world(slots, s);
      if (n < N) store(loc, obs, time, n, unpack_pos(pos[n], time[n]));
    }
  }
  if (blockIdx.x == 0 && threadIdx.x == 0) cnt_out[0] = (int64_t)base;
}

}  // namespace

extern "C" {

// Ints of scratch a K8 launch over N worlds needs (block counts, two parities).
int bb_scratch_ints(int N) { return episode::scratch_ints(N); }

// Ints of K7's scan words for N worlds (episode::step_scan_ints): zero
// before the first launch, and left zero by every launch.
int bb_step_scratch_ints(int N) { return episode::step_scan_ints(N); }

// `scratch`: the scan words, zero at the first launch (left zero by each).
int bb_step(const int32_t* loc_in, const int32_t* obs_in, const int32_t* time_in,
            const int32_t* rng_in, const int32_t* act, const int64_t* cnt_in,
            int32_t* loc_out, int32_t* obs_out, int32_t* time_out, int32_t* rng_out,
            float* rew, bool* done, int64_t* cnt_out, int* scratch, int N, int device,
            void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  int tiles = 0, per = 0;
  err = episode::step_plan((const void*)bb_step_kernel, N, device, &tiles, &per);
  if (err != cudaSuccess) return (int)err;
  bb_step_kernel<<<tiles, THREADS, 0, (cudaStream_t)stream>>>(
      reinterpret_cast<const int2*>(loc_in), obs_in, time_in, rng_in,
      reinterpret_cast<const int2*>(act), cnt_in, reinterpret_cast<int2*>(loc_out), obs_out,
      time_out, rng_out, rew, done, cnt_out, reinterpret_cast<unsigned long long*>(scratch), N,
      per);
  return (int)cudaGetLastError();
}

int bb_rollout(const int32_t* loc_in, const int32_t* obs_in, const int32_t* time_in,
               const int32_t* rng_in, const int32_t* arng_in, const int64_t* cnt_in,
               int32_t* loc, int32_t* obs, int32_t* time, int32_t* rng, int32_t* arng,
               int32_t* dcnt, float* chk, int64_t* cnt_out, uint32_t* pos, int* scratch,
               int N, int T, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  int max_blocks = 0, blocks = 0, slots = 0;
  err = episode::resident_blocks((const void*)bb_rollout_kernel, device, &max_blocks);
  if (err != cudaSuccess) return (int)err;
  episode::split(N, max_blocks, &blocks, &slots);
  if (slots > episode::MAX_ROLLOUT_SLOTS) return episode::ERR_TOO_MANY_ENVS;
  const int2* loc_in2 = reinterpret_cast<const int2*>(loc_in);
  const int2* obs_in2 = reinterpret_cast<const int2*>(obs_in);
  int2* loc2 = reinterpret_cast<int2*>(loc);
  int2* obs2 = reinterpret_cast<int2*>(obs);
  void* args[] = {(void*)&loc_in2, (void*)&obs_in2, (void*)&time_in, (void*)&rng_in,
                  (void*)&arng_in, (void*)&cnt_in,  (void*)&loc2,    (void*)&obs2,
                  (void*)&time,    (void*)&rng,     (void*)&arng,    (void*)&dcnt,
                  (void*)&chk,     (void*)&cnt_out, (void*)&pos,     (void*)&scratch,
                  (void*)&N,       (void*)&T,       (void*)&slots};
  err = cudaLaunchCooperativeKernel((const void*)bb_rollout_kernel, dim3(blocks), dim3(THREADS),
                                    args, 0, (cudaStream_t)stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

const char* bb_error_string(int err) { return episode::error_string(err); }

}  // extern "C"
