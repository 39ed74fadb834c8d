// Acrobot step kernels for Hopper (sm_90a), bound through a plain C
// interface and loaded with ctypes (ops/acrobot.py).
//
// K9 `ac_step_kernel` replaces the per-step Pallas kernel
//   madrona_rl_envs_playground_tpu/ops/acrobot_pallas.py::_build_kernel
//   (body _make_step, launched by fused_step): one RK4 step of the acrobot
//   dynamics, the angle wrap to [-pi, pi) and the velocity clamps, the
//   height or 501-step termination, the world-order episode index of every
//   world that resets and its TEA+LCG reset draw (4 uniforms).  One kernel
//   launch: a block steps a tile of worlds, ranks its done worlds over the
//   batch by a decoupled look-back over the tiles in the order the blocks
//   start (csrc/episode_scan.cuh), and each warp draws its done worlds'
//   fresh episodes.  No memset and no device query per call: the tiles fit
//   the resident grid, whose size is asked once per device, and the scan
//   words are left zero for the next launch.
// K10 `ac_rollout_onchip_kernel` / `ac_rollout_kernel` replace the
//   persistent rollout Pallas kernel ops/acrobot_pallas.py::
//   _build_rollout_kernel (fused_rollout): T steps in one cooperative
//   launch, actions from a per-env LCG (three torques: action = ((w >> 8) &
//   0xFFFFFF) * 3 >> 24 of the advanced word), a per-env done count and the
//   checksum chk + t1 + t2 + w1 + w2 + done after every step (float32, in
//   that order, on the state after the reset).  K6's design
//   (csrc/cartpole.cu, episode_scan.cuh's rollout section): the launcher
//   picks the kernel by N; where every block of the resident grid holds its
//   worlds' carry in shared memory (up to 8,192 worlds an SM), the on-chip
//   kernel, else the carry lies in the output arrays in device memory.  Each
//   step ranks its resets over the whole batch in one pass with one
//   grid-wide sync, so episodes are allocated per step in whole-batch world
//   order: K10 equals T applications of K9 and JAX's fused_rollout with one
//   block (block == N), not JAX's block-sequential order at more than one
//   block.
//
// Layout.  The state is env-major [N, 4] f32 (theta1, theta2, omega1,
// omega2): one 16-byte load and store per world, and the same memory is the
// [N, 1, 4] obs the policy reads.  The step counts and the episode LCG
// words are int32 [N].
//
// K10's carry is 28 B a world: the state, the action word, the checksum,
// and one word that packs the done count (bits 9-31) over the step count
// (bits 0-8).  A live world's step count is at most 500, so 9 bits hold it;
// a world that enters the launch with a count outside [0, 510] keeps the
// value WIDE in those bits and its exact count in the `steps` output in
// device memory until it resets, so any int32 count is stepped exactly.
// The done count is at most T, hence T <= MAX_T.  The episode LCG word
// changes only at a reset and is written straight to `rng`.
//
// Exactness.  Every operation is a __fadd_rn/__fsub_rn/__fmul_rn/__fdiv_rn,
// one IEEE rounding each, in the operation order of JAX's
// envs/acrobot._ds_dt and _rk4_step (nvcc never contracts these into FMAs),
// and the divisions are exact quotients, as PyTorch's division by a tensor
// is.  sinf, cosf and fmodf are the precise CUDA functions under nvcc's
// default flags, as in PyTorch's torch.sin/torch.cos/torch.remainder
// kernels, and sincosf gives both of one argument with their bits.  The constants are the float32 values JAX computes, written as
// hex floats; JAX folds some Python constants in double first
// (0.25 + 1.0 is 1.25, 2.0 * 0.5 * w2 is w2).  The step count adds one in
// int32 with wrap-around, as torch and JAX do.
//
// What bounds them on an H100.  A step is about 679 instructions a world
// (chip_smoke.py's AC_STEP_OPS: four evaluations of the dynamics with 18
// sin/cos and 16 divisions), so operations bound both: K9 moves 53 B per
// world-step against that (about 13 instructions a byte, the card's
// balance is 10), and K10 touches device memory only at its start and end
// and to store a reset's episode word, with its carry on chip at up to
// 8,192 worlds an SM.  The grid-wide sync and the ranking are a fixed cost
// a step.

#include <cooperative_groups.h>
#include <cstdint>
#include <cuda_runtime.h>

#include "episode_scan.cuh"

namespace cg = cooperative_groups;
using episode::THREADS;

namespace {

// float32 values of the JAX constants (envs/acrobot.py)
constexpr float QUARTER = 0.25f;
constexpr float HALF = 0.5f;
constexpr float FIVE_QUARTERS = 1.25f;           // 0.25 + 1.0, folded in double
constexpr float HALF_G = 0x1.39999ap+2f;         // f32(0.5) * f32(9.8)
constexpr float THREE_HALVES_G = 0x1.d66668p+3f; // f32(1.5) * f32(9.8), rounded
constexpr float HALF_PI = 0x1.921fb6p+0f;        // f32(pi / 2)
constexpr float PI = 0x1.921fb6p+1f;             // f32(pi)
constexpr float TWO_PI = 0x1.921fb6p+2f;         // f32(pi) - f32(-pi)
constexpr float MAX_VEL_1 = 0x1.921fb6p+3f;      // f32(4 pi)
constexpr float MAX_VEL_2 = 0x1.c463acp+4f;      // f32(9 pi)
constexpr float DT = 0x1.99999ap-3f;             // f32(0.2)
constexpr float HALF_DT = 0x1.99999ap-4f;        // f32(0.2) / 2
constexpr float SIXTH_DT = 0x1.111112p-5f;       // f32(0.2) / 6, rounded
constexpr float LO = -0x1.99999ap-4f;            // -0.1
constexpr float RANGE = 0x1.99999ap-3f;          // 0.1 - (-0.1)
constexpr int MAX_STEPS = 500;
constexpr int ERR_TOO_MANY_STEPS = -3;  // returned by ac_rollout

struct Arm {
  float t1, t2, w1, w2;
};

__device__ __forceinline__ Arm load(const float4* st, int n) {
  const float4 v = st[n];
  return {v.x, v.y, v.z, v.w};
}

__device__ __forceinline__ void store(float4* st, int n, const Arm& s) {
  st[n] = make_float4(s.t1, s.t2, s.w1, s.w2);
}

// d/dt of (t1, t2, w1, w2): (w1, w2, a1, a2).  JAX envs/acrobot._ds_dt.
// sincosf gives both of t2 in fewer instructions than the sinf/cosf pair
// nvcc builds (about 60 fewer a step), and equals them on every float
// (chip_smoke.py's phase_sincos_exact).
__device__ __forceinline__ Arm ds_dt(const Arm& s, float torque) {
  float s2, c2;
  sincosf(s.t2, &s2, &c2);
  const float d1 = __fadd_rn(__fadd_rn(QUARTER, __fadd_rn(FIVE_QUARTERS, c2)), 2.0f);
  const float d2 = __fadd_rn(__fadd_rn(QUARTER, __fmul_rn(HALF, c2)), 1.0f);
  const float phi2 = __fmul_rn(HALF_G, cosf(__fsub_rn(__fadd_rn(s.t1, s.t2), HALF_PI)));
  const float phi1 = __fadd_rn(
      __fadd_rn(__fsub_rn(__fmul_rn(__fmul_rn(__fmul_rn(-HALF, s.w2), s.w2), s2),
                          __fmul_rn(__fmul_rn(s.w2, s.w1), s2)),
                __fmul_rn(THREE_HALVES_G, cosf(__fsub_rn(s.t1, HALF_PI)))),
      phi2);
  const float num = __fsub_rn(
      __fsub_rn(__fadd_rn(torque, __fmul_rn(__fdiv_rn(d2, d1), phi1)),
                __fmul_rn(__fmul_rn(__fmul_rn(HALF, s.w1), s.w1), s2)),
      phi2);
  const float a2 = __fdiv_rn(num, __fsub_rn(FIVE_QUARTERS, __fdiv_rn(__fmul_rn(d2, d2), d1)));
  const float a1 = __fdiv_rn(-__fadd_rn(__fmul_rn(d2, a2), phi1), d1);
  return {s.w1, s.w2, a1, a2};
}

__device__ __forceinline__ Arm axpy(const Arm& y, const Arm& k, float h) {
  return {__fadd_rn(y.t1, __fmul_rn(h, k.t1)), __fadd_rn(y.t2, __fmul_rn(h, k.t2)),
          __fadd_rn(y.w1, __fmul_rn(h, k.w1)), __fadd_rn(y.w2, __fmul_rn(h, k.w2))};
}

// y + dt / 6 * (a + 2 b + 2 c + d)
__device__ __forceinline__ float rk4_sum(float y, float a, float b, float c, float d) {
  return __fadd_rn(y, __fmul_rn(SIXTH_DT, __fadd_rn(__fadd_rn(__fadd_rn(a, __fmul_rn(2.0f, b)),
                                                              __fmul_rn(2.0f, c)),
                                                    d)));
}

// jnp.remainder(x + pi, 2 pi) - pi: fmod, then + 2 pi where the remainder is
// negative (the divisor's sign differs from it), each rounded
__device__ __forceinline__ float wrap(float x) {
  float m = fmodf(__fadd_rn(x, PI), TWO_PI);
  if (m != 0.0f && m < 0.0f) m = __fadd_rn(m, TWO_PI);
  return __fsub_rn(m, PI);
}

// One RK4 step with `torque`, the wrap and clamps; returns whether the arm
// reached the height.  Semantics: envs/acrobot.py (both packages).
__device__ __forceinline__ bool transition(Arm& s, float torque) {
  const Arm k1 = ds_dt(s, torque);
  const Arm k2 = ds_dt(axpy(s, k1, HALF_DT), torque);
  const Arm k3 = ds_dt(axpy(s, k2, HALF_DT), torque);
  const Arm k4 = ds_dt(axpy(s, k3, DT), torque);
  Arm n{rk4_sum(s.t1, k1.t1, k2.t1, k3.t1, k4.t1), rk4_sum(s.t2, k1.t2, k2.t2, k3.t2, k4.t2),
        rk4_sum(s.w1, k1.w1, k2.w1, k3.w1, k4.w1), rk4_sum(s.w2, k1.w2, k2.w2, k3.w2, k4.w2)};
  n.t1 = wrap(n.t1);
  n.t2 = wrap(n.t2);
  n.w1 = fminf(fmaxf(n.w1, -MAX_VEL_1), MAX_VEL_1);
  n.w2 = fminf(fmaxf(n.w2, -MAX_VEL_2), MAX_VEL_2);
  s = n;
  return __fsub_rn(-cosf(n.t1), cosf(__fadd_rn(n.t2, n.t1))) > 1.0f;
}

// steps + 1 in int32, wrapping as torch and JAX do
__device__ __forceinline__ int next_steps(int steps) { return (int)((uint32_t)steps + 1u); }

// The fresh episode `idx`: TEA seed, then 4 LCG draws in [-0.1, 0.1).
__device__ __forceinline__ Arm fresh(uint32_t idx, uint32_t* word) {
  uint32_t v = episode::tea_seed(idx);
  float r[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    v = episode::lcg_next(v);
    r[k] = __fadd_rn(LO, __fmul_rn(episode::unif(v), RANGE));
  }
  *word = v;
  return {r[0], r[1], r[2], r[3]};
}

// chk + t1 + t2 + w1 + w2 + done, left to right
__device__ __forceinline__ float checksum(float chk, const Arm& s, bool done) {
  return __fadd_rn(
      __fadd_rn(__fadd_rn(__fadd_rn(__fadd_rn(chk, s.t1), s.t2), s.w1), s.w2),
      done ? 1.0f : 0.0f);
}

// ---- K9 ---------------------------------------------------------------------

// A tile is `per` consecutive worlds (episode::step_plan), ranked and drawn
// as the header's one-launch step kernels are; each slot's inputs are loaded
// during the slot before.
__global__ void __launch_bounds__(THREADS)
ac_step_kernel(const float4* __restrict__ st_in, const int32_t* __restrict__ steps_in,
               const int32_t* __restrict__ rng_in, const int32_t* __restrict__ act,
               const int64_t* __restrict__ cnt_in, float4* __restrict__ st_out,
               int32_t* __restrict__ steps_out, int32_t* __restrict__ rng_out,
               bool* __restrict__ done_out, int64_t* __restrict__ cnt_out,
               unsigned long long* __restrict__ scan, int N, int per) {
  constexpr int WARPS = THREADS / 32;
  __shared__ int cnt[episode::RANK_COUNTS];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int tile = episode::step_tile(scan);
  const int first = tile * per, slots = (per + THREADS - 1) / THREADS;
  const int last = min(per, N - first);  // worlds in this tile
  // the step, each slot's inputs loaded during the slot before; live worlds
  // are final
  uint32_t dmask = 0u;
  float4 nx = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  int nx_steps = 0, nx_act = 0;
  if (tid < last) {
    nx = st_in[first + tid];
    nx_steps = steps_in[first + tid];
    nx_act = act[first + tid];
  }
  for (int s = 0; s < slots; ++s) {
    const int i = s * THREADS + tid, n = first + i;
    Arm p{nx.x, nx.y, nx.z, nx.w};
    const int steps = next_steps(nx_steps), a = nx_act;
    if (i + THREADS < last) {
      nx = st_in[n + THREADS];
      nx_steps = steps_in[n + THREADS];
      nx_act = act[n + THREADS];
    }
    bool done = false;
    if (i < last) {
      done = transition(p, a == 0 ? -1.0f : (a == 1 ? 0.0f : 1.0f)) || steps > MAX_STEPS;
      if (!done) {
        store(st_out, n, p);
        steps_out[n] = steps;
        rng_out[n] = rng_in[n];
      }
      done_out[n] = done;
    }
    const unsigned b = __ballot_sync(episode::FULL_MASK, done);
    if (lane == 0) cnt[s * WARPS + warp] = __popc(b);
    dmask |= (uint32_t)done << s;
  }
  // the warp's done worlds drawn one a lane, in (slot, lane) order
  const uint32_t next = episode::step_rank(scan, tile, slots, cnt, cnt_in, cnt_out);
  const int resets = episode::warp_resets(dmask, slots);
  for (int j0 = 0; j0 < resets; j0 += 32) {
    uint32_t rank = 0u;
    const int i = episode::nth_done(dmask, slots, cnt, j0 + lane, &rank);
    if (i >= 0) {
      uint32_t w;
      const int n = first + i;
      store(st_out, n, fresh(next + rank, &w));
      rng_out[n] = (int32_t)w;
      steps_out[n] = 0;
    }
  }
}

// ---- K10 --------------------------------------------------------------------

constexpr uint32_t STEP_BITS = 9;
constexpr uint32_t WIDE = (1u << STEP_BITS) - 1u;  // the step count lies in `steps`
constexpr int MAX_T = (int)(0xFFFFFFFFu >> STEP_BITS);  // done counts that fit
constexpr int CARRY_BYTES = 16 + 4 + 4 + 4;  // state, action word, checksum, packed counts

#define AC_ROLLOUT_PARAMS                                                                   \
  const float4 *__restrict__ st_in, const int32_t *__restrict__ steps_in,                   \
      const int32_t *__restrict__ rng_in, const int32_t *__restrict__ arng_in,             \
      const int64_t *__restrict__ cnt_in, float4 *__restrict__ st,                         \
      int32_t *__restrict__ steps, int32_t *__restrict__ rng, int32_t *__restrict__ arng,  \
      int32_t *__restrict__ dcnt, float *__restrict__ chk, int64_t *__restrict__ cnt_out,  \
      int *__restrict__ totals, int N, int T, int slots
#define AC_ROLLOUT_ARGS                                                                    \
  st_in, steps_in, rng_in, arng_in, cnt_in, st, steps, rng, arng, dcnt, chk, cnt_out, totals, \
      N, T, slots

template <bool ONCHIP>
__device__ __forceinline__ void rollout(AC_ROLLOUT_PARAMS) {
  __shared__ int counts[2][episode::RANK_COUNTS];  // by the step's parity
  __shared__ uint32_t offsets[2];
  extern __shared__ __align__(16) unsigned char carry_smem[];
  cg::grid_group grid = cg::this_grid();
  const int G = gridDim.x, tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int block = blockDim.x, warps = block >> 5;
  const int cap = slots * block, first = blockIdx.x * cap;  // world first + i is slot i / block
  // the carry of world first + i at index i: in shared memory, or the
  // outputs themselves (the packed counts in `dcnt`); each world is only
  // ever touched by its thread, or at a reset by a lane of its warp
  float4* arm = ONCHIP ? reinterpret_cast<float4*>(carry_smem) : st + first;
  uint32_t* aw = ONCHIP ? reinterpret_cast<uint32_t*>(arm + cap)
                        : reinterpret_cast<uint32_t*>(arng) + first;
  float* ck = ONCHIP ? reinterpret_cast<float*>(aw + cap) : chk + first;
  uint32_t* pk = ONCHIP ? reinterpret_cast<uint32_t*>(ck + cap)
                        : reinterpret_cast<uint32_t*>(dcnt) + first;
  for (int s = 0; s < slots; ++s) {
    const int i = s * block + tid, n = first + i;
    if (n < N) {
      arm[i] = st_in[n];
      aw[i] = (uint32_t)arng_in[n];
      ck[i] = 0.0f;
      const int k = steps_in[n];
      pk[i] = min((uint32_t)k, WIDE);
      steps[n] = k;  // a wide world's count stays here
      rng[n] = rng_in[n];
    }
  }
  uint32_t base = (uint32_t)cnt_in[0];
  EPISODE_STAMPS_BEGIN
  for (int t = 0; t < T; ++t) {
    int* cnt = counts[t & 1];
    int* step_totals = totals + (t & 1) * G;
    // phase A: action, dynamics, done; live worlds are final for this step
    uint32_t dmask = 0u;
    for (int s = 0; s < slots; ++s) {
      const int i = s * block + tid, n = first + i;
      bool done = false;
      if (n < N) {
        const uint32_t w = episode::lcg_next(aw[i]);
        aw[i] = w;
        const int a = (int)((((w >> 8) & 0x00FFFFFFu) * 3u) >> 24);
        Arm p = load(arm, i);
        uint32_t k = pk[i];
        const bool wide = (k & WIDE) == WIDE;
        const int after = wide ? next_steps(steps[n]) : (int)(k & WIDE) + 1;
        done = transition(p, (float)(a - 1)) || after > MAX_STEPS;
        if (!done) {
          store(arm, i, p);
          ck[i] = checksum(ck[i], p, false);
          if (wide) steps[n] = after;
          else k += 1u;
        } else {
          k = (k | WIDE) + 1u;  // one more done, and step count 0
        }
        pk[i] = k;
      }
      const unsigned b = __ballot_sync(episode::FULL_MASK, done);
      if (lane == 0) cnt[s * warps + warp] = __popc(b);
      dmask |= (uint32_t)done << s;
    }
    EPISODE_STAMP(episode::PH_A);
    __syncthreads();
    EPISODE_STAMP(episode::PH_BARRIER);
    if (warp == 0) {
      const int total = episode::scan_counts(cnt, slots * warps);
      if (lane == 0) step_totals[blockIdx.x] = total;
    }
    EPISODE_STAMP(episode::PH_SCAN);
    // the parity buffers let one sync a step suffice (see csrc/cartpole.cu)
    grid.sync();
    EPISODE_STAMP(episode::PH_GRID);
    // phase B: rank this step's resets over the whole batch and draw them,
    // the warp's done worlds one a lane in (slot, lane) order; the next
    // step's barrier after phase A protects `offsets`
    uint32_t before, all;
    episode::first_warp_offsets(step_totals, blockIdx.x, G, offsets, &before, &all);
    const uint32_t next = base + before;
    EPISODE_STAMP(episode::PH_OFFSETS);
    const int resets = episode::warp_resets(dmask, slots);
    for (int j0 = 0; j0 < resets; j0 += 32) {
      uint32_t rank = 0u;
      const int i = episode::nth_done(dmask, slots, cnt, j0 + lane, &rank);
      if (i >= 0) {
        uint32_t w;
        const Arm p = fresh(next + rank, &w);
        store(arm, i, p);
        rng[first + i] = (int32_t)w;
        ck[i] = checksum(ck[i], p, true);
      }
    }
    __syncwarp();  // the owners read the drawn worlds next step
    base += all;
    EPISODE_STAMP(episode::PH_DRAWS);
  }
  EPISODE_STAMPS_END
  for (int s = 0; s < slots; ++s) {
    const int i = s * block + tid, n = first + i;
    if (n < N) {
      const uint32_t k = pk[i];
      if ((k & WIDE) != WIDE) steps[n] = (int32_t)(k & WIDE);
      dcnt[n] = (int32_t)(k >> STEP_BITS);
      if (ONCHIP) {
        st[n] = arm[i];
        arng[n] = (int32_t)aw[i];
        chk[n] = ck[i];
      }
    }
  }
  if (blockIdx.x == 0 && tid == 0) cnt_out[0] = (int64_t)base;
}

__global__ void __launch_bounds__(episode::ROLLOUT_THREADS, 1)
ac_rollout_onchip_kernel(AC_ROLLOUT_PARAMS) {
  rollout<true>(AC_ROLLOUT_ARGS);
}

__global__ void __launch_bounds__(THREADS) ac_rollout_kernel(AC_ROLLOUT_PARAMS) {
  rollout<false>(AC_ROLLOUT_ARGS);
}

cudaError_t rollout_shape(int N, int device, episode::Shape* sh) {
  return episode::rollout_shape((const void*)ac_rollout_onchip_kernel,
                                (const void*)ac_rollout_kernel, CARRY_BYTES, N, device, sh);
}

}  // namespace

extern "C" {

// Ints of scratch a K10 launch over N worlds needs: two parities of block
// counts, its blocks holding at least one warp of worlds.
int ac_scratch_ints(int N) { return 2 * ((N + 31) / 32); }

// Ints of K9's scan words for N worlds (episode::step_scan_ints): zero
// before the first launch, and left zero by every launch.
int ac_step_scratch_ints(int N) { return episode::step_scan_ints(N); }

int ac_step(const float* st_in, const int32_t* steps_in, const int32_t* rng_in,
            const int32_t* act, const int64_t* cnt_in, float* st_out, int32_t* steps_out,
            int32_t* rng_out, bool* done, int64_t* cnt_out, int* scratch, int N, int device,
            void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  int tiles = 0, per = 0;
  err = episode::step_plan((const void*)ac_step_kernel, N, device, &tiles, &per);
  if (err != cudaSuccess) return (int)err;
  ac_step_kernel<<<tiles, THREADS, 0, (cudaStream_t)stream>>>(
      reinterpret_cast<const float4*>(st_in), steps_in, rng_in, act, cnt_in,
      reinterpret_cast<float4*>(st_out), steps_out, rng_out, done, cnt_out,
      reinterpret_cast<unsigned long long*>(scratch), N, per);
  return (int)cudaGetLastError();
}

int ac_rollout(const float* st_in, const int32_t* steps_in, const int32_t* rng_in,
               const int32_t* arng_in, const int64_t* cnt_in, float* st, int32_t* steps,
               int32_t* rng, int32_t* arng, int32_t* dcnt, float* chk, int64_t* cnt_out,
               int* scratch, int N, int T, int device, void* stream) {
  if (T > MAX_T) return ERR_TOO_MANY_STEPS;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  episode::Shape sh;
  err = rollout_shape(N, device, &sh);
  if (err != cudaSuccess) return (int)err;
  if (sh.slots > episode::MAX_ROLLOUT_SLOTS) return episode::ERR_TOO_MANY_ENVS;
  const float4* st_in4 = reinterpret_cast<const float4*>(st_in);
  float4* st4 = reinterpret_cast<float4*>(st);
  void* args[] = {(void*)&st_in4, (void*)&steps_in, (void*)&rng_in, (void*)&arng_in,
                  (void*)&cnt_in, (void*)&st4,      (void*)&steps,  (void*)&rng,
                  (void*)&arng,   (void*)&dcnt,     (void*)&chk,    (void*)&cnt_out,
                  (void*)&scratch, (void*)&N,       (void*)&T,      (void*)&sh.slots};
  const void* kernel =
      sh.onchip ? (const void*)ac_rollout_onchip_kernel : (const void*)ac_rollout_kernel;
  err = cudaLaunchCooperativeKernel(kernel, dim3(sh.blocks), dim3(sh.threads), args, sh.smem,
                                    (cudaStream_t)stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// 1 where K10 runs N worlds with their carry on chip, 0 where in device
// memory, or a negative error.
int ac_rollout_onchip(int N, int device) {
  episode::Shape sh;
  const cudaError_t err = rollout_shape(N, device, &sh);
  return err != cudaSuccess ? -(int)err : (int)sh.onchip;
}

// The longest rollout: its done counts fit the packed carry.
int ac_rollout_max_steps() { return MAX_T; }

const char* ac_error_string(int err) {
  if (err == ERR_TOO_MANY_STEPS) return "too many steps for the packed done counts";
  return episode::error_string(err);
}

#ifdef EPISODE_PHASE_STAMPS
int ac_phase_take(unsigned long long* clocks, long long* span) {
  return episode::phase_take(clocks, span);
}
#endif

}  // extern "C"
