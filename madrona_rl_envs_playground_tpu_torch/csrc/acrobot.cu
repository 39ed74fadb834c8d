// Acrobot step kernels for Hopper (sm_90a), bound through a plain C
// interface and loaded with ctypes (ops/acrobot.py).
//
// K9 `ac_step_kernel` + `ac_reset_kernel` replace the per-step Pallas kernel
//   madrona_rl_envs_playground_tpu/ops/acrobot_pallas.py::_build_kernel
//   (body _make_step, launched by fused_step): one RK4 step of the acrobot
//   dynamics, the angle wrap to [-pi, pi) and the velocity clamps, the
//   height or 501-step termination, the world-order episode index of every
//   world that resets and its TEA+LCG reset draw (4 uniforms).  One
//   fused_step is these two launches, as csrc/cartpole.cu's K5: the first
//   steps every world and writes each block's count of done worlds; the
//   second ranks the done worlds (csrc/episode_scan.cuh) and draws their
//   fresh episodes.
// K10 `ac_rollout_kernel` replaces the persistent rollout Pallas kernel
//   ops/acrobot_pallas.py::_build_rollout_kernel (fused_rollout): T steps in
//   one cooperative launch, actions from a per-env LCG (three torques:
//   action = ((w >> 8) & 0xFFFFFF) * 3 >> 24 of the advanced word), a
//   per-env done count and the checksum chk + t1 + t2 + w1 + w2 + done after
//   every step (float32, in that order, on the state after the reset).
//   Every step ranks its resets over the whole batch with one grid-wide
//   sync, as K6 does, so episodes are allocated per step in whole-batch
//   world order: K10 equals T applications of K9 and JAX's fused_rollout
//   with one block (block == N), not JAX's block-sequential order at more
//   than one block.
//
// Layout.  The state is env-major [N, 4] f32 (theta1, theta2, omega1,
// omega2): one 16-byte load and store per world, and the same memory is the
// [N, 1, 4] obs the policy reads.  The step counts and the episode LCG
// words are int32 [N].  Block b owns a contiguous run of slots * THREADS
// worlds (episode_scan.cuh's `world`).
//
// Exactness.  Every operation is a __fadd_rn/__fsub_rn/__fmul_rn/__fdiv_rn,
// one IEEE rounding each, in the operation order of JAX's
// envs/acrobot._ds_dt and _rk4_step (nvcc never contracts these into FMAs),
// and the divisions are exact quotients, as PyTorch's division by a tensor
// is.  sinf, cosf and fmodf are the precise CUDA functions under nvcc's
// default flags, as in PyTorch's torch.sin/torch.cos/torch.remainder
// kernels.  The constants are the float32 values JAX computes, written as
// hex floats; JAX folds some Python constants in double first
// (0.25 + 1.0 is 1.25, 2.0 * 0.5 * w2 is w2).
//
// What bounds them on an H100.  K9 moves 53 B per world-step (state 16 B,
// step count, LCG word and action read; the same and done written) and does
// 233 operations counting each sin/cos as one (RK4: four evaluations of the
// dynamics, each with four sin/cos), about 4.4 per byte against the card's
// 20 per byte, so bytes bound it.  K10 keeps 36 B of carry per world
// (state, step count, two LCG words, done count, checksum), 38 MB at 1M
// worlds, which the 50 MB L2 holds across the grid-wide sync of each step,
// so its operations bound it.

#include <cooperative_groups.h>
#include <cstdint>
#include <cuda_runtime.h>

#include "episode_scan.cuh"

namespace cg = cooperative_groups;
using episode::THREADS;
using episode::world;

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
__device__ __forceinline__ Arm ds_dt(const Arm& s, float torque) {
  const float c2 = cosf(s.t2);
  const float s2 = sinf(s.t2);
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

// One RK4 step with torque a - 1, the wrap and clamps; advances `steps` and
// returns done.  Semantics: envs/acrobot.py (both packages).
__device__ __forceinline__ bool transition(Arm& s, int& steps, int a) {
  const float torque = a == 0 ? -1.0f : (a == 1 ? 0.0f : 1.0f);
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
  steps += 1;
  return __fsub_rn(-cosf(n.t1), cosf(__fadd_rn(n.t2, n.t1))) > 1.0f || steps > MAX_STEPS;
}

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

__global__ void __launch_bounds__(THREADS)
ac_step_kernel(const float4* __restrict__ st_in, const int32_t* __restrict__ steps_in,
               const int32_t* __restrict__ act, float4* __restrict__ st_out,
               int32_t* __restrict__ steps_out, bool* __restrict__ done_out,
               int* __restrict__ totals, int N, int slots) {
  int count = 0;
  for (int s = 0; s < slots; ++s) {
    const int n = world(slots, s);
    bool done = false;
    if (n < N) {
      Arm p = load(st_in, n);
      int steps = steps_in[n];
      done = transition(p, steps, act[n]);
      store(st_out, n, p);  // the reset kernel overwrites the done worlds
      steps_out[n] = done ? 0 : steps;
      done_out[n] = done;
    }
    count += __syncthreads_count(done);
  }
  if (threadIdx.x == 0) totals[blockIdx.x] = count;
}

__global__ void __launch_bounds__(THREADS)
ac_reset_kernel(const bool* __restrict__ done_in, const int32_t* __restrict__ rng_in,
                const int64_t* __restrict__ cnt_in, const int* __restrict__ totals,
                float4* __restrict__ st_out, int32_t* __restrict__ rng_out,
                int64_t* __restrict__ cnt_out, int N, int slots) {
  __shared__ int smem[episode::SCAN_SMEM_INTS];
  uint32_t before, unused;
  episode::block_offsets(totals, blockIdx.x, blockIdx.x, smem, &before, &unused);
  uint32_t next = (uint32_t)cnt_in[0] + before;  // index of the next reset
  for (int s = 0; s < slots; ++s) {
    const int n = world(slots, s);
    const bool done = n < N && done_in[n];
    int total;
    const int rank = episode::block_rank(done, smem, &total);
    if (done) {
      uint32_t w;
      store(st_out, n, fresh(next + (uint32_t)rank, &w));
      rng_out[n] = (int32_t)w;
    } else if (n < N) {
      rng_out[n] = rng_in[n];
    }
    next += (uint32_t)total;
  }
  // the last block's next index is the counter after the step
  if (blockIdx.x == gridDim.x - 1 && threadIdx.x == 0) cnt_out[0] = (int64_t)next;
}

// ---- K10 --------------------------------------------------------------------

__global__ void __launch_bounds__(THREADS)
ac_rollout_kernel(const float4* __restrict__ st_in, const int32_t* __restrict__ steps_in,
                  const int32_t* __restrict__ rng_in, const int32_t* __restrict__ arng_in,
                  const int64_t* __restrict__ cnt_in, float4* __restrict__ st,
                  int32_t* __restrict__ steps, int32_t* __restrict__ rng,
                  int32_t* __restrict__ arng, int32_t* __restrict__ dcnt,
                  float* __restrict__ chk, int64_t* __restrict__ cnt_out,
                  int* __restrict__ totals, int N, int T, int slots) {
  __shared__ int smem[episode::SCAN_SMEM_INTS];
  cg::grid_group grid = cg::this_grid();
  const int G = gridDim.x;
  // the outputs are the working state: each world is only ever touched by
  // the thread that owns it
  for (int s = 0; s < slots; ++s) {
    const int n = world(slots, s);
    if (n < N) {
      st[n] = st_in[n];
      steps[n] = steps_in[n];
      rng[n] = rng_in[n];
      arng[n] = arng_in[n];
      dcnt[n] = 0;
      chk[n] = 0.0f;
    }
  }
  uint32_t base = (uint32_t)cnt_in[0];
  for (int t = 0; t < T; ++t) {
    int* step_totals = totals + (t & 1) * G;
    // phase A: action, dynamics, done; live worlds are final for this step
    uint32_t dmask = 0u;
    int count = 0;
    for (int s = 0; s < slots; ++s) {
      const int n = world(slots, s);
      bool done = false;
      if (n < N) {
        const uint32_t w = episode::lcg_next((uint32_t)arng[n]);
        arng[n] = (int32_t)w;
        Arm p = load(st, n);
        int k = steps[n];
        done = transition(p, k, (int)((((w >> 8) & 0x00FFFFFFu) * 3u) >> 24));
        if (!done) {
          store(st, n, p);
          steps[n] = k;
          chk[n] = checksum(chk[n], p, false);
        }
        dcnt[n] += done;
      }
      dmask |= (uint32_t)done << s;
      count += __syncthreads_count(done);
    }
    if (threadIdx.x == 0) step_totals[blockIdx.x] = count;
    // the parity buffers let one sync a step suffice (see csrc/cartpole.cu)
    grid.sync();
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
        const Arm p = fresh(next + (uint32_t)rank, &w);
        store(st, n, p);
        steps[n] = 0;
        rng[n] = (int32_t)w;
        chk[n] = checksum(chk[n], p, true);
      }
      next += (uint32_t)total;
    }
    base += all;
  }
  if (blockIdx.x == 0 && threadIdx.x == 0) cnt_out[0] = (int64_t)base;
}

}  // namespace

extern "C" {

int ac_scratch_ints(int N) { return episode::scratch_ints(N); }

int ac_step(const float* st_in, const int32_t* steps_in, const int32_t* rng_in,
            const int32_t* act, const int64_t* cnt_in, float* st_out, int32_t* steps_out,
            int32_t* rng_out, bool* done, int64_t* cnt_out, int* scratch, int N, int device,
            void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  int max_blocks = 0, blocks = 0, slots = 0;
  err = episode::resident_blocks((const void*)ac_step_kernel, device, &max_blocks);
  if (err != cudaSuccess) return (int)err;
  episode::split(N, max_blocks, &blocks, &slots);
  cudaStream_t s = (cudaStream_t)stream;
  ac_step_kernel<<<blocks, THREADS, 0, s>>>(reinterpret_cast<const float4*>(st_in), steps_in,
                                            act, reinterpret_cast<float4*>(st_out), steps_out,
                                            done, scratch, N, slots);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  ac_reset_kernel<<<blocks, THREADS, 0, s>>>(done, rng_in, cnt_in, scratch,
                                             reinterpret_cast<float4*>(st_out), rng_out,
                                             cnt_out, N, slots);
  return (int)cudaGetLastError();
}

int ac_rollout(const float* st_in, const int32_t* steps_in, const int32_t* rng_in,
               const int32_t* arng_in, const int64_t* cnt_in, float* st, int32_t* steps,
               int32_t* rng, int32_t* arng, int32_t* dcnt, float* chk, int64_t* cnt_out,
               int* scratch, int N, int T, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  int max_blocks = 0, blocks = 0, slots = 0;
  err = episode::resident_blocks((const void*)ac_rollout_kernel, device, &max_blocks);
  if (err != cudaSuccess) return (int)err;
  episode::split(N, max_blocks, &blocks, &slots);
  if (slots > episode::MAX_ROLLOUT_SLOTS) return episode::ERR_TOO_MANY_ENVS;
  const float4* st_in4 = reinterpret_cast<const float4*>(st_in);
  float4* st4 = reinterpret_cast<float4*>(st);
  void* args[] = {(void*)&st_in4, (void*)&steps_in, (void*)&rng_in, (void*)&arng_in,
                  (void*)&cnt_in, (void*)&st4,      (void*)&steps,  (void*)&rng,
                  (void*)&arng,   (void*)&dcnt,     (void*)&chk,    (void*)&cnt_out,
                  (void*)&scratch, (void*)&N,       (void*)&T,      (void*)&slots};
  err = cudaLaunchCooperativeKernel((const void*)ac_rollout_kernel, dim3(blocks), dim3(THREADS),
                                    args, 0, (cudaStream_t)stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

const char* ac_error_string(int err) { return episode::error_string(err); }

}  // extern "C"
