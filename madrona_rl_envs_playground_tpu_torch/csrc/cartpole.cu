// Cartpole step kernels for Hopper (sm_90a), bound through a plain C
// interface and loaded with ctypes (ops/cartpole.py).
//
// K5 `cp_step_kernel` + `cp_reset_kernel` replace the per-step Pallas kernel
//   madrona_rl_envs_playground_tpu/ops/cartpole_pallas.py::_build_kernel
//   (body _make_step2, launched by fused_step): Euler physics, termination,
//   the world-order episode index of every world that resets, and its
//   TEA+LCG reset draw (4 uniforms).  One fused_step is these two launches:
//   the first steps every world and writes each block's count of done
//   worlds; the second ranks the done worlds (csrc/episode_scan.cuh) and
//   draws their fresh episodes.  The launch boundary is the barrier between
//   the two halves of the scan, so no block waits on another.
// K6 `cp_rollout_kernel` replaces the persistent rollout Pallas kernels
//   ops/cartpole_pallas.py::_build_rollout_kernel and
//   _build_rollout_kernel_packed (fused_rollout): T steps in one cooperative
//   launch, actions from a per-env LCG (action = bit 23 of the advanced
//   word), a per-env done count and checksum (sum of x after every step).
//   Every step ranks its resets over the whole batch: each block writes its
//   count to a buffer of the step's parity, one grid-wide sync, then every
//   block sums the counts before it.  So episodes are allocated per step in
//   whole-batch world order, as T applications of K5 do (and as JAX's
//   fused_rollout with one block, block == N, does; with more blocks JAX
//   runs each block's T steps before the next block's, an order a
//   concurrent grid cannot follow, so the checksums differ from JAX's at
//   bench.py's block of 32,768).
//
// Layout.  The state is env-major [N, 4] f32 (x, x_dot, theta, theta_dot):
// one 16-byte load and store per world, and the same memory is the [N, 1, 4]
// obs the policy reads.  The episode LCG words are int32 [N].  Block b owns
// a contiguous run of slots * THREADS worlds (episode_scan.cuh's `world`), so
// the loads of a slot are coalesced and (block, slot, thread) order is world
// order.
//
// Exactness.  The physics is written with __fadd_rn/__fsub_rn/__fmul_rn/
// __fdiv_rn, one IEEE rounding per operation in the JAX operation order:
// nvcc never contracts these into FMAs, whatever -fmad says, and divisions
// are exact quotients, as PyTorch's division by a tensor is.  sinf and cosf
// are the precise CUDA functions under nvcc's default flags, as in PyTorch's
// own torch.sin/torch.cos kernels.  Constants are the float32 values of the
// JAX constants, written as hex floats.
//
// What bounds them on an H100.  K5 moves 45 B per world-step (state 16 B,
// LCG word 4 B and action 4 B read; state, word and done written) and does
// about 40 operations, so device-memory bytes bound it.  K6 reads and writes
// each world once per launch but does its operations T times; its state does
// not fit in registers at 1M worlds (32 B of carry per world against the
// register file's 33.8 MB over 132 SMs), so each step loads and stores the
// carry, which stays in the 50 MB L2 for cartpole.  The grid-wide sync per
// step is the other cost.

#include <cooperative_groups.h>
#include <cstdint>
#include <cuda_runtime.h>

#include "episode_scan.cuh"

namespace cg = cooperative_groups;
using episode::THREADS;
using episode::world;

namespace {

// float32 values of the JAX constants (envs/cartpole.py)
constexpr float GRAVITY = 0x1.39999ap+3f;          // 9.8
constexpr float MASSPOLE = 0x1.99999ap-4f;         // 0.1
constexpr float TOTAL_MASS = 0x1.19999ap+0f;       // 1.1
constexpr float LENGTH = 0x1p-1f;                  // 0.5
constexpr float POLEMASS_LENGTH = 0x1.99999ap-5f;  // 0.05
constexpr float FORCE_MAG = 10.0f;
constexpr float TAU = 0x1.47ae14p-6f;              // 0.02
constexpr float FOUR_THIRDS = 0x1.555556p+0f;      // 4/3
constexpr float X_THRESHOLD = 0x1.333334p+1f;      // 2.4
constexpr float THETA_THRESHOLD = 0x1.aceeap-3f;   // 12 * 2 * pi / 360
constexpr float LO = -0x1.99999ap-5f;              // -0.05
constexpr float RANGE = 0x1.99999ap-4f;            // 0.05 - (-0.05)

struct Pole {
  float x, xd, th, thd;
};

__device__ __forceinline__ Pole load(const float4* st, int n) {
  const float4 v = st[n];
  return {v.x, v.y, v.z, v.w};
}

__device__ __forceinline__ void store(float4* st, int n, const Pole& s) {
  st[n] = make_float4(s.x, s.xd, s.th, s.thd);
}

// One Euler step; returns done.  Semantics: envs/cartpole.py (both packages).
__device__ __forceinline__ bool transition(Pole& s, int a) {
  const float force = a == 1 ? FORCE_MAG : -FORCE_MAG;
  const float costh = cosf(s.th);
  const float sinth = sinf(s.th);
  const float temp = __fdiv_rn(
      __fadd_rn(force, __fmul_rn(__fmul_rn(__fmul_rn(POLEMASS_LENGTH, s.thd), s.thd), sinth)),
      TOTAL_MASS);
  const float denom = __fmul_rn(
      LENGTH, __fsub_rn(FOUR_THIRDS,
                        __fdiv_rn(__fmul_rn(__fmul_rn(MASSPOLE, costh), costh), TOTAL_MASS)));
  const float thacc = __fdiv_rn(__fsub_rn(__fmul_rn(GRAVITY, sinth), __fmul_rn(costh, temp)), denom);
  const float xacc = __fsub_rn(
      temp, __fdiv_rn(__fmul_rn(__fmul_rn(POLEMASS_LENGTH, thacc), costh), TOTAL_MASS));
  const Pole n{__fadd_rn(s.x, __fmul_rn(TAU, s.xd)), __fadd_rn(s.xd, __fmul_rn(TAU, xacc)),
               __fadd_rn(s.th, __fmul_rn(TAU, s.thd)), __fadd_rn(s.thd, __fmul_rn(TAU, thacc))};
  s = n;
  return n.x < -X_THRESHOLD || n.x > X_THRESHOLD || n.th < -THETA_THRESHOLD ||
         n.th > THETA_THRESHOLD;
}

// The fresh episode `idx`: TEA seed, then 4 LCG draws in [-0.05, 0.05).
__device__ __forceinline__ Pole fresh(uint32_t idx, uint32_t* word) {
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

// ---- K5 ---------------------------------------------------------------------

__global__ void __launch_bounds__(THREADS)
cp_step_kernel(const float4* __restrict__ st_in, const int32_t* __restrict__ act,
               float4* __restrict__ st_out, bool* __restrict__ done_out,
               int* __restrict__ totals, int N, int slots) {
  int count = 0;
  for (int s = 0; s < slots; ++s) {
    const int n = world(slots, s);
    bool done = false;
    if (n < N) {
      Pole p = load(st_in, n);
      done = transition(p, act[n]);
      store(st_out, n, p);  // the reset kernel overwrites the done worlds
      done_out[n] = done;
    }
    count += __syncthreads_count(done);
  }
  if (threadIdx.x == 0) totals[blockIdx.x] = count;
}

__global__ void __launch_bounds__(THREADS)
cp_reset_kernel(const bool* __restrict__ done_in, const int32_t* __restrict__ rng_in,
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

// ---- K6 ---------------------------------------------------------------------

__global__ void __launch_bounds__(THREADS)
cp_rollout_kernel(const float4* __restrict__ st_in, const int32_t* __restrict__ rng_in,
                  const int32_t* __restrict__ arng_in, const int64_t* __restrict__ cnt_in,
                  float4* __restrict__ st, int32_t* __restrict__ rng,
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
      rng[n] = rng_in[n];
      arng[n] = arng_in[n];
      dcnt[n] = 0;
      chk[n] = 0.0f;
    }
  }
  uint32_t base = (uint32_t)cnt_in[0];
  for (int t = 0; t < T; ++t) {
    int* step_totals = totals + (t & 1) * G;
    // phase A: action, physics, done; live worlds are final for this step
    uint32_t dmask = 0u;
    int count = 0;
    for (int s = 0; s < slots; ++s) {
      const int n = world(slots, s);
      bool done = false;
      if (n < N) {
        const uint32_t w = episode::lcg_next((uint32_t)arng[n]);
        arng[n] = (int32_t)w;
        Pole p = load(st, n);
        done = transition(p, (int)((w >> 23) & 1u));
        if (!done) {
          store(st, n, p);
          chk[n] = __fadd_rn(chk[n], p.x);
        }
        dcnt[n] += done;
      }
      dmask |= (uint32_t)done << s;
      count += __syncthreads_count(done);
    }
    if (threadIdx.x == 0) step_totals[blockIdx.x] = count;
    // the parity buffers let one sync a step suffice: a block writes the
    // next step's counts only after every block has passed this sync, hence
    // finished reading the counts of two steps back
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
        const Pole p = fresh(next + (uint32_t)rank, &w);
        store(st, n, p);
        rng[n] = (int32_t)w;
        chk[n] = __fadd_rn(chk[n], p.x);
      }
      next += (uint32_t)total;
    }
    base += all;
  }
  if (blockIdx.x == 0 && threadIdx.x == 0) cnt_out[0] = (int64_t)base;
}

}  // namespace

extern "C" {

int cp_scratch_ints(int N) { return episode::scratch_ints(N); }

int cp_step(const float* st_in, const int32_t* rng_in, const int32_t* act,
            const int64_t* cnt_in, float* st_out, int32_t* rng_out, bool* done,
            int64_t* cnt_out, int* scratch, int N, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  int max_blocks = 0, blocks = 0, slots = 0;
  err = episode::resident_blocks((const void*)cp_step_kernel, device, &max_blocks);
  if (err != cudaSuccess) return (int)err;
  episode::split(N, max_blocks, &blocks, &slots);
  cudaStream_t s = (cudaStream_t)stream;
  cp_step_kernel<<<blocks, THREADS, 0, s>>>(
      reinterpret_cast<const float4*>(st_in), act, reinterpret_cast<float4*>(st_out), done,
      scratch, N, slots);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  cp_reset_kernel<<<blocks, THREADS, 0, s>>>(done, rng_in, cnt_in, scratch,
                                             reinterpret_cast<float4*>(st_out), rng_out,
                                             cnt_out, N, slots);
  return (int)cudaGetLastError();
}

int cp_rollout(const float* st_in, const int32_t* rng_in, const int32_t* arng_in,
               const int64_t* cnt_in, float* st, int32_t* rng, int32_t* arng,
               int32_t* dcnt, float* chk, int64_t* cnt_out, int* scratch, int N, int T,
               int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  int max_blocks = 0, blocks = 0, slots = 0;
  err = episode::resident_blocks((const void*)cp_rollout_kernel, device, &max_blocks);
  if (err != cudaSuccess) return (int)err;
  episode::split(N, max_blocks, &blocks, &slots);
  if (slots > episode::MAX_ROLLOUT_SLOTS) return episode::ERR_TOO_MANY_ENVS;
  const float4* st_in4 = reinterpret_cast<const float4*>(st_in);
  float4* st4 = reinterpret_cast<float4*>(st);
  void* args[] = {(void*)&st_in4, (void*)&rng_in, (void*)&arng_in, (void*)&cnt_in,
                  (void*)&st4,    (void*)&rng,    (void*)&arng,    (void*)&dcnt,
                  (void*)&chk,    (void*)&cnt_out, (void*)&scratch, (void*)&N,
                  (void*)&T,      (void*)&slots};
  err = cudaLaunchCooperativeKernel((const void*)cp_rollout_kernel, dim3(blocks), dim3(THREADS),
                                    args, 0, (cudaStream_t)stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

const char* cp_error_string(int err) { return episode::error_string(err); }

}  // extern "C"
