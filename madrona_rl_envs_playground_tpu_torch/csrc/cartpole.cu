// Cartpole step kernels for Hopper (sm_90a), bound through a plain C
// interface and loaded with ctypes (ops/cartpole.py).
//
// K5 `cp_step_kernel` replaces the per-step Pallas kernel
//   madrona_rl_envs_playground_tpu/ops/cartpole_pallas.py::_build_kernel
//   (body _make_step2, launched by fused_step): Euler physics, termination,
//   the world-order episode index of every world that resets, and its
//   TEA+LCG reset draw (4 uniforms).  One kernel launch, as K9's
//   (csrc/acrobot.cu): a block steps a tile of worlds spread on the resident
//   grid, ranks its done worlds over the batch by a decoupled look-back over
//   the tiles in the order the blocks start (csrc/episode_scan.cuh's
//   one-launch step kernels), and each warp draws its done worlds' fresh
//   episodes.  No memset and no device query per call: the resident grid is
//   asked once per device, and the scan words are left zero for the next
//   launch.
// K6 `cp_rollout_onchip_kernel` / `cp_rollout_kernel` replace the
//   persistent rollout Pallas kernels ops/cartpole_pallas.py::
//   _build_rollout_kernel and _build_rollout_kernel_packed (fused_rollout):
//   T steps in one cooperative launch, actions from a per-env LCG (action =
//   bit 23 of the advanced word), a per-env done count and checksum (sum of
//   x after every step).  The launcher picks the kernel by N: where every
//   block of the resident grid holds its worlds' carry in shared memory (up
//   to 8,192 worlds an SM, 28 B each), the on-chip kernel; else the carry
//   lies in the output arrays in device memory.  Every step ranks its
//   resets over the whole batch: each block writes its count to a buffer of
//   the step's parity, one grid-wide sync, then every block sums the counts
//   before it.  So episodes are allocated per step in
//   whole-batch world order, as T applications of K5 do (and as JAX's
//   fused_rollout with one block, block == N, does; with more blocks JAX
//   runs each block's T steps before the next block's, an order a
//   concurrent grid cannot follow, so the checksums differ from JAX's at
//   bench.py's block of 32,768).
//
// Layout.  The state is env-major [N, 4] f32 (x, x_dot, theta, theta_dot):
// one 16-byte load and store per world, and the same memory is the [N, 1, 4]
// obs the policy reads.  The episode LCG words are int32 [N].  A block owns
// a contiguous run of worlds (K5's tile, K6's slots * (its threads)), so the
// loads of a slot are coalesced and (block, slot, thread) order is world
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
// LCG word 4 B and action 4 B read; state, word and done written, each once
// in one launch) and does about 100 instructions, so device-memory bytes
// bound it.  K6 reads and
// writes each world once per launch but does its ~98 instructions a step T
// times, so operations bound it.  Its per-step carry (state, action word,
// checksum, done count: 28 B) stays in shared memory for all T steps where
// the resident grid holds it (8,192 worlds x 28 B = 224 KB a block at 1M
// worlds), so a step touches device memory only to store a reset's episode
// word; past that it makes a round trip through L2 every step.  The
// grid-wide sync and the scan are a fixed cost a step; the ranking takes
// one barrier and one warp scan a step, whatever the slots.

#include <cooperative_groups.h>
#include <cstdint>
#include <cuda_runtime.h>

#include "episode_scan.cuh"

namespace cg = cooperative_groups;
using episode::THREADS;

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

// A tile is `per` consecutive worlds (episode::step_plan); each slot's
// state, action and episode word are loaded during the slot before.  A live
// world's state and word are written once in its slot, a done world's once
// at its draw.
__global__ void __launch_bounds__(THREADS)
cp_step_kernel(const float4* __restrict__ st_in, const int32_t* __restrict__ rng_in,
               const int32_t* __restrict__ act, const int64_t* __restrict__ cnt_in,
               float4* __restrict__ st_out, int32_t* __restrict__ rng_out,
               bool* __restrict__ done_out, int64_t* __restrict__ cnt_out,
               unsigned long long* __restrict__ scan, int N, int per) {
  constexpr int WARPS = THREADS / 32;
  __shared__ int cnt[episode::RANK_COUNTS];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int tile = episode::step_tile(scan);
  const int first = tile * per, slots = (per + THREADS - 1) / THREADS;
  const int last = min(per, N - first);  // worlds in this tile
  uint32_t dmask = 0u;
  float4 nx = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  int nx_act = 0, nx_rng = 0;
  if (tid < last) {
    nx = st_in[first + tid];
    nx_act = act[first + tid];
    nx_rng = rng_in[first + tid];
  }
  for (int s = 0; s < slots; ++s) {
    const int i = s * THREADS + tid, n = first + i;
    Pole p{nx.x, nx.y, nx.z, nx.w};
    const int a = nx_act, rng = nx_rng;
    if (i + THREADS < last) {
      nx = st_in[n + THREADS];
      nx_act = act[n + THREADS];
      nx_rng = rng_in[n + THREADS];
    }
    bool done = false;
    if (i < last) {
      done = transition(p, a);
      if (!done) {
        store(st_out, n, p);
        rng_out[n] = rng;
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
    }
  }
}

// ---- K6 ---------------------------------------------------------------------

// K6's two kernels run one body (rollout<ONCHIP>, as csrc/episode_scan.cuh
// describes): with each world's carry in the block's shared memory (ONCHIP,
// cp_rollout_onchip_kernel), or in the output arrays in device memory
// (cp_rollout_kernel).  The carry: state, action word, checksum, done count.
constexpr int CARRY_BYTES = 16 + 4 + 4 + 4;

#define CP_ROLLOUT_PARAMS                                                                  \
  const float4 *__restrict__ st_in, const int32_t *__restrict__ rng_in,                    \
      const int32_t *__restrict__ arng_in, const int64_t *__restrict__ cnt_in,            \
      float4 *__restrict__ st, int32_t *__restrict__ rng, int32_t *__restrict__ arng,      \
      int32_t *__restrict__ dcnt, float *__restrict__ chk, int64_t *__restrict__ cnt_out, \
      int *__restrict__ totals, int N, int T, int slots
#define CP_ROLLOUT_ARGS \
  st_in, rng_in, arng_in, cnt_in, st, rng, arng, dcnt, chk, cnt_out, totals, N, T, slots

template <bool ONCHIP>
__device__ __forceinline__ void rollout(CP_ROLLOUT_PARAMS) {
  __shared__ int counts[2][episode::RANK_COUNTS];  // by the step's parity
  __shared__ int scan_smem[episode::SCAN_SMEM_INTS];
  extern __shared__ __align__(16) unsigned char carry_smem[];
  cg::grid_group grid = cg::this_grid();
  const int G = gridDim.x, tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int block = blockDim.x, warps = block >> 5;
  const int cap = slots * block, first = blockIdx.x * cap;  // world first + i is slot i / block
  // the carry of world first + i at index i: in shared memory, or the
  // outputs themselves (each world is only ever touched by its thread, or
  // at a reset by a lane of its warp)
  float4* pole = ONCHIP ? reinterpret_cast<float4*>(carry_smem) : st + first;
  uint32_t* aw = ONCHIP ? reinterpret_cast<uint32_t*>(pole + cap)
                        : reinterpret_cast<uint32_t*>(arng) + first;
  float* ck = ONCHIP ? reinterpret_cast<float*>(aw + cap) : chk + first;
  int* dc = ONCHIP ? reinterpret_cast<int*>(ck + cap) : dcnt + first;
  for (int s = 0; s < slots; ++s) {
    const int i = s * block + tid, n = first + i;
    if (n < N) {
      pole[i] = st_in[n];
      aw[i] = (uint32_t)arng_in[n];
      ck[i] = 0.0f;
      dc[i] = 0;
      rng[n] = rng_in[n];
    }
  }
  uint32_t base = (uint32_t)cnt_in[0];
  EPISODE_STAMPS_BEGIN
  for (int t = 0; t < T; ++t) {
    int* cnt = counts[t & 1];
    int* step_totals = totals + (t & 1) * G;
    // phase A: action, physics, done; live worlds are final for this step
    uint32_t dmask = 0u;
    for (int s = 0; s < slots; ++s) {
      const int i = s * block + tid;
      bool done = false;
      if (first + i < N) {
        const uint32_t w = episode::lcg_next(aw[i]);
        aw[i] = w;
        Pole p = load(pole, i);
        done = transition(p, (int)((w >> 23) & 1u));
        if (!done) {
          store(pole, i, p);
          ck[i] = __fadd_rn(ck[i], p.x);
        }
        dc[i] += done;
      }
      const unsigned b = __ballot_sync(episode::FULL_MASK, done);
      if (lane == 0) cnt[s * warps + warp] = __popc(b);
      dmask |= (uint32_t)done << s;
    }
    EPISODE_STAMP(episode::PH_A);
    __syncthreads();
    EPISODE_STAMP(episode::PH_BARRIER);
    if (warp == 0) {
      // the counts' exclusive scan in world order, and the block's total
      const int total = episode::scan_counts(cnt, slots * warps);
      if (lane == 0) step_totals[blockIdx.x] = total;
    }
    EPISODE_STAMP(episode::PH_SCAN);
    // the parity buffers let one sync a step suffice: a block writes the
    // next step's counts only after every block has passed this sync, hence
    // finished reading the counts of two steps back
    grid.sync();
    EPISODE_STAMP(episode::PH_GRID);
    // phase B: rank this step's resets over the whole batch and draw them,
    // the warp's done worlds one a lane in (slot, lane) order
    uint32_t before, all;
    episode::block_offsets(step_totals, blockIdx.x, G, scan_smem, &before, &all);
    const uint32_t next = base + before;
    EPISODE_STAMP(episode::PH_OFFSETS);
    const int resets = episode::warp_resets(dmask, slots);
    for (int j0 = 0; j0 < resets; j0 += 32) {
      uint32_t rank = 0u;
      const int i = episode::nth_done(dmask, slots, cnt, j0 + lane, &rank);
      if (i >= 0) {
        uint32_t w;
        const Pole p = fresh(next + rank, &w);
        store(pole, i, p);
        rng[first + i] = (int32_t)w;
        ck[i] = __fadd_rn(ck[i], p.x);
      }
    }
    __syncwarp();  // the owners read the drawn worlds next step
    base += all;
    EPISODE_STAMP(episode::PH_DRAWS);
  }
  EPISODE_STAMPS_END
  if (ONCHIP) {
    for (int s = 0; s < slots; ++s) {
      const int i = s * block + tid, n = first + i;
      if (n < N) {
        st[n] = pole[i];
        arng[n] = (int32_t)aw[i];
        chk[n] = ck[i];
        dcnt[n] = dc[i];
      }
    }
  }
  if (blockIdx.x == 0 && tid == 0) cnt_out[0] = (int64_t)base;
}

__global__ void __launch_bounds__(episode::ROLLOUT_THREADS, 1)
cp_rollout_onchip_kernel(CP_ROLLOUT_PARAMS) {
  rollout<true>(CP_ROLLOUT_ARGS);
}

__global__ void __launch_bounds__(THREADS) cp_rollout_kernel(CP_ROLLOUT_PARAMS) {
  rollout<false>(CP_ROLLOUT_ARGS);
}

cudaError_t rollout_shape(int N, int device, episode::Shape* sh) {
  return episode::rollout_shape((const void*)cp_rollout_onchip_kernel,
                                (const void*)cp_rollout_kernel, CARRY_BYTES, N, device, sh);
}

}  // namespace

extern "C" {

// Ints of scratch a K6 launch over N worlds needs: two parities of block
// counts, its blocks holding at least one warp of worlds.
int cp_scratch_ints(int N) { return 2 * ((N + 31) / 32); }

// Ints of K5's scan words for N worlds (episode::step_scan_ints): zero
// before the first launch, and left zero by every launch.
int cp_step_scratch_ints(int N) { return episode::step_scan_ints(N); }

// `scratch`: the scan words, zero at the first launch (left zero by each).
int cp_step(const float* st_in, const int32_t* rng_in, const int32_t* act,
            const int64_t* cnt_in, float* st_out, int32_t* rng_out, bool* done,
            int64_t* cnt_out, int* scratch, int N, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  int tiles = 0, per = 0;
  err = episode::step_plan((const void*)cp_step_kernel, N, device, &tiles, &per);
  if (err != cudaSuccess) return (int)err;
  cp_step_kernel<<<tiles, THREADS, 0, (cudaStream_t)stream>>>(
      reinterpret_cast<const float4*>(st_in), rng_in, act, cnt_in,
      reinterpret_cast<float4*>(st_out), rng_out, done, cnt_out,
      reinterpret_cast<unsigned long long*>(scratch), N, per);
  return (int)cudaGetLastError();
}

int cp_rollout(const float* st_in, const int32_t* rng_in, const int32_t* arng_in,
               const int64_t* cnt_in, float* st, int32_t* rng, int32_t* arng,
               int32_t* dcnt, float* chk, int64_t* cnt_out, int* scratch, int N, int T,
               int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  episode::Shape sh;
  err = rollout_shape(N, device, &sh);
  if (err != cudaSuccess) return (int)err;
  if (sh.slots > episode::MAX_ROLLOUT_SLOTS) return episode::ERR_TOO_MANY_ENVS;
  const float4* st_in4 = reinterpret_cast<const float4*>(st_in);
  float4* st4 = reinterpret_cast<float4*>(st);
  void* args[] = {(void*)&st_in4, (void*)&rng_in, (void*)&arng_in, (void*)&cnt_in,
                  (void*)&st4,    (void*)&rng,    (void*)&arng,    (void*)&dcnt,
                  (void*)&chk,    (void*)&cnt_out, (void*)&scratch, (void*)&N,
                  (void*)&T,      (void*)&sh.slots};
  const void* kernel =
      sh.onchip ? (const void*)cp_rollout_onchip_kernel : (const void*)cp_rollout_kernel;
  err = cudaLaunchCooperativeKernel(kernel, dim3(sh.blocks), dim3(sh.threads), args, sh.smem,
                                    (cudaStream_t)stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// 1 where K6 runs N worlds with their carry on chip, 0 where in device
// memory, or a negative error.
int cp_rollout_onchip(int N, int device) {
  episode::Shape sh;
  const cudaError_t err = rollout_shape(N, device, &sh);
  return err != cudaSuccess ? -(int)err : (int)sh.onchip;
}

const char* cp_error_string(int err) { return episode::error_string(err); }

#ifdef EPISODE_PHASE_STAMPS
int cp_phase_take(unsigned long long* clocks, long long* span) {
  return episode::phase_take(clocks, span);
}
#endif

}  // extern "C"
