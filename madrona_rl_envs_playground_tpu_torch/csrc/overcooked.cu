// Overcooked step kernels for Hopper (sm_90a), bound through a plain C
// interface and loaded with ctypes (ops/overcooked.py).
//
// K1 `oc_step_kernel` replaces the per-step Pallas kernel
//   madrona_rl_envs_playground_tpu/ops/overcooked_pallas.py::_build_kernel
//   (body _make_transition + _obs_channel_blocks, launched by fused_step):
//   one step per env -- interacts, movement and collisions, cook ticks, the
//   horizon auto-reset -- and the full lossless observation encode.
// K2 `oc_rollout_kernel` replaces the persistent rollout Pallas kernel
//   ops/overcooked_pallas.py::_build_rollout_kernel (fused_rollout): T steps
//   in one launch with the state in registers and local memory, actions from
//   a per-(env, player) LCG, and every step's obs, reward and done folded
//   into a per-env int32 checksum.
//
// Design.  One thread per env.  The state is stored as int8 rows [R, N]
// (R = 4S + 6P: obj_name, obj_onions, obj_tomatoes, obj_tick over S cells,
// then pos, orient, held_name, held_onions, held_tomatoes, held_tick over P
// players) plus an int32 timestep [N]; thread n reads column n, so a warp's
// loads and stores of one row are coalesced.  The layout tables (terrain,
// recipe times and values, start positions, shaping rewards) are one
// by-value kernel argument sized for the envelope S <= 100, P <= 4, so one
// build serves every layout.  Both kernels share `transition` and `encode`,
// as the JAX kernels share _make_transition.
//
// What bounds them on an H100.  K1 moves about 1.24 KB per env-step on
// cramped_room (state 92 B in and out, 8 B actions, 1,040 B of obs, 12 B of
// reward and done), so it is bound by device-memory bytes; its obs is
// written straight in the env-major [N, P, W*H*C] int8 layout the policy
// reads, and each thread packs its sequential bytes into aligned 32-bit
// stores.  Neighbouring threads still write 1,040 bytes apart, so the stores
// are not coalesced: staging through shared memory is later work.  K2 reads
// and writes the state once per launch and is bound by integer operations
// (the encode dominates); it keeps everything per thread and needs no
// communication between threads.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int MAX_S = 100;
constexpr int MAX_P = 4;
constexpr int NUM_ACTIONS = 6;
constexpr int O_NONE = 0, O_TOMATO = 1, O_ONION = 2, O_DISH = 3, O_SOUP = 4;
constexpr int A_STAY = 4, A_INTERACT = 5;
constexpr int T_AIR = 0, T_POT = 1, T_COUNTER = 2, T_ONION_SRC = 3;
constexpr int MAX_INGREDIENTS = 3;
constexpr int THREADS = 128;

}  // namespace

// Mirrored field for field by ops/overcooked.py::_Layout (ctypes).
struct OcLayout {
  int S, P, W, H, C, K, v1, horizon;
  int t_tomato, t_dish, t_serve;
  int r_place, r_dish, r_soup;
  int rtimes[16];
  int rvals[16];
  int starts[MAX_P];
  signed char terr[MAX_S];
};

namespace {

// Cell fields stay int8 in local memory (widened to int on every read);
// the few player fields live in registers.
struct Env {
  int8_t on[MAX_S], oo[MAX_S], ot[MAX_S], otk[MAX_S];
  int pos[MAX_P], ori[MAX_P], hn[MAX_P], ho[MAX_P], ht[MAX_P], htk[MAX_P];
  int ts;
};

__device__ __forceinline__ int wrap_mod(int x, int m) {
  int r = x % m;
  return r < 0 ? r + m : r;  // non-negative, as jnp.remainder
}

__device__ __forceinline__ int move(const OcLayout& L, int p, int d) {
  int delta = d == 0 ? -L.W : d == 1 ? L.W : d == 2 ? 1 : d == 3 ? -1 : 0;
  return wrap_mod(p + delta, L.S);
}

__device__ void load_state(const OcLayout& L, Env& e, const int8_t* rows,
                           const int32_t* ts, int n, int N) {
  const int S = L.S, P = L.P;
  for (int s = 0; s < S; ++s) {
    e.on[s] = rows[(size_t)s * N + n];
    e.oo[s] = rows[(size_t)(S + s) * N + n];
    e.ot[s] = rows[(size_t)(2 * S + s) * N + n];
    e.otk[s] = rows[(size_t)(3 * S + s) * N + n];
  }
  const int8_t* pr = rows + (size_t)4 * S * N;
  for (int p = 0; p < P; ++p) {
    e.pos[p] = pr[(size_t)p * N + n];
    e.ori[p] = pr[(size_t)(P + p) * N + n];
    e.hn[p] = pr[(size_t)(2 * P + p) * N + n];
    e.ho[p] = pr[(size_t)(3 * P + p) * N + n];
    e.ht[p] = pr[(size_t)(4 * P + p) * N + n];
    e.htk[p] = pr[(size_t)(5 * P + p) * N + n];
  }
  e.ts = ts[n];
}

__device__ void store_state(const OcLayout& L, const Env& e, int8_t* rows,
                            int32_t* ts, int n, int N) {
  const int S = L.S, P = L.P;
  for (int s = 0; s < S; ++s) {
    rows[(size_t)s * N + n] = e.on[s];
    rows[(size_t)(S + s) * N + n] = e.oo[s];
    rows[(size_t)(2 * S + s) * N + n] = e.ot[s];
    rows[(size_t)(3 * S + s) * N + n] = e.otk[s];
  }
  int8_t* pr = rows + (size_t)4 * S * N;
  for (int p = 0; p < P; ++p) {
    pr[(size_t)p * N + n] = (int8_t)e.pos[p];
    pr[(size_t)(P + p) * N + n] = (int8_t)e.ori[p];
    pr[(size_t)(2 * P + p) * N + n] = (int8_t)e.hn[p];
    pr[(size_t)(3 * P + p) * N + n] = (int8_t)e.ho[p];
    pr[(size_t)(4 * P + p) * N + n] = (int8_t)e.ht[p];
    pr[(size_t)(5 * P + p) * N + n] = (int8_t)e.htk[p];
  }
  ts[n] = e.ts;
}

// One step with the horizon auto-reset.  Returns the shared reward and sets
// `done`.  Semantics: envs/overcooked_base.py (both packages).
__device__ int transition(const OcLayout& L, Env& e, const int* act, bool& done) {
  const int S = L.S, P = L.P;

  // pot occupancy snapshot before any interact resolves
  int n_pots = 0;
  for (int s = 0; s < S; ++s)
    n_pots += (L.terr[s] == T_POT && e.on[s] != O_NONE &&
               (e.otk[s] >= 0 || e.oo[s] + e.ot[s] < MAX_INGREDIENTS));

  int reward = 0;
  // interacts resolve one player after another, in id order
  for (int p = 0; p < P; ++p) {
    const bool doi = act[p] == A_INTERACT;
    const int ipos = move(L, e.pos[p], e.ori[p]);
    const int t = L.terr[ipos];
    const int held = e.hn[p], held_o = e.ho[p], held_t = e.ht[p], held_k = e.htk[p];
    const int cn = e.on[ipos], co = e.oo[ipos], ct = e.ot[ipos], ctk = e.otk[ipos];

    const bool place = doi && t == T_COUNTER && held != O_NONE && cn == O_NONE;
    const bool take = doi && t == T_COUNTER && held == O_NONE && cn != O_NONE;
    const bool onion_src = doi && t == T_ONION_SRC && held == O_NONE;
    const bool tomato_src = doi && t == L.t_tomato && held == O_NONE;
    const bool dish_src = doi && t == L.t_dish && held == O_NONE;

    // the dish-pickup shaping reward exists only for two players
    bool dish_useful = false;
    if (P == 2 && dish_src) {
      int n_held_dishes = 0;
      for (int q = 0; q < P; ++q) n_held_dishes += e.hn[q] == O_DISH;
      bool dish_on_counter = false;
      for (int s = 0; s < S; ++s)
        dish_on_counter |= (L.terr[s] == T_COUNTER && e.on[s] == O_DISH);
      dish_useful = !dish_on_counter && n_held_dishes < n_pots;
    }

    const bool at_pot = doi && t == T_POT;
    const int cell_time = L.rtimes[(4 * co + ct) & 15];
    const bool is_soup = cn == O_SOUP;
    const bool ready = is_soup && ctk >= 0 && ctk >= cell_time;
    const bool cooking = is_soup && ctk >= 0 && ctk < cell_time;

    const bool soup_pick = at_pot && held == O_DISH && ready;
    const bool ing = at_pot && (held == O_ONION || held == O_TOMATO);
    // an ingredient on an empty pot creates SOUP(0, 0) first
    const int eff_on = cn == O_NONE ? 0 : co;
    const int eff_to = cn == O_NONE ? 0 : ct;
    const int eff_tk = cn == O_NONE ? -1 : ctk;
    const bool can_add = !(eff_tk >= 0 || eff_on + eff_to == MAX_INGREDIENTS);
    const bool add = ing && can_add;
    const int new_on = eff_on + (add && held == O_ONION);
    const int new_to = eff_to + (add && held == O_TOMATO);

    const bool start_cook =
        L.v1 ? (at_pot && held == O_NONE && is_soup && !cooking && !ready && co + ct > 0)
             : (ing && eff_tk == -1 && new_on + new_to == MAX_INGREDIENTS);

    const bool serve = doi && t == L.t_serve && held == O_SOUP;
    const int deliver = L.rvals[(4 * held_o + held_t) & 15];

    reward += add * L.r_place + soup_pick * L.r_soup +
              (dish_src && dish_useful) * L.r_dish + serve * deliver;

    const bool drop = place || add || serve;
    const bool fresh = onion_src || tomato_src || dish_src;
    const int fresh_name = onion_src ? O_ONION : tomato_src ? O_TOMATO : O_DISH;
    const bool pickup = take || soup_pick;
    e.hn[p] = drop ? O_NONE : fresh ? fresh_name : pickup ? cn : held;
    e.ho[p] = (drop || fresh) ? 0 : pickup ? co : held_o;
    e.ht[p] = (drop || fresh) ? 0 : pickup ? ct : held_t;
    e.htk[p] = (drop || fresh) ? -1 : pickup ? ctk : held_k;

    e.on[ipos] = (int8_t)(pickup ? O_NONE : place ? held : add ? O_SOUP : cn);
    e.oo[ipos] = (int8_t)(pickup ? 0 : place ? held_o : add ? new_on : co);
    e.ot[ipos] = (int8_t)(pickup ? 0 : place ? held_t : add ? new_to : ct);
    e.otk[ipos] = (int8_t)(pickup ? -1 : start_cook ? 0 : place ? held_k : add ? eff_tk : ctk);
  }

  // movement: any same-cell or swap conflict freezes every player
  int prop_pos[MAX_P], prop_or[MAX_P];
  for (int p = 0; p < P; ++p) {
    const int a = act[p];
    const int tgt = move(L, e.pos[p], a);
    const bool blocked = a == A_INTERACT || L.terr[tgt] != T_AIR;
    prop_pos[p] = blocked ? e.pos[p] : tgt;
    prop_or[p] = a < A_STAY ? a : e.ori[p];
  }
  bool conflict = false;
  for (int i = 0; i < P; ++i)
    for (int j = i + 1; j < P; ++j)
      conflict |= prop_pos[i] == prop_pos[j] ||
                  (prop_pos[i] == e.pos[j] && e.pos[i] == prop_pos[j]);
  for (int p = 0; p < P; ++p) {
    if (!conflict) e.pos[p] = prop_pos[p];
    e.ori[p] = prop_or[p];
  }

  // every cooking soup ticks, on a pot or a counter
  for (int s = 0; s < S; ++s)
    if (e.on[s] == O_SOUP && e.otk[s] >= 0 &&
        e.otk[s] < L.rtimes[(4 * e.oo[s] + e.ot[s]) & 15])
      e.otk[s] += 1;

  const int ts = e.ts + 1;
  done = ts >= L.horizon;
  if (done) {
    for (int s = 0; s < S; ++s) {
      e.on[s] = O_NONE; e.oo[s] = 0; e.ot[s] = 0; e.otk[s] = -1;
    }
    for (int p = 0; p < P; ++p) {
      e.pos[p] = L.starts[p]; e.ori[p] = 0;
      e.hn[p] = O_NONE; e.ho[p] = 0; e.ht[p] = 0; e.htk[p] = -1;
    }
  }
  e.ts = done ? 0 : ts;
  return reward;
}

// The object block (channels 5P..C-1) of cell s: terrain one-hot plus the
// cell's object and the objects held by players standing on it.
__device__ void object_channels(const OcLayout& L, const Env& e, int s, int* ch) {
#pragma unroll
  for (int k = 0; k < 16; ++k) ch[k] = 0;
  const int terr = L.terr[s];
  if (terr > T_AIR) ch[terr - 1] += 1;
  const bool pot = terr == T_POT;
  const int onv = e.on[s], oov = e.oo[s], otv = e.ot[s], otkv = e.otk[s];
  const bool soup = onv == O_SOUP;
  if (L.v1) {
    const bool idle = soup && pot && otkv < 0;
    const bool live = soup && pot && otkv >= 0;
    const bool off = soup && !pot;
    const int t_of = L.rtimes[(4 * oov + otv) & 15];
    ch[6] += idle ? oov : 0;
    ch[7] += idle ? otv : 0;
    ch[8] += (live || off) ? oov : 0;
    ch[9] += (live || off) ? otv : 0;
    ch[10] += live ? t_of - otkv : 0;
    ch[11] += (live && otkv >= t_of) || off;
    ch[12] += onv == O_DISH;
    ch[13] += onv == O_ONION;
    ch[14] += onv == O_TOMATO;
    ch[15] += (L.horizon - e.ts) < 40;  // post-reset timestep
    for (int p = 0; p < L.P; ++p) {
      if (e.pos[p] != s) continue;
      const int h = e.hn[p];
      if (h == O_SOUP) { ch[8] += e.ho[p]; ch[9] += e.ht[p]; ch[11] += 1; }
      ch[12] += h == O_DISH;
      ch[13] += h == O_ONION;
      ch[14] += h == O_TOMATO;
    }
  } else {
    const bool in_pot = soup && pot;
    ch[5] += in_pot ? oov : 0;
    ch[6] += in_pot ? (otkv > 0 ? otkv : 0) : 0;
    ch[7] += soup && !pot;
    ch[8] += onv == O_DISH;
    ch[9] += onv == O_ONION;
    for (int p = 0; p < L.P; ++p) {
      if (e.pos[p] != s) continue;
      const int h = e.hn[p];
      ch[7] += h == O_SOUP;
      ch[8] += h == O_DISH;
      ch[9] += h == O_ONION;
    }
  }
}

// Walks the observation in memory order of each observer's [W*H*C] row:
// cells in (x, y)-major order, channels minor.  Per observer i, channel c of
// the player block is: c < P, presence of the player of rank c; then
// P + 4*rank + orientation.  Rank 0 is the observer, the others follow in id
// order skipping the observer.  `sink.put(i, v)` receives every byte.
template <class Sink>
__device__ void encode(const OcLayout& L, const Env& e, Sink& sink) {
  const int P = L.P, K = L.K;
  int ch[16];
  for (int x = 0; x < L.W; ++x) {
    for (int y = 0; y < L.H; ++y) {
      const int s = y * L.W + x;
      object_channels(L, e, s, ch);
      for (int i = 0; i < P; ++i) {
        for (int r = 0; r < P; ++r) {
          const int j = r == 0 ? i : (r <= i ? r - 1 : r);
          sink.put(i, e.pos[j] == s);
        }
        for (int r = 0; r < P; ++r) {
          const int j = r == 0 ? i : (r <= i ? r - 1 : r);
          const bool here = e.pos[j] == s;
#pragma unroll
          for (int d = 0; d < 4; ++d) sink.put(i, here && e.ori[j] == d);
        }
        for (int k = 0; k < K; ++k) sink.put(i, ch[k]);
      }
    }
  }
}

// K1's sink: P sequential byte streams, one per observer row, packed into
// aligned 32-bit stores (bytes before the row's first aligned word, and
// after its last, are stored one by one).
struct ObsWriter {
  uint8_t* row[MAX_P];
  uint32_t word[MAX_P];
  int off[MAX_P];

  __device__ ObsWriter(int8_t* obs, int n, const OcLayout& L) {
    const size_t F = (size_t)L.S * L.C;
    for (int i = 0; i < MAX_P; ++i) {
      row[i] = reinterpret_cast<uint8_t*>(obs) + ((size_t)n * L.P + i) * F;
      word[i] = 0;
      off[i] = 0;
    }
  }

  // Store the pending bytes of the aligned word that holds end[-1]: those
  // from the word's start, or from the row's start if that is later.
  __device__ void store_pending(int i, uint8_t* end) {
    uint8_t* last = end - 1;
    uint8_t* wbase = reinterpret_cast<uint8_t*>(
        reinterpret_cast<uintptr_t>(last) & ~(uintptr_t)3);
    uint8_t* from = wbase < row[i] ? row[i] : wbase;
    if (from == wbase && last == wbase + 3) {
      *reinterpret_cast<uint32_t*>(wbase) = word[i];
    } else {
      for (uint8_t* b = from; b <= last; ++b)
        *b = (uint8_t)(word[i] >> (8 * (int)(b - wbase)));
    }
    word[i] = 0;
  }

  __device__ void put(int i, int v) {
    uint8_t* addr = row[i] + off[i];
    const int lane = (int)(reinterpret_cast<uintptr_t>(addr) & 3);
    word[i] |= (uint32_t)(uint8_t)(int8_t)v << (8 * lane);
    off[i] += 1;
    if (lane == 3) store_pending(i, addr + 1);
  }

  __device__ void finish(int P) {
    for (int i = 0; i < P; ++i)
      if (reinterpret_cast<uintptr_t>(row[i] + off[i]) & 3) store_pending(i, row[i] + off[i]);
  }
};

// K2's sink: the sum of every obs byte.
struct ObsSum {
  uint32_t total = 0;
  __device__ void put(int, int v) { total += (uint32_t)(int8_t)v; }
};

__global__ void __launch_bounds__(THREADS)
oc_step_kernel(const OcLayout L, const int8_t* __restrict__ rows_in,
               const int32_t* __restrict__ ts_in, const int32_t* __restrict__ act,
               int8_t* __restrict__ rows_out, int32_t* __restrict__ ts_out,
               int8_t* __restrict__ obs, int32_t* __restrict__ rew,
               bool* __restrict__ done_out, int N) {
  const int n = blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= N) return;
  Env e;
  load_state(L, e, rows_in, ts_in, n, N);
  int a[MAX_P];
  for (int p = 0; p < L.P; ++p) a[p] = act[(size_t)p * N + n];
  bool done;
  const int r = transition(L, e, a, done);
  store_state(L, e, rows_out, ts_out, n, N);
  for (int p = 0; p < L.P; ++p) rew[(size_t)p * N + n] = r;
  done_out[n] = done;
  ObsWriter w(obs, n, L);
  encode(L, e, w);
  w.finish(L.P);
}

__global__ void __launch_bounds__(THREADS)
oc_rollout_kernel(const OcLayout L, const int8_t* __restrict__ rows_in,
                  const int32_t* __restrict__ ts_in, const int32_t* __restrict__ rng_in,
                  int8_t* __restrict__ rows_out, int32_t* __restrict__ ts_out,
                  int32_t* __restrict__ rng_out, int32_t* __restrict__ dcnt,
                  int32_t* __restrict__ chk, int N, int T) {
  const int n = blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= N) return;
  Env e;
  load_state(L, e, rows_in, ts_in, n, N);
  uint32_t w[MAX_P];
  for (int p = 0; p < L.P; ++p) w[p] = (uint32_t)rng_in[(size_t)p * N + n];
  uint32_t sum = 0;
  int ndone = 0;
  int a[MAX_P];
  for (int t = 0; t < T; ++t) {
    for (int p = 0; p < L.P; ++p) {
      w[p] = 1664525u * w[p] + 1013904223u;
      a[p] = (int)((((w[p] >> 8) & 0x00FFFFFFu) * (uint32_t)NUM_ACTIONS) >> 24);
    }
    bool done;
    const int r = transition(L, e, a, done);
    ObsSum s;
    encode(L, e, s);
    sum += s.total + (uint32_t)L.P * (uint32_t)r + (uint32_t)done;
    ndone += done;
  }
  store_state(L, e, rows_out, ts_out, n, N);
  for (int p = 0; p < L.P; ++p) rng_out[(size_t)p * N + n] = (int32_t)w[p];
  dcnt[n] = ndone;
  chk[n] = (int32_t)sum;
}

}  // namespace

extern "C" {

int oc_step(const OcLayout* L, const int8_t* rows_in, const int32_t* ts_in,
            const int32_t* act, int8_t* rows_out, int32_t* ts_out, int8_t* obs,
            int32_t* rew, bool* done, int N, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const int blocks = (N + THREADS - 1) / THREADS;
  oc_step_kernel<<<blocks, THREADS, 0, (cudaStream_t)stream>>>(
      *L, rows_in, ts_in, act, rows_out, ts_out, obs, rew, done, N);
  return (int)cudaGetLastError();
}

int oc_rollout(const OcLayout* L, const int8_t* rows_in, const int32_t* ts_in,
               const int32_t* rng_in, int8_t* rows_out, int32_t* ts_out,
               int32_t* rng_out, int32_t* dcnt, int32_t* chk, int N, int T,
               int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const int blocks = (N + THREADS - 1) / THREADS;
  oc_rollout_kernel<<<blocks, THREADS, 0, (cudaStream_t)stream>>>(
      *L, rows_in, ts_in, rng_in, rows_out, ts_out, rng_out, dcnt, chk, N, T);
  return (int)cudaGetLastError();
}

const char* oc_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
