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
//   in one launch, actions from a per-(env, player) LCG, and every step's
//   obs, reward and done folded into a per-env int32 checksum.
//
// Layout.  The state is int8 rows [R, N] (R = 4S + 6P: obj_name,
// obj_onions, obj_tomatoes, obj_tick over S cells, then pos, orient,
// held_name, held_onions, held_tomatoes, held_tick over P players) plus an
// int32 timestep [N]; thread n reads and writes column n, so a warp's loads
// and stores of one row are coalesced.  The layout (scalars, terrain,
// recipe tables, the pot and counter cells, the obs cell order) is one
// OcLayout that the wrapper keeps on the card and each block copies into
// shared memory.
//
// Design.  One thread per env, 128 envs per block.  Both kernels are
// templates on the player count and the rule variant (P = 1..4, v1/v2), so
// every player loop unrolls and the players' fields, the actions and the LCG
// words sit in registers, and every obs channel has a constant index.  A
// cell's four int8 fields pack into one 32-bit word, and the cells live in
// dynamic shared memory as [cell][env] words with a row stride of 129, so a
// warp reading one cell of 32 envs, or 32 cells of one env, hits 32 banks.
// Nothing is indexed by a runtime value in local memory: ptxas reports no
// stack frame for either kernel.
//
// What bounds them on an H100.  K1 moves about 1.25 KB per env-step on
// cramped_room, almost all of it the obs (1,040 B), so it is bound by
// device-memory bytes.  After the step each block's state is in shared
// memory, and the block's envs own one contiguous obs range
// [n0 * P*S*C, (n0 + nb) * P*S*C) of the env-major [N, P, W*H*C] output.
// Each warp walks that range in runs of 32 (env, observer, cell) records
// of C bytes: each lane computes one record's C channel bytes from the
// shared state, stages them in a per-warp buffer, and the warp stores the
// run with aligned 16-byte stores, neighbouring lanes on neighbouring
// words; the partial words at a run's two ends are stored byte by byte.
// K2 reads and writes the state once per launch and is bound by integer
// operations: per env-step and cell it ticks the cell, computes every
// dynamic object channel once for all observers and every presence and
// orientation value of the player block, and adds them to the checksum;
// the static terrain one-hots add the same per-layout constant every step
// (`base_total`, as the JAX kernel's).  Channel values stay below 128 for
// every state the dynamics reach (recipe times < 128), so each obs byte is
// its channel value.

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
constexpr int WARPS = THREADS / 32;
constexpr int CSTRIDE = THREADS + 1;  // words from one cell's row to the next
constexpr int MAX_C = 5 * MAX_P + 16;
constexpr int STAGE_BYTES = 32 * MAX_C + 16;  // one warp's run of records
constexpr uint32_t EMPTY_CELL = 0xFF000000u;  // no object, tick -1

}  // namespace

// Mirrored field for field by ops/overcooked.py::_Layout (ctypes).
struct OcLayout {
  int S, P, W, H, C, K, v1, horizon;
  int t_tomato, t_dish, t_serve;
  int r_place, r_dish, r_soup;
  int n_pots, n_counters, base_total;
  int rtimes[16];
  int rvals[16];
  int starts[MAX_P];
  signed char terr[MAX_S];
  signed char cell_of[MAX_S];   // obs cell q = x*H + y -> state cell y*W + x
  signed char pots[MAX_S];      // the cells whose terrain is a pot
  signed char counters[MAX_S];  // the cells whose terrain is a counter
};

namespace {

template <int P>
struct Players {
  int pos[P], ori[P], hn[P], ho[P], ht[P], htk[P];
};

__device__ __forceinline__ int c_name(uint32_t w) { return (int)(int8_t)(w & 0xFF); }
__device__ __forceinline__ int c_onions(uint32_t w) { return (int)(int8_t)((w >> 8) & 0xFF); }
__device__ __forceinline__ int c_tomatoes(uint32_t w) { return (int)(int8_t)((w >> 16) & 0xFF); }
__device__ __forceinline__ int c_tick(uint32_t w) { return (int)(int8_t)(w >> 24); }

__device__ __forceinline__ uint32_t cell_word(int name, int onions, int tomatoes, int tick) {
  return (uint32_t)(name & 0xFF) | (uint32_t)(onions & 0xFF) << 8 |
         (uint32_t)(tomatoes & 0xFF) << 16 | (uint32_t)(tick & 0xFF) << 24;
}

// Rank r of observer i's player block: rank 0 is the observer, the others
// follow in id order skipping it.
__host__ __device__ constexpr int rank_player(int i, int r) {
  return r == 0 ? i : (r <= i ? r - 1 : r);
}

// The block copies the layout from the card into shared memory.
__device__ __forceinline__ void load_layout(OcLayout& dst, const OcLayout* __restrict__ src) {
  const int* s = reinterpret_cast<const int*>(src);
  int* d = reinterpret_cast<int*>(&dst);
  for (int k = threadIdx.x; k < (int)(sizeof(OcLayout) / 4); k += blockDim.x) d[k] = __ldg(s + k);
  __syncthreads();
}

// One move with the non-negative wrap of jnp.remainder; p is a cell and
// |delta| <= W <= S, so one correction suffices.
__device__ __forceinline__ int move(int p, int d, int W, int S) {
  const int delta = d == 0 ? -W : d == 1 ? W : d == 2 ? 1 : d == 3 ? -1 : 0;
  int r = p + delta;
  r = r < 0 ? r + S : r;
  return r >= S ? r - S : r;
}

// Load env n's cells into its shared-memory column and its players into
// registers.
template <int P>
__device__ __forceinline__ void load_state(int S, const int8_t* __restrict__ rows, int n, int N,
                                           uint32_t* col, Players<P>& e) {
  const size_t NN = (size_t)N;
  for (int s = 0; s < S; ++s)
    col[s * CSTRIDE] = cell_word(rows[s * NN + n], rows[(S + s) * NN + n],
                                 rows[(2 * S + s) * NN + n], rows[(3 * S + s) * NN + n]);
  const int8_t* pr = rows + 4 * S * NN;
#pragma unroll
  for (int p = 0; p < P; ++p) {
    e.pos[p] = pr[p * NN + n];
    e.ori[p] = pr[(P + p) * NN + n];
    e.hn[p] = pr[(2 * P + p) * NN + n];
    e.ho[p] = pr[(3 * P + p) * NN + n];
    e.ht[p] = pr[(4 * P + p) * NN + n];
    e.htk[p] = pr[(5 * P + p) * NN + n];
  }
}

__device__ __forceinline__ void store_cell(int S, int8_t* __restrict__ rows, int s, int n,
                                           int N, uint32_t w) {
  const size_t NN = (size_t)N;
  rows[s * NN + n] = (int8_t)c_name(w);
  rows[(S + s) * NN + n] = (int8_t)c_onions(w);
  rows[(2 * S + s) * NN + n] = (int8_t)c_tomatoes(w);
  rows[(3 * S + s) * NN + n] = (int8_t)c_tick(w);
}

template <int P>
__device__ __forceinline__ void store_players(int S, int8_t* __restrict__ rows, int n, int N,
                                              const Players<P>& e) {
  const size_t NN = (size_t)N;
  int8_t* pr = rows + 4 * S * NN;
#pragma unroll
  for (int p = 0; p < P; ++p) {
    pr[p * NN + n] = (int8_t)e.pos[p];
    pr[(P + p) * NN + n] = (int8_t)e.ori[p];
    pr[(2 * P + p) * NN + n] = (int8_t)e.hn[p];
    pr[(3 * P + p) * NN + n] = (int8_t)e.ho[p];
    pr[(4 * P + p) * NN + n] = (int8_t)e.ht[p];
    pr[(5 * P + p) * NN + n] = (int8_t)e.htk[p];
  }
}

// The interacts and the movement of one step (cook ticks, the timestep and
// the reset follow in the kernels).  Returns the shared reward.  Semantics:
// envs/overcooked_base.py (both packages).
template <int P, bool V1>
__device__ __forceinline__ int interact_and_move(const OcLayout& L, uint32_t* col, Players<P>& e,
                                                 const int (&act)[P]) {
  const int S = L.S, W = L.W;

  // pot occupancy snapshot before any interact resolves (it feeds only the
  // two-player dish-pickup shaping reward)
  int n_pots = 0;
  if constexpr (P == 2) {
    for (int k = 0; k < L.n_pots; ++k) {
      const uint32_t w = col[L.pots[k] * CSTRIDE];
      n_pots += c_name(w) != O_NONE &&
                (c_tick(w) >= 0 || c_onions(w) + c_tomatoes(w) < MAX_INGREDIENTS);
    }
  }

  int reward = 0;
  // interacts resolve one player after another, in id order; a player that
  // does not interact changes nothing here
#pragma unroll
  for (int p = 0; p < P; ++p) {
    if (act[p] != A_INTERACT) continue;
    const int ipos = move(e.pos[p], e.ori[p], W, S);
    const int t = L.terr[ipos];
    uint32_t* cell = col + ipos * CSTRIDE;
    const uint32_t cw = *cell;
    const int held = e.hn[p], held_o = e.ho[p], held_t = e.ht[p], held_k = e.htk[p];
    const int cn = c_name(cw), co = c_onions(cw), ct = c_tomatoes(cw), ctk = c_tick(cw);

    const bool place = t == T_COUNTER && held != O_NONE && cn == O_NONE;
    const bool take = t == T_COUNTER && held == O_NONE && cn != O_NONE;
    const bool onion_src = t == T_ONION_SRC && held == O_NONE;
    const bool tomato_src = t == L.t_tomato && held == O_NONE;
    const bool dish_src = t == L.t_dish && held == O_NONE;

    // the dish-pickup shaping reward exists only for two players
    bool dish_useful = false;
    if (P == 2 && dish_src) {
      int n_held_dishes = 0;
#pragma unroll
      for (int q = 0; q < P; ++q) n_held_dishes += e.hn[q] == O_DISH;
      bool dish_on_counter = false;
      for (int k = 0; k < L.n_counters; ++k)
        dish_on_counter |= c_name(col[L.counters[k] * CSTRIDE]) == O_DISH;
      dish_useful = !dish_on_counter && n_held_dishes < n_pots;
    }

    const bool at_pot = t == T_POT;
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
        V1 ? (at_pot && held == O_NONE && is_soup && !cooking && !ready && co + ct > 0)
           : (ing && eff_tk == -1 && new_on + new_to == MAX_INGREDIENTS);

    const bool serve = t == L.t_serve && held == O_SOUP;
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

    *cell = cell_word(pickup ? O_NONE : place ? held : add ? O_SOUP : cn,
                      pickup ? 0 : place ? held_o : add ? new_on : co,
                      pickup ? 0 : place ? held_t : add ? new_to : ct,
                      pickup ? -1 : start_cook ? 0 : place ? held_k : add ? eff_tk : ctk);
  }

  // movement: any same-cell or swap conflict freezes every player
  int prop_pos[P];
#pragma unroll
  for (int p = 0; p < P; ++p) {
    const int a = act[p];
    const int tgt = move(e.pos[p], a, W, S);
    const bool blocked = a == A_INTERACT || L.terr[tgt] != T_AIR;
    prop_pos[p] = blocked ? e.pos[p] : tgt;
  }
  bool conflict = false;
#pragma unroll
  for (int i = 0; i < P; ++i)
#pragma unroll
    for (int j = i + 1; j < P; ++j)
      conflict |= prop_pos[i] == prop_pos[j] ||
                  (prop_pos[i] == e.pos[j] && e.pos[i] == prop_pos[j]);
#pragma unroll
  for (int p = 0; p < P; ++p) {
    if (!conflict) e.pos[p] = prop_pos[p];
    e.ori[p] = act[p] < A_STAY ? act[p] : e.ori[p];
  }
  return reward;
}

// Advance the timestep; at the horizon reset the players and report done.
template <int P>
__device__ __forceinline__ bool advance_time(const OcLayout& L, Players<P>& e, int& ts) {
  ts += 1;
  const bool done = ts >= L.horizon;
  if (done) {
#pragma unroll
    for (int p = 0; p < P; ++p) {
      e.pos[p] = L.starts[p]; e.ori[p] = 0;
      e.hn[p] = O_NONE; e.ho[p] = 0; e.ht[p] = 0; e.htk[p] = -1;
    }
    ts = 0;
  }
  return done;
}

// A cell after the step's cook tick (every cooking soup, on a pot or a
// counter) and the reset.
__device__ __forceinline__ uint32_t tick_cell(const OcLayout& L, uint32_t w, bool done) {
  if (done) return EMPTY_CELL;
  const int tk = c_tick(w);
  const bool cooking = c_name(w) == O_SOUP && tk >= 0 &&
                       tk < L.rtimes[(4 * c_onions(w) + c_tomatoes(w)) & 15];
  return cooking ? w + (1u << 24) : w;  // tk < 127, so the byte does not wrap
}

// The object block (channels 5P..C-1) of one cell, word w with terrain
// `terr`: its object and the objects held by the players standing on it
// (`here`), plus the terrain one-hot where TERRAIN.  `ts` is the env's
// timestep after the step.
template <int P, bool V1, bool TERRAIN>
__device__ __forceinline__ void object_channels(const OcLayout& L, uint32_t w, int terr, int ts,
                                                const bool (&here)[P], const Players<P>& e,
                                                int (&ch)[V1 ? 16 : 10]) {
  constexpr int K = V1 ? 16 : 10;
#pragma unroll
  for (int k = 0; k < K; ++k) ch[k] = TERRAIN && terr == k + 1;
  const bool pot = terr == T_POT;
  const int onv = c_name(w), oov = c_onions(w), otv = c_tomatoes(w), tk = c_tick(w);
  const bool soup = onv == O_SOUP;
  if constexpr (V1) {
    const bool idle = soup && pot && tk < 0;
    const bool live = soup && pot && tk >= 0;
    const bool off = soup && !pot;
    const int t_of = live ? L.rtimes[(4 * oov + otv) & 15] : 0;
    ch[6] += idle ? oov : 0;
    ch[7] += idle ? otv : 0;
    ch[8] += (live || off) ? oov : 0;
    ch[9] += (live || off) ? otv : 0;
    ch[10] += live ? t_of - tk : 0;
    ch[11] += (live && tk >= t_of) || off;
    ch[12] += onv == O_DISH;
    ch[13] += onv == O_ONION;
    ch[14] += onv == O_TOMATO;
    ch[15] += (L.horizon - ts) < 40;
#pragma unroll
    for (int p = 0; p < P; ++p) {
      const int h = here[p] ? e.hn[p] : O_NONE;
      const bool hs = h == O_SOUP;
      ch[8] += hs ? e.ho[p] : 0;
      ch[9] += hs ? e.ht[p] : 0;
      ch[11] += hs;
      ch[12] += h == O_DISH;
      ch[13] += h == O_ONION;
      ch[14] += h == O_TOMATO;
    }
  } else {
    const bool in_pot = soup && pot;
    ch[5] += in_pot ? oov : 0;
    ch[6] += in_pot ? (tk > 0 ? tk : 0) : 0;
    ch[7] += soup && !pot;
    ch[8] += onv == O_DISH;
    ch[9] += onv == O_ONION;
#pragma unroll
    for (int p = 0; p < P; ++p) {
      const int h = here[p] ? e.hn[p] : O_NONE;
      ch[7] += h == O_SOUP;
      ch[8] += h == O_DISH;
      ch[9] += h == O_ONION;
    }
  }
}

// ---- K1 --------------------------------------------------------------------

// K1's dynamic shared memory: the cells [S][CSTRIDE] words, the players'
// packed (pos, orient, held name, held onions) bytes and held tomatoes
// [P][THREADS] each, the timesteps [THREADS], then the warps' staging
// buffers on a 16-byte boundary.
__host__ __device__ constexpr int k1_stage_offset(int S, int P) {
  return (4 * (S * CSTRIDE + 2 * P * THREADS + THREADS) + 15) / 16 * 16;
}
__host__ __device__ constexpr int k1_smem_bytes(int S, int P) {
  return k1_stage_offset(S, P) + WARPS * STAGE_BYTES;
}

// One (env e, observer i, obs cell q) record: its C channel bytes at dst.
template <int P, bool V1>
__device__ __forceinline__ void encode_record(const OcLayout& L, const uint32_t* cells,
                                              const uint32_t* pw, const int* pht, const int* sts,
                                              int e, int i, int q, uint8_t* dst) {
  constexpr int K = V1 ? 16 : 10;
  const int s = L.cell_of[q];
  Players<P> pl;
  bool here[P];
#pragma unroll
  for (int p = 0; p < P; ++p) {
    const uint32_t w = pw[p * THREADS + e];
    pl.pos[p] = (int8_t)(w & 0xFF);
    pl.ori[p] = (int8_t)((w >> 8) & 0xFF);
    pl.hn[p] = (int8_t)((w >> 16) & 0xFF);
    pl.ho[p] = (int8_t)(w >> 24);
    pl.ht[p] = pht[p * THREADS + e];
    pl.htk[p] = 0;  // the encode does not read it
    here[p] = pl.pos[p] == s;
  }
  int ch[K];
  object_channels<P, V1, true>(L, cells[s * CSTRIDE + e], L.terr[s], sts[e], here, pl, ch);
  // the player block: presence of rank r, then P + 4r + orientation
#pragma unroll
  for (int r = 0; r < P; ++r) {
    bool h;
    int o;
    if (r == 0) {
      h = here[0];
      o = pl.ori[0];
#pragma unroll
      for (int p = 1; p < P; ++p) {
        h = i == p ? here[p] : h;
        o = i == p ? pl.ori[p] : o;
      }
    } else {
      const bool lo = r <= i;
      const int below = r > 0 ? r - 1 : 0;
      h = lo ? here[below] : here[r];
      o = lo ? pl.ori[below] : pl.ori[r];
    }
    dst[r] = h;
#pragma unroll
    for (int d = 0; d < 4; ++d) dst[P + 4 * r + d] = h && o == d;
  }
#pragma unroll
  for (int k = 0; k < K; ++k) dst[5 * P + k] = (uint8_t)ch[k];
}

// The block's obs range, written by all its warps: runs of 32 records,
// staged per warp and stored with aligned 16-byte stores.
template <int P, bool V1>
__device__ __forceinline__ void write_obs(const OcLayout& L, const uint32_t* cells,
                                          const uint32_t* pw, const int* pht, const int* sts,
                                          uint8_t* stage, uint8_t* __restrict__ obs, int n0,
                                          int nb) {
  constexpr int C = 5 * P + (V1 ? 16 : 10);
  const int S = L.S, PS = P * L.S;
  const int lane = threadIdx.x & 31;
  const int nrec = nb * PS;
  const size_t rec0 = (size_t)n0 * PS;
  for (int c0 = (threadIdx.x >> 5) * 32; c0 < nrec; c0 += THREADS) {
    const size_t g0 = (rec0 + c0) * C;  // the run's first byte in obs
    const int head = (int)(g0 & 15);
    const int r = c0 + lane;
    if (r < nrec) {
      const int e = r / PS;
      const int rem = r - e * PS;
      const int i = rem / S;
      encode_record<P, V1>(L, cells, pw, pht, sts, e, i, rem - i * S, stage + head + lane * C);
    }
    __syncwarp();
    const int end = head + min(32, nrec - c0) * C;  // staging bytes [head, end)
    uint8_t* base = obs + (g0 - head);
    for (int lo = lane * 16; lo < end; lo += 32 * 16) {
      if (lo >= head && lo + 16 <= end) {
        *reinterpret_cast<uint4*>(base + lo) = *reinterpret_cast<const uint4*>(stage + lo);
      } else {
        for (int b = max(lo, head); b < min(lo + 16, end); ++b) base[b] = stage[b];
      }
    }
    __syncwarp();
  }
}

template <int P, bool V1>
__global__ void __launch_bounds__(THREADS)
oc_step_kernel(const OcLayout* __restrict__ Lg, const int8_t* __restrict__ rows_in,
               const int32_t* __restrict__ ts_in, const int32_t* __restrict__ act,
               int8_t* __restrict__ rows_out, int32_t* __restrict__ ts_out,
               int8_t* __restrict__ obs, int32_t* __restrict__ rew,
               bool* __restrict__ done_out, int N) {
  __shared__ OcLayout L;
  extern __shared__ __align__(16) unsigned char smem[];
  load_layout(L, Lg);
  const int S = L.S;
  uint32_t* cells = reinterpret_cast<uint32_t*>(smem);
  uint32_t* pw = cells + S * CSTRIDE;
  int* pht = reinterpret_cast<int*>(pw + P * THREADS);
  int* sts = pht + P * THREADS;
  uint8_t* stage = smem + k1_stage_offset(S, P) + (threadIdx.x >> 5) * STAGE_BYTES;

  const int tid = threadIdx.x;
  const int n0 = blockIdx.x * THREADS;
  const int n = n0 + tid;
  if (n < N) {
    uint32_t* col = cells + tid;
    Players<P> e;
    load_state<P>(S, rows_in, n, N, col, e);
    int a[P];
#pragma unroll
    for (int p = 0; p < P; ++p) a[p] = act[(size_t)p * N + n];
    const int r = interact_and_move<P, V1>(L, col, e, a);
    int ts = ts_in[n];
    const bool done = advance_time<P>(L, e, ts);
    for (int s = 0; s < S; ++s) {
      const uint32_t w = tick_cell(L, col[s * CSTRIDE], done);
      col[s * CSTRIDE] = w;
      store_cell(S, rows_out, s, n, N, w);
    }
    store_players<P>(S, rows_out, n, N, e);
    ts_out[n] = ts;
#pragma unroll
    for (int p = 0; p < P; ++p) {
      rew[(size_t)p * N + n] = r;
      pw[p * THREADS + tid] = cell_word(e.pos[p], e.ori[p], e.hn[p], e.ho[p]);
      pht[p * THREADS + tid] = e.ht[p];
    }
    done_out[n] = done;
    sts[tid] = ts;
  }
  __syncthreads();
  write_obs<P, V1>(L, cells, pw, pht, sts, stage, reinterpret_cast<uint8_t*>(obs), n0,
                   min(THREADS, N - n0));
}

// ---- K2 --------------------------------------------------------------------

template <int P, bool V1>
__global__ void __launch_bounds__(THREADS)
oc_rollout_kernel(const OcLayout* __restrict__ Lg, const int8_t* __restrict__ rows_in,
                  const int32_t* __restrict__ ts_in, const int32_t* __restrict__ rng_in,
                  int8_t* __restrict__ rows_out, int32_t* __restrict__ ts_out,
                  int32_t* __restrict__ rng_out, int32_t* __restrict__ dcnt,
                  int32_t* __restrict__ chk, int N, int T) {
  constexpr int K = V1 ? 16 : 10;
  __shared__ OcLayout L;
  extern __shared__ __align__(16) unsigned char smem[];
  load_layout(L, Lg);
  const int n = blockIdx.x * THREADS + threadIdx.x;
  if (n >= N) return;
  const int S = L.S;
  uint32_t* col = reinterpret_cast<uint32_t*>(smem) + threadIdx.x;
  Players<P> e;
  load_state<P>(S, rows_in, n, N, col, e);
  int ts = ts_in[n];
  uint32_t w[P];
#pragma unroll
  for (int p = 0; p < P; ++p) w[p] = (uint32_t)rng_in[(size_t)p * N + n];
  uint32_t sum = 0;
  int ndone = 0;
  for (int t = 0; t < T; ++t) {
    int a[P];
#pragma unroll
    for (int p = 0; p < P; ++p) {
      w[p] = 1664525u * w[p] + 1013904223u;
      a[p] = (int)((((w[p] >> 8) & 0x00FFFFFFu) * (uint32_t)NUM_ACTIONS) >> 24);
    }
    const int r = interact_and_move<P, V1>(L, col, e, a);
    const bool done = advance_time<P>(L, e, ts);
    // each cell: tick and reset it, then add every obs byte it gives
    uint32_t obs_sum = 0;
    for (int s = 0; s < S; ++s) {
      const uint32_t w0 = col[s * CSTRIDE];
      const uint32_t cw = tick_cell(L, w0, done);
      if (cw != w0) col[s * CSTRIDE] = cw;
      bool here[P];
#pragma unroll
      for (int p = 0; p < P; ++p) here[p] = e.pos[p] == s;
      int ch[K];
      object_channels<P, V1, false>(L, cw, L.terr[s], ts, here, e, ch);
      int obj = 0;
#pragma unroll
      for (int k = 0; k < K; ++k) obj += ch[k];
      int cell = 0;
#pragma unroll
      for (int i = 0; i < P; ++i) {
        cell += obj;  // the object block repeats for every observer
#pragma unroll
        for (int r2 = 0; r2 < P; ++r2) {
          const int j = rank_player(i, r2);
          cell += here[j];
#pragma unroll
          for (int d = 0; d < 4; ++d) cell += here[j] && e.ori[j] == d;
        }
      }
      obs_sum += (uint32_t)cell;
    }
    sum += obs_sum + (uint32_t)L.base_total + (uint32_t)P * (uint32_t)r + (uint32_t)done;
    ndone += done;
  }
  for (int s = 0; s < S; ++s) store_cell(S, rows_out, s, n, N, col[s * CSTRIDE]);
  store_players<P>(S, rows_out, n, N, e);
  ts_out[n] = ts;
#pragma unroll
  for (int p = 0; p < P; ++p) rng_out[(size_t)p * N + n] = (int32_t)w[p];
  dcnt[n] = ndone;
  chk[n] = (int32_t)sum;
}

// ---- launches ----------------------------------------------------------------

// Dynamic shared memory above 48 KB needs the kernel's opt-in.
template <class Kernel>
cudaError_t allow_smem(Kernel kernel, int smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
}

template <int P, bool V1>
int launch_step(const OcLayout* Ld, int S, const int8_t* rows_in, const int32_t* ts_in,
                const int32_t* act, int8_t* rows_out, int32_t* ts_out, int8_t* obs,
                int32_t* rew, bool* done, int N, cudaStream_t stream) {
  const int smem = k1_smem_bytes(S, P);
  cudaError_t err = allow_smem(oc_step_kernel<P, V1>, smem);
  if (err != cudaSuccess) return (int)err;
  oc_step_kernel<P, V1><<<(N + THREADS - 1) / THREADS, THREADS, smem, stream>>>(
      Ld, rows_in, ts_in, act, rows_out, ts_out, obs, rew, done, N);
  return (int)cudaGetLastError();
}

template <int P, bool V1>
int launch_rollout(const OcLayout* Ld, int S, const int8_t* rows_in, const int32_t* ts_in,
                   const int32_t* rng_in, int8_t* rows_out, int32_t* ts_out, int32_t* rng_out,
                   int32_t* dcnt, int32_t* chk, int N, int T, cudaStream_t stream) {
  const int smem = 4 * S * CSTRIDE;
  cudaError_t err = allow_smem(oc_rollout_kernel<P, V1>, smem);
  if (err != cudaSuccess) return (int)err;
  oc_rollout_kernel<P, V1><<<(N + THREADS - 1) / THREADS, THREADS, smem, stream>>>(
      Ld, rows_in, ts_in, rng_in, rows_out, ts_out, rng_out, dcnt, chk, N, T);
  return (int)cudaGetLastError();
}

// The instantiation for (P, v1), or -1 outside P = 1..4.
int variant_index(const OcLayout* L) {
  if (L->P < 1 || L->P > MAX_P || L->S < 1 || L->S > MAX_S) return -1;
  return 2 * (L->P - 1) + (L->v1 ? 1 : 0);
}

}  // namespace

extern "C" {

int oc_layout_size() { return (int)sizeof(OcLayout); }

// L: the layout on the host (read for the dispatch); Ld: the same bytes on
// the card (read by the kernel).
int oc_step(const OcLayout* L, const OcLayout* Ld, const int8_t* rows_in, const int32_t* ts_in,
            const int32_t* act, int8_t* rows_out, int32_t* ts_out, int8_t* obs,
            int32_t* rew, bool* done, int N, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = (cudaStream_t)stream;
  const int S = L->S;
#define OC_STEP(P, V1) \
  launch_step<P, V1>(Ld, S, rows_in, ts_in, act, rows_out, ts_out, obs, rew, done, N, s)
  switch (variant_index(L)) {
    case 0: return OC_STEP(1, false);
    case 1: return OC_STEP(1, true);
    case 2: return OC_STEP(2, false);
    case 3: return OC_STEP(2, true);
    case 4: return OC_STEP(3, false);
    case 5: return OC_STEP(3, true);
    case 6: return OC_STEP(4, false);
    case 7: return OC_STEP(4, true);
    default: return (int)cudaErrorInvalidValue;
  }
#undef OC_STEP
}

int oc_rollout(const OcLayout* L, const OcLayout* Ld, const int8_t* rows_in,
               const int32_t* ts_in, const int32_t* rng_in, int8_t* rows_out, int32_t* ts_out,
               int32_t* rng_out, int32_t* dcnt, int32_t* chk, int N, int T, int device,
               void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = (cudaStream_t)stream;
  const int S = L->S;
#define OC_ROLLOUT(P, V1)                                                                 \
  launch_rollout<P, V1>(Ld, S, rows_in, ts_in, rng_in, rows_out, ts_out, rng_out, dcnt, \
                        chk, N, T, s)
  switch (variant_index(L)) {
    case 0: return OC_ROLLOUT(1, false);
    case 1: return OC_ROLLOUT(1, true);
    case 2: return OC_ROLLOUT(2, false);
    case 3: return OC_ROLLOUT(2, true);
    case 4: return OC_ROLLOUT(3, false);
    case 5: return OC_ROLLOUT(3, true);
    case 6: return OC_ROLLOUT(4, false);
    case 7: return OC_ROLLOUT(4, true);
    default: return (int)cudaErrorInvalidValue;
  }
#undef OC_ROLLOUT
}

const char* oc_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
