// Hanabi kernels for Hopper (sm_90a), 2-player configs, bound through a
// plain C interface and loaded with ctypes (ops/hanabi.py).
//
// K3 `hk_step_kernel` + `hk_reset_kernel` replace the per-step Pallas kernel
//   madrona_rl_envs_playground_tpu/ops/hanabi_megakernel.py::_build_kernel
//   (body _make_body, _load_state, _store_state; launched by fused_step):
//   discard / play / reveal, the random-swap replacement draw or the
//   empty-deck shift, turn / score / life termination, the world-order
//   episode index of every reset and its closed-form deal, and the 658-bit
//   observation, own-hand and legal-mask encodes with the stale-seat rule.
//   One fused_step is these two launches: the first steps every world and
//   writes each block's count of done worlds; the second ranks the done
//   worlds (csrc/episode_scan.cuh), deals their fresh games, and writes the
//   refreshed seats' encodes (the others' bytes are copied from the input
//   buffers).  The launch boundary is the barrier between the two halves of
//   the scan.
// K4 `hk_rollout_kernel` replaces the persistent rollout Pallas kernel
//   ops/hanabi_megakernel.py::_build_rollout_kernel (fused_rollout): T steps
//   in one cooperative launch; each world's action is the
//   ((u24 * L) >> 24)-th of the acting seat's L legal moves, u24 = bits
//   8..31 of the world's advanced action-LCG word (sample_legal); each seat
//   carries the sum of its obs, own and mask bytes, started from the
//   launch-time buffers and re-encoded only where that seat is refreshed,
//   and the checksum adds P * reward + done + both seats' sums every step.
//   Episodes are allocated per step in whole-batch world order (a grid-wide
//   sync per step, as csrc/cartpole.cu's K6), which equals T applications
//   of K3 and JAX's fused_rollout with one block; JAX's multi-block grids
//   allocate block by block.
// K11 `hk_mask_kernel` replaces ops/hanabi_pallas.py::_mask_kernel
//   (legal_moves_pallas): every seat's legal-move mask from the hand cards,
//   hand sizes and info tokens, one thread per (world, seat).
//
// Semantics: envs/hanabi.py of both packages, with the reference's two
// quirks: the card-knowledge section broadcasts plausible bit `offset` over
// the bits-per-card block, and the reveal legality scans dead hand slots.
//
// Layout.  The state is int32 [rows, N] (ops/hanabi.py's row order: deck,
// discards, fireworks, 16 scalar rows, hand cards, plausible masks, hand
// sizes, known colors, known ranks), so a warp's loads of one row are
// coalesced; block b owns a contiguous run of slots * THREADS worlds
// (episode_scan.cuh's `world`).  The scalars and the hands of a world live
// in registers during a step (struct Game, indexed only by unrolled loop
// counters); the deck, discards and fireworks stay in device memory.  The
// encodes go straight into the env-major [N, P, bits] buffers the policy
// reads, packed into aligned 32-bit stores (ByteSink).
//
// Exactness.  The only float work is the draw position int32(f32(size) *
// u): u = (word & 0xFFFFFF) * 2^-24 is exact, __fmul_rn rounds the product
// once and __float2int_rz truncates, as the JAX code's float32 multiply and
// astype(int32) do.  Every / and % has non-negative operands.
//
// What bounds them on an H100.  K3 moves 552 B of state in and out per
// world, reads the stale seat's 803 B of obs / own / mask and writes both
// seats' 1,606 B, reads the acting seat's action and writes 5 B of reward
// and done: about 3.5 KB per world-step, against a few hundred integer
// operations, so device-memory bytes bound it; its per-thread rows of 658 B
// are written 658 B apart across a warp (uncoalesced), which is the first
// thing to fix.  K4 reads and writes the state once per launch but its
// carry (552 B per world) does not fit in registers at useful occupancy, so
// each step loads and stores the touched part of it; its bound is
// operations, which a sum taken section by section keeps to a few hundred
// per world-step (this encode still counts bit by bit).  K11 reads 52 B and
// writes 40 B per world.

#include <cooperative_groups.h>
#include <cstdint>
#include <cstring>
#include <cuda_runtime.h>

#include "episode_scan.cuh"

namespace cg = cooperative_groups;
using episode::THREADS;
using episode::world;

namespace {

constexpr int P = 2;      // players: the kernels' envelope (ops/hanabi.py)
constexpr int H = 5;      // hand size below 4 players
constexpr int D = P * H;  // cards dealt
constexpr int NSCAL = 16;
constexpr int ERR_BAD_CONFIG = -2;

// scalar rows, in ops/hanabi.py's SCAL_FIELDS order
enum { DS, INFO, LIFE, CUR, TURNS, SCORE, LMM, LMP, LMT, LMCI, LMSC, LMIT, LMC, LMR, LMRB, RNG };
enum { M_DISCARD, M_PLAY, M_REVEAL_C, M_REVEAL_R, M_INVALID };

// The config's sizes and the state's row offsets, a flat array of ints in
// this order from ops/hanabi.py::_cfg, which owns the layout.
struct Cfg {
  int C, R, max_info, max_life;
  int CR, cpc, M, deck_bits, obs, own, A;
  int r_deck, r_disc, r_fw, r_scal, r_hc, r_hp, r_hs, r_kc, r_kr, rows;
};
constexpr int CFG_INTS = 21;
static_assert(sizeof(Cfg) == CFG_INTS * sizeof(int), "Cfg is read as a flat int array");

// Returns false outside the envelope the kernels hold in 32-bit masks.
bool make_cfg(const int* in, int n, Cfg* c) {
  if (n != CFG_INTS) return false;
  std::memcpy(c, in, sizeof(Cfg));
  return c->CR <= 32 && c->A <= 32 && c->deck_bits >= 0 && c->rows > 0;
}

__device__ __forceinline__ int copies(const Cfg& c, int r) {
  return r == 0 ? 3 : (r == c.R - 1 ? 1 : 2);
}

// One world's column of the [rows, N] state.
struct Col {
  int32_t* p;
  int N;
  __device__ __forceinline__ int32_t& operator[](int row) const { return p[(size_t)row * N]; }
};

// The scalars and hands of one world, in registers.
struct Game {
  int s[NSCAL];
  int hc[P][H], kc[P][H], kr[P][H];
  uint32_t hp[P][H];
  int hs[P];
};

__device__ __forceinline__ void load_game(const Cfg& c, Col col, Game& g) {
#pragma unroll
  for (int k = 0; k < NSCAL; ++k) g.s[k] = col[c.r_scal + k];
#pragma unroll
  for (int p = 0; p < P; ++p) {
#pragma unroll
    for (int h = 0; h < H; ++h) {
      g.hc[p][h] = col[c.r_hc + p * H + h];
      g.hp[p][h] = (uint32_t)col[c.r_hp + p * H + h];
      g.kc[p][h] = col[c.r_kc + p * H + h];
      g.kr[p][h] = col[c.r_kr + p * H + h];
    }
    g.hs[p] = col[c.r_hs + p];
  }
}

__device__ __forceinline__ void store_game(const Cfg& c, Col col, const Game& g) {
#pragma unroll
  for (int k = 0; k < NSCAL; ++k) col[c.r_scal + k] = g.s[k];
#pragma unroll
  for (int p = 0; p < P; ++p) {
#pragma unroll
    for (int h = 0; h < H; ++h) {
      col[c.r_hc + p * H + h] = g.hc[p][h];
      col[c.r_hp + p * H + h] = (int32_t)g.hp[p][h];
      col[c.r_kc + p * H + h] = g.kc[p][h];
      col[c.r_kr + p * H + h] = g.kr[p][h];
    }
    col[c.r_hs + p] = g.hs[p];
  }
}

// hand values of seat q (0 or 1) at a fixed slot, without indexing the
// register arrays by a runtime seat
#define SEAT(arr, q, h) ((q) == 0 ? (arr)[0][h] : (arr)[1][h])

// ---- the game step (envs/hanabi.py::transition, _remove_from_hand) --------

// One step of world `col` with move `uid` of the current player; returns
// done and the score delta in *rew.
__device__ bool transition(const Cfg& c, Col col, Game& g, int uid, int* rew) {
  int* s = g.s;
  s[TURNS] -= s[DS] == 0;
  const int agent = s[CUR];
  const int rc_base = 2 * H, rr_base = 2 * H + (P - 1) * c.C;
  const bool is_discard = uid < H, is_play = uid >= H && uid < 2 * H;
  const bool is_rc = uid >= rc_base && uid < rr_base, is_rr = uid >= rr_base;
  const bool took = is_discard || is_play, reveal = is_rc || is_rr;
  // the slot played or discarded (JAX clamps it into [0, H); it is only
  // read for those two moves), tested through a one-hot mask of the slots
  const int card_idx = is_discard ? uid : (is_play ? uid - H : 0);
  const uint32_t at = 1u << card_idx;
  int card = 0;
#pragma unroll
  for (int h = 0; h < H; ++h)
    if ((at >> h) & 1u) card = SEAT(g.hc, agent, h);
  const int card_color = card / c.R, card_rank = card % c.R;

  // discard and play
  const int fwc = col[c.r_fw + card_color];
  const bool success = is_play && fwc == card_rank;
  const bool completed = success && fwc + 1 == c.R;
  const bool failed = is_play && !success;
  if (is_discard || failed) col[c.r_disc + card] += 1;
  if (success) col[c.r_fw + card_color] = fwc + 1;
  s[INFO] += (int)is_discard + (int)completed;
  s[LIFE] -= (int)failed;

  // reveals: with two players the target is the partner
  const int rev_color = is_rc ? uid - rc_base : 0;
  const int rev_rank = is_rr ? uid - rr_base : 0;
  const int target = (agent + 1) % P;
  s[INFO] -= (int)reveal;
  const uint32_t color_mask = ((1u << c.R) - 1u) << (rev_color * c.R);
  uint32_t rank_mask = 0u;
  for (int i = 0; i < c.R; ++i)
    if (i * c.R + rev_rank < 32) rank_mask |= 1u << (i * c.R + rev_rank);
  int reveal_bits = 0;
#pragma unroll
  for (int p = 0; p < P; ++p) {
    const bool tgt = reveal && target == p;
#pragma unroll
    for (int h = 0; h < H; ++h) {
      const bool live = h < g.hs[p];
      const bool mc = live && g.hc[p][h] / c.R == rev_color;
      const bool mr = live && g.hc[p][h] % c.R == rev_rank;
      if (tgt && is_rc) g.hp[p][h] &= mc ? color_mask : ~color_mask;
      if (tgt && is_rr) g.hp[p][h] &= mr ? rank_mask : ~rank_mask;
      if (tgt && is_rc && mc) g.kc[p][h] = rev_color;
      if (tgt && is_rr && mr) g.kr[p][h] = rev_rank;
      if (tgt && ((is_rc && mc) || (is_rr && mr))) reveal_bits |= 1 << h;
    }
  }

  s[LMM] = is_discard ? M_DISCARD : is_play ? M_PLAY : is_rc ? M_REVEAL_C : M_REVEAL_R;
  s[LMP] = agent;
  s[LMT] = reveal ? target : -1;
  s[LMCI] = took ? card_idx : -1;
  s[LMSC] = success;
  s[LMIT] = completed;
  s[LMC] = took ? card_color : (is_rc ? rev_color : -1);
  s[LMR] = took ? card_rank : (is_rr ? rev_rank : -1);
  s[LMRB] = reveal_bits;
  s[CUR] = (agent + 1) % P;

  // removeFromHand: a random-swap draw into the slot, or, with the deck
  // empty, shift the later live slots left (the dead slot keeps its values)
  const int ds = s[DS];
  if (took && ds > 0) {
    const uint32_t v1 = episode::lcg_next((uint32_t)s[RNG]);
    const int loc = __float2int_rz(__fmul_rn((float)ds, episode::unif(v1)));
    const int drawn = col[c.r_deck + loc];
    col[c.r_deck + loc] = col[c.r_deck + ds - 1];
    s[DS] = ds - 1;
    s[RNG] = (int)v1;
#pragma unroll
    for (int p = 0; p < P; ++p) {
#pragma unroll
      for (int h = 0; h < H; ++h) {
        if (p == agent && ((at >> h) & 1u)) {
          g.hc[p][h] = drawn;
          g.hp[p][h] = (uint32_t)((1ull << c.CR) - 1ull);
          g.kc[p][h] = -1;
          g.kr[p][h] = -1;
        }
      }
    }
  } else if (took) {
#pragma unroll
    for (int p = 0; p < P; ++p) {
      if (p != agent) continue;
      const int last = g.hs[p] - 1;
#pragma unroll
      for (int h = 0; h + 1 < H; ++h) {
        // ascending, so slot h + 1 is read before it is overwritten
        if (h >= card_idx && h < last) {
          g.hc[p][h] = g.hc[p][h + 1];
          g.hp[p][h] = g.hp[p][h + 1];
          g.kc[p][h] = g.kc[p][h + 1];
          g.kr[p][h] = g.kr[p][h + 1];
        }
      }
      g.hs[p] -= 1;
    }
  }

  // checkDone
  int fwsum = 0;
  for (int k = 0; k < c.C; ++k) fwsum += col[c.r_fw + k];
  const int score = s[LIFE] > 0 ? fwsum : 0;
  *rew = score - s[SCORE];
  s[SCORE] = score;
  return s[LIFE] < 1 || score >= c.CR || s[TURNS] <= 0;
}

// ---- the deal (envs/hanabi.py::init_core) ---------------------------------

// deck0[loc]: the card at position loc of the unshuffled deck
__device__ __forceinline__ int orig_card(const Cfg& c, int loc) {
  const int rem = loc % c.cpc;
  int rank = 0, acc = 0;
  for (int r = 0; r < c.R; ++r) {
    acc += copies(c, r);
    if (rem >= acc) rank = r + 1;
  }
  return (loc / c.cpc) * c.R + rank;
}

// A fresh game for episode `idx`.  The D swap draws of the deal are
// resolved in closed form: positions from D LCG words of the TEA seed, then
// a last-write-wins cascade over the touched positions.
__device__ void deal(const Cfg& c, Col col, Game& g, uint32_t idx) {
  uint32_t v = episode::tea_seed(idx);
  int locs[D], moved[D];
#pragma unroll
  for (int k = 0; k < D; ++k) {
    v = episode::lcg_next(v);
    locs[k] = __float2int_rz(__fmul_rn((float)(c.M - k), episode::unif(v)));
  }
  // moved[j] = the card at position M-1-j just before draw j
#pragma unroll
  for (int j = 0; j < D; ++j) {
    const int tgt = c.M - 1 - j;
    int val = orig_card(c, tgt);
#pragma unroll
    for (int i = 0; i < j; ++i)
      if (locs[i] == tgt) val = moved[i];
    moved[j] = val;
  }
  // dealt card k = the last value written at locs[k] (the original if none)
#pragma unroll
  for (int k = 0; k < D; ++k) {
    int val = orig_card(c, locs[k]);
#pragma unroll
    for (int j = 0; j < k; ++j)
      if (locs[j] == locs[k]) val = moved[j];
    g.hc[k / H][k % H] = val;
  }
  for (int m = 0; m < c.M; ++m) {
    int val = orig_card(c, m);
#pragma unroll
    for (int j = 0; j < D; ++j)
      if (locs[j] == m) val = moved[j];
    col[c.r_deck + m] = val;
  }
  for (int k = 0; k < c.CR; ++k) col[c.r_disc + k] = 0;
  for (int k = 0; k < c.C; ++k) col[c.r_fw + k] = 0;
#pragma unroll
  for (int p = 0; p < P; ++p) {
#pragma unroll
    for (int h = 0; h < H; ++h) {
      g.hp[p][h] = (uint32_t)((1ull << c.CR) - 1ull);
      g.kc[p][h] = -1;
      g.kr[p][h] = -1;
    }
    g.hs[p] = H;
  }
  int* s = g.s;
  s[DS] = c.M - D;
  s[INFO] = c.max_info;
  s[LIFE] = c.max_life;
  s[CUR] = 0;
  s[TURNS] = P;
  s[SCORE] = 0;
  s[LMM] = M_INVALID;
  s[LMP] = -1;
  s[LMT] = -1;
  s[LMCI] = -1;
  s[LMSC] = 0;
  s[LMIT] = 0;
  s[LMC] = -1;
  s[LMR] = -1;
  s[LMRB] = 0;
  s[RNG] = (int)v;
}

// ---- the encodes (envs/hanabi.py::_encode_seat, legal_mask) ---------------

// Bit k of the result: move k is legal for a seat whose hand holds `size`
// live cards, whose partner holds `pc` (dead slots included), with `info`
// info tokens.
__device__ __forceinline__ uint32_t legal_bits(const Cfg& c, int size, const int (&pc)[H],
                                               int info) {
  uint32_t bits = 0u;
#pragma unroll
  for (int h = 0; h < H; ++h) {
    if (h < size && info < c.max_info) bits |= 1u << h;
    if (h < size) bits |= 1u << (H + h);
  }
  if (info > 0) {
    for (int k = 0; k < c.C; ++k) {
      bool any = false;
#pragma unroll
      for (int h = 0; h < H; ++h) any |= pc[h] / c.R == k;
      if (any) bits |= 1u << (2 * H + k);
    }
    for (int r = 0; r < c.R; ++r) {
      bool any = false;
#pragma unroll
      for (int h = 0; h < H; ++h) any |= pc[h] % c.R == r;
      if (any) bits |= 1u << (2 * H + c.C + r);
    }
  }
  return bits;
}

__device__ __forceinline__ uint32_t seat_legal(const Cfg& c, const Game& g, int a) {
  int pc[H];
#pragma unroll
  for (int h = 0; h < H; ++h) pc[h] = SEAT(g.hc, 1 - a, h);
  return legal_bits(c, a == 0 ? g.hs[0] : g.hs[1], pc, g.s[INFO]);
}

// Writes 0/1 bytes from `dst` on, packed into aligned 32-bit stores once
// the address is aligned.
struct ByteSink {
  uint8_t* p;
  uint32_t acc;
  int n;  // bytes held in acc; the word they fill starts at p
  __device__ __forceinline__ explicit ByteSink(uint8_t* dst) : p(dst), acc(0u), n(0) {}
  __device__ __forceinline__ void put(bool b) {
    if (n == 0 && (reinterpret_cast<uintptr_t>(p) & 3u)) {
      *p++ = (uint8_t)b;
      return;
    }
    acc |= (uint32_t)b << (8 * n);
    if (++n == 4) {
      *reinterpret_cast<uint32_t*>(p) = acc;
      p += 4;
      acc = 0u;
      n = 0;
    }
  }
  __device__ __forceinline__ void flush() {
    for (int i = 0; i < n; ++i) p[i] = (uint8_t)(acc >> (8 * i));
    p += n;
    acc = 0u;
    n = 0;
  }
};

// Counts the set bits instead of writing them (K4's per-seat sums).
struct SumSink {
  int sum = 0;
  __device__ __forceinline__ void put(bool b) { sum += (int)b; }
};

// Seat a's observation bits, in envs/hanabi.py::_encode_seat's order.
template <class Sink>
__device__ void encode_obs(const Cfg& c, Col col, const Game& g, int a, Sink& o) {
  const int* s = g.s;
  const int q = 1 - a;  // the partner
  // hands: the partner's cards, then "hand not full" of (a, partner)
#pragma unroll
  for (int h = 0; h < H; ++h) {
    const bool live = h < g.hs[q];
    const int card = SEAT(g.hc, q, h);
    for (int b = 0; b < c.CR; ++b) o.put(live && card == b);
  }
  o.put(g.hs[a] < H);
  o.put(g.hs[q] < H);
  // board
  for (int i = 0; i < c.deck_bits; ++i) o.put(i < s[DS]);
  for (int k = 0; k < c.C; ++k) {
    const int f = col[c.r_fw + k];
    for (int r = 0; r < c.R; ++r) o.put(f == r + 1);
  }
  for (int i = 0; i < c.max_info; ++i) o.put(i < s[INFO]);
  for (int i = 0; i < c.max_life; ++i) o.put(i < s[LIFE]);
  // discards: card id k's count against thresholds 0..copies-1
  for (int k = 0; k < c.CR; ++k) {
    const int d = col[c.r_disc + k];
    const int n = copies(c, k % c.R);
    for (int i = 0; i < n; ++i) o.put(d > i);
  }
  // last action
  const int lmm = s[LMM], lmc = s[LMC], lmr = s[LMR];
  const int rel_actor = s[LMP] == -1 ? -1 : (a - s[LMP] + P) % P;
#pragma unroll
  for (int p = 0; p < P; ++p) o.put(p == rel_actor);
  o.put(lmm == M_PLAY);
  o.put(lmm == M_DISCARD);
  o.put(lmm == M_REVEAL_C);
  o.put(lmm == M_REVEAL_R);
  const bool is_reveal = lmm == M_REVEAL_C || lmm == M_REVEAL_R;
  const int rel_target = (a - s[LMT] + P) % P;  // LMT >= -1
#pragma unroll
  for (int p = 0; p < P; ++p) o.put(is_reveal && p == rel_target);
  for (int k = 0; k < c.C; ++k) o.put(lmm == M_REVEAL_C && k == lmc);
  for (int r = 0; r < c.R; ++r) o.put(lmm == M_REVEAL_R && r == lmr);
#pragma unroll
  for (int h = 0; h < H; ++h) o.put(is_reveal && ((s[LMRB] >> h) & 1));
  const bool is_pd = lmm == M_PLAY || lmm == M_DISCARD;
#pragma unroll
  for (int h = 0; h < H; ++h) o.put(is_pd && h == s[LMCI]);
  for (int k = 0; k < c.CR; ++k) o.put(is_pd && k == lmc * c.R + lmr);
  o.put(lmm == M_PLAY && s[LMSC] != 0);
  o.put(lmm == M_PLAY && s[LMIT] != 0);
  // card knowledge of (a, partner); the plausible bit is the offset's
#pragma unroll
  for (int off = 0; off < P; ++off) {
    const int k = (a + off) % P;
#pragma unroll
    for (int h = 0; h < H; ++h) {
      const bool live = h < (k == 0 ? g.hs[0] : g.hs[1]);
      const bool pb = live && ((SEAT(g.hp, k, h) >> off) & 1u);
      const int kc = SEAT(g.kc, k, h), kr = SEAT(g.kr, k, h);
      for (int b = 0; b < c.CR; ++b) o.put(pb);
      for (int x = 0; x < c.C; ++x) o.put(live && kc == x);
      for (int r = 0; r < c.R; ++r) o.put(live && kr == r);
    }
  }
}

// Seat a's own hand (the state tensor's tail).
template <class Sink>
__device__ __forceinline__ void encode_own(const Cfg& c, const Game& g, int a, Sink& o) {
  const int size = a == 0 ? g.hs[0] : g.hs[1];
#pragma unroll
  for (int h = 0; h < H; ++h) {
    const int card = SEAT(g.hc, a, h);
    for (int b = 0; b < c.CR; ++b) o.put(h < size && card == b);
  }
}

template <class Sink>
__device__ __forceinline__ void encode_mask(const Cfg& c, uint32_t bits, Sink& o) {
  for (int k = 0; k < c.A; ++k) o.put((bits >> k) & 1u);
}

__device__ __forceinline__ void copy_bytes(uint8_t* dst, const uint8_t* src, int len) {
  // dst and src sit at the same offset from 16-byte-aligned bases
  int i = 0;
  for (; i < len && (reinterpret_cast<uintptr_t>(dst + i) & 3u); ++i) dst[i] = src[i];
  for (; i + 4 <= len; i += 4)
    *reinterpret_cast<uint32_t*>(dst + i) = *reinterpret_cast<const uint32_t*>(src + i);
  for (; i < len; ++i) dst[i] = src[i];
}

__device__ __forceinline__ int sum_bytes(const int8_t* src, int len) {
  int s = 0;
  for (int i = 0; i < len; ++i) s += src[i];
  return s;
}

// ---- K3 ---------------------------------------------------------------------

__global__ void __launch_bounds__(THREADS)
hk_step_kernel(const Cfg c, const int32_t* __restrict__ st_in, const int32_t* __restrict__ act,
               int32_t* __restrict__ st_out, int32_t* __restrict__ rew_out,
               bool* __restrict__ done_out, int* __restrict__ totals, int N, int slots) {
  int count = 0;
  for (int s = 0; s < slots; ++s) {
    const int n = world(slots, s);
    bool done = false;
    if (n < N) {
      const Col in{const_cast<int32_t*>(st_in) + n, N}, out{st_out + n, N};
      for (int r = 0; r < c.r_scal; ++r) out[r] = in[r];  // deck, discards, fireworks
      Game g;
      load_game(c, in, g);
      int rew;
      done = transition(c, out, g, act[(size_t)n * P + g.s[CUR]], &rew);
      store_game(c, out, g);  // the reset kernel deals the done worlds
      rew_out[n] = rew;
      done_out[n] = done;
    }
    count += __syncthreads_count(done);
  }
  if (threadIdx.x == 0) totals[blockIdx.x] = count;
}

__global__ void __launch_bounds__(THREADS)
hk_reset_kernel(const Cfg c, const bool* __restrict__ done_in, const int64_t* __restrict__ cnt_in,
                const int* __restrict__ totals, int32_t* __restrict__ st,
                const int8_t* __restrict__ obs_in, const int8_t* __restrict__ own_in,
                const bool* __restrict__ mask_in, int8_t* __restrict__ obs_out,
                int8_t* __restrict__ own_out, bool* __restrict__ mask_out,
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
    if (n < N) {
      const Col col{st + n, N};
      Game g;
      load_game(c, col, g);
      if (done) {
        deal(c, col, g, next + (uint32_t)rank);
        store_game(c, col, g);
      }
#pragma unroll
      for (int a = 0; a < P; ++a) {
        const size_t row = (size_t)n * P + a;
        uint8_t* o = reinterpret_cast<uint8_t*>(obs_out) + row * c.obs;
        uint8_t* w = reinterpret_cast<uint8_t*>(own_out) + row * c.own;
        uint8_t* m = reinterpret_cast<uint8_t*>(mask_out) + row * c.A;
        if (done || g.s[CUR] == a) {  // the stale-seat rule
          ByteSink so(o), sw(w), sm(m);
          encode_obs(c, col, g, a, so);
          so.flush();
          encode_own(c, g, a, sw);
          sw.flush();
          encode_mask(c, seat_legal(c, g, a), sm);
          sm.flush();
        } else {
          copy_bytes(o, reinterpret_cast<const uint8_t*>(obs_in) + row * c.obs, c.obs);
          copy_bytes(w, reinterpret_cast<const uint8_t*>(own_in) + row * c.own, c.own);
          copy_bytes(m, reinterpret_cast<const uint8_t*>(mask_in) + row * c.A, c.A);
        }
      }
    }
    next += (uint32_t)total;
  }
  // the last block's next index is the counter after the step
  if (blockIdx.x == gridDim.x - 1 && threadIdx.x == 0) cnt_out[0] = (int64_t)next;
}

// ---- K4 ---------------------------------------------------------------------

__global__ void __launch_bounds__(THREADS)
hk_rollout_kernel(const Cfg c, const int32_t* __restrict__ st_in,
                  const int8_t* __restrict__ obs_in, const int8_t* __restrict__ own_in,
                  const bool* __restrict__ mask_in, const int32_t* __restrict__ arng_in,
                  const int64_t* __restrict__ cnt_in, int32_t* __restrict__ st,
                  int32_t* __restrict__ arng, int32_t* __restrict__ dcnt,
                  int32_t* __restrict__ chk, int64_t* __restrict__ cnt_out,
                  int32_t* __restrict__ seat_sum, int* __restrict__ totals, int N, int T,
                  int slots) {
  __shared__ int smem[episode::SCAN_SMEM_INTS];
  cg::grid_group grid = cg::this_grid();
  const int G = gridDim.x;
  // the outputs are the working state; each world is only ever touched by
  // the thread that owns it
  for (int s = 0; s < slots; ++s) {
    const int n = world(slots, s);
    if (n < N) {
      const Col in{const_cast<int32_t*>(st_in) + n, N}, out{st + n, N};
      for (int r = 0; r < c.rows; ++r) out[r] = in[r];
      arng[n] = arng_in[n];
      dcnt[n] = 0;
      chk[n] = 0;
#pragma unroll
      for (int a = 0; a < P; ++a) {
        const size_t row = (size_t)n * P + a;
        seat_sum[(size_t)a * N + n] =
            sum_bytes(obs_in + row * c.obs, c.obs) + sum_bytes(own_in + row * c.own, c.own) +
            sum_bytes(reinterpret_cast<const int8_t*>(mask_in) + row * c.A, c.A);
      }
    }
  }
  uint32_t base = (uint32_t)cnt_in[0];
  for (int t = 0; t < T; ++t) {
    int* step_totals = totals + (t & 1) * G;
    // phase A: the legal draw and the step; live worlds are final
    uint32_t dmask = 0u;
    int count = 0;
    for (int s = 0; s < slots; ++s) {
      const int n = world(slots, s);
      bool done = false;
      if (n < N) {
        const Col col{st + n, N};
        Game g;
        load_game(c, col, g);
        const uint32_t w = episode::lcg_next((uint32_t)arng[n]);
        arng[n] = (int32_t)w;
        const uint32_t legal = seat_legal(c, g, g.s[CUR]);
        const uint32_t idx = (((w >> 8) & 0x00FFFFFFu) * (uint32_t)__popc(legal)) >> 24;
        int uid = 0;
        uint32_t seen = 0u;
        for (int k = 0; k < c.A; ++k) {
          if ((legal >> k) & 1u) {
            if (seen == idx) uid = k;
            ++seen;
          }
        }
        int rew;
        done = transition(c, col, g, uid, &rew);
        store_game(c, col, g);
        chk[n] += rew * P + (int)done;
        dcnt[n] += done;
      }
      dmask |= (uint32_t)done << s;
      count += __syncthreads_count(done);
    }
    if (threadIdx.x == 0) step_totals[blockIdx.x] = count;
    // the parity buffers let one sync a step suffice (csrc/cartpole.cu)
    grid.sync();
    // phase B: rank this step's resets over the whole batch, deal them,
    // and re-sum the refreshed seats
    uint32_t before, all;
    episode::block_offsets(step_totals, blockIdx.x, G, smem, &before, &all);
    uint32_t next = base + before;
    for (int s = 0; s < slots; ++s) {
      const int n = world(slots, s);
      const bool done = (dmask >> s) & 1u;
      int total;
      const int rank = episode::block_rank(done, smem, &total);
      if (n < N) {
        const Col col{st + n, N};
        Game g;
        load_game(c, col, g);
        if (done) {
          deal(c, col, g, next + (uint32_t)rank);
          store_game(c, col, g);
        }
        int sums = 0;
#pragma unroll
        for (int a = 0; a < P; ++a) {
          int32_t& ss = seat_sum[(size_t)a * N + n];
          if (done || g.s[CUR] == a) {
            SumSink sink;
            encode_obs(c, col, g, a, sink);
            encode_own(c, g, a, sink);
            encode_mask(c, seat_legal(c, g, a), sink);
            ss = sink.sum;
          }
          sums += ss;
        }
        chk[n] += sums;
      }
      next += (uint32_t)total;
    }
    base += all;
  }
  if (blockIdx.x == 0 && threadIdx.x == 0) cnt_out[0] = (int64_t)base;
}

// ---- K11 --------------------------------------------------------------------

__global__ void __launch_bounds__(THREADS)
hk_mask_kernel(const Cfg c, const int32_t* __restrict__ cards, const int32_t* __restrict__ size,
               const int32_t* __restrict__ info, bool* __restrict__ out, int N) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;  // (world, seat)
  if (i >= N * P) return;
  const int n = i / P, a = i % P;
  const int32_t* partner = cards + ((size_t)n * P + (a + 1) % P) * H;
  int pc[H];
#pragma unroll
  for (int h = 0; h < H; ++h) pc[h] = partner[h];
  const uint32_t bits = legal_bits(c, size[i], pc, info[n]);
  bool* o = out + (size_t)i * c.A;
  for (int k = 0; k < c.A; ++k) o[k] = (bits >> k) & 1u;
}

}  // namespace

extern "C" {

int hk_scratch_ints(int N) { return episode::scratch_ints(N); }

int hk_step(const int* cfg, int cfg_ints, const int32_t* st_in, const int8_t* obs_in,
            const int8_t* own_in, const bool* mask_in, const int32_t* act,
            const int64_t* cnt_in, int32_t* st_out, int8_t* obs_out, int8_t* own_out,
            bool* mask_out, int32_t* rew, bool* done, int64_t* cnt_out, int* scratch, int N,
            int device, void* stream) {
  Cfg c;
  if (!make_cfg(cfg, cfg_ints, &c)) return ERR_BAD_CONFIG;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  int max_blocks = 0, blocks = 0, slots = 0;
  err = episode::resident_blocks((const void*)hk_reset_kernel, device, &max_blocks);
  if (err != cudaSuccess) return (int)err;
  episode::split(N, max_blocks, &blocks, &slots);
  cudaStream_t s = (cudaStream_t)stream;
  hk_step_kernel<<<blocks, THREADS, 0, s>>>(c, st_in, act, st_out, rew, done, scratch, N, slots);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  hk_reset_kernel<<<blocks, THREADS, 0, s>>>(c, done, cnt_in, scratch, st_out, obs_in, own_in,
                                             mask_in, obs_out, own_out, mask_out, cnt_out, N,
                                             slots);
  return (int)cudaGetLastError();
}

int hk_rollout(const int* cfg, int cfg_ints, const int32_t* st_in, const int8_t* obs_in,
               const int8_t* own_in, const bool* mask_in, const int32_t* arng_in,
               const int64_t* cnt_in, int32_t* st, int32_t* arng, int32_t* dcnt,
               int32_t* chk, int64_t* cnt_out, int32_t* seat_sum, int* scratch, int N, int T,
               int device, void* stream) {
  Cfg c;
  if (!make_cfg(cfg, cfg_ints, &c)) return ERR_BAD_CONFIG;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  int max_blocks = 0, blocks = 0, slots = 0;
  err = episode::resident_blocks((const void*)hk_rollout_kernel, device, &max_blocks);
  if (err != cudaSuccess) return (int)err;
  episode::split(N, max_blocks, &blocks, &slots);
  if (slots > episode::MAX_ROLLOUT_SLOTS) return episode::ERR_TOO_MANY_ENVS;
  void* args[] = {(void*)&c,     (void*)&st_in,   (void*)&obs_in,   (void*)&own_in,
                  (void*)&mask_in, (void*)&arng_in, (void*)&cnt_in, (void*)&st,
                  (void*)&arng,  (void*)&dcnt,    (void*)&chk,      (void*)&cnt_out,
                  (void*)&seat_sum, (void*)&scratch, (void*)&N,     (void*)&T,
                  (void*)&slots};
  err = cudaLaunchCooperativeKernel((const void*)hk_rollout_kernel, dim3(blocks), dim3(THREADS),
                                    args, 0, (cudaStream_t)stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

int hk_legal(const int* cfg, int cfg_ints, const int32_t* cards, const int32_t* size,
             const int32_t* info, bool* out, int N, int device, void* stream) {
  Cfg c;
  if (!make_cfg(cfg, cfg_ints, &c)) return ERR_BAD_CONFIG;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const int blocks = (N * P + THREADS - 1) / THREADS;
  hk_mask_kernel<<<blocks, THREADS, 0, (cudaStream_t)stream>>>(c, cards, size, info, out, N);
  return (int)cudaGetLastError();
}

const char* hk_error_string(int err) {
  if (err == ERR_BAD_CONFIG) return "config outside the kernels' envelope";
  return episode::error_string(err);
}

}  // extern "C"
