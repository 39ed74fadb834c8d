// Hanabi kernels for Hopper (sm_90a): the step and rollout for 2-player
// configs, the legal-move mask for every config; bound through a plain C
// interface and loaded with ctypes (ops/hanabi.py).
//
// K3 `hk_step_kernel` replaces the per-step Pallas kernel
//   madrona_rl_envs_playground_tpu/ops/hanabi_megakernel.py::_build_kernel
//   (body _make_body, _load_state, _store_state; launched by fused_step):
//   discard / play / reveal, the random-swap replacement draw or the
//   empty-deck shift, turn / score / life termination, the world-order
//   episode index of every reset and its deal, and the 658-bit observation,
//   own-hand and legal-mask encodes with the stale-seat rule, in one
//   launch.  A block owns a tile of 32 contiguous worlds, taken by a ticket
//   in the order the blocks start: it stages the tile's state in shared
//   memory and steps it one world a lane of its first warp, while its other
//   warps load the tile's obs, own and mask rows (one contiguous run of
//   each) into shared memory as 16-byte words; it ranks its ended worlds
//   over the batch by a decoupled look-back (csrc/episode_scan.cuh) and
//   deals them from its first lanes; then every thread writes a refreshed
//   seat's bytes over the loaded ones, each from a section table
//   (ops/hanabi.py::encode_table) and the seat's values, and the rows go out
//   as 16-byte words.
// K4 `hk_rollout_onchip_kernel<C, R>` and `hk_rollout_kernel<C, R>` replace
//   the persistent rollout Pallas kernel
//   ops/hanabi_megakernel.py::_build_rollout_kernel (fused_rollout): T
//   steps in one cooperative launch; each world's action is the
//   ((u24 * L) >> 24)-th of the acting seat's L legal moves, u24 =
//   bits 8..31 of the world's advanced action-LCG word (sample_legal); each
//   seat carries the sum of its obs, own and mask bytes, started from the
//   launch-time buffers and recomputed in closed form (seat_sum, section by
//   section; ops/hanabi.py::seat_sums_plain is the same formula) only where
//   that seat is refreshed, and the checksum adds P * reward + done + both
//   seats' sums every step.  Episodes are allocated per step in
//   whole-batch world order (a grid-wide sync per step, as
//   csrc/cartpole.cu's K6), which equals T applications of K3 and JAX's
//   fused_rollout with one block; JAX's multi-block grids allocate block by
//   block.  Instantiated for the 2-player configs full, small and
//   very_small (<5, 5>, <2, 5>, <1, 5>); other configs are refused with
//   ERR_BAD_CONFIG.
// K11 `hk_mask_kernel<P>` replaces ops/hanabi_pallas.py::_mask_kernel
//   (legal_moves_pallas): every seat's legal-move mask from the hand cards,
//   hand sizes and info tokens, for any game of JAX's Env (2 to 5 players
//   instantiated, any other count read at run time; up to 64 moves).  A
//   block stages a tile of at most 128 worlds' inputs in shared memory,
//   builds each player's colour and rank sets once, each seat's moves as a
//   64-bit word, and writes the tile's mask bytes as coalesced 16-byte
//   words.
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
// counters).  K3 writes the env-major [N, P, bits] buffers the policy reads;
// a block's rows of each are one contiguous run.
//
// K4's carry.  At launch K4 transcodes the [rows, N] state into one record
// per world (Rec: 192 B in the full config, 144 small, 128 very_small) and
// back at the end: a 112-byte header of the plausible masks, the episode
// and action LCG words, the two seat sums, the checksum and done count as
// words, then every other scalar and hand value, and the fireworks' and
// discards' share of a seat sum, as int8; after it the deck, fireworks and
// discards as int8.  Where every block of the grid is resident with its
// records in shared memory (131,072 full worlds: 2 blocks of 512 records an
// SM, 208-byte stride), the records stay on chip (ONCHIP,
// hk_rollout_onchip_kernel); otherwise (hk_rollout_kernel) they lie in
// device memory (25 MB at 131,072 full worlds, within the L2).  A
// step loads and stores a world's header with 16-byte accesses and touches
// its board a byte at a time.  A block lists the worlds that end in a step
// in shared memory and deals them one per thread from its first threads,
// so that only the warps holding a deal run one.
//
// K4's envelope.  The int8 fields hold exactly the values a game started by
// init_packed reaches through fused_step and fused_rollout: cards 0..C*R-1,
// discards 0..copies, fireworks 0..R, deck size 0..M-D, info 0..max_info+C,
// life 0..max_life, current player 0..1, turns 0..P, score 0..C*R, hand
// sizes 0..H, known colour -1..C-1, known rank -1..R-1 (every step's
// last-move fields are written before K4 reads them; the masks and LCG
// words are 32-bit).  A game started inside keeps every field within int8
// until it ends: it makes at most M-D+P draws and discards and C
// completions, so no count passes 127.  K4 checks its entry state on the
// card, with no host read: as the launch transcodes a world it tests every
// value of the world's column against its row's (lo, hi)
// (ops/hanabi.py::rollout_envelope, copied to the card once); a block
// notes whether any of its worlds lies outside, and after one grid-wide
// sync no block steps if any block did.  Such a launch is refused on the
// card: block 0 writes the envelope word (each row's min and max over the
// batch and the bitmask of the rows outside, the formula of
// ops/hanabi.py::envelope_violations) into mapped pinned host memory, and
// every world returns its state, action word and counter as given, done
// count -1 and checksum INT32_MIN.  The wrapper raises on the word at the
// next launch or check_rollout_envelope, so nothing is wrapped silently.
//
// Exactness.  The only float work is the draw position int32(f32(size) *
// u): u = (word & 0xFFFFFF) * 2^-24 is exact, __fmul_rn rounds the product
// once and __float2int_rz truncates, as the JAX code's float32 multiply and
// astype(int32) do.  Every / and % of K3 and K4 has non-negative operands;
// K11 floors its own, as JAX's // and % do.
//
// What bounds them on an H100.  K3 moves 552 B of state in and out per
// world, reads the stale seat's 803 B of obs / own / mask and writes both
// seats' 1,606 B, reads the acting seat's action and writes 5 B of reward
// and done: about 3.5 KB per world-step, against a few hundred integer
// operations for the step and about ten per encoded byte, so device-memory
// bytes bound it: its loads and stores are whole 16-byte words of
// consecutive lanes, the state's rows 128 B a warp.  Below some thousands
// of worlds the launch itself (a memset of the scan's flags and one kernel)
// takes the time.  K4 reads and writes the state once per launch (its
// envelope check compares the values it transcodes, two compares a row, and
// adds one grid-wide sync) and does a
// few hundred integer operations per world-step (the step, the legal draw,
// one refreshed seat's closed-form sum), so operations bound it; in
// practice the grid-wide sync and the scan of the block counts each step,
// and the latency of a world's dependent loads, take most of its time.
// K11 reads 4 (P H + P + 1) B and writes P A B per world (92 B in the full
// 2-player config, 344 B with 5 players) against some tens of integer
// operations a seat, so bytes bound it; below about a million worlds the
// launch and the ramp of device memory take much of its time.

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

// The config's sizes, the state's row offsets and the first index of each
// group of a seat's values (K3), a flat array of ints in this order from
// ops/hanabi.py::_cfg, which owns both layouts (row_offsets, value_layout).
struct Cfg {
  int C, R, max_info, max_life;
  int CR, cpc, M, deck_bits, obs, own, A;
  int r_deck, r_disc, r_fw, r_scal, r_hc, r_hp, r_hs, r_kc, r_kr, rows;
  int v_pc, v_nf, v_ds, v_fw, v_info, v_life, v_disc, v_ra, v_lmm, v_rt, v_rc, v_rr, v_rb,
      v_ci, v_cid, v_sc, v_it, v_pb, v_kc, v_kr, v_oc, v_lg, values;
};
constexpr int CFG_INTS = 44;
static_assert(sizeof(Cfg) == CFG_INTS * sizeof(int), "Cfg is read as a flat int array");

// Returns false outside the envelope the kernels hold in 32-bit masks and
// the section table in bytes.
bool make_cfg(const int* in, int n, Cfg* c) {
  if (n != CFG_INTS) return false;
  std::memcpy(c, in, sizeof(Cfg));
  return c->CR <= 32 && c->A <= 32 && c->deck_bits >= 0 && c->rows > 0 && c->values > 0 &&
         c->values <= 255;
}

// Copies of each card of rank r among R ranks: 3 of rank 0, 1 of the top
// rank, 2 of the others.
__host__ __device__ constexpr int copies(int r, int R) { return r == 0 ? 3 : (r == R - 1 ? 1 : 2); }

// The sizes a kernel reads: compile-time constants in K4's instantiations
// (<C_, R_> > 0: the section loops unroll and / and % by R fold), the
// config's at run time in K3 (<0, 0>).
template <int C_, int R_>
struct Dims {
  int C, R, CR;
  __device__ __forceinline__ explicit Dims(const Cfg& c)
      : C(C_ > 0 ? C_ : c.C), R(R_ > 0 ? R_ : c.R), CR((C_ > 0 ? C_ : c.C) * (R_ > 0 ? R_ : c.R)) {}
};

// One world's column of the [rows, N] state, and the board (deck, discards,
// fireworks) that transition and deal read and write through it.
struct Col {
  int32_t* p;
  int N;
  const Cfg* c;
  __device__ __forceinline__ int32_t& operator[](int row) const { return p[(size_t)row * N]; }
  __device__ __forceinline__ int fw(int k) const { return (*this)[c->r_fw + k]; }
  __device__ __forceinline__ void set_fw(int k, int v) const { (*this)[c->r_fw + k] = v; }
  __device__ __forceinline__ void add_discard(int card) const { (*this)[c->r_disc + card] += 1; }
  __device__ __forceinline__ int deck(int i) const { return (*this)[c->r_deck + i]; }
  __device__ __forceinline__ void set_deck(int i, int v) const { (*this)[c->r_deck + i] = v; }
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

// One step of the world on board `b` with move `uid` of the current player;
// returns done and the score delta in *rew.
template <int C_, int R_, class Board>
__device__ __forceinline__ bool transition(const Cfg& c, const Board& b, Game& g, int uid, int* rew) {
  const Dims<C_, R_> d(c);
  int* s = g.s;
  s[TURNS] -= s[DS] == 0;
  const int agent = s[CUR];
  const int rc_base = 2 * H, rr_base = 2 * H + (P - 1) * d.C;
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
  const int card_color = card / d.R, card_rank = card % d.R;

  // discard and play
  const int fwc = b.fw(card_color);
  const bool success = is_play && fwc == card_rank;
  const bool completed = success && fwc + 1 == d.R;
  const bool failed = is_play && !success;
  if (is_discard || failed) b.add_discard(card);
  if (success) b.set_fw(card_color, fwc + 1);
  s[INFO] += (int)is_discard + (int)completed;
  s[LIFE] -= (int)failed;

  // reveals: with two players the target is the partner
  const int rev_color = is_rc ? uid - rc_base : 0;
  const int rev_rank = is_rr ? uid - rr_base : 0;
  const int target = (agent + 1) % P;
  s[INFO] -= (int)reveal;
  const uint32_t color_mask = ((1u << d.R) - 1u) << (rev_color * d.R);
  uint32_t rank_mask = 0u;
  for (int i = 0; i < d.R; ++i)
    if (i * d.R + rev_rank < 32) rank_mask |= 1u << (i * d.R + rev_rank);
  int reveal_bits = 0;
#pragma unroll
  for (int p = 0; p < P; ++p) {
    const bool tgt = reveal && target == p;
#pragma unroll
    for (int h = 0; h < H; ++h) {
      const bool live = h < g.hs[p];
      const bool mc = live && g.hc[p][h] / d.R == rev_color;
      const bool mr = live && g.hc[p][h] % d.R == rev_rank;
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
    const int drawn = b.deck(loc);
    b.set_deck(loc, b.deck(ds - 1));
    s[DS] = ds - 1;
    s[RNG] = (int)v1;
#pragma unroll
    for (int p = 0; p < P; ++p) {
#pragma unroll
      for (int h = 0; h < H; ++h) {
        if (p == agent && ((at >> h) & 1u)) {
          g.hc[p][h] = drawn;
          g.hp[p][h] = (uint32_t)((1ull << d.CR) - 1ull);
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
  for (int k = 0; k < d.C; ++k) fwsum += b.fw(k);
  const int score = s[LIFE] > 0 ? fwsum : 0;
  *rew = score - s[SCORE];
  s[SCORE] = score;
  return s[LIFE] < 1 || score >= d.CR || s[TURNS] <= 0;
}

// ---- the deal (envs/hanabi.py::init_core) ---------------------------------

// deck0[loc]: the card at position loc of the unshuffled deck
__device__ __forceinline__ int orig_card(const Cfg& c, int loc) {
  const int rem = loc % c.cpc;
  int rank = 0, acc = 0;
  for (int r = 0; r < c.R; ++r) {
    acc += copies(r, c.R);
    if (rem >= acc) rank = r + 1;
  }
  return (loc / c.cpc) * c.R + rank;
}

// The rest of a fresh game: hands' knowledge, sizes and the scalars.
__device__ __forceinline__ void fresh_scalars(const Cfg& c, Game& g, uint32_t v) {
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

// A fresh game for episode `idx` in a world's column of K3's state tile: the
// unshuffled deck, then the D swap draws in order (draw k takes the card at
// a position among the M - k left and moves the last one there), as
// envs/hanabi.py::init_core and K4's deal_rec do.
__device__ void deal_tile(const Cfg& c, Col col, uint32_t idx, const int32_t* deck0) {
  for (int m = 0; m < c.M; ++m) col.set_deck(m, deck0[m]);
  Game g;
  uint32_t v = episode::tea_seed(idx);
#pragma unroll
  for (int k = 0; k < D; ++k) {
    v = episode::lcg_next(v);
    const int loc = __float2int_rz(__fmul_rn((float)(c.M - k), episode::unif(v)));
    g.hc[k / H][k % H] = col.deck(loc);
    col.set_deck(loc, col.deck(c.M - 1 - k));
  }
  for (int k = 0; k < c.CR; ++k) col[c.r_disc + k] = 0;
  for (int k = 0; k < c.C; ++k) col[c.r_fw + k] = 0;
  fresh_scalars(c, g, v);
  store_game(c, col, g);
}

// ---- the encodes (envs/hanabi.py::_encode_seat, legal_mask) ---------------

// Bit k of the result: move k is legal for a seat whose hand holds `size`
// live cards, whose partner holds `pc` (dead slots included), with `info`
// info tokens.  A partner card shows its colour pc / R where that lies in
// [0, C) and its rank pc % R where that lies in [0, R), as the reference's
// any-of-the-hand tests do for every int32; K4's envelope holds every card
// in [0, C*R), so its instantiations skip the range tests.
template <int C_, int R_>
__device__ __forceinline__ uint32_t legal_bits(const Cfg& c, int size, const int (&pc)[H],
                                               int info) {
  const Dims<C_, R_> d(c);
  uint32_t bits = 0u;
#pragma unroll
  for (int h = 0; h < H; ++h) {
    if (h < size && info < c.max_info) bits |= 1u << h;
    if (h < size) bits |= 1u << (H + h);
  }
  if (info > 0) {
    uint32_t colors = 0u, ranks = 0u;
#pragma unroll
    for (int h = 0; h < H; ++h) {
      const int col = pc[h] / d.R, rank = pc[h] % d.R;
      if (C_ > 0) {
        colors |= 1u << col;
        ranks |= 1u << rank;
      } else {
        colors |= (unsigned)col < (unsigned)d.C ? 1u << col : 0u;
        ranks |= (unsigned)rank < (unsigned)d.R ? 1u << rank : 0u;
      }
    }
    bits |= colors << (2 * H) | ranks << (2 * H + d.C);
  }
  return bits;
}

template <int C_, int R_>
__device__ __forceinline__ uint32_t seat_legal(const Cfg& c, const Game& g, int a) {
  int pc[H];
#pragma unroll
  for (int h = 0; h < H; ++h) pc[h] = SEAT(g.hc, 1 - a, h);
  return legal_bits<C_, R_>(c, a == 0 ? g.hs[0] : g.hs[1], pc, g.s[INFO]);
}

// ---- K3 ---------------------------------------------------------------------

// A block steps K3_WORLDS contiguous worlds, one thread of its first warp
// each, and all K3_WARPS warps write their encodes.
constexpr int K3_WORLDS = 32;
constexpr int K3_THREADS = 256;
constexpr int K3_WARPS = K3_THREADS / 32;
static_assert(K3_WORLDS * P <= 64, "a block's seats fit one 64-bit mask");

// Seat a's values (ops/hanabi.py::value_layout, at the group starts Cfg
// carries), each int8 clamped to [-1, 64]: every byte of the seat's obs, own hand and mask is
// one of them tested against a range of the section table
// (ops/hanabi.py::encode_table; constants 0..63, so the clamp keeps every
// test), with the reference's quirks of its encode: the plausible bit of a
// knowledge slot is bit `offset` of its mask, broadcast over the CR bytes,
// and rel_target is taken for LMT = -1 too (the reveal flag gates it).
// Bytes between two seats' values: 2 mod 4, so that the 32 worlds of one
// seat, 2 rows apart, write to 32 different banks.
__host__ __device__ __forceinline__ int value_stride(const Cfg& c) {
  const int n = c.values;
  return n + ((2 - n) & 3);
}

// Part 0 writes the values up to the last move's flags, part 1 the rest
// (the knowledge blocks, the own cards and the legal moves): about half of
// them each.
__device__ void seat_values(const Cfg& c, const int32_t* S, int w, int a, int part, int8_t* v) {
  const auto at = [&](int row) { return S[row * K3_WORLDS + w]; };
  const auto sc = [&](int k) { return at(c.r_scal + k); };
  const auto put = [&](int i, int x) { v[i] = (int8_t)min(max(x, -1), 64); };
  const int q = 1 - a;
  const int hs0 = at(c.r_hs), hs1 = at(c.r_hs + 1);
  const int hs_a = a == 0 ? hs0 : hs1, hs_q = a == 0 ? hs1 : hs0;
  int pc[H];
#pragma unroll
  for (int h = 0; h < H; ++h) pc[h] = at(c.r_hc + q * H + h);
  if (part == 0) {
#pragma unroll
    for (int h = 0; h < H; ++h) put(c.v_pc + h, h < hs_q ? pc[h] : -1);
    put(c.v_nf, hs_a < H);
    put(c.v_nf + 1, hs_q < H);
    put(c.v_ds, sc(DS));
    for (int k = 0; k < c.C; ++k) put(c.v_fw + k, at(c.r_fw + k));
    put(c.v_info, sc(INFO));
    put(c.v_life, sc(LIFE));
    for (int k = 0; k < c.CR; ++k) put(c.v_disc + k, at(c.r_disc + k));
    const int lmm = sc(LMM), lmp = sc(LMP), lmc = sc(LMC), lmr = sc(LMR);
    const bool is_reveal = lmm == M_REVEAL_C || lmm == M_REVEAL_R;
    const bool is_pd = lmm == M_PLAY || lmm == M_DISCARD;
    put(c.v_ra, lmp == -1 ? -1 : (a - lmp + P) % P);
    put(c.v_lmm, lmm);
    put(c.v_rt, is_reveal ? (a - sc(LMT) + P) % P : -1);
    put(c.v_rc, lmm == M_REVEAL_C ? lmc : -1);
    put(c.v_rr, lmm == M_REVEAL_R ? lmr : -1);
    const int lmrb = sc(LMRB);
#pragma unroll
    for (int h = 0; h < H; ++h) put(c.v_rb + h, is_reveal && ((lmrb >> h) & 1));
    put(c.v_ci, is_pd ? sc(LMCI) : -1);
    put(c.v_cid, is_pd ? lmc * c.R + lmr : -1);
    put(c.v_sc, lmm == M_PLAY && sc(LMSC) != 0);
    put(c.v_it, lmm == M_PLAY && sc(LMIT) != 0);
    return;
  }
  // knowledge: seat (a + off) % P's slots (a's own, then the partner's):
  // the plausible bits, colours, ranks
#pragma unroll
  for (int off = 0; off < P; ++off)
#pragma unroll
    for (int h = 0; h < H; ++h) {
      const int k = off == 0 ? a : q;
      put(c.v_pb + off * H + h,
          h < (off == 0 ? hs_a : hs_q) && (((uint32_t)at(c.r_hp + k * H + h) >> off) & 1u));
    }
#pragma unroll
  for (int off = 0; off < P; ++off)
#pragma unroll
    for (int h = 0; h < H; ++h) {
      const int k = off == 0 ? a : q;
      put(c.v_kc + off * H + h, h < (off == 0 ? hs_a : hs_q) ? at(c.r_kc + k * H + h) : -1);
    }
#pragma unroll
  for (int off = 0; off < P; ++off)
#pragma unroll
    for (int h = 0; h < H; ++h) {
      const int k = off == 0 ? a : q;
      put(c.v_kr + off * H + h, h < (off == 0 ? hs_a : hs_q) ? at(c.r_kr + k * H + h) : -1);
    }
#pragma unroll
  for (int h = 0; h < H; ++h) put(c.v_oc + h, h < hs_a ? at(c.r_hc + a * H + h) : -1);
  const uint32_t legal = legal_bits<0, 0>(c, hs_a, pc, sc(INFO));
  for (int k = 0; k < c.A; ++k) put(c.v_lg + k, (legal >> k) & 1u);
}

// A block's rows of one per-seat buffer of `len`-byte rows (row = world * P
// + seat; they are contiguous): bytes [g0, g1) of the buffer, held in
// shared memory as the 16-byte words [a0, a1) that cover them.
struct Run {
  size_t g0, g1, a0, a1;
  __device__ __forceinline__ Run(size_t row0, int nrows, int len)
      : g0(row0 * len), g1(row0 * len + (size_t)nrows * len),
        a0(row0 * len & ~(size_t)15), a1((row0 * len + (size_t)nrows * len + 15) & ~(size_t)15) {}
  __device__ __forceinline__ int words() const { return (int)((a1 - a0) / 16); }
};

// Word k of the run of `in` (a tensor of `total` bytes), the bytes past
// its end 0.
__device__ __forceinline__ uint4 run_word(const Run& run, const uint8_t* __restrict__ in,
                                          size_t total, int k) {
  const size_t w = run.a0 + 16 * (size_t)k;
  if (w + 16 <= total) return *reinterpret_cast<const uint4*>(in + w);
  uint32_t v[4] = {0u, 0u, 0u, 0u};
  for (int b = 0; w + b < total; ++b) v[b / 4] |= (uint32_t)in[w + b] << (8 * (b % 4));
  return make_uint4(v[0], v[1], v[2], v[3]);
}

// The refreshed rows' bytes of the run into `img`, one byte a thread
// (consecutive threads, consecutive table entries): byte `off` of row r is
// value tab[off] of the row's values tested against its range.  `rows`
// lists the nf refreshed rows.
__device__ __forceinline__ void fill_run(const Run& run, int len, const uint32_t* tab,
                                         const int8_t* vals, int vs, const uint8_t* rows, int nf,
                                         uint8_t* img) {
  // k / len == __umulhi(k, inv) for every k < 2^32 / len (here k < 64 * len)
  const uint32_t inv = 0xFFFFFFFFu / (uint32_t)len + 1u;
  uint8_t* base = img + (run.g0 - run.a0);
#pragma unroll 4
  for (uint32_t k = threadIdx.x; k < (uint32_t)(nf * len); k += K3_THREADS) {
    const uint32_t f = __umulhi(k, inv), off = k - f * (uint32_t)len;
    const int r = rows[f];
    const uint32_t e = tab[off];
    const int v = vals[r * vs + (e & 0xFFu)];
    base[r * len + off] = (uint32_t)(v - (int)((e >> 8) & 0xFFu)) <= (e >> 16);
  }
}

// The run from `img` into `out`: whole 16-byte words, and the first and last
// words, which neighbouring blocks share, byte by byte.
__device__ __forceinline__ void store_run(const Run& run, const uint8_t* img,
                                          uint8_t* __restrict__ out) {
  for (int k = threadIdx.x; k < run.words(); k += K3_THREADS) {
    const size_t w = run.a0 + 16 * (size_t)k;
    if (w >= run.g0 && w + 16 <= run.g1) {
      *reinterpret_cast<uint4*>(out + w) = *reinterpret_cast<const uint4*>(img + 16 * k);
    } else {
      for (int b = 0; b < 16; ++b)
        if (w + b >= run.g0 && w + b < run.g1) out[w + b] = img[16 * k + b];
    }
  }
}

// Bytes of shared memory that hold a run of the block's rows of `len` bytes.
__host__ __device__ __forceinline__ int run_bytes(int len) {
  return (K3_WORLDS * P * len + 15) / 16 * 16 + 32;  // up to 15 bytes more at each end
}

// The own and mask runs' words a thread holds while the obs run is filled:
// at most 4 (C*R and A at most 32: 772 words over K3_THREADS).
constexpr int K3_HELD = 4;
static_assert(((K3_WORLDS * P * 5 * 32 + 30) / 16 + 1 + (K3_WORLDS * P * 32 + 30) / 16 + 1) <=
                  K3_HELD * K3_THREADS,
              "a thread holds its own and mask words in K3_HELD registers");

// K3's dynamic shared memory: the block's obs words; the state tile
// [rows][K3_WORLDS] int32, whose room then takes the own and mask words;
// the section table, the unshuffled deck, and each seat's values.
struct K3Smem {
  int obs, tile, own, mask, tab, deck0, vals, bytes;
};

__host__ __device__ __forceinline__ K3Smem k3_smem(const Cfg& c, int vs) {
  K3Smem m;
  m.obs = 0;
  m.tile = m.own = run_bytes(c.obs);
  m.mask = m.own + run_bytes(c.own);
  const int tile = 4 * c.rows * K3_WORLDS, own_mask = run_bytes(c.own) + run_bytes(c.A);
  m.tab = m.tile + (tile > own_mask ? tile : own_mask);
  m.deck0 = m.tab + 4 * (c.obs + c.own + c.A);
  m.vals = m.deck0 + 4 * c.M;
  m.bytes = (m.vals + K3_WORLDS * P * vs + 15) / 16 * 16;
  return m;
}

__global__ void __launch_bounds__(K3_THREADS, 3)
hk_step_kernel(const Cfg c, const int32_t* __restrict__ st_in, const uint8_t* __restrict__ obs_in,
               const uint8_t* __restrict__ own_in, const uint8_t* __restrict__ mask_in,
               const int32_t* __restrict__ act, const int64_t* __restrict__ cnt_in,
               const uint32_t* __restrict__ tab_in, int32_t* __restrict__ st_out,
               uint8_t* __restrict__ obs_out, uint8_t* __restrict__ own_out,
               uint8_t* __restrict__ mask_out, int32_t* __restrict__ rew_out,
               bool* __restrict__ done_out, int64_t* __restrict__ cnt_out,
               unsigned long long* __restrict__ scan, int N) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int tile_s, nfresh;
  __shared__ int listed[K3_WORLDS];
  __shared__ uint8_t rows[K3_WORLDS * P];  // the refreshed rows, in order
  __shared__ uint64_t fresh_s;
  const int vs = value_stride(c);
  const K3Smem L = k3_smem(c, vs);
  int32_t* S = reinterpret_cast<int32_t*>(smem + L.tile);
  uint32_t* tab = reinterpret_cast<uint32_t*>(smem + L.tab);
  int32_t* deck0 = reinterpret_cast<int32_t*>(smem + L.deck0);
  int8_t* vals = reinterpret_cast<int8_t*>(smem + L.vals);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  // the tile (a run of K3_WORLDS worlds) in the order the blocks start, so
  // that every tile the look-back waits on belongs to a running block
  if (tid == 0) tile_s = (int)episode::take_ticket(scan);
  for (int i = tid; i < c.obs + c.own + c.A; i += K3_THREADS) tab[i] = tab_in[i];
  for (int m = tid; m < c.M; m += K3_THREADS) deck0[m] = orig_card(c, m);
  __syncthreads();
  const int tile = tile_s, n0 = tile * K3_WORLDS, nw = min(K3_WORLDS, N - n0);
  for (int r = warp; r < c.rows; r += K3_WARPS)
    if (lane < nw) S[r * K3_WORLDS + lane] = st_in[(size_t)r * N + n0 + lane];
  __syncthreads();
  const size_t row0 = (size_t)n0 * P, rows_total = (size_t)N * P;
  const Run obs_run(row0, nw * P, c.obs), own_run(row0, nw * P, c.own), mask_run(row0, nw * P, c.A);
  if (warp == 0) {
    // the step, one world a lane, on the tile
    const Col col{S + lane, K3_WORLDS, &c};
    bool done = false;
    int rew = 0;
    if (lane < nw) {
      Game g;
      load_game(c, col, g);
      done = transition<0, 0>(c, col, g, act[(size_t)(n0 + lane) * P + g.s[CUR]], &rew);
      store_game(c, col, g);
      rew_out[n0 + lane] = rew;
      done_out[n0 + lane] = done;
    }
    // rank the ended worlds over the batch, list them, and deal them from
    // the first lanes
    const uint32_t dm = __ballot_sync(episode::FULL_MASK, done);
    const int count = __popc(dm);
    const uint32_t before = episode::look_back(scan + 1, tile, (uint32_t)count);
    const uint32_t first = (uint32_t)cnt_in[0] + before;  // the block's first episode index
    if (done) listed[__popc(dm & ((1u << lane) - 1u))] = lane;
    __syncwarp();
    if (lane < count) {
      const int w = listed[lane];
      deal_tile(c, Col{S + w, K3_WORLDS, &c}, first + (uint32_t)lane, deck0);
    }
    __syncwarp();
    // the stale-seat rule: a seat is refreshed where the world ended or the
    // seat is to act
    const int cur = S[(c.r_scal + CUR) * K3_WORLDS + lane];
    const uint32_t f0 = __ballot_sync(episode::FULL_MASK, lane < nw && (done || cur == 0));
    const uint32_t f1 = __ballot_sync(episode::FULL_MASK, lane < nw && (done || cur == 1));
    if (lane == 0) {
      uint64_t f = 0;
      int nf = 0;
      for (int w = 0; w < K3_WORLDS; ++w) {
#pragma unroll
        for (int a = 0; a < P; ++a) {
          if (((a == 0 ? f0 : f1) >> w) & 1u) {
            f |= 1ull << (P * w + a);
            rows[nf++] = (uint8_t)(P * w + a);
          }
        }
      }
      fresh_s = f;
      nfresh = nf;
      // the last tile's next index is the counter after the step
      if (tile == (int)gridDim.x - 1) cnt_out[0] = (int64_t)(first + (uint32_t)count);
    }
  } else {
    // meanwhile the other warps bring in the block's obs words
    for (int k = tid - 32; k < obs_run.words(); k += K3_THREADS - 32)
      *reinterpret_cast<uint4*>(smem + L.obs + 16 * k) =
          run_word(obs_run, obs_in, rows_total * c.obs, k);
  }
  __syncthreads();
  const uint64_t fresh = fresh_s;
  for (int r = warp; r < c.rows; r += K3_WARPS)
    if (lane < nw) st_out[(size_t)r * N + n0 + lane] = S[r * K3_WORLDS + lane];
  if (tid < 2 * K3_WORLDS * P) {  // two threads a refreshed seat
    const int w = tid % K3_WORLDS, a = (tid / K3_WORLDS) % P, row = P * w + a;
    if ((fresh >> row) & 1ull) seat_values(c, S, w, a, tid / (K3_WORLDS * P), vals + row * vs);
  }
  __syncthreads();
  // the own and mask words in flight while the obs run is filled, then into
  // the tile's room
  const int own_words = own_run.words(), om_words = own_words + mask_run.words();
  uint4 held[K3_HELD];
#pragma unroll
  for (int u = 0; u < K3_HELD; ++u) {
    const int k = tid + u * K3_THREADS;
    if (k < own_words) held[u] = run_word(own_run, own_in, rows_total * c.own, k);
    else if (k < om_words) held[u] = run_word(mask_run, mask_in, rows_total * c.A, k - own_words);
  }
  const int nf = nfresh;
  fill_run(obs_run, c.obs, tab, vals, vs, rows, nf, smem + L.obs);
#pragma unroll
  for (int u = 0; u < K3_HELD; ++u) {
    const int k = tid + u * K3_THREADS;
    if (k < own_words)
      *reinterpret_cast<uint4*>(smem + L.own + 16 * k) = held[u];
    else if (k < om_words)
      *reinterpret_cast<uint4*>(smem + L.mask + 16 * (k - own_words)) = held[u];
  }
  __syncthreads();
  store_run(obs_run, smem + L.obs, obs_out);
  fill_run(own_run, c.own, tab + c.obs, vals, vs, rows, nf, smem + L.own);
  fill_run(mask_run, c.A, tab + c.obs + c.own, vals, vs, rows, nf, smem + L.mask);
  __syncthreads();
  store_run(own_run, smem + L.own, own_out);
  store_run(mask_run, smem + L.mask, mask_out);
}

// ---- K4 ---------------------------------------------------------------------

// K4's carry: one record per world, world-major, so a thread loads its world
// with 16-byte loads (the launch transcodes the [rows, N] state into it and
// back).  Words 0..15 and bytes 64..111 are loaded and stored every step;
// the board after them is read and written a byte at a time (a draw, a
// discard, a firework) and its fireworks and discards read as words for the
// seat sums.
constexpr int W_HP = 0;          // P * H plausible masks
constexpr int W_RNG = P * H;     // the episode LCG word
constexpr int W_SUM = W_RNG + 1; // the two seats' sums of obs, own and mask bytes
constexpr int W_ARNG = W_SUM + P, W_CHK = W_ARNG + 1, W_DCNT = W_CHK + 1;
constexpr int B_SCAL = 4 * (W_DCNT + 1);  // DS .. LMRB, one int8 each
constexpr int B_HS = B_SCAL + NSCAL - 1;  // hand sizes
constexpr int B_HC = B_HS + P, B_KC = B_HC + P * H, B_KR = B_KC + P * H;
// the fireworks' and discards' share of every seat sum (their sections of
// the obs encode), kept up to date by the board as a step changes them
constexpr int B_FD = B_KR + P * H;
constexpr int GAME_WORDS = (B_FD + 1 + 15) / 16 * 4;  // 28: bytes 0..111
constexpr int B_BOARD = 4 * GAME_WORDS;
static_assert(B_SCAL == 64 && B_BOARD == 112, "the record's header is 112 bytes");

template <int C, int R>
struct Rec {
  static constexpr int CR = C * R;
  static constexpr int M = C * (R == 1 ? 3 : 2 * R);  // the cards of a colour: sum of copies
  static constexpr int A = 2 * H + (P - 1) * (C + R);
  // the deck, then the fireworks and discards
  static constexpr int B_DECK = B_BOARD, B_FW = B_DECK + M, B_DISC = B_FW + C;
  static constexpr int BYTES = (B_DISC + CR + 15) / 16 * 16;
  static constexpr int DECK_VECS = (M + 15) / 16;  // a fresh deck's 16-byte stores
  static_assert(B_DECK + 16 * DECK_VECS <= BYTES, "a fresh deck's stores lie in the record");
  // the stride of the records in shared memory: an odd number of 16-byte
  // words, so that the 16-byte accesses of 8 threads hit 32 different banks
  static constexpr int STRIDE = BYTES / 16 % 2 ? BYTES : BYTES + 16;
  static_assert(CR <= 32 && A <= 32, "cards and moves fit 32-bit masks");
};

// The record's words beside the Game.
struct Extra {
  int sum[P];
  uint32_t arng;
  int chk, dcnt;
  int fd;  // byte B_FD
};

__device__ __forceinline__ int rec_byte(const uint32_t* w, int off) {
  return (int)(int8_t)(w[off >> 2] >> (8 * (off & 3)));
}

__device__ __forceinline__ void load_rec(const uint8_t* rec, Game& g, Extra& e) {
  uint32_t w[GAME_WORDS];
#pragma unroll
  for (int i = 0; i < GAME_WORDS / 4; ++i) {
    const uint4 v = reinterpret_cast<const uint4*>(rec)[i];
    w[4 * i] = v.x;
    w[4 * i + 1] = v.y;
    w[4 * i + 2] = v.z;
    w[4 * i + 3] = v.w;
  }
#pragma unroll
  for (int p = 0; p < P; ++p) {
#pragma unroll
    for (int h = 0; h < H; ++h) {
      g.hp[p][h] = w[W_HP + p * H + h];
      g.hc[p][h] = rec_byte(w, B_HC + p * H + h);
      g.kc[p][h] = rec_byte(w, B_KC + p * H + h);
      g.kr[p][h] = rec_byte(w, B_KR + p * H + h);
    }
    g.hs[p] = rec_byte(w, B_HS + p);
    e.sum[p] = (int)w[W_SUM + p];
  }
#pragma unroll
  for (int k = 0; k < NSCAL - 1; ++k) g.s[k] = rec_byte(w, B_SCAL + k);
  g.s[RNG] = (int)w[W_RNG];
  e.arng = w[W_ARNG];
  e.chk = (int)w[W_CHK];
  e.dcnt = (int)w[W_DCNT];
  e.fd = rec_byte(w, B_FD);
}

// Word i of a record's header (constant i: the branches fold away).
__device__ __forceinline__ uint32_t rec_word(const Game& g, const Extra& e, int i) {
  if (i < W_RNG) return g.hp[i / H][i % H];
  if (i == W_RNG) return (uint32_t)g.s[RNG];
  if (i < W_ARNG) return (uint32_t)e.sum[i - W_SUM];
  if (i == W_ARNG) return e.arng;
  if (i == W_CHK) return (uint32_t)e.chk;
  if (i == W_DCNT) return (uint32_t)e.dcnt;
  uint32_t w = 0u;
#pragma unroll
  for (int b = 0; b < 4; ++b) {
    const int off = 4 * i + b;
    int v = 0;
    if (off < B_HS) v = g.s[off - B_SCAL];
    else if (off < B_HC) v = g.hs[off - B_HS];
    else if (off < B_KC) v = g.hc[(off - B_HC) / H][(off - B_HC) % H];
    else if (off < B_KR) v = g.kc[(off - B_KC) / H][(off - B_KC) % H];
    else if (off < B_FD) v = g.kr[(off - B_KR) / H][(off - B_KR) % H];
    else if (off == B_FD) v = e.fd;
    w |= (uint32_t)(uint8_t)v << (8 * b);
  }
  return w;
}

// Stores the header 16 bytes at a time, each as soon as its words are made.
__device__ __forceinline__ void store_rec(uint8_t* rec, const Game& g, const Extra& e) {
#pragma unroll
  for (int i = 0; i < GAME_WORDS / 4; ++i)
    reinterpret_cast<uint4*>(rec)[i] =
        make_uint4(rec_word(g, e, 4 * i), rec_word(g, e, 4 * i + 1), rec_word(g, e, 4 * i + 2),
                   rec_word(g, e, 4 * i + 3));
}

// The board of a record, for transition; a firework or discard it changes
// moves the record's fireworks-and-discards share *fd of the seat sums.
template <int C, int R>
struct PackedBoard {
  uint8_t* r;
  int* fd;
  __device__ __forceinline__ int fw(int k) const { return (int8_t)r[Rec<C, R>::B_FW + k]; }
  __device__ __forceinline__ void set_fw(int k, int v) const {
    const int f = fw(k);  // a firework counts where 1 <= f <= R
    *fd += (v >= 1 && v <= R) - (f >= 1 && f <= R);
    r[Rec<C, R>::B_FW + k] = (uint8_t)v;
  }
  __device__ __forceinline__ void add_discard(int card) const {
    const int d = (int8_t)r[Rec<C, R>::B_DISC + card];  // counts up to its copies
    *fd += d >= 0 && d < copies(card % R, R);
    r[Rec<C, R>::B_DISC + card] = (uint8_t)(d + 1);
  }
  __device__ __forceinline__ int deck(int i) const { return (int8_t)r[Rec<C, R>::B_DECK + i]; }
  __device__ __forceinline__ void set_deck(int i, int v) const {
    r[Rec<C, R>::B_DECK + i] = (uint8_t)v;
  }
};

__device__ __forceinline__ int clamp_to(int x, int hi) { return min(max(x, 0), hi); }

// The fireworks' and discards' share of a seat sum, from the record's board:
// a firework counts where 1 <= f <= R, a discard count up to its copies.
template <int C, int R>
__device__ int fd_share(const uint8_t* rec) {
  using L = Rec<C, R>;
  int sum = 0;
  for (int k = 0; k < C; ++k) {
    const int f = (int8_t)rec[L::B_FW + k];
    sum += f >= 1 && f <= R;
  }
  for (int k = 0; k < L::CR; ++k) sum += clamp_to((int8_t)rec[L::B_DISC + k], copies(k % R, R));
  return sum;
}

// A seat's sum of obs, own-hand and mask bytes in closed form, section by
// section of envs/hanabi.py's _encode_seat and legal_mask (ops/hanabi.py's
// seat_sums_plain is the same formula): a one-hot block adds 1 where its
// value lies in range, a thermometer the clamped count.  The reference's
// quirks stay: the plausible bit of the knowledge section is bit `offset`
// broadcast over the CR bits of a slot, rel_target is taken even for
// LMT = -1 (the reveal flag gates it), and the reveal legality reads dead
// slots.  Most sections are the same for both seats (seat_common); the
// rest depend on the observer (seat_sum).  fd: the fireworks' and
// discards' share (fd_share).
template <int C, int R>
__device__ __forceinline__ int seat_common(const Cfg& c, const Game& g, int fd) {
  using L = Rec<C, R>;
  const int* s = g.s;
  int sum = fd;
#pragma unroll
  for (int p = 0; p < P; ++p) {
    // the partner's live cards (obs) and the own ones (own hand) cover both
    // seats' hands, "hand not full" both seats, and the knowledge section's
    // colour and rank blocks both seats' slots
#pragma unroll
    for (int h = 0; h < H; ++h) {
      const bool live = h < g.hs[p];
      sum += live && (unsigned)g.hc[p][h] < (unsigned)L::CR;
      sum += live && (unsigned)g.kc[p][h] < (unsigned)C;
      sum += live && (unsigned)g.kr[p][h] < (unsigned)R;
    }
    sum += g.hs[p] < H;
  }
  // board
  sum += clamp_to(s[DS], c.deck_bits);
  sum += clamp_to(s[INFO], c.max_info) + clamp_to(s[LIFE], c.max_life);
  // last action, but for the observer-relative actor and target
  const int lmm = s[LMM], lmc = s[LMC], lmr = s[LMR];
  const bool is_reveal = lmm == M_REVEAL_C || lmm == M_REVEAL_R;
  const bool is_pd = lmm == M_PLAY || lmm == M_DISCARD;
  sum += is_reveal || is_pd;
  sum += lmm == M_REVEAL_C && (unsigned)lmc < (unsigned)C;
  sum += lmm == M_REVEAL_R && (unsigned)lmr < (unsigned)R;
  sum += is_reveal ? __popc((uint32_t)s[LMRB] & ((1u << H) - 1u)) : 0;
  sum += is_pd && (unsigned)s[LMCI] < (unsigned)H;
  sum += is_pd && (unsigned)(lmc * R + lmr) < (unsigned)L::CR;
  sum += (lmm == M_PLAY && s[LMSC] != 0) + (lmm == M_PLAY && s[LMIT] != 0);
  return sum;
}

// Seat a's sum, given seat_common's.
template <int C, int R>
__device__ __forceinline__ int seat_sum(const Cfg& c, const Game& g, int a, int common) {
  using L = Rec<C, R>;
  const int* s = g.s;
  int sum = common;
  const int rel_actor = s[LMP] == -1 ? -1 : (a - s[LMP] + P) % P;
  sum += (unsigned)rel_actor < (unsigned)P;
  const int rel_target = (a - s[LMT] + P) % P;
  sum += (s[LMM] == M_REVEAL_C || s[LMM] == M_REVEAL_R) && (unsigned)rel_target < (unsigned)P;
  // the plausible blocks: seat k's slots show bit (k - a) mod P of the mask
#pragma unroll
  for (int h = 0; h < H; ++h) {
    sum += h < g.hs[0] && ((g.hp[0][h] >> a) & 1u) ? L::CR : 0;
    sum += h < g.hs[1] && ((g.hp[1][h] >> (1 - a)) & 1u) ? L::CR : 0;
  }
  return sum + __popc(seat_legal<C, R>(c, g, a));
}

// A fresh game for episode `idx` in the record `rec`, its two seat sums
// added to the checksum.  deck0: the unshuffled deck in shared memory,
// zero-padded to whole 16-byte words.
template <int C, int R>
__device__ void deal_rec(const Cfg& c, uint8_t* rec, uint32_t idx, const uint4* deck0v) {
  using L = Rec<C, R>;
  const uint4 x = reinterpret_cast<const uint4*>(rec)[W_ARNG / 4];  // words 12..15
  static_assert(W_ARNG % 4 == 1 && W_DCNT % 4 == 3 && W_SUM + 1 == W_ARNG - 1,
                "sum[1], arng, chk, dcnt share one 16-B word");
  Extra e;
  e.arng = x.y;
  e.chk = (int)x.z;
  e.dcnt = (int)x.w;
  // the unshuffled deck and zeros up to the record's end
  uint4* board = reinterpret_cast<uint4*>(rec + B_BOARD);
#pragma unroll
  for (int i = 0; i < (L::BYTES - B_BOARD) / 16; ++i)
    board[i] = i < L::DECK_VECS ? deck0v[i] : make_uint4(0u, 0u, 0u, 0u);
  // the deal's D swap draws in order on the record's deck: draw k takes the
  // card at a position among the M - k left and moves the last one there
  // (as K3's deal_tile)
  Game g;
  uint8_t* deck = rec + L::B_DECK;
  uint32_t v = episode::tea_seed(idx);
#pragma unroll
  for (int k = 0; k < D; ++k) {
    v = episode::lcg_next(v);
    const int loc = __float2int_rz(__fmul_rn((float)(L::M - k), episode::unif(v)));
    g.hc[k / H][k % H] = (int8_t)deck[loc];
    deck[loc] = deck[L::M - 1 - k];
  }
  fresh_scalars(c, g, v);
  e.fd = 0;  // a fresh board
  const int common = seat_common<C, R>(c, g, e.fd);
#pragma unroll
  for (int a = 0; a < P; ++a) e.sum[a] = seat_sum<C, R>(c, g, a, common);
  e.chk += e.sum[0] + e.sum[1];
  store_rec(rec, g, e);
}

constexpr int RESET_CAP = 2 * THREADS;  // resets listed before a block deals them

// World n's record: in device memory (the L2-resident carry), or in the
// block's shared memory when the whole resident grid holds every record
// (ONCHIP; `first` is the block's first world).
template <int C, int R, bool ONCHIP>
__device__ __forceinline__ uint8_t* record(uint8_t* carry, uint4* onchip, int first, int n) {
  if (ONCHIP) return reinterpret_cast<uint8_t*>(onchip) + (size_t)(n - first) * Rec<C, R>::STRIDE;
  return carry + (size_t)n * Rec<C, R>::BYTES;
}

// ---- K4's envelope check -------------------------------------------------
//
// tab: int32 [2, rows], each row's lo then each row's hi
// (ops/hanabi.py::rollout_envelope).  The envelope word, in mapped pinned
// host memory (hk_envelope_record), int32: [0] 1 once a refused launch
// wrote the rest (the host clears it after reading), then the bitmask of
// the rows outside ((rows + 31) / 32 words, row r at bit r % 32 of word
// r / 32), then every row's min, then every row's max over the batch.
__host__ __device__ constexpr int envelope_bitmask_words(int rows) { return (rows + 31) / 32; }
__host__ __device__ constexpr int envelope_ints(int rows) {
  return 1 + envelope_bitmask_words(rows) + 2 * rows;
}
constexpr int REFUSED_DCNT = -1;  // a refused launch's done counts
constexpr int32_t REFUSED_CHK = INT32_MIN;  // and checksums

__device__ __forceinline__ bool outside(const int* __restrict__ tab, int rows, int r, int v) {
  return v < __ldg(tab + r) || v > __ldg(tab + rows + r);
}

// Whether a world's scalars and hands, as load_game read them, leave the
// envelope (the board's rows are tested where the entry reads them).
__device__ __forceinline__ bool game_outside(const Cfg& c, const int* __restrict__ tab,
                                             const Game& g) {
  bool bad = false;
#pragma unroll
  for (int k = 0; k < NSCAL; ++k) bad |= outside(tab, c.rows, c.r_scal + k, g.s[k]);
#pragma unroll
  for (int p = 0; p < P; ++p) {
#pragma unroll
    for (int h = 0; h < H; ++h) {
      const int i = p * H + h;
      bad |= outside(tab, c.rows, c.r_hc + i, g.hc[p][h]);
      bad |= outside(tab, c.rows, c.r_hp + i, (int)g.hp[p][h]);
      bad |= outside(tab, c.rows, c.r_kc + i, g.kc[p][h]);
      bad |= outside(tab, c.rows, c.r_kr + i, g.kr[p][h]);
    }
    bad |= outside(tab, c.rows, c.r_hs + p, g.hs[p]);
  }
  return bad;
}

// A launch whose entry state leaves the envelope: block 0 writes the
// envelope word unless an earlier refused launch's word is still unread
// (that one is reported first), and every world's outputs take their
// refused values.  Error path only (not inlined, so that it takes no
// registers from the steps): block 0 reads the whole state.  smem: the
// block's SCAN_SMEM_INTS ints, free outside the steps.
__device__ __noinline__ void refuse(const Cfg& c, const int* __restrict__ tab,
                                    int* __restrict__ word, const int32_t* __restrict__ st_in,
                                    const int32_t* __restrict__ arng_in,
                                    const int64_t* __restrict__ cnt_in, int32_t* __restrict__ st,
                                    int32_t* __restrict__ arng, int32_t* __restrict__ dcnt,
                                    int32_t* __restrict__ chk, int64_t* __restrict__ cnt_out,
                                    int N, int slots, int* smem) {
  if (blockIdx.x == 0) {
    volatile int* w = word;
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    if (!__syncthreads_or(threadIdx.x == 0 && w[0] != 0)) {
      const int nb = envelope_bitmask_words(c.rows);
      uint32_t bits = 0u;  // thread 0's word of the bitmask being built
      for (int r = 0; r < c.rows; ++r) {
        int mn = INT32_MAX, mx = INT32_MIN;
        for (int n = threadIdx.x; n < N; n += THREADS) {
          const int v = st_in[(size_t)r * N + n];
          mn = min(mn, v);
          mx = max(mx, v);
        }
        mn = __reduce_min_sync(episode::FULL_MASK, mn);
        mx = __reduce_max_sync(episode::FULL_MASK, mx);
        if (lane == 0) smem[warp] = mn, smem[THREADS / 32 + warp] = mx;
        __syncthreads();
        if (threadIdx.x == 0) {
          for (int i = 1; i < THREADS / 32; ++i)
            mn = min(mn, smem[i]), mx = max(mx, smem[THREADS / 32 + i]);
          w[1 + nb + r] = mn;
          w[1 + nb + c.rows + r] = mx;
          if (mn < tab[r] || mx > tab[c.rows + r]) bits |= 1u << (r & 31);
          if ((r & 31) == 31 || r == c.rows - 1) w[1 + (r >> 5)] = (int)bits, bits = 0u;
        }
        __syncthreads();  // smem is refilled for the next row
      }
      if (threadIdx.x == 0) {
        __threadfence_system();  // the rows before the flag that announces them
        w[0] = 1;
        __threadfence_system();
      }
    }
  }
  for (int s = 0; s < slots; ++s) {
    const int n = world(slots, s);
    if (n < N) {
      for (int r = 0; r < c.rows; ++r) st[(size_t)r * N + n] = st_in[(size_t)r * N + n];
      arng[n] = arng_in[n];
      dcnt[n] = REFUSED_DCNT;
      chk[n] = REFUSED_CHK;
    }
  }
  if (blockIdx.x == 0 && threadIdx.x == 0) cnt_out[0] = cnt_in[0];
}

#define HK_ROLLOUT_PARAMS                                                                  \
  const Cfg c, const int32_t* __restrict__ st_in, const int8_t* __restrict__ obs_in,         \
      const int8_t* __restrict__ own_in, const bool* __restrict__ mask_in,                   \
      const int32_t* __restrict__ arng_in, const int64_t* __restrict__ cnt_in,               \
      const int* __restrict__ tab, int32_t* __restrict__ st, int32_t* __restrict__ arng,     \
      int32_t* __restrict__ dcnt, int32_t* __restrict__ chk, int64_t* __restrict__ cnt_out,  \
      uint8_t* __restrict__ carry, int* __restrict__ totals, int* __restrict__ word, int N,  \
      int T, int slots
#define HK_ROLLOUT_ARGS                                                                      \
  c, st_in, obs_in, own_in, mask_in, arng_in, cnt_in, tab, st, arng, dcnt, chk, cnt_out, carry, \
      totals, word, N, T, slots

template <int C, int R, bool ONCHIP>
__device__ __forceinline__ void rollout(HK_ROLLOUT_PARAMS) {
  using L = Rec<C, R>;
  __shared__ int smem[episode::SCAN_SMEM_INTS];
  __shared__ int2 resets[RESET_CAP];  // done worlds to deal: (world, episode index)
  __shared__ uint4 deck0v[L::DECK_VECS];
  extern __shared__ uint4 onchip[];  // the records, when ONCHIP
  cg::grid_group grid = cg::this_grid();
  const int G = gridDim.x, lane = threadIdx.x & 31, first = blockIdx.x * slots * THREADS;
  uint8_t* deck0 = reinterpret_cast<uint8_t*>(deck0v);
  for (int m = threadIdx.x; m < 16 * L::DECK_VECS; m += THREADS)
    deck0[m] = m < L::M ? (uint8_t)orig_card(c, m) : 0;

  // the launch-time state into the carry, every value tested against the
  // envelope as it is read; each seat's sum of its launch-time
  // obs, own and mask bytes taken by the warp together, one world at a time,
  // so that the lanes read consecutive bytes
  bool bad = false;
  for (int s = 0; s < slots; ++s) {
    const int n = world(slots, s), warp_first = n - lane;
    Extra e;
    for (int j = 0; j < 32 && warp_first + j < N; ++j) {
#pragma unroll
      for (int a = 0; a < P; ++a) {
        const size_t row = (size_t)(warp_first + j) * P + a;
        int v = 0;
        for (int i = lane; i < c.obs; i += 32) v += obs_in[row * c.obs + i];
        for (int i = lane; i < c.own; i += 32) v += own_in[row * c.own + i];
        for (int i = lane; i < c.A; i += 32) v += (int)mask_in[row * c.A + i];
#pragma unroll
        for (int dd = 16; dd > 0; dd >>= 1) v += __shfl_xor_sync(episode::FULL_MASK, v, dd);
        if (lane == j) e.sum[a] = v;
      }
    }
    if (n < N) {
      const Col in{const_cast<int32_t*>(st_in) + n, N, &c};
      uint8_t* rec = record<C, R, ONCHIP>(carry, onchip, first, n);
      Game g;
      load_game(c, in, g);
      bad |= game_outside(c, tab, g);
      for (int m = 0; m < L::M; ++m) {
        const int v = in.deck(m);
        bad |= outside(tab, c.rows, c.r_deck + m, v);
        rec[L::B_DECK + m] = (uint8_t)v;
      }
      for (int k = 0; k < L::CR; ++k) {
        const int v = in[c.r_disc + k];
        bad |= outside(tab, c.rows, c.r_disc + k, v);
        rec[L::B_DISC + k] = (uint8_t)v;
      }
      for (int k = 0; k < C; ++k) {
        const int v = in.fw(k);
        bad |= outside(tab, c.rows, c.r_fw + k, v);
        rec[L::B_FW + k] = (uint8_t)v;
      }
      e.fd = fd_share<C, R>(rec);
      e.arng = (uint32_t)arng_in[n];
      e.chk = 0;
      e.dcnt = 0;
      store_rec(rec, g, e);
    }
  }
  // whether any block read a value outside the envelope: each block's flag
  // in the odd steps' totals (first written by step 1, after step 0's sync)
  int* outside_blocks = totals + G;
  const int block_bad = __syncthreads_or(bad);
  if (threadIdx.x == 0) outside_blocks[blockIdx.x] = block_bad;
  grid.sync();
  int any = 0;
  for (int b = threadIdx.x; b < G; b += THREADS) any |= __ldcg(outside_blocks + b);
  if (__syncthreads_or(any)) {  // the same for every block: none steps
    refuse(c, tab, word, st_in, arng_in, cnt_in, st, arng, dcnt, chk, cnt_out, N, slots, smem);
    return;
  }
  uint32_t base = (uint32_t)cnt_in[0];
  for (int t = 0; t < T; ++t) {
    int* step_totals = totals + (t & 1) * G;
    // phase A: the legal draw, the step, and a live world's refreshed seat
    // (the seat to act next); live worlds are final for this step
    uint32_t dmask = 0u;
    int count = 0;
    for (int s = 0; s < slots; ++s) {
      const int n = world(slots, s);
      bool done = false;
      if (n < N) {
        uint8_t* rec = record<C, R, ONCHIP>(carry, onchip, first, n);
        Game g;
        Extra e;
        load_rec(rec, g, e);
        e.arng = episode::lcg_next(e.arng);
        const uint32_t legal = seat_legal<C, R>(c, g, g.s[CUR]);
        const uint32_t idx = (((e.arng >> 8) & 0x00FFFFFFu) * (uint32_t)__popc(legal)) >> 24;
        uint32_t rest = legal;  // the idx-th legal move: drop the idx lowest
        for (uint32_t i = 0; i < idx; ++i) rest &= rest - 1u;
        const int uid = rest ? __ffs(rest) - 1 : 0;  // no legal move: 0
        int rew;
        done = transition<C, R>(c, PackedBoard<C, R>{rec, &e.fd}, g, uid, &rew);
        e.chk += rew * P + (int)done;
        e.dcnt += done;
        if (done) {  // its deal reads only words 12..15 and writes the rest
          reinterpret_cast<uint4*>(rec)[W_ARNG / 4] =
              make_uint4((uint32_t)e.sum[1], e.arng, (uint32_t)e.chk, (uint32_t)e.dcnt);
        } else {
          const int a = g.s[CUR];
          const int fresh = seat_sum<C, R>(c, g, a, seat_common<C, R>(c, g, e.fd));
          if (a == 0) e.sum[0] = fresh; else e.sum[1] = fresh;
          e.chk += e.sum[0] + e.sum[1];
          store_rec(rec, g, e);
        }
      }
      dmask |= (uint32_t)done << s;
      count += __syncthreads_count(done);
    }
    if (threadIdx.x == 0) step_totals[blockIdx.x] = count;
    // the parity buffers let one sync a step suffice (csrc/cartpole.cu)
    grid.sync();
    // phase B: rank this step's resets over the whole batch, list them in
    // shared memory, and deal them one per thread from the block's first
    // threads, so that only the warps holding a deal run one
    uint32_t before, all;
    episode::block_offsets(step_totals, blockIdx.x, G, smem, &before, &all);
    uint32_t next = base + before;
    int listed = 0;
    for (int s = 0; s <= slots; ++s) {  // s == slots: deal what is listed
      const bool done = s < slots && ((dmask >> s) & 1u);
      int total = 0, rank = 0;
      if (s < slots) rank = episode::block_rank(done, smem, &total);
      if (s == slots || listed + total > RESET_CAP) {  // the same for the whole block
        __syncthreads();
        for (int i = threadIdx.x; i < listed; i += THREADS)
          deal_rec<C, R>(c, record<C, R, ONCHIP>(carry, onchip, first, resets[i].x),
                         (uint32_t)resets[i].y, deck0v);
        __syncthreads();  // the owners read the dealt records next
        listed = 0;
      }
      if (done) resets[listed + rank] = make_int2(world(slots, s), (int)(next + (uint32_t)rank));
      listed += total;
      next += (uint32_t)total;
    }
    base += all;
  }
  // the carry back into the [rows, N] state, action words, counts, checksum
  for (int s = 0; s < slots; ++s) {
    const int n = world(slots, s);
    if (n < N) {
      const uint8_t* rec = record<C, R, ONCHIP>(carry, onchip, first, n);
      const Col out{st + n, N, &c};
      Game g;
      Extra e;
      load_rec(rec, g, e);
      store_game(c, out, g);
      for (int m = 0; m < L::M; ++m) out.set_deck(m, (int8_t)rec[L::B_DECK + m]);
      for (int k = 0; k < L::CR; ++k) out[c.r_disc + k] = (int8_t)rec[L::B_DISC + k];
      for (int k = 0; k < C; ++k) out.set_fw(k, (int8_t)rec[L::B_FW + k]);
      arng[n] = (int32_t)e.arng;
      chk[n] = e.chk;
      dcnt[n] = e.dcnt;
    }
  }
  if (blockIdx.x == 0 && threadIdx.x == 0) cnt_out[0] = (int64_t)base;
}

// K4's two kernels.  With the records in shared memory (the resident grid
// holds them all) two blocks an SM fit in 128 registers; with them in
// device memory (larger batches) ptxas may take more registers than 128,
// which keeps every instantiation free of spills at one block an SM.
template <int C, int R>
__global__ void __launch_bounds__(THREADS) hk_rollout_onchip_kernel(HK_ROLLOUT_PARAMS) {
  rollout<C, R, true>(HK_ROLLOUT_ARGS);
}

template <int C, int R>
__global__ void __launch_bounds__(THREADS, 1) hk_rollout_kernel(HK_ROLLOUT_PARAMS) {
  rollout<C, R, false>(HK_ROLLOUT_ARGS);
}

// ---- K11 --------------------------------------------------------------------

// K11's config, a flat array of ints in this order from
// ops/hanabi.py::_mask_cfg: players, hand size, colours, ranks, moves and
// info tokens at most.  Any game of JAX's Env with a player and a rank.
struct MaskCfg {
  int P, H, C, R, A, max_info;
};
constexpr int MASK_CFG_INTS = 6;
static_assert(sizeof(MaskCfg) == MASK_CFG_INTS * sizeof(int),
              "MaskCfg is read as a flat int array");
constexpr int MASK_THREADS = 256;
constexpr int MASK_WORLDS = 128;       // worlds a tile at most, a multiple of 16
constexpr int MASK_SMEM = 48 * 1024;   // a tile's shared bytes at most (no opt-in)

// The hand size of a game of `players` (envs/hanabi.py).
__host__ __device__ constexpr int hand_of(int players) { return players < 4 ? 5 : 4; }

// Returns false outside what K11 holds: a seat's moves in one 64-bit word,
// a world in shared memory, and every value a shift or index below reads.
bool make_mask_cfg(const int* in, int n, MaskCfg* m) {
  if (n != MASK_CFG_INTS) return false;
  std::memcpy(m, in, sizeof(MaskCfg));
  if (m->P < 1 || m->H < 2 || m->C < 0 || m->R < 1 || m->A > 64) return false;
  return (long long)m->A == 2LL * m->H + (long long)(m->P - 1) * ((long long)m->C + m->R);
}

// A world's shared bytes: its cards, hand sizes and info tokens, then two
// 64-bit sets per player (each seat's 64-bit moves later take the cards'
// room, H >= 2).  Within A <= 64 a world takes at most 2,816 B, so a tile of
// 16 worlds always fits MASK_SMEM.
int mask_world_bytes(const MaskCfg& m) { return 4 * m.P * m.H + 4 * m.P + 4 + 16 * m.P; }
int mask_tile_worlds(const MaskCfg& m) {
  const int w = MASK_SMEM / mask_world_bytes(m) / 16 * 16;
  return w < MASK_WORLDS ? w : MASK_WORLDS;
}

// `count` int32 from global memory into shared memory, consecutive threads
// on consecutive words: as 16-byte vectors where `src` starts on a 16-byte
// boundary (the wrapper accepts 4-byte-aligned views), else one int each.
// K11's copy and store loops stay rolled (`unroll 1`): unrolled, ptxas
// spilled in two instantiations and the kernel ran slower (PERF.md §6).
__device__ __forceinline__ void stage(int32_t* dst, const int32_t* __restrict__ src, int count) {
  int done = 0;
  if ((reinterpret_cast<uintptr_t>(src) & 15) == 0) {
    done = count & ~3;
#pragma unroll 1
    for (int i = threadIdx.x; i < done / 4; i += MASK_THREADS)
      reinterpret_cast<int4*>(dst)[i] = __ldg(reinterpret_cast<const int4*>(src) + i);
  }
#pragma unroll 1
  for (int i = done + threadIdx.x; i < count; i += MASK_THREADS) dst[i] = __ldg(src + i);
}

// Floor division of n in [0, 2^31) by a divisor d >= 1 fixed for a launch:
// n * magic >> shift, magic = ceil(2^shift / d) and shift = 31 + ceil(log2
// d), so that 2^shift <= magic * d <= 2^shift + 2^ceil(log2 d), which makes
// the quotient exact for every such n (Granlund and Montgomery, "Division by
// invariant integers using multiplication", 1994, theorem 4.2).  A few
// instructions where `/` by a run-time divisor takes about twenty.
struct Divider {
  unsigned long long magic;
  int shift;
};
inline Divider make_divider(int d) {
  const int l = d > 1 ? 32 - __builtin_clz((unsigned)(d - 1)) : 0;
  return {((1ull << (31 + l)) + d - 1) / d, 31 + l};
}
__device__ __forceinline__ int quotient(int n, const Divider& by) {
  return (int)(((unsigned long long)n * by.magic) >> by.shift);
}

// Four bits to four 0/1 bytes, bit k to byte k.
__device__ __forceinline__ uint32_t spread4(uint32_t nibble) {
  return (nibble * 0x00204081u) & 0x01010101u;
}

// Every seat's legal moves ([N, P, A] bool) from the hand cards [N, P, H],
// hand sizes [N, P] and info tokens [N], as _mask_kernel and
// envs/hanabi.py::_mask_seat compute them for every int32 input: a card
// shows colour floor(card / R) where that lies in [0, C) and rank
// floor_mod(card, R); dead slots are scanned too.  A block owns a tile of W
// contiguous worlds, whose inputs and output are contiguous runs: it stages
// the inputs in shared memory, builds each player's colour and rank sets
// once, then each seat's moves as one 64-bit word (discard, play, then each
// partner's colours and ranks at their offsets), and writes the tile's W * P
// * A bytes as 16-byte words, consecutive threads on consecutive words:
// word k is bits 16k..16k+15 of the seats' words laid end to end, spread to
// bytes.  NP > 0: P = NP and H = hand_of(NP) are compile-time (the card and
// partner loops unroll); NP = 0 reads both from the config.
template <int NP>
__global__ void __launch_bounds__(MASK_THREADS)
hk_mask_kernel(const MaskCfg m, const Divider by_rank, const Divider by_moves,
               const int32_t* __restrict__ cards, const int32_t* __restrict__ size,
               const int32_t* __restrict__ info, bool* __restrict__ out, int N, int W) {
  extern __shared__ __align__(16) unsigned char mask_smem[];
  const int P = NP > 0 ? NP : m.P, H = NP > 0 ? hand_of(NP) : m.H;
  const int n0 = blockIdx.x * W, worlds = min(W, N - n0), rows = worlds * P;
  int32_t* s_cards = reinterpret_cast<int32_t*>(mask_smem);         // [W * P * H]
  int32_t* s_size = s_cards + W * P * H;                            // [W * P]
  int32_t* s_info = s_size + W * P;                                 // [W]
  uint64_t* s_sets = reinterpret_cast<uint64_t*>(s_info + W);       // [W * P] x {colours, ranks}
  uint64_t* s_moves = reinterpret_cast<uint64_t*>(mask_smem);       // [W * P], over the cards
  stage(s_cards, cards + (size_t)n0 * P * H, rows * H);
  stage(s_size, size + (size_t)n0 * P, rows);
  stage(s_info, info + n0, worlds);
  __syncthreads();
  for (int q = threadIdx.x; q < rows; q += MASK_THREADS) {  // (world, player)
    uint64_t colors = 0, ranks = 0;
#pragma unroll
    for (int h = 0; h < H; ++h) {
      // floor division and modulo: for card < 0, floor(card / R) is
      // ~floor(~card / R) and the rank R - 1 - ~card % R
      const int card = s_cards[q * H + h], n = card < 0 ? ~card : card;
      const int nq = quotient(n, by_rank), nr = n - nq * m.R;
      const int col = card < 0 ? ~nq : nq, rank = card < 0 ? m.R - 1 - nr : nr;
      if ((unsigned)col < (unsigned)m.C) colors |= 1ull << col;
      ranks |= 1ull << rank;
    }
    s_sets[2 * q] = colors;
    s_sets[2 * q + 1] = ranks;
  }
  __syncthreads();
  for (int q = threadIdx.x; q < rows; q += MASK_THREADS) {  // (world, seat)
    const int n = q / P, a = q - n * P, hs = s_size[q], tokens = s_info[n];
    const uint64_t live = hs <= 0 ? 0ull : hs >= H ? (1ull << H) - 1 : (1ull << hs) - 1;
    uint64_t moves = (tokens < m.max_info ? live : 0ull) | live << H;
    if (tokens > 0) {
      const uint64_t* sets = s_sets + 2 * n * P;
      int t = a;
#pragma unroll
      for (int o = 1; o < P; ++o) {
        t = t + 1 == P ? 0 : t + 1;
        moves |= sets[2 * t] << (2 * H + (o - 1) * m.C) |
                 sets[2 * t + 1] << (2 * H + (P - 1) * m.C + (o - 1) * m.R);
      }
    }
    s_moves[q] = moves;  // the cards were last read before the barrier above
  }
  __syncthreads();
  // the tile's bytes start on a 16-byte boundary where `out` does: W * P * A
  // is a multiple of 16
  const int bytes = rows * m.A;
  uint8_t* dst = reinterpret_cast<uint8_t*>(out) + (size_t)n0 * P * m.A;
  const bool vec = (reinterpret_cast<uintptr_t>(out) & 15) == 0;
#pragma unroll 1
  for (int w = threadIdx.x; w < (bytes + 15) / 16; w += MASK_THREADS) {
    const int b = 16 * w;
    int r = quotient(b, by_moves);
    const int off = b - r * m.A;
    uint64_t x = s_moves[r] >> off;
    for (int k = m.A - off; k < 16 && ++r < rows; k += m.A) x |= s_moves[r] << k;
    const uint32_t x16 = (uint32_t)x;
    if (vec && b + 16 <= bytes) {  // streamed: no later read of the mask here
      __stcs(reinterpret_cast<uint4*>(dst + b),
             make_uint4(spread4(x16 & 15u), spread4(x16 >> 4 & 15u), spread4(x16 >> 8 & 15u),
                        spread4(x16 >> 12 & 15u)));
    } else {  // the ragged end of the last tile, or an unaligned `out`
      for (int j = 0; j < 16 && b + j < bytes; ++j) dst[b + j] = (x16 >> j) & 1u;
    }
  }
}

template <int NP>
int launch_mask(const MaskCfg& m, const int32_t* cards, const int32_t* size, const int32_t* info,
                bool* out, int N, void* stream) {
  const int W = mask_tile_worlds(m);
  hk_mask_kernel<NP><<<(N + W - 1) / W, MASK_THREADS, W * mask_world_bytes(m),
                       (cudaStream_t)stream>>>(m, make_divider(m.R), make_divider(m.A), cards,
                                               size, info, out, N, W);
  return (int)cudaGetLastError();
}

// K4's instantiations: the 2-player configs of envs/hanabi.py's CONFIGS.
template <int C, int R>
bool rollout_config(const Cfg& c) {
  using L = Rec<C, R>;
  return c.C == C && c.R == R && c.M == L::M && c.A == L::A && c.CR == L::CR &&
         c.max_info + 2 * C <= 127;  // info stays an int8 (see the header)
}

// The records in shared memory with the fewest slots at which every block
// is resident at once (hk_rollout_onchip_kernel); else in device memory
// (hk_rollout_kernel).  Sets the on-chip kernel's dynamic shared memory to
// what it launches with.
template <int C, int R>
int rollout_shape(int N, int device, const void** kernel, int* blocks, int* slots,
                  size_t* bytes) {
  *kernel = (const void*)hk_rollout_onchip_kernel<C, R>;
  *blocks = *slots = 0;
  *bytes = 0;
  int sms = 0, optin = 0;
  cudaError_t err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (err != cudaSuccess) return (int)err;
  for (int k = 1; k <= episode::MAX_ROLLOUT_SLOTS && !*slots; ++k) {
    const size_t need = (size_t)k * THREADS * Rec<C, R>::STRIDE;
    if (need + 4096 > (size_t)optin) break;  // the static shared memory beside it
    err = cudaFuncSetAttribute(*kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)need);
    if (err != cudaSuccess) return (int)err;
    int per_sm = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, *kernel, THREADS, need);
    if (err != cudaSuccess) return (int)err;
    const int g = (N + k * THREADS - 1) / (k * THREADS);
    if (g <= per_sm * sms) *blocks = g, *slots = k, *bytes = need;
  }
  if (!*slots) {
    *kernel = (const void*)hk_rollout_kernel<C, R>;
    int max_blocks = 0;
    err = episode::resident_blocks(*kernel, device, &max_blocks);
    if (err != cudaSuccess) return (int)err;
    episode::split(N, max_blocks, blocks, slots);
    if (*slots > episode::MAX_ROLLOUT_SLOTS) return episode::ERR_TOO_MANY_ENVS;
  }
  return 0;
}

template <int C, int R>
int launch_rollout(const Cfg& c, const int32_t* st_in, const int8_t* obs_in,
                   const int8_t* own_in, const bool* mask_in, const int32_t* arng_in,
                   const int64_t* cnt_in, const int* tab, int32_t* st, int32_t* arng,
                   int32_t* dcnt, int32_t* chk, int64_t* cnt_out, uint8_t* carry, int* scratch,
                   int* word, int N, int T, int device, void* stream) {
  const void* kernel = nullptr;
  int blocks = 0, slots = 0;
  size_t bytes = 0;
  const int rc = rollout_shape<C, R>(N, device, &kernel, &blocks, &slots, &bytes);
  if (rc) return rc;
  void* args[] = {(void*)&c,       (void*)&st_in,   (void*)&obs_in, (void*)&own_in,
                  (void*)&mask_in, (void*)&arng_in, (void*)&cnt_in, (void*)&tab,
                  (void*)&st,      (void*)&arng,    (void*)&dcnt,   (void*)&chk,
                  (void*)&cnt_out, (void*)&carry,   (void*)&scratch, (void*)&word,
                  (void*)&N,       (void*)&T,       (void*)&slots};
  const cudaError_t err = cudaLaunchCooperativeKernel(kernel, dim3(blocks), dim3(THREADS), args,
                                                      bytes, (cudaStream_t)stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int hk_scratch_ints(int N) { return episode::scratch_ints(N); }

// K3's scratch: the ticket and one look-back word per tile, 64-bit each.
int hk_step_scratch_ints(int N) { return 2 * ((N + K3_WORLDS - 1) / K3_WORLDS + 1); }

int hk_step(const int* cfg, int cfg_ints, const int32_t* st_in, const int8_t* obs_in,
            const int8_t* own_in, const bool* mask_in, const int32_t* act,
            const int64_t* cnt_in, const uint32_t* tab, int32_t* st_out, int8_t* obs_out,
            int8_t* own_out, bool* mask_out, int32_t* rew, bool* done, int64_t* cnt_out,
            int* scratch, int N, int device, void* stream) {
  Cfg c;
  if (!make_cfg(cfg, cfg_ints, &c)) return ERR_BAD_CONFIG;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const int tiles = (N + K3_WORLDS - 1) / K3_WORLDS;
  const int bytes = k3_smem(c, value_stride(c)).bytes;
  if (bytes > 48 * 1024) {
    err = cudaFuncSetAttribute((const void*)hk_step_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return (int)err;
  }
  cudaStream_t s = (cudaStream_t)stream;
  // a zero ticket and no published tile, for every launch
  err = cudaMemsetAsync(scratch, 0, sizeof(unsigned long long) * (tiles + 1), s);
  if (err != cudaSuccess) return (int)err;
  hk_step_kernel<<<tiles, K3_THREADS, bytes, s>>>(
      c, st_in, reinterpret_cast<const uint8_t*>(obs_in), reinterpret_cast<const uint8_t*>(own_in),
      reinterpret_cast<const uint8_t*>(mask_in), act, cnt_in, tab, st_out,
      reinterpret_cast<uint8_t*>(obs_out), reinterpret_cast<uint8_t*>(own_out),
      reinterpret_cast<uint8_t*>(mask_out), rew, done, cnt_out,
      reinterpret_cast<unsigned long long*>(scratch), N);
  return (int)cudaGetLastError();
}

// Ints of the envelope word for a state of `rows` rows.
int hk_envelope_ints(int rows) { return envelope_ints(rows); }

// A zeroed envelope word for a state of `rows` rows in pinned host memory
// mapped into the device's address space: *host for the host, *dev for the
// kernel.  Held for the life of the process (ops/hanabi.py keeps one per
// config and device).
int hk_envelope_record(int rows, int device, void** host, void** dev) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const size_t bytes = sizeof(int) * (size_t)envelope_ints(rows);
  err = cudaHostAlloc(host, bytes, cudaHostAllocMapped | cudaHostAllocPortable);
  if (err != cudaSuccess) return (int)err;
  std::memset(*host, 0, bytes);
  return (int)cudaHostGetDevicePointer(dev, *host, 0);
}

int hk_carry_bytes(const int* cfg, int cfg_ints) {
  Cfg c;
  if (!make_cfg(cfg, cfg_ints, &c)) return ERR_BAD_CONFIG;
  if (rollout_config<5, 5>(c)) return Rec<5, 5>::BYTES;
  if (rollout_config<2, 5>(c)) return Rec<2, 5>::BYTES;
  if (rollout_config<1, 5>(c)) return Rec<1, 5>::BYTES;
  return ERR_BAD_CONFIG;
}

// K4.  tab: the envelope's [2, rows] table on the device; word: the device
// address of the envelope word (hk_envelope_record), which a launch whose
// entry state leaves the envelope fills (see the header).
int hk_rollout(const int* cfg, int cfg_ints, const int32_t* st_in, const int8_t* obs_in,
               const int8_t* own_in, const bool* mask_in, const int32_t* arng_in,
               const int64_t* cnt_in, const int* tab, int32_t* st, int32_t* arng,
               int32_t* dcnt, int32_t* chk, int64_t* cnt_out, uint8_t* carry, int* scratch,
               int* word, int N, int T, int device, void* stream) {
  Cfg c;
  if (!make_cfg(cfg, cfg_ints, &c)) return ERR_BAD_CONFIG;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
#define HK_ROLLOUT(C, R)                                                                      \
  if (rollout_config<C, R>(c))                                                                \
    return launch_rollout<C, R>(c, st_in, obs_in, own_in, mask_in, arng_in, cnt_in, tab, st,  \
                                arng, dcnt, chk, cnt_out, carry, scratch, word, N, T, device, \
                                stream);
  HK_ROLLOUT(5, 5)
  HK_ROLLOUT(2, 5)
  HK_ROLLOUT(1, 5)
#undef HK_ROLLOUT
  return ERR_BAD_CONFIG;
}

// Which K4 kernel hk_rollout launches for N worlds of the config on the
// device: *onchip = 1 for hk_rollout_onchip_kernel, 0 for hk_rollout_kernel.
int hk_rollout_onchip(const int* cfg, int cfg_ints, int N, int device, int* onchip) {
  Cfg c;
  if (!make_cfg(cfg, cfg_ints, &c)) return ERR_BAD_CONFIG;
  const cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const void* kernel = nullptr;
  int blocks = 0, slots = 0;
  size_t bytes = 0;
#define HK_ONCHIP(C, R)                                                               \
  if (rollout_config<C, R>(c)) {                                                      \
    const int rc = rollout_shape<C, R>(N, device, &kernel, &blocks, &slots, &bytes);  \
    *onchip = kernel == (const void*)hk_rollout_onchip_kernel<C, R>;                  \
    return rc;                                                                        \
  }
  HK_ONCHIP(5, 5)
  HK_ONCHIP(2, 5)
  HK_ONCHIP(1, 5)
#undef HK_ONCHIP
  return ERR_BAD_CONFIG;
}

int hk_legal(const int* cfg, int cfg_ints, const int32_t* cards, const int32_t* size,
             const int32_t* info, bool* out, int N, int device, void* stream) {
  MaskCfg m;
  if (!make_mask_cfg(cfg, cfg_ints, &m)) return ERR_BAD_CONFIG;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  // the games of 2 to 5 players, each with its own compile-time shape; any
  // other player count (JAX's Env also plays 6 and 7) reads it at run time
  if (m.H == hand_of(m.P)) switch (m.P) {
      case 2: return launch_mask<2>(m, cards, size, info, out, N, stream);
      case 3: return launch_mask<3>(m, cards, size, info, out, N, stream);
      case 4: return launch_mask<4>(m, cards, size, info, out, N, stream);
      case 5: return launch_mask<5>(m, cards, size, info, out, N, stream);
    }
  return launch_mask<0>(m, cards, size, info, out, N, stream);
}

const char* hk_error_string(int err) {
  if (err == ERR_BAD_CONFIG) return "config outside the kernels' envelope";
  return episode::error_string(err);
}

}  // extern "C"
