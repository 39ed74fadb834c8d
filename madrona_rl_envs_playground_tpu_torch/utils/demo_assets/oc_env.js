// Browser-side Overcooked environment — the JS twin of
// envs/overcooked_base.py (itself validated bit-for-bit against the
// reference author's python MDPs, oracles/reference_mdp.py).  Sequential
// id-order interact resolution, all-or-nothing collisions, v1/v2 rule
// variants, and the lossless [W*H*C] observation encoding the exported
// actor consumes.  Validated in-browser against env_vectors.json dumped
// from the JAX sim (see the self-check panel in play.html).
//
// Config object (layout.json): {variant, height, width, numPlayers,
// terrain (length H*W, codes below), startPos, placementInPotRew,
// dishPickupRew, soupPickupRew, recipeValues[16], recipeTimes[16],
// horizon}.
"use strict";

const OC = (() => {
  // object codes
  const O_NONE = 0, O_TOMATO = 1, O_ONION = 2, O_DISH = 3, O_SOUP = 4;
  // actions
  const A_NORTH = 0, A_SOUTH = 1, A_EAST = 2, A_WEST = 3, A_STAY = 4,
        A_INTERACT = 5;
  // terrain codes (shared); variant-specific codes resolved in the ctor
  const T_AIR = 0, T_POT = 1, T_COUNTER = 2, T_ONION_SRC = 3;
  const MAX_ING = 3;

  class OcEnv {
    constructor(cfg) {
      this.cfg = cfg;
      this.S = cfg.height * cfg.width;
      this.P = cfg.numPlayers;
      this.W = cfg.width;
      this.H = cfg.height;
      this.v1 = cfg.variant === "v1";
      // (tomato_source, dish_source, serving) per variant
      this.tTomato = this.v1 ? 4 : 6;
      this.tDish = this.v1 ? 5 : 4;
      this.tServe = this.v1 ? 6 : 5;
      this.K = this.v1 ? 16 : 10;
      this.C = 5 * this.P + this.K;
      this.numActions = 6;
      this.obsSize = this.S * this.C;
      this.reset();
    }

    reset() {
      const S = this.S, P = this.P;
      this.objName = new Int32Array(S);
      this.objOnions = new Int32Array(S);
      this.objTomatoes = new Int32Array(S);
      this.objTick = new Int32Array(S).fill(-1);
      this.pos = Int32Array.from(this.cfg.startPos);
      this.orient = new Int32Array(P);
      this.heldName = new Int32Array(P);
      this.heldOnions = new Int32Array(P);
      this.heldTomatoes = new Int32Array(P);
      this.heldTick = new Int32Array(P).fill(-1);
      this.timestep = 0;
      this.score = 0;
    }

    move(pos, dir) {
      const delta = [-this.W, this.W, 1, -1, 0, 0][dir];
      return ((pos + delta) % this.S + this.S) % this.S;
    }

    // One env step for all players.  actions: int array [P].
    // Returns {reward, done} (reward = shared summed reward, done at horizon;
    // the env auto-resets on done, like the fused batched step).
    step(actions) {
      const cfg = this.cfg, S = this.S, P = this.P, terr = cfg.terrain;
      let reward = 0;

      // pot occupancy snapshot before any interaction resolves
      let nPotsNonempty = 0;
      for (let s = 0; s < S; s++) {
        if (terr[s] === T_POT && this.objName[s] !== O_NONE &&
            (this.objTick[s] >= 0 ||
             this.objOnions[s] + this.objTomatoes[s] < MAX_ING))
          nPotsNonempty++;
      }

      for (let p = 0; p < P; p++) {
        if (actions[p] !== A_INTERACT) continue;
        const ipos = this.move(this.pos[p], this.orient[p]);
        const t = terr[ipos];
        const held = this.heldName[p], heldO = this.heldOnions[p],
              heldT = this.heldTomatoes[p], heldK = this.heldTick[p];
        const cn = this.objName[ipos], co = this.objOnions[ipos],
              ct = this.objTomatoes[ipos], ctk = this.objTick[ipos];

        const place = t === T_COUNTER && held !== O_NONE && cn === O_NONE;
        const take = t === T_COUNTER && held === O_NONE && cn !== O_NONE;
        const onionSrc = t === T_ONION_SRC && held === O_NONE;
        const tomatoSrc = t === this.tTomato && held === O_NONE;
        const dishSrc = t === this.tDish && held === O_NONE;

        // dish-pickup shaped reward gate (2-player rule, sim.cpp analog)
        let dishUseful = false;
        if (P === 2) {
          let nHeldDishes = 0;
          for (let q = 0; q < P; q++)
            if (this.heldName[q] === O_DISH) nHeldDishes++;
          let dishOnCounter = false;
          for (let s = 0; s < S; s++)
            if (terr[s] === T_COUNTER && this.objName[s] === O_DISH)
              dishOnCounter = true;
          dishUseful = !dishOnCounter && nHeldDishes < nPotsNonempty;
        }

        const atPot = t === T_POT;
        const cellTime = cfg.recipeTimes[4 * co + ct];
        const isSoup = cn === O_SOUP;
        const ready = isSoup && ctk >= 0 && ctk >= cellTime;
        const cooking = isSoup && ctk >= 0 && ctk < cellTime;

        const soupPick = atPot && held === O_DISH && ready;
        const ing = atPot && (held === O_ONION || held === O_TOMATO);
        // implicit soup creation on an empty pot
        const effOn = cn === O_NONE ? 0 : co;
        const effTo = cn === O_NONE ? 0 : ct;
        const effTk = cn === O_NONE ? -1 : ctk;
        const canAdd = !(effTk >= 0 || effOn + effTo === MAX_ING);
        const add = ing && canAdd;
        const newOn = effOn + (add && held === O_ONION ? 1 : 0);
        const newTo = effTo + (add && held === O_TOMATO ? 1 : 0);

        let startCook;
        if (this.v1) {
          startCook = atPot && held === O_NONE && isSoup && !cooking &&
                      !ready && co + ct > 0;
        } else {
          // fires even when the ingredient doesn't fit (poking a full idle
          // pot auto-starts it) — the trailing soup_to_be_cooked rule
          startCook = ing && effTk === -1 && newOn + newTo === MAX_ING;
        }

        const serve = t === this.tServe && held === O_SOUP;
        const deliverVal = cfg.recipeValues[4 * heldO + heldT];

        reward += (add ? cfg.placementInPotRew : 0) +
                  (soupPick ? cfg.soupPickupRew : 0) +
                  (dishSrc && dishUseful ? cfg.dishPickupRew : 0) +
                  (serve ? deliverVal : 0);

        // held-object update
        const drop = place || add || serve;
        const fresh = onionSrc || tomatoSrc || dishSrc;
        const freshName = onionSrc ? O_ONION : tomatoSrc ? O_TOMATO : O_DISH;
        const pickup = take || soupPick;
        this.heldName[p] = drop ? O_NONE : fresh ? freshName : pickup ? cn : held;
        this.heldOnions[p] = drop || fresh ? 0 : pickup ? co : heldO;
        this.heldTomatoes[p] = drop || fresh ? 0 : pickup ? ct : heldT;
        this.heldTick[p] = drop || fresh ? -1 : pickup ? ctk : heldK;

        // grid-cell update
        const clear = pickup;
        this.objName[ipos] = clear ? O_NONE : place ? held : add ? O_SOUP : cn;
        this.objOnions[ipos] = clear ? 0 : place ? heldO : add ? newOn : co;
        this.objTomatoes[ipos] = clear ? 0 : place ? heldT : add ? newTo : ct;
        this.objTick[ipos] = clear ? -1 : startCook ? 0
                           : place ? heldK : add ? effTk : ctk;
      }

      // movement: all-or-nothing collision rule
      const propPos = new Int32Array(P), propOr = new Int32Array(P);
      for (let p = 0; p < P; p++) {
        const a = actions[p];
        const isDir = a < A_STAY;
        const tgt = this.move(this.pos[p], a);
        propOr[p] = isDir ? a : this.orient[p];
        propPos[p] = (a === A_INTERACT || terr[tgt] !== T_AIR)
                   ? this.pos[p] : tgt;
      }
      let conflict = false;
      for (let i = 0; i < P; i++)
        for (let j = 0; j < P; j++) {
          if (i === j) continue;
          if (propPos[i] === propPos[j]) conflict = true;
          if (propPos[i] === this.pos[j] && this.pos[i] === propPos[j])
            conflict = true;
        }
      for (let p = 0; p < P; p++) {
        if (!conflict) this.pos[p] = propPos[p];
        this.orient[p] = propOr[p];
      }

      // environment effects: tick cooking pots, horizon
      this.timestep += 1;
      for (let s = 0; s < S; s++) {
        const cellTime = cfg.recipeTimes[4 * this.objOnions[s] + this.objTomatoes[s]];
        if (this.objName[s] === O_SOUP && this.objTick[s] >= 0 &&
            this.objTick[s] < cellTime)
          this.objTick[s] += 1;
      }
      const done = this.timestep >= cfg.horizon;
      this.score += reward;
      if (done) {
        const score = this.score;
        this.reset();
        this.score = score;  // cumulative across episodes for the HUD
      }
      return { reward, done };
    }

    // Lossless observation for observer i: Int8Array [W*H*C], flattened in
    // (x, y, c) order — exactly envs/overcooked_base.py encode().
    encode(i) {
      const cfg = this.cfg, S = this.S, P = this.P, K = this.K, C = this.C;
      const W = this.W, H = this.H, shift = 5 * P, terr = cfg.terrain;
      // [S, C] scratch in y-major cell order, remapped to x-major at the end
      const grid = new Int32Array(S * C);
      const at = (s, c) => s * C + c;

      // player block: presence channel ch(i,j), orientation P + 4*ch + or
      for (let j = 0; j < P; j++) {
        const c1 = j === i ? 0 : (j < i ? j + 1 : j);
        grid[at(this.pos[j], c1)] += 1;
        grid[at(this.pos[j], P + 4 * c1 + this.orient[j])] += 1;
      }

      // object block: terrain one-hot base
      for (let s = 0; s < S; s++)
        if (terr[s] > T_AIR) grid[at(s, shift + terr[s] - 1)] += 1;

      for (let s = 0; s < S; s++) {
        const name = this.objName[s], oo = this.objOnions[s],
              ot = this.objTomatoes[s], otk = this.objTick[s];
        const pot = terr[s] === T_POT, soup = name === O_SOUP;
        if (this.v1) {
          const idle = soup && pot && otk < 0;
          const live = soup && pot && otk >= 0;
          const off = soup && !pot;
          const tOf = cfg.recipeTimes[4 * oo + ot];
          if (idle) { grid[at(s, shift + 6)] += oo; grid[at(s, shift + 7)] += ot; }
          if (live || off) { grid[at(s, shift + 8)] += oo; grid[at(s, shift + 9)] += ot; }
          if (live) grid[at(s, shift + 10)] += tOf - otk;
          if ((live && otk >= tOf) || off) grid[at(s, shift + 11)] += 1;
          if (name === O_DISH) grid[at(s, shift + 12)] += 1;
          if (name === O_ONION) grid[at(s, shift + 13)] += 1;
          if (name === O_TOMATO) grid[at(s, shift + 14)] += 1;
        } else {
          if (soup && pot) {
            grid[at(s, shift + 5)] += oo;
            grid[at(s, shift + 6)] += Math.max(otk, 0);
          }
          if (soup && !pot) grid[at(s, shift + 7)] += 1;
          if (name === O_DISH) grid[at(s, shift + 8)] += 1;
          if (name === O_ONION) grid[at(s, shift + 9)] += 1;
        }
      }
      if (this.v1 && cfg.horizon - this.timestep < 40)
        for (let s = 0; s < S; s++) grid[at(s, shift + 15)] += 1;

      // held-object writes at the holder's cell
      for (let p = 0; p < P; p++) {
        const s = this.pos[p], hn = this.heldName[p];
        if (this.v1) {
          if (hn === O_SOUP) {
            grid[at(s, shift + 8)] += this.heldOnions[p];
            grid[at(s, shift + 9)] += this.heldTomatoes[p];
            grid[at(s, shift + 11)] += 1;
          }
          if (hn === O_DISH) grid[at(s, shift + 12)] += 1;
          if (hn === O_ONION) grid[at(s, shift + 13)] += 1;
          if (hn === O_TOMATO) grid[at(s, shift + 14)] += 1;
        } else {
          if (hn === O_SOUP) grid[at(s, shift + 7)] += 1;
          if (hn === O_DISH) grid[at(s, shift + 8)] += 1;
          if (hn === O_ONION) grid[at(s, shift + 9)] += 1;
        }
      }

      // (y-major cells, c) -> flattened (x, y, c)
      const obs = new Int8Array(this.obsSize);
      let f = 0;
      for (let x = 0; x < W; x++)
        for (let y = 0; y < H; y++)
          for (let c = 0; c < C; c++)
            obs[f++] = grid[at(y * W + x, c)];
      return obs;
    }

    // order-independent obs checksum, twin of demo_export._obs_digest
    obsDigest(i) {
      const obs = this.encode(i);
      let acc = 0;
      for (let f = 0; f < obs.length; f++)
        acc = (acc + obs[f] * ((f % 97) + 1)) % 1000000007;
      return acc;
    }

    // sparse state dump for the self-check differ
    dumpState() {
      const cells = [];
      for (let s = 0; s < this.S; s++)
        if (this.objName[s] !== 0)
          cells.push([s, this.objName[s], this.objOnions[s],
                      this.objTomatoes[s], this.objTick[s]]);
      return {
        pos: Array.from(this.pos), orient: Array.from(this.orient),
        held: Array.from(this.heldName),
        held_onions: Array.from(this.heldOnions),
        held_tomatoes: Array.from(this.heldTomatoes),
        held_tick: Array.from(this.heldTick),
        cells, t: this.timestep,
      };
    }
  }

  return { OcEnv, O_NONE, O_TOMATO, O_ONION, O_DISH, O_SOUP,
           A_NORTH, A_SOUTH, A_EAST, A_WEST, A_STAY, A_INTERACT,
           T_AIR, T_POT, T_COUNTER, T_ONION_SRC };
})();
