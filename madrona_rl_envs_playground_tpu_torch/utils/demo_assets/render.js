// Canvas renderer for the Overcooked browser demo — a dependency-free
// flat-shaded analog of the reference demo's sprite renderer
// (overcooked_demo/static/assets/*).  Draws terrain tiles, pots with
// ingredient/cook state, counters with objects, players with orientation
// and held items, and a HUD strip.
"use strict";

const OcRender = (() => {
  const TILE = 56;
  const COLORS = {
    air: "#f3e9d9", counter: "#b08d57", counterEdge: "#8a6b3f",
    pot: "#4a4a55", onionSrc: "#e8c46b", tomatoSrc: "#e4756b",
    dishSrc: "#dfe4ea", serve: "#7fb069",
    onion: "#e3b23c", tomato: "#d64545", dish: "#f5f6f8",
    soup: "#c98a3d", soupCooked: "#9a5d20",
    players: ["#1e6a9e", "#44956b", "#9e4a9e", "#c2762c"],
    text: "#2d2a26",
  };

  function tileKind(env, s) {
    const t = env.cfg.terrain[s];
    if (t === OC.T_AIR) return "air";
    if (t === OC.T_POT) return "pot";
    if (t === OC.T_COUNTER) return "counter";
    if (t === OC.T_ONION_SRC) return "onionSrc";
    if (t === env.tTomato) return "tomatoSrc";
    if (t === env.tDish) return "dishSrc";
    if (t === env.tServe) return "serve";
    return "air";
  }

  function drawObject(ctx, cx, cy, name, onions, tomatoes, tick, cookTime, r) {
    if (name === OC.O_ONION) {
      ctx.fillStyle = COLORS.onion;
      ctx.beginPath(); ctx.arc(cx, cy, r, 0, 7); ctx.fill();
    } else if (name === OC.O_TOMATO) {
      ctx.fillStyle = COLORS.tomato;
      ctx.beginPath(); ctx.arc(cx, cy, r, 0, 7); ctx.fill();
    } else if (name === OC.O_DISH) {
      ctx.fillStyle = COLORS.dish;
      ctx.strokeStyle = "#999";
      ctx.beginPath(); ctx.arc(cx, cy, r, 0, 7); ctx.fill(); ctx.stroke();
    } else if (name === OC.O_SOUP) {
      const done = tick >= 0 && tick >= cookTime;
      ctx.fillStyle = done ? COLORS.soupCooked : COLORS.soup;
      ctx.beginPath(); ctx.arc(cx, cy, r, 0, 7); ctx.fill();
      // ingredient pips
      const n = onions + tomatoes;
      for (let k = 0; k < n; k++) {
        ctx.fillStyle = k < onions ? COLORS.onion : COLORS.tomato;
        const a = -Math.PI / 2 + (k * 2 * Math.PI) / 3;
        ctx.beginPath();
        ctx.arc(cx + 0.45 * r * Math.cos(a), cy + 0.45 * r * Math.sin(a),
                r * 0.28, 0, 7);
        ctx.fill();
      }
    }
  }

  function draw(canvas, env) {
    const W = env.W, H = env.H, cfg = env.cfg;
    canvas.width = W * TILE;
    canvas.height = H * TILE + 34;
    const ctx = canvas.getContext("2d");
    ctx.fillStyle = "#fffdf8";
    ctx.fillRect(0, 0, canvas.width, canvas.height);

    for (let y = 0; y < H; y++)
      for (let x = 0; x < W; x++) {
        const s = y * W + x, px = x * TILE, py = y * TILE;
        const kind = tileKind(env, s);
        ctx.fillStyle = COLORS[kind === "pot" ? "counter" : kind];
        ctx.fillRect(px, py, TILE, TILE);
        ctx.strokeStyle = "#00000014";
        ctx.strokeRect(px + 0.5, py + 0.5, TILE - 1, TILE - 1);
        const cx = px + TILE / 2, cy = py + TILE / 2;

        if (kind === "pot") {
          ctx.fillStyle = COLORS.pot;
          ctx.beginPath(); ctx.arc(cx, cy, TILE * 0.36, 0, 7); ctx.fill();
        } else if (kind === "onionSrc" || kind === "tomatoSrc") {
          drawObject(ctx, cx, cy, kind === "onionSrc" ? OC.O_ONION : OC.O_TOMATO,
                     0, 0, -1, 0, TILE * 0.2);
        } else if (kind === "dishSrc") {
          drawObject(ctx, cx, cy, OC.O_DISH, 0, 0, -1, 0, TILE * 0.24);
        } else if (kind === "serve") {
          ctx.fillStyle = "#ffffffb0";
          ctx.font = `${TILE * 0.4}px sans-serif`;
          ctx.textAlign = "center"; ctx.textBaseline = "middle";
          ctx.fillText("✓", cx, cy);
        }

        // loose / pot objects
        const name = env.objName[s];
        if (name !== OC.O_NONE) {
          const oo = env.objOnions[s], ot = env.objTomatoes[s],
                tick = env.objTick[s];
          const cookTime = cfg.recipeTimes[4 * oo + ot];
          drawObject(ctx, cx, cy, name, oo, ot, tick, cookTime,
                     TILE * (kind === "pot" ? 0.26 : 0.22));
          if (kind === "pot" && name === OC.O_SOUP && tick >= 0 && tick < cookTime) {
            // cook progress arc
            ctx.strokeStyle = "#fff";
            ctx.lineWidth = 3;
            ctx.beginPath();
            ctx.arc(cx, cy, TILE * 0.34, -Math.PI / 2,
                    -Math.PI / 2 + (2 * Math.PI * tick) / cookTime);
            ctx.stroke();
            ctx.lineWidth = 1;
          }
        }
      }

    // players
    const dxy = [[0, -1], [0, 1], [1, 0], [-1, 0]];  // N,S,E,W
    for (let p = 0; p < env.P; p++) {
      const s = env.pos[p];
      const x = s % W, y = (s - x) / W;
      const cx = x * TILE + TILE / 2, cy = y * TILE + TILE / 2;
      ctx.fillStyle = COLORS.players[p % COLORS.players.length];
      ctx.beginPath(); ctx.arc(cx, cy, TILE * 0.3, 0, 7); ctx.fill();
      // facing marker
      const [dx, dy] = dxy[env.orient[p]];
      ctx.fillStyle = "#ffffffd0";
      ctx.beginPath();
      ctx.arc(cx + dx * TILE * 0.18, cy + dy * TILE * 0.18, TILE * 0.09, 0, 7);
      ctx.fill();
      // held object, offset toward facing
      if (env.heldName[p] !== OC.O_NONE) {
        const cookTime = env.cfg.recipeTimes[
          4 * env.heldOnions[p] + env.heldTomatoes[p]];
        drawObject(ctx, cx + dx * TILE * 0.34, cy + dy * TILE * 0.34,
                   env.heldName[p], env.heldOnions[p], env.heldTomatoes[p],
                   env.heldTick[p], cookTime, TILE * 0.14);
      }
    }

    // HUD
    ctx.fillStyle = COLORS.text;
    ctx.font = "14px sans-serif";
    ctx.textAlign = "left"; ctx.textBaseline = "middle";
    ctx.fillText(
      `t ${env.timestep}/${cfg.horizon}    score ${env.score}`,
      8, H * TILE + 17);
  }

  return { draw, TILE, COLORS };
})();
