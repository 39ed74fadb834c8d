// Interactive demo driver: seat controllers (exported actor / keyboard /
// random / stay), the game loop, and the in-browser validation panel that
// re-runs env_vectors.json (action + state + reward + obs-digest dumps from
// the JAX sim) through the JS env.  Analog of the reference demo's
// static/js/demo wiring (AI vs human seat selection, keyboard play).
"use strict";

let env = new OC.OcEnv(DEMO.layout);
let timer = null;
let pendingKey = OC.A_STAY;   // human action queued for the next tick

function seatMode(p) {
  const el = document.getElementById("seat" + p);
  return el ? el.value : "ai";
}

function sampleFrom(probs) {
  let u = Math.random();
  for (let i = 0; i < probs.length; i++) {
    u -= probs[i];
    if (u <= 0) return i;
  }
  return probs.length - 1;
}

function chooseAction(p) {
  const mode = seatMode(p);
  if (mode === "human") {
    const a = pendingKey;
    pendingKey = OC.A_STAY;
    return a;
  }
  if (mode === "random") return Math.floor(Math.random() * 6);
  if (mode === "stay") return OC.A_STAY;
  // AI seat
  if (!DEMO.model) return OC.A_STAY;
  const obs = env.encode(p);
  const probs = forward(DEMO.model, obs, null);
  return document.getElementById("greedy").checked
    ? sampleGreedy(probs) : sampleFrom(probs);
}

function tick() {
  const actions = [];
  for (let p = 0; p < env.P; p++) actions.push(chooseAction(p));
  const { reward, done } = env.step(actions);
  OcRender.draw(document.getElementById("game"), env);
  if (done && !document.getElementById("loop").checked) pause();
}

function play() {
  if (timer) return;
  const sps = Number(document.getElementById("speed").value);
  timer = setInterval(tick, 1000 / sps);
  document.getElementById("playbtn").textContent = "Pause";
}

function pause() {
  clearInterval(timer);
  timer = null;
  document.getElementById("playbtn").textContent = "Play";
}

function togglePlay() { timer ? pause() : play(); }

function resetGame() {
  pause();
  env = new OC.OcEnv(DEMO.layout);
  env.score = 0;
  OcRender.draw(document.getElementById("game"), env);
}

document.addEventListener("keydown", (e) => {
  const map = { ArrowUp: OC.A_NORTH, ArrowDown: OC.A_SOUTH,
                ArrowRight: OC.A_EAST, ArrowLeft: OC.A_WEST,
                " ": OC.A_INTERACT, ".": OC.A_STAY };
  if (e.key in map) {
    pendingKey = map[e.key];
    e.preventDefault();
  }
});

// --------------------------------------------------------------------------
// self-check: replay the JAX sim's recorded steps through the JS env
// --------------------------------------------------------------------------
function runSelfCheck() {
  const out = [];
  let failures = 0;

  if (DEMO.vectors) {
    const v = DEMO.vectors;
    const e2 = new OC.OcEnv(DEMO.layout);
    for (let t = 0; t < v.actions.length; t++) {
      const { reward } = e2.step(v.actions[t]);
      const got = e2.dumpState();
      const want = v.states[t];
      let bad = [];
      if (reward !== v.rewards[t]) bad.push(`reward ${reward}!=${v.rewards[t]}`);
      for (const k of ["pos", "orient", "held", "held_onions",
                       "held_tomatoes", "held_tick", "t"])
        if (JSON.stringify(got[k]) !== JSON.stringify(want[k]))
          bad.push(`${k} ${JSON.stringify(got[k])}!=${JSON.stringify(want[k])}`);
      if (JSON.stringify(got.cells) !== JSON.stringify(want.cells))
        bad.push("cells differ");
      for (let p = 0; p < e2.P; p++)
        if (e2.obsDigest(p) !== v.obs_digests[t][p])
          bad.push(`obs digest p${p}`);
      if (bad.length) {
        failures++;
        out.push(`step ${t}: ${bad.join("; ")}`);
      }
    }
    out.unshift(`env vectors: ${v.actions.length} steps, ` +
                `${failures === 0 ? "all match the JAX sim" : failures + " FAILURES"}`);
  } else out.push("no env_vectors in bundle");

  if (DEMO.model && DEMO.testvector) {
    const tv = DEMO.testvector;
    const probs = forward(DEMO.model, tv.obs, tv.action_mask);
    let maxerr = 0;
    for (let i = 0; i < probs.length; i++)
      maxerr = Math.max(maxerr, Math.abs(probs[i] - tv.expected_probs[i]));
    const ok = maxerr < 1e-4;
    if (!ok) failures++;
    out.push(`actor forward: max |Δprobs| = ${maxerr.toExponential(2)} ` +
             `(${ok ? "PASS" : "FAIL"})`);
  }

  const el = document.getElementById("selfcheck");
  el.textContent = (failures === 0 ? "PASS\n" : "FAIL\n") + out.join("\n");
  el.className = failures === 0 ? "ok" : "bad";
  return failures === 0;
}

window.addEventListener("load", () => {
  // seat selectors
  const seats = document.getElementById("seats");
  for (let p = 0; p < env.P; p++) {
    const label = document.createElement("label");
    label.textContent = ` P${p + 1} `;
    const sel = document.createElement("select");
    sel.id = "seat" + p;
    for (const m of ["ai", "human", "random", "stay"]) {
      const o = document.createElement("option");
      o.value = m;
      o.textContent = m === "ai" ? "AI agent" : m;
      if (!DEMO.model && m === "ai") o.disabled = true;
      sel.appendChild(o);
    }
    if (!DEMO.model) sel.value = p === 0 ? "human" : "random";
    label.appendChild(sel);
    seats.appendChild(label);
  }
  OcRender.draw(document.getElementById("game"), env);
  runSelfCheck();
});
