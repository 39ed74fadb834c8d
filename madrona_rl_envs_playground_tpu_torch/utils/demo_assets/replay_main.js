// Trajectory replay driver (analog of the reference's static/replay.html):
// the bundle's traj.json records the action sequence + per-step rewards from
// a JAX-sim rollout; the (validated) JS env re-simulates it, which makes
// every frame seekable AND cross-checks the recorded rewards live.
"use strict";

let stepIdx = 0;
let timer = null;
let env = null;
let mismatches = 0;

function simulateTo(n) {
  // deterministic env: re-run from the start for random access
  env = new OC.OcEnv(DEMO.layout);
  env.score = 0;
  mismatches = 0;
  for (let t = 0; t < n; t++) {
    const { reward } = env.step(DEMO.traj.actions[t]);
    if (reward !== DEMO.traj.rewards[t]) mismatches++;
  }
  stepIdx = n;
}

function refresh() {
  OcRender.draw(document.getElementById("game"), env);
  document.getElementById("stepSlider").value = stepIdx;
  document.getElementById("info").textContent =
    `step ${stepIdx}/${DEMO.traj.actions.length}` +
    (mismatches ? `  — ${mismatches} reward MISMATCHES vs the JAX trace`
                : "  — rewards match the JAX trace");
}

function stepOnce() {
  if (stepIdx >= DEMO.traj.actions.length) { pause(); return; }
  const { reward } = env.step(DEMO.traj.actions[stepIdx]);
  if (reward !== DEMO.traj.rewards[stepIdx]) mismatches++;
  stepIdx++;
  refresh();
}

function play() {
  if (timer) return;
  timer = setInterval(stepOnce, 1000 / Number(document.getElementById("speed").value));
  document.getElementById("playbtn").textContent = "Pause";
}
function pause() {
  clearInterval(timer); timer = null;
  document.getElementById("playbtn").textContent = "Play";
}
function togglePlay() { timer ? pause() : play(); }

window.addEventListener("load", () => {
  const slider = document.getElementById("stepSlider");
  slider.max = DEMO.traj.actions.length;
  slider.addEventListener("input", () => {
    pause();
    simulateTo(Number(slider.value));
    refresh();
  });
  simulateTo(0);
  refresh();
});
