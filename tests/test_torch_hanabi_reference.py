"""The benchmark's plain Hanabi reference (``port_bench/reference/hanabi.py``,
``hanabi_ppo.py``) and K3's yardstick (``port_bench/yardstick_hanabi.py``)
against the port, on the CPU at small sizes.

* The plain game against the port's ``envs/hanabi.py`` through
  ``core/batch.py``, step for step on legal moves drawn from a seed: every
  output (obs, state obs, mask, active flags, reward, done), every state
  field and the episode counter, exactly, across resets; one case drains
  the deck by discards and reveals, no play costing a life, so the games
  end on their final turns; one prefers reveals that only dead slots match
  (the reveal scan's quirk) in the very_small game, whose deck is empty
  from the deal, so every play or discard shifts the hand down.
* The plain masked self-play against ``SelfPlayPPO`` on seeded random
  weights (very_small game, 2 x 16 towers, 2 updates), the reference
  following the program's actions: the step buffers exactly; the credited
  rewards exactly; the advantages, the losses and the parameters within
  float32 rounding of a few thousand sums.
* The credit and the masked GAE against the port's ``credit_rewards`` and
  ``active_masked_gae`` on random turn patterns.
* K3's frozen count against ``chip_smoke.py``'s ``hanabi_work``.

No JAX here: the port is the side held against the reference.
"""

import importlib.util
from pathlib import Path

import pytest
import torch

from madrona_rl_envs_playground_tpu_torch.core.batch import batched_reset, batched_step
from madrona_rl_envs_playground_tpu_torch.envs import hanabi as th
from madrona_rl_envs_playground_tpu_torch.train import cleanrl_ppo as t_ppo
from madrona_rl_envs_playground_tpu_torch.train import selfplay as t_selfplay
from port_bench import yardstick_hanabi
from port_bench.reference import hanabi as ref
from port_bench.reference import hanabi_ppo as ref_ppo
from port_bench.reference import ppo as plain_ppo

REPO = Path(__file__).resolve().parents[1]
CPU = torch.device("cpu")
OUTS = ("obs", "state_obs", "action_mask", "active", "reward", "done")


def _config(name):
    return {"game": dict(th.CONFIGS[name])}


def _dead_only_reveals(env, s, a):
    """[N, A] bool: seat ``a``'s reveals whose colour or rank only dead
    slots of the partner's hand hold (2 players)."""
    C, R, H = env.C, env.R, env.H
    q = (a + 1) % env.P
    cards = s.hand_cards[:, q]
    live = torch.arange(H) < s.hand_size[:, q, None]
    by_c = ref.onehot(cards // R, C)
    by_r = ref.onehot(cards % R, R)
    dead_c = (by_c & ~live[..., None]).any(1) & ~(by_c & live[..., None]).any(1)
    dead_r = (by_r & ~live[..., None]).any(1) & ~(by_r & live[..., None]).any(1)
    return torch.cat([torch.zeros(cards.shape[0], 2 * H, dtype=torch.bool), dead_c, dead_r], 1)


def _choose(gen, mask, prefer=None):
    """A uniform legal move per (world, seat) of the bool mask [N, P, A],
    among the ``prefer`` moves [N, P, A] where some are legal."""
    if prefer is not None:
        narrowed = mask & prefer
        mask = torch.where(narrowed.any(-1, keepdim=True), narrowed, mask)
    u = torch.rand(mask.shape, generator=gen)
    return torch.where(mask, u, -1.0).argmax(-1).to(torch.int32)


@pytest.mark.parametrize("name,n,steps,seed,prefer", [
    ("full", 24, 80, 0, None),
    ("full", 4, 110, 1, "discard"),
    ("small", 24, 80, 2, None),
    ("very_small", 24, 60, 3, "dead_reveal"),
])
def test_plain_game_matches_the_port_step_for_step(name, n, steps, seed, prefer):
    te, re_ = th.Env(**th.CONFIGS[name]), ref.make_env(_config(name))
    assert (re_.obs_size, re_.state_size, re_.num_actions) == (te.obs_size, te.state_size,
                                                               te.num_actions)
    bstate, out = batched_reset(te, n, device=CPU)
    s, counter, *outs = ref.reset(re_, n, CPU)
    gen = torch.Generator().manual_seed(seed)
    resets = dead_reveals = shifted = 0
    for t in range(steps + 1):
        got = (out.obs, out.state_obs, out.action_mask, out.active)
        for k, x, y in zip(OUTS, got, outs[:4]):
            assert torch.equal(x, y), (t, k)
        if t:
            assert torch.equal(out.reward, outs[4]) and torch.equal(out.done, outs[5]), t
        for f in ref.FIELDS:
            x, y = getattr(bstate.env_states, f), getattr(s, f)
            assert x.dtype == y.dtype and torch.equal(x, y), (t, f)
        assert int(bstate.episode_counter) == int(counter), t
        if t == steps:
            break
        pref = None
        if prefer == "discard":  # else a reveal, which frees the next discard
            pref = torch.zeros_like(out.action_mask)
            can = out.action_mask[..., :te.hand].any(-1, keepdim=True)
            pref[..., :te.hand] = can
            pref[..., 2 * te.hand:] = ~can
        elif prefer == "dead_reveal":
            pref = torch.stack([_dead_only_reveals(re_, s, a) for a in range(2)], 1)
        actions = _choose(gen, out.action_mask, pref)
        if prefer == "dead_reveal":
            acting = pref[torch.arange(n), s.cur_player.long()]
            dead_reveals += int(acting.gather(1, actions[torch.arange(n), s.cur_player.long(),
                                                         None].long()).sum())
        bstate, out = batched_step(te, bstate, actions)
        s, counter, *outs = ref.step(re_, s, counter, actions)
        resets += int(out.done.sum())
        shifted += int((s.hand_size < te.hand).sum())
    assert resets > 0
    if prefer == "dead_reveal":
        assert dead_reveals > 0 and shifted > 0


RECIPE = dict(num_steps=16, gamma=0.99, gae_lambda=0.95, update_epochs=2, num_minibatches=1,
              lr=1e-3, adam_eps=1e-5, ent_coef=0.01, vf_coef=0.5, clip_coef=0.2,
              max_grad_norm=0.5, hidden=16, num_layers=2, value_loss="clipped_mse")


def _selfplay_pair(seed, n=8):
    config = {"game": dict(th.CONFIGS["very_small"]), "recipe": dict(RECIPE),
              "precision": {"towers": "float32"}}
    env = th.Env(**th.CONFIGS["very_small"])
    widths = plain_ppo.towers(config, ref.make_env(config))
    params = plain_ppo.make_weights(widths, seed, CPU)
    cfg = t_selfplay.SelfPlayConfig(**{k: v for k, v in RECIPE.items() if k != "adam_eps"})
    trainer = t_selfplay.SelfPlayPPO(env, n, cfg, seed=seed, device=CPU)
    trainer.net.load_state_dict(params)
    plain = ref_ppo.PlainHanabiSelfPlay(config, n, params, seed, CPU)
    return trainer, plain, params


@pytest.mark.parametrize("seed", [11, 2**31 + 5])
def test_plain_masked_selfplay_matches_selfplayppo(seed):
    trainer, plain, params = _selfplay_pair(seed)
    kept = {}
    rollout, advantage, scans = trainer._rollout, trainer._advantage, trainer._scan_body

    def keep_rollout(*a):
        kept["rollout"] = out = rollout(*a)
        return out

    def keep_advantage(*a):
        kept["advantage"] = out = advantage(*a)
        return out

    def keep_scans(*a):
        kept["scans"] = out = scans(*a)
        return out

    trainer._rollout, trainer._advantage, trainer._scan_body = (keep_rollout, keep_advantage,
                                                                keep_scans)
    for u in range(2):
        m = trainer.train_step()
        _, _, tr = kept["rollout"]
        chunks, _ = kept["advantage"]
        rewards, _, _, trainable = kept["scans"]
        r = plain.update(tr["action"])
        assert r["action_gap"] < 1e-5, (u, r["action_gap"])
        assert torch.equal(r["obs_hash"], plain_ppo.obs_hash(tr["obs"])), u
        assert torch.equal(r["state_hash"], plain_ppo.obs_hash(tr["state_obs"])), u
        for k in ("mask", "active", "reward", "done"):
            assert torch.equal(r[k], tr[k]), (u, k)
        assert torch.equal(r["rewards"], rewards), u
        assert torch.equal(r["trainable"], trainable), u
        assert int(trainable.sum()) > 0 and not bool((trainable & ~tr["active"]).any())
        torch.testing.assert_close(r["values"], tr["value"], rtol=1e-5, atol=1e-6)
        torch.testing.assert_close(r["advantages"], chunks["advantages"][0], rtol=1e-4,
                                   atol=1e-4)
        prog = torch.stack([m[k] for k in ("pg_loss", "v_loss", "entropy", "approx_kl")])
        torch.testing.assert_close(r["losses"], prog, rtol=1e-4, atol=1e-6)
    for k, v in trainer.net.named_parameters():
        change_p, change_r = v.detach() - params[k], plain.params[k] - params[k]
        # Adam's steps are lr-sized wherever a gradient is not all but zero
        torch.testing.assert_close(change_p, change_r, rtol=0, atol=2e-5 + 0.01 * RECIPE["lr"])


def _turns(T, M, gen):
    """Random turn patterns of two-seat streams (world-major, seat minor):
    one seat of each world active a step, episodes ending at random."""
    N = M // 2
    cur = torch.randint(0, 2, (N,), generator=gen)
    active, dones = [], []
    for _ in range(T):
        act = torch.stack([cur == 0, cur == 1], 1).reshape(M)
        done = torch.rand(N, generator=gen) < 0.15
        active.append(act)
        dones.append(done[:, None].expand(N, 2).reshape(M))
        cur = torch.where(done, torch.zeros_like(cur), 1 - cur)
    return torch.stack(active), torch.stack(dones)


@pytest.mark.parametrize("seed", [0, 1])
def test_credit_and_masked_gae_match_the_ports(seed):
    gen = torch.Generator().manual_seed(seed)
    T, M = 24, 32
    active, dones = _turns(T, M, gen)
    rewards = torch.randint(-2, 3, (T, M), generator=gen).float()
    values = torch.randn((T, M), generator=gen)
    credited, slot_dones = t_selfplay.credit_rewards(rewards, active, dones)
    assert torch.equal(ref_ppo.credit(rewards, active, dones), credited)
    next_value = torch.randn(M, generator=gen)
    final_active = torch.rand(M, generator=gen) < 0.5
    next_done = torch.rand(M, generator=gen) < 0.2
    buf = t_ppo.Rollout(obs=None, states=None, actions=None, action_masks=None, logprobs=None,
                        rewards=credited, dones=slot_dones, active=active, values=values)
    adv, ret, trainable = t_ppo.active_masked_gae(buf, next_value, next_done, final_active,
                                                  0.99, 0.95)
    r_adv, r_ret, r_trainable = ref_ppo.masked_gae(credited, slot_dones, values, active,
                                                   next_value, next_done, final_active, 0.99,
                                                   0.95)
    assert torch.equal(r_trainable, trainable)
    torch.testing.assert_close(r_adv, adv, rtol=0, atol=1e-6)
    torch.testing.assert_close(r_ret, ret, rtol=0, atol=1e-6)


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke_counts", REPO / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("name,n", [("full", 1024), ("small", 8192)])
def test_k3_yardstick_counts_chip_smokes_work(name, n):
    cs = _chip_smoke()
    env = th.Env(**th.CONFIGS[name])
    assert yardstick_hanabi.k3_work(th.CONFIGS[name], n) == cs.hanabi_work(env, n, 0)
    assert yardstick_hanabi.state_rows(th.CONFIGS[name]) == \
        cs.ops("hanabi").row_offsets(env)["rows"]
    assert yardstick_hanabi.obs_size(th.CONFIGS[name]) == env.obs_size
