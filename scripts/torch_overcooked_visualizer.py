#!/usr/bin/env python3
"""ASCII visualizer for Overcooked rollouts on the port (counterpart of
``scripts/overcooked_visualizer.py``; reference:
``scripts/overcooked_visualizer_script.py`` and the JS demo's renderer).

    python3 scripts/torch_overcooked_visualizer.py --layout cramped_room --variant v2
    python3 scripts/torch_overcooked_visualizer.py --device cpu --steps 30 --fps 4

Renders one world of a random-action rollout as terminal frames decoded
from the simulator state, for v1 and v2 terrain.  The world steps through
the env's collector on ``--device`` (default the card: one K1 launch a
step), its state unpacked for each frame; the actions are JAX's draws
(``numpy.random.RandomState(seed)``), so the frames are JAX's.
"""

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402

TERRAIN_CHARS_V1 = {0: " ", 1: "P", 2: "X", 3: "O", 4: "T", 5: "D", 6: "S"}
TERRAIN_CHARS_V2 = {0: " ", 1: "P", 2: "X", 3: "O", 4: "D", 5: "S", 6: "T"}
OBJ_CHARS = {0: " ", 1: "t", 2: "o", 3: "d", 4: "s"}
ORIENT_ARROWS = "^v><"


def render(env, state, world: int) -> str:
    """World ``world`` of a batched ``State`` as text: the grid, then each
    player's orientation and held object."""
    tc = TERRAIN_CHARS_V1 if env.variant == "v1" else TERRAIN_CHARS_V2
    H, W = env.height, env.width
    host = lambda a: a[world].cpu().numpy()  # noqa: E731
    terr = np.asarray(env.terrain).reshape(H, W)
    obj = host(state.obj_name).reshape(H, W)
    tick = host(state.obj_tick).reshape(H, W)
    pos, orient, held = host(state.pos), host(state.orient), host(state.held_name)

    grid = [[tc[terr[y, x]] for x in range(W)] for y in range(H)]
    for y in range(H):
        for x in range(W):
            if obj[y, x] > 0:
                c = OBJ_CHARS[obj[y, x]]
                if obj[y, x] == 4 and tick[y, x] >= 0:
                    c = "S" if terr[y, x] == 1 else "s"
                grid[y][x] = c
    for p in range(env.num_players):
        y, x = divmod(int(pos[p]), W)
        grid[y][x] = str(p + 1)
    lines = ["".join(row) for row in grid]
    info = " ".join(
        f"p{p + 1}:{ORIENT_ARROWS[orient[p]]}{OBJ_CHARS[held[p]].strip() or '-'}"
        for p in range(env.num_players))
    return "\n".join(lines) + f"\n t={int(state.timestep[world])} {info}"


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--layout", default="cramped_room")
    p.add_argument("--variant", default="v1", choices=["v1", "v2"])
    p.add_argument("--horizon", type=int, default=50)
    p.add_argument("--steps", type=int, default=30)
    p.add_argument("--fps", type=float, default=0, help="0 = print all frames")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = p.parse_args(argv)

    import torch

    from madrona_rl_envs_playground_tpu_torch.core.batch import batched_reset
    from madrona_rl_envs_playground_tpu_torch.device import resolve_device
    from madrona_rl_envs_playground_tpu_torch.envs import overcooked, overcooked2
    from madrona_rl_envs_playground_tpu_torch.train.fused_collect import make_fused_collect

    dev = resolve_device(args.device)
    maker = overcooked.make if args.variant == "v1" else overcooked2.make
    env = maker(args.layout, horizon=args.horizon)
    collect = make_fused_collect(env, 1, dev)
    bstate, _ = batched_reset(env, 1, device=dev)
    carry = collect.pack(bstate)
    rs = np.random.RandomState(args.seed)
    frames = [render(env, bstate.env_states, 0)]
    print(frames[0])
    for _ in range(args.steps):
        a = rs.randint(0, 6, size=(1, env.num_players)).astype(np.int32)
        carry, _ = collect.step(carry, torch.from_numpy(a).to(dev))
        frames.append(render(env, collect.unpack(carry).env_states, 0))
        if args.fps:
            print("\033[2J\033[H" + frames[-1])
            time.sleep(1.0 / args.fps)
        else:
            print()
            print(frames[-1])
    return frames


if __name__ == "__main__":
    main()
