"""MAPPO configuration (the reference's ``train/config.py`` defaults).

Counterpart of ``madrona_rl_envs_playground_tpu/train/mappo/config.py``: one
dataclass with the reference's flag names and defaults (``use_valuenorm``
True and ``use_popart`` False, ppo_epoch 15, max_grad_norm 10.0, huber 10.0,
hidden 512 x layer_N 2 with ReLU and a feature LayerNorm, lr = critic_lr =
5e-4), and ``get_config()``, the same flags on an argparse parser.

Every field of the JAX config is here but ``rollout_backend``: in the port
the device decides, and the env's collector steps through its kernel on the
card and its plain version on the CPU.  The runner takes the device
instead.  JAX's ``n_eval_rollout_threads``, ``save_gifs``, ``ifi`` and
``n_render_rollout_threads`` are read by nothing (eval runs on the training
envs; render writes browser pages, not gifs), so they are no fields here:
the parser takes them at their defaults, for the reference's command lines,
and ``config_from_args`` refuses any other value.  ``COLAB_RECIPE`` is the
reference Colab's configuration on Overcooked2 ``simple``
(``scripts/mappo_train.py``), written once here.
"""

from __future__ import annotations

import argparse
import dataclasses

from ...models.mappo_nets import ModelConfig

# the reference Colab's args cell (overcooked_compiled_colab.ipynb): 800
# envs, episode 200, hidden 64 x 1 layer, lr 1e-2, ppo_epoch 7, 8M env-steps
# (50 updates)
COLAB_RECIPE = dict(n_rollout_threads=800, episode_length=200, hidden_size=64, layer_N=1,
                    lr=1e-2, critic_lr=1e-2, ppo_epoch=7, num_env_steps=8e6)

# the reference's flags that nothing reads, at their defaults
UNREAD_FLAGS = {"n_eval_rollout_threads": 1, "save_gifs": False, "ifi": 0.1,
                "n_render_rollout_threads": 1}


@dataclasses.dataclass(frozen=True)
class MAPPOConfig:
    # rollout
    episode_length: int = 200
    n_rollout_threads: int = 1
    num_env_steps: float = 10e6
    # network
    hidden_size: int = 512
    layer_N: int = 2
    use_ReLU: bool = True
    use_orthogonal: bool = True
    use_feature_normalization: bool = True
    gain: float = 0.01
    use_naive_recurrent_policy: bool = False
    use_recurrent_policy: bool = False
    recurrent_N: int = 1
    # the recurrent update's chunk length (the naive form trains whole
    # episodes); episode_length must be a multiple of it
    data_chunk_length: int = 10
    # grid-shaped [W, H, C] obs for the CNN base (Overcooked only)
    use_cnn_obs: bool = False
    # optimizer: Adam, or AdamW where weight_decay is set
    lr: float = 5e-4
    critic_lr: float = 5e-4
    opti_eps: float = 1e-5
    weight_decay: float = 0.0
    use_linear_lr_decay: bool = False
    # ppo
    ppo_epoch: int = 15
    clip_param: float = 0.2
    num_mini_batch: int = 1
    # minibatches as permuted timestep bands, which keep the env axis of a
    # mesh local
    shard_local_minibatch: bool = False
    entropy_coef: float = 0.01
    value_loss_coef: float = 1.0
    use_max_grad_norm: bool = True
    max_grad_norm: float = 10.0
    use_gae: bool = True
    gamma: float = 0.99
    gae_lambda: float = 0.95
    use_proper_time_limits: bool = False
    use_huber_loss: bool = True
    huber_delta: float = 10.0
    use_clipped_value_loss: bool = True
    use_popart: bool = False
    use_valuenorm: bool = True
    use_value_active_masks: bool = True
    use_policy_active_masks: bool = True
    # run
    seed: int = 1
    # with a run_dir, MAPPORunner.run saves every save_interval updates
    save_interval: int = 1
    log_interval: int = 5
    # periodic deterministic eval during training (runner.evaluate);
    # eval_episodes is a total episode budget spread over the training envs
    use_eval: bool = False
    eval_interval: int = 25
    eval_episodes: int = 32
    # render after training (scripts/torch_mappo_train.py): browser replay
    # pages of render_episodes horizons for Overcooked, a trajectory JSON
    # elsewhere
    use_render: bool = False
    render_episodes: int = 5

    def model_config(self) -> ModelConfig:
        return ModelConfig(
            hidden_size=self.hidden_size,
            layer_N=self.layer_N,
            use_relu=self.use_ReLU,
            use_orthogonal=self.use_orthogonal,
            use_feature_normalization=self.use_feature_normalization,
            gain=self.gain,
            use_recurrent_policy=(self.use_recurrent_policy
                                  or self.use_naive_recurrent_policy),
            recurrent_N=self.recurrent_N,
            use_popart=self.use_popart,
        )


def get_config() -> argparse.ArgumentParser:
    """Argparse mirror of the reference ``train/config.py:get_config``."""
    p = argparse.ArgumentParser(description="MAPPO (PyTorch port)")
    defaults = {f.name: f.default for f in dataclasses.fields(MAPPOConfig)}
    for name, default in {**defaults, **UNREAD_FLAGS}.items():
        if isinstance(default, bool):
            p.add_argument("--" + name, dest=name,
                           action="store_false" if default else "store_true")
            p.set_defaults(**{name: default})
        else:
            p.add_argument("--" + name, type=type(default), default=default)
    # env selection flags from the reference trainer surface
    p.add_argument("--env_name", type=str, default="overcooked")
    p.add_argument("--over_layout", type=str, default="simple")
    p.add_argument("--run_dir", type=str, default="runs/mappo")
    p.add_argument("--model_dir", type=str, default=None)
    return p


def config_from_args(args) -> MAPPOConfig:
    for name, default in UNREAD_FLAGS.items():
        if getattr(args, name, default) != default:
            raise ValueError(f"--{name} is read by nothing in the port (eval runs on the "
                             "training envs; --use_render writes browser pages, not gifs)")
    return MAPPOConfig(**{f.name: getattr(args, f.name) for f in dataclasses.fields(MAPPOConfig)})
