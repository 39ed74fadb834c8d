"""MAPPO: config, buffer, policy, trainer (R_MAPPO) and runner (MainPlayer).

Counterpart of ``madrona_rl_envs_playground_tpu/train/mappo/``: the
feed-forward, recurrent (GRU) and CNN policies.
"""

from .buffer import MAPPOBuffer, after_update, chooseinsert, compute_returns, init_buffer, insert
from .config import COLAB_RECIPE, MAPPOConfig, config_from_args, get_config
from .policy import MAPPOPolicy
from .runner import MAPPORunner
from .trainer import RMAPPOTrainer, huber
from .valuenorm import (ValueNormState, init_valuenorm, popart_update, vn_copy_,
                        vn_denormalize, vn_normalize, vn_update)

__all__ = [
    "MAPPOBuffer", "after_update", "chooseinsert", "compute_returns", "init_buffer", "insert",
    "COLAB_RECIPE", "MAPPOConfig", "config_from_args", "get_config", "MAPPOPolicy",
    "MAPPORunner", "RMAPPOTrainer", "huber", "ValueNormState", "init_valuenorm",
    "popart_update", "vn_copy_", "vn_denormalize", "vn_normalize", "vn_update",
]
