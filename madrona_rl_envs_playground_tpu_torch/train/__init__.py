"""Training algorithms: the CleanRL-style PPO agent and self-play PPO."""

from .cleanrl_ppo import CleanPPOAgent, active_masked_gae
from .selfplay import SelfPlayConfig, SelfPlayPPO, credit_rewards

__all__ = [
    "CleanPPOAgent",
    "active_masked_gae",
    "SelfPlayConfig",
    "SelfPlayPPO",
    "credit_rewards",
]
