from .cleanrl import CleanRLNetwork, MLPTower, load_flax_params

__all__ = ["CleanRLNetwork", "MLPTower", "load_flax_params"]
