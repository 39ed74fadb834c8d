"""Checkpoints and scalar logging (counterpart of the JAX package's ``utils/``)."""
