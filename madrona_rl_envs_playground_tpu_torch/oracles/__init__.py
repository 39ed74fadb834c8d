"""Pure-numpy oracles, the port's own copies of the JAX package's ``oracles/``
(``reference_mdp.py`` excepted: only its own JAX test uses it)."""
