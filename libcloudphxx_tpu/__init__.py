"""libcloudphxx_tpu — a JAX cloud-microphysics framework.

Built from scratch in JAX/XLA/Pallas with the capabilities of
igfuw/libcloudph++ (see SURVEY.md): the blk_1m and blk_2m bulk schemes and
the Lagrangian super-droplet method (lgrngn), on a common physics
foundation, scaled over device meshes via jax.sharding.
"""

__version__ = "0.1.0"

from . import blk_1m, blk_2m, common, lgrngn, models, parallel

__all__ = ["blk_1m", "blk_2m", "common", "lgrngn", "models", "parallel", "__version__"]
