"""Mean free paths for vapour diffusion and heat conduction.

JAX equivalent of reference include/libcloudph++/common/mean_free_path.hpp
(Williams & Loyalka 1991 eqs. 6.6 and 6.33).
"""

import jax.numpy as jnp

from . import constants as c


def lambda_D(T):
    """Condensation mean free path [m] (reference mean_free_path.hpp:14-30)."""
    return 2.0 * c.D_0 / jnp.sqrt(2.0 * c.R_v * T)


def lambda_K(T, p):
    """Thermal mean free path [m] (mean_free_path.hpp:32-51)."""
    return 0.8 * (c.K_0 * T / p) / jnp.sqrt(2.0 * c.R_d * T)
