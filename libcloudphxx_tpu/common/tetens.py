"""Tetens saturation formulas.

JAX equivalent of reference include/libcloudph++/common/tetens.hpp.
"""

import jax.numpy as jnp


def p_vs(T):
    """Tetens saturation vapour pressure [Pa] (reference tetens.hpp:13-23)."""
    T_C = T - 273.15
    return 6.1078e2 * jnp.exp(17.27 * T_C / (T_C + 237.3))


def r_vs(T, p):
    """Tetens saturation mixing ratio (tetens.hpp:25-36)."""
    T_C = T - 273.15
    return 380.0 / (p * jnp.exp(-17.2693882 * T_C / (T - 35.86)) - 610.9)
