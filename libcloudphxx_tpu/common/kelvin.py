"""Kelvin (curvature) term in the Koehler equation.

JAX equivalent of reference include/libcloudph++/common/kelvin_term.hpp.
"""

import jax.numpy as jnp

from . import constants as c


def sg_surf(T):
    """Water-air surface tension [N/m], Eotvos rule
    (reference kelvin_term.hpp:23-29)."""
    return 0.07275 * (1.0 - 0.002 * (T - 291.0))


def A(T):
    """Kelvin curvature parameter [m] (kelvin_term.hpp:31-39)."""
    return 2 * sg_surf(T) / c.R_v / T / c.rho_w


def klvntrm(r, T):
    """Kelvin term exp(A/r) (kelvin_term.hpp:41-50)."""
    return jnp.exp(A(T) / r)
