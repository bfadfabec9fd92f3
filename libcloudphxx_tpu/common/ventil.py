"""Ventilation coefficients (Smolik et al. 2001).

JAX equivalent of reference include/libcloudph++/common/ventil.hpp.
"""

import jax.numpy as jnp



def Re(v_term, r_w, rho, eta):
    """Reynolds number of a droplet at terminal velocity
    (reference ventil.hpp:12-24)."""
    return v_term * (2.0 * r_w) * rho / eta


def Nu(Pr, Re):
    """Nusselt number (ventil.hpp:26-44)."""
    return 1.0 + jnp.cbrt(1.0 + Re * Pr) * jnp.maximum(1.0, Re ** 0.077)


def Sh(Sc, Re):
    """Sherwood number (ventil.hpp:46-56)."""
    return Nu(Sc, Re)


def Sc(eta, rho, D):
    """Schmidt number (ventil.hpp:58-68)."""
    return eta / rho / D


def Pr(eta, c_p, K):
    """Prandtl number (ventil.hpp:70-80)."""
    return c_p * eta / K
