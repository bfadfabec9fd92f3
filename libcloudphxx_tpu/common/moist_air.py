"""Moist-air thermodynamic relations.

JAX equivalent of reference include/libcloudph++/common/moist_air.hpp.
All functions are pure, elementwise over jnp arrays, dtype-preserving.
"""

import jax.numpy as jnp

from . import constants as c


def mix(dry, vap, r):
    """Mass-mixing-ratio mixing rule for extensive quantities
    (reference moist_air.hpp:55-62)."""
    return (dry + r * vap) / (1 + r)


def R(r):
    """Gas constant of moist air [J/K/kg] (moist_air.hpp:64-70)."""
    return mix(c.R_d, c.R_v, r)


def c_p(r):
    """Specific heat capacity of moist air [J/K/kg] (moist_air.hpp:72-78)."""
    return mix(c.c_pd, c.c_pv, r)


def p_v(p, r):
    """Water-vapour partial pressure [Pa] (moist_air.hpp:80-88)."""
    return p * r / (r + c.eps)


def D(T, p):
    """Vapour diffusivity in air [m2/s], Tracy/Welch/Porter 1980
    (moist_air.hpp:93-109)."""
    p_0 = 100000.0
    T_0 = 273.15
    return c.D_0 * (T / T_0) ** 1.81 * (p_0 / p)


def rho_to_rhod(rho, rv):
    """Dry-air density from total density and vapour mixing ratio."""
    return rho / (1 + rv)
