"""Terminal fall velocity formulas.

JAX equivalent of reference include/libcloudph++/common/vterm.hpp.
The reference's radius-regime ``if`` branches become branchless ``jnp.where``
selects so every formula vectorizes over the whole droplet population.
"""

import jax.numpy as jnp

from . import constants as c
from . import kelvin


def visc(T):
    """Dynamic viscosity of air [Pa s], Rogers & Yau 1989 p. 102
    (reference vterm.hpp:20-31)."""
    T_over_T_tri = T / c.T_tri
    return 1.72e-5 * (393.0 / (T + 120.0)) * T_over_T_tri * jnp.sqrt(T_over_T_tri)


def _polyval_ascending(coeffs, x):
    """sum_i coeffs[i] * x**i (Horner, coefficients in ascending order)."""
    acc = jnp.zeros_like(x) + coeffs[-1]
    for coef in coeffs[-2::-1]:
        acc = acc * x + coef
    return acc


def vt_khvorostyanov(r, T, rhoa, eta, spherical=True):
    """Khvorostyanov & Curry 2002 terminal velocity [m/s]
    (reference vterm.hpp:36-106)."""
    # Best number, eq 2.7
    X = (32.0 / 3) * (c.rho_w - rhoa) / rhoa * c.g * r**3 / eta**2 * rhoa**2
    sqX = jnp.sqrt(X)
    root = jnp.sqrt(1.0 + 0.0902 * sqX)
    b = (0.0902 / 2) * sqX / ((root - 1.0) * root)
    a = (9.06 * 9.06 / 4) * (root - 1.0) ** 2 / X**b

    if spherical:
        # eq 3.1
        Av = (
            a
            * (eta / rhoa * 1e4) ** (1.0 - 2.0 * b)
            * ((4.0 / 3) * c.rho_w / rhoa * c.g * 1e2) ** b
        )
    else:
        # aspect ratio eq. 3.4 + table-1 alfa, eqs. 2.24-2.25
        lambda_half = 2.35e-3
        ksi = jnp.exp(-r / lambda_half) + (1.0 - jnp.exp(-r / lambda_half)) / (
            1.0 + r / lambda_half
        )
        alfa = jnp.pi / 6.0 * c.rho_w * ksi
        Av = (
            a
            * (eta / rhoa * 1e4) ** (1.0 - 2.0 * b)
            * (2.546479 * alfa / rhoa * c.g * 1e2) ** b
        )
    Bv = 3.0 * b - 1.0
    return Av * (2e2 * r) ** Bv / 1e2


# Beard 1977 sea-level polynomial coefficients (reference vterm.hpp:120-122)
_BEARD77_SMALL = (0.105035e2, 0.108750e1, -0.133245, -0.659969e-2)
_BEARD77_LARGE = (
    0.65639e1, -0.10391e1, -0.14001e1, -0.82736e0,
    -0.34277e0, -0.83072e-1, -0.10583e-1, -0.54208e-3,
)


def vt_beard77_v0(r):
    """Beard 1977 sea-level terminal velocity [m/s]
    (reference vterm.hpp:108-135)."""
    x = jnp.log(2 * 100 * r)
    y_s = _polyval_ascending(_BEARD77_SMALL, x)
    y_l = _polyval_ascending(_BEARD77_LARGE, x)
    y = jnp.where(r <= 20e-6, y_s, y_l)
    return jnp.exp(y) / 100.0


def vt_beard77_fact(r, p, rhoa, eta):
    """Beard 1977 altitude correction factor (reference vterm.hpp:137-166)."""
    eta_0 = 1.818e-5
    # small drops: slip-corrected Stokes scaling
    l_0 = 6.62e-8
    l = l_0 * (eta / eta_0) * jnp.sqrt(c.p_stp / p * c.rho_stp / rhoa)
    fact_small = (eta_0 / eta) * (1 + 1.255 * (l / r)) / (1 + 1.255 * (l_0 / r))
    # large drops
    eps_s = (eta_0 / eta) - 1
    eps_c = jnp.sqrt(c.rho_stp / rhoa) - 1
    fact_large = (
        1.104 * eps_s
        + ((1.058 * eps_c - 1.104 * eps_s) * (5.52 + jnp.log(2 * 100 * r)) / 5.01)
        + 1
    )
    return jnp.where(r <= 20e-6, fact_small, fact_large)


# Beard 1976 polynomial coefficients (reference vterm.hpp:197,210)
_BEARD76_MID = (
    -0.318657e1, 0.992696, -0.153193e-2, -0.987059e-3,
    -0.578878e-3, 0.855176e-4, -0.327815e-5,
)
_BEARD76_BIG = (
    -0.500015e1, 0.523778e1, -0.204914e1, 0.475294, -0.542819e-1, 0.238449e-2,
)


def vt_beard76(r, T, p, rhoa, eta):
    """Beard 1976 exact terminal velocity [m/s] (reference vterm.hpp:168-220)."""
    # slip correction (small & mid regimes)
    l = 6.62e-8 * (eta / 1.818e-5) * (c.p_stp / p) * jnp.sqrt(T / 293.15)
    C_ac = 1.0 + 1.255 * l / r

    # regime 1: r <= 9.5 um — Stokes with slip correction
    v_small = (c.rho_w - rhoa) * c.g / (4.5 * eta) * C_ac * r * r

    # regime 2: 9.5 um < r <= 503.5 um — Davies-number polynomial
    log_N_Da = jnp.log(
        jnp.maximum((32.0 / 3.0) * r**3 * rhoa * (c.rho_w - rhoa) * c.g / eta**2, 1e-30)
    )
    Y_mid = _polyval_ascending(_BEARD76_MID, log_N_Da)
    N_Re_mid = C_ac * jnp.exp(Y_mid)
    v_mid = eta * N_Re_mid / rhoa / 2.0 / r

    # regime 3: r > 503.5 um — Bond/property-number polynomial
    sg = kelvin.sg_surf(T)
    Bo = (16.0 / 3.0) * r * r * (c.rho_w - rhoa) * c.g / sg
    N_p = sg**3 * rhoa**2 / eta**4 / c.g / (c.rho_w - rhoa)
    X = jnp.log(jnp.maximum(Bo * N_p ** (1.0 / 6.0), 1e-30))
    Y_big = _polyval_ascending(_BEARD76_BIG, X)
    N_Re_big = N_p ** (1.0 / 6.0) * jnp.exp(Y_big)
    v_big = eta * N_Re_big / rhoa / 2.0 / r

    return jnp.where(
        r <= 9.5e-6, v_small, jnp.where(r <= 5.035e-4, v_mid, v_big)
    )
