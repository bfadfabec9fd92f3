"""kappa-Koehler hygroscopicity parameterisation (Petters & Kreidenweis 2007).

JAX equivalent of reference include/libcloudph++/common/kappa_koehler.hpp.
Root solves are batched fixed-iteration bracketing (ops/rootfind.py) rather
than the reference's per-element TOMS-748.
"""

import jax.numpy as jnp

from . import kelvin
from ..ops.rootfind import solve_bracketed


def rw3_eq_nokelvin(rd3, kappa, RH):
    """Equilibrium wet radius cubed, Kelvin term discarded
    (reference kappa_koehler.hpp:29-41)."""
    return rd3 * (1 - RH * (1 - kappa)) / (1 - RH)


def a_w(rw3, rd3, kappa):
    """Water activity in solution (kappa_koehler.hpp:44-54)."""
    return (rw3 - rd3) / (rw3 - rd3 * (1.0 - kappa))


def rw3_eq(rd3, kappa, RH, T, *, iters=32):
    """Equilibrium wet radius cubed with the Kelvin term, batched root solve
    (kappa_koehler.hpp:123-146).  RH must be < 1."""

    def minfun(rw3):
        return RH - a_w(rw3, rd3, kappa) * kelvin.klvntrm(jnp.cbrt(rw3), T)

    lo = rd3
    hi = rw3_eq_nokelvin(rd3, kappa, RH)
    out = solve_bracketed(minfun, lo, hi, iters=iters)
    # kappa == 0: insoluble, equilibrium at dry radius (kappa_koehler.hpp:139)
    return jnp.where(kappa == 0, rd3, out)


def rw3_cr(rd3, kappa, T, *, iters=48):
    """Critical (Koehler-maximum) wet radius cubed (kappa_koehler.hpp:148-169)."""

    def minfun(rw3):
        return (
            kelvin.A(T) * (rd3 - rw3) * ((kappa - 1) * rd3 + rw3)
            + 3 * kappa * rd3 * rw3 * jnp.cbrt(rw3)
        )

    return solve_bracketed(minfun, 1e0 * rd3, 1e8 * rd3, iters=iters)


def S_cr(rd3, kappa, T, *, iters=48):
    """Critical supersaturation S(r_cr) (kappa_koehler.hpp:171-191)."""
    rw3 = rw3_cr(rd3, kappa, T, iters=iters)
    return a_w(rw3, rd3, kappa) * kelvin.klvntrm(jnp.cbrt(rw3), T)
