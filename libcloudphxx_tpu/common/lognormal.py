"""Lognormal aerosol size distributions (Seinfeld & Pandis 1997 eqs 7.33-7.34).

JAX equivalent of reference include/libcloudph++/common/lognormal.hpp.
"""

import jax.numpy as jnp


def n_e(mean_r, stdev, n_tot, lnr):
    """dN/dln(r) [m^-3] (reference lognormal.hpp:24-37)."""
    ln_sdev = jnp.log(stdev)
    return (
        n_tot
        * jnp.exp(-((lnr - jnp.log(mean_r)) ** 2) / (2 * ln_sdev**2))
        / ln_sdev
        / jnp.sqrt(2 * jnp.pi)
    )


def n(mean_r, stdev, n_tot, r):
    """dN/dr [m^-4] (lognormal.hpp:39-52)."""
    ln_sdev = jnp.log(stdev)
    return (
        n_tot
        / r
        * jnp.exp(-(jnp.log(r / mean_r) ** 2) / (2 * ln_sdev**2))
        / ln_sdev
        / jnp.sqrt(2 * jnp.pi)
    )
