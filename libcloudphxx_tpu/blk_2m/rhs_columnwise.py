"""Two-moment rain sedimentation.

JAX equivalent of reference include/libcloudph++/blk_2m/rhs_columnwise.hpp.
Separate mass- and number-weighted terminal momenta; each edge flux is capped
by the mass/number available in the donor cell within dt (including prior
cellwise tendencies), exactly as the reference.  The reference's top-down
walk vectorizes because each cap reads only the donor cell's *pre-existing*
tendency, not the sedimentation inflow.  Vertical = LAST axis, index 0 bottom.
"""

import jax.numpy as jnp

from . import formulae as f
from .options import opts_t


def rhs_columnwise(opts: opts_t, dot_rr, dot_nr, rhod, rr, nr, dt, dz):
    """(reference rhs_columnwise.hpp:22-155)
    Returns (dot_rr, dot_nr, surface rain-mass flux [kg/m3/s], negative=down)."""
    if not opts.sedi:
        zflux = jnp.zeros(jnp.shape(rr)[:-1], dtype=jnp.result_type(rr))
        return dot_rr, dot_nr, zflux

    mom_m = -rhod * f.v_term_m(rhod, rr, nr)
    mom_n = -rhod * f.v_term_n(rhod, rr, nr)

    def fluxes(mom, q, dot_q):
        # edge-averaged momentum below cell k (k>=1); bottom cell mid-cell
        edge = 0.5 * (mom[..., :-1] + mom[..., 1:]) * q[..., 1:] / dz
        bottom = mom[..., 0:1] * q[..., 0:1] / dz
        flux_out = jnp.concatenate([bottom, edge], axis=-1)
        # cap: a cell cannot lose more than it holds (plus what cellwise
        # tendencies add) within dt (rhs_columnwise.hpp:100-105)
        cap = rhod * (q + dt * dot_q) / dt
        flux_out = -jnp.minimum(-flux_out, cap)
        flux_in = jnp.concatenate(
            [flux_out[..., 1:], jnp.zeros_like(flux_out[..., 0:1])], axis=-1
        )
        return dot_q - (flux_in - flux_out) / rhod, flux_out[..., 0]

    dot_rr, surf_flux = fluxes(mom_m, rr, dot_rr)
    dot_nr, _ = fluxes(mom_n, nr, dot_nr)
    return dot_rr, dot_nr, surf_flux
