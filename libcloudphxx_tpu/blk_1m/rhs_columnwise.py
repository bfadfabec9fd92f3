"""Column-wise (sedimentation) right-hand-side terms for blk_1m.

JAX equivalent of reference include/libcloudph++/blk_1m/rhs_columnwise.hpp.
The reference walks each column top-down carrying an edge flux; here the walk
becomes shifted-array arithmetic over the whole grid at once (the vertical is
the LAST axis, index 0 = lowest level, matching the reference's
"begin() points to the lowest level" contract).
"""

import enum

import jax.numpy as jnp

from . import formulae
from .options import opts_t


class ice_t(enum.Enum):
    iceA = 0
    iceB = 1


def _sediment(dot_r, rhod, r, dz, momentum):
    """Upstream sedimentation given per-cell terminal momenta rhod*v
    (shared skeleton of reference rhs_columnwise.hpp:22-90 and :93-189).

    ``momentum[..., k]`` is rhod*v_term at cell k.  The downward flux through
    the bottom edge of cell k (k>=1) uses the edge-averaged momentum and the
    rain content of the cell above the edge; the bottom cell uses its mid-cell
    momentum.  Returns (dot_r updated, flux out of the domain [kg/m3/s],
    negative = downward)."""
    # flux out through the bottom edge of each cell
    edge = -0.5 * (momentum[..., :-1] + momentum[..., 1:]) * r[..., 1:] / dz
    bottom = -momentum[..., 0:1] * r[..., 0:1] / dz
    flux_out = jnp.concatenate([bottom, edge], axis=-1)
    # inflow from above = outflow of the cell above; zero above the top
    flux_in = jnp.concatenate(
        [flux_out[..., 1:], jnp.zeros_like(flux_out[..., 0:1])], axis=-1
    )
    dot_r = dot_r - (flux_in - flux_out) / rhod
    return dot_r, flux_out[..., 0]


def rhs_columnwise(opts: opts_t, dot_rr, rhod, rr, dz):
    """Rain sedimentation with Kessler/Beard terminal velocity
    (reference rhs_columnwise.hpp:22-90).
    Returns (dot_rr updated, surface rain flux [kg/m3/s], negative=down)."""
    if not opts.sedi:
        return dot_rr, jnp.zeros(jnp.shape(rr)[:-1], dtype=jnp.result_type(rr))
    rhod_0 = rhod[..., 0:1]
    momentum = rhod * formulae.v_term(rr, rhod, rhod_0)
    return _sediment(dot_rr, rhod, rr, dz, momentum)


def rhs_columnwise_ice(opts: opts_t, dot_ri, rhod, ri, dz, ice_type: ice_t):
    """Ice A/B sedimentation (reference rhs_columnwise.hpp:93-189).
    Returns (dot_ri updated, surface ice flux [kg/m3/s])."""
    if not opts.sedi:
        return dot_ri, jnp.zeros(jnp.shape(ri)[:-1], dtype=jnp.result_type(ri))
    if ice_type == ice_t.iceA:
        v = formulae.velocity_iceA(ri, rhod)
    else:
        v = formulae.velocity_iceB(ri, rhod)
    return _sediment(dot_ri, rhod, ri, dz, rhod * v)
