"""Cell-wise right-hand-side terms for the single-moment bulk scheme.

JAX equivalent of reference include/libcloudph++/blk_1m/rhs_cellwise.hpp.
Functional style: each function returns updated copies of the tendency arrays
it would have accumulated into in the reference.
"""

import jax.numpy as jnp

from ..common import const_cp, constants as c, theta_dry
from . import formulae
from .adj_cellwise import _T_p
from .options import opts_t


def rhs_cellwise(opts: opts_t, dot_rc, dot_rr, rc, rr):
    """Kessler autoconversion + accretion (reference rhs_cellwise.hpp:17-75).
    Returns (dot_rc, dot_rr) updated."""
    rc_to_rr = jnp.zeros_like(rc)
    if opts.conv:
        rc_to_rr = rc_to_rr + formulae.autoconversion_rate(
            rc, opts.r_c0, opts.k_acnv
        )
    if opts.accr:
        rc_to_rr = rc_to_rr + formulae.collection_rate(rc, rr)
    return dot_rc - rc_to_rr, dot_rr + rc_to_rr


def rhs_cellwise_revap(
    opts: opts_t, dot_th, dot_rv, dot_rc, dot_rr,
    rhod, p, th, rv, rc, rr, dt,
):
    """Autoconversion/accretion plus rain evaporation as an explicit forcing
    (the Newton-Raphson-adjustment companion; reference
    rhs_cellwise.hpp:77-156).  Returns (dot_th, dot_rv, dot_rc, dot_rr)."""
    assert opts.adj_nwtrph, (
        "blk_1m: rhs_cellwise_revap requires Newton-Raphson in adj_cellwise"
    )
    dot_rc, dot_rr = rhs_cellwise(opts, dot_rc, dot_rr, rc, rr)

    T, p_full = _T_p(opts, th, rv, rhod, p)
    r_vs = const_cp.r_vs(T, p_full)
    rr_to_rv = formulae.evaporation_rate(rv, r_vs, rr, rhod, p_full) * dt
    rr_to_rv = jnp.minimum(rr / dt, rr_to_rv)

    dot_rv = dot_rv + rr_to_rv
    dot_rr = dot_rr - rr_to_rv
    dot_th = dot_th + theta_dry.d_th_d_rv(T, th) * rr_to_rv
    return dot_th, dot_rv, dot_rc, dot_rr


def rhs_cellwise_ice(
    opts: opts_t, dot_th, dot_rv, dot_rc, dot_rr, dot_ria, dot_rib,
    rhod, p, th, rv, rc, rr, ria, rib, dt,
):
    """Grabowski-1999 ice A/B processes on top of the warm-rain rhs
    (reference rhs_cellwise.hpp:158-424).
    Returns (dot_th, dot_rv, dot_rc, dot_rr, dot_ria, dot_rib)."""
    if opts.adj_nwtrph:
        dot_th, dot_rv, dot_rc, dot_rr = rhs_cellwise_revap(
            opts, dot_th, dot_rv, dot_rc, dot_rr,
            rhod, p, th, rv, rc, rr, dt,
        )
    else:
        dot_rc, dot_rr = rhs_cellwise(opts, dot_rc, dot_rr, rc, rr)

    T, p_full = _T_p(opts, th, rv, rhod, p)
    rvs = const_cp.r_vs(T, p_full)
    rvsi = const_cp.r_vsi(T, p_full)

    zero = jnp.zeros_like(rv)
    rv_to_ria = zero
    rv_to_rib = zero
    rc_to_ria = zero
    rc_to_rib = zero
    rr_to_rib = zero
    ria_to_rib = zero
    ria_to_rr = zero
    rib_to_rr = zero

    if opts.hetA:
        rc_to_ria = rc_to_ria + formulae.het_A_nucleation(ria, rc, T, rhod, dt)
    if opts.homA1:
        rv_to_ria = rv_to_ria + formulae.hom_A_nucleation_1(rv, rvs, rvsi, T, dt)
    if opts.homA2:
        rc_to_ria = rc_to_ria + formulae.hom_A_nucleation_2(rc, T, dt)
    if opts.hetB:
        rr_to_rib = rr_to_rib + formulae.het_B_nucleation_1(rr, ria, T, rhod)
        ria_to_rib = ria_to_rib + formulae.het_B_nucleation_2(rr, ria, T, rhod)
    if opts.melA:
        ria_to_rr = ria_to_rr + formulae.melting_A(ria, T, rhod, dt)
    if opts.melB:
        rib_to_rr = rib_to_rr + formulae.melting_B(rib, T, rhod, dt)
    if opts.depA:
        rv_to_ria = rv_to_ria + formulae.deposition_A(ria, rv, rvs, rvsi, T, rhod)
    if opts.rimA:
        rc_to_ria = rc_to_ria + formulae.riming_A(ria, rc, rv, rvs, rvsi, T, rhod)
    if opts.depB:
        rv_to_rib = rv_to_rib + formulae.deposition_B(rib, rv, rvs, rvsi, T, rhod)
    if opts.rimB:
        rc_to_rib = rc_to_rib + formulae.riming_B_1(
            rib, rc, rr, rv, rvs, rvsi, T, rhod
        )
        rr_to_rib = rr_to_rib + formulae.riming_B_2(
            rib, rc, rr, rv, rvs, rvsi, T, rhod
        )

    # rate limiting: no source may exhaust its reservoir within dt
    # (rhs_cellwise.hpp:392-400)
    rv_to_ria = jnp.minimum(rv / dt, rv_to_ria)
    rv_to_rib = jnp.minimum(rv / dt, rv_to_rib)
    rc_to_ria = jnp.minimum(rc / dt, rc_to_ria)
    rc_to_rib = jnp.minimum(rc / dt, rc_to_rib)
    rr_to_rib = jnp.minimum(rr / dt, rr_to_rib)
    ria_to_rib = jnp.minimum(ria / dt, ria_to_rib)
    ria_to_rr = jnp.minimum(ria / dt, ria_to_rr)
    rib_to_rr = jnp.minimum(rib / dt, rib_to_rr)

    dot_rc = dot_rc - rc_to_ria - rc_to_rib
    dot_rv = dot_rv - rv_to_ria - rv_to_rib
    dot_rr = dot_rr + ria_to_rr - rr_to_rib + rib_to_rr
    dot_ria = dot_ria + rc_to_ria + rv_to_ria - ria_to_rib - ria_to_rr
    dot_rib = dot_rib + rr_to_rib + ria_to_rib + rv_to_rib + rc_to_rib - rib_to_rr
    # latent heating: sublimation for vapour pathways, freezing for the rest
    # (rhs_cellwise.hpp:411-415)
    dot_th = dot_th + th / T * const_cp.l_s(T) / c.c_pd * (rv_to_ria + rv_to_rib)
    dot_th = dot_th + th / T * const_cp.l_f(T) / c.c_pd * (
        rc_to_ria + rc_to_rib + rr_to_rib - rib_to_rr - ria_to_rr
    )
    return dot_th, dot_rv, dot_rc, dot_rr, dot_ria, dot_rib
