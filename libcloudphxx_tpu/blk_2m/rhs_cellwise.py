"""Cell-wise right-hand side for the double-moment bulk scheme.

JAX equivalent of reference include/libcloudph++/blk_2m/rhs_cellwise.hpp.
The reference's per-cell chain (activation -> cond/evap -> limiters ->
autoconversion -> accretion -> collision N sink) with its sequential
cloud/rain-limiter flags becomes a single branchless program over the grid:
each ``if``/flag turns into a boolean mask array threaded through the chain.
Functional: returns the six updated tendency arrays.
"""

import jax.numpy as jnp

from ..common import const_cp, theta_dry, theta_std
from ..common import constants as c
from . import formulae as f
from .options import opts_t


def _T_p(opts, th, rv, rhod, p):
    opts.validate_theta_convention()
    if opts.th_dry:
        T = theta_dry.T(th, rhod)
        p_full = theta_dry.p(rhod, rv, T)
    else:
        T = th * theta_std.exner(p)
        p_full = p
    return T, p_full


def rhs_cellwise(
    opts: opts_t,
    dot_th, dot_rv, dot_rc, dot_nc, dot_rr, dot_nr,
    rhod, th, rv, rc, nc, rr, nr,
    dt, p=None,
):
    """Morrison & Grabowski 2007 process chain (reference
    rhs_cellwise.hpp:21-300).  nc/nr are specific concentrations [1/kg].
    Returns (dot_th, dot_rv, dot_rc, dot_nc, dot_rr, dot_nr)."""
    T, p_full = _T_p(opts, th, rv, rhod, p)
    r_vs = const_cp.r_vs(T, p_full)

    zero = jnp.zeros_like(rv)
    l_rc, l_rr, l_nc, l_nr = zero, zero, zero, zero

    # --- activation (rhs_cellwise.hpp:144-168)
    if opts.acti and opts.dry_distros:
        n_ccn = zero
        for mode in opts.dry_distros:
            n_ccn = n_ccn + f.n_c_p(
                p_full, T, rv, mode.mean_rd, mode.sdev_rd, mode.N_stp,
                mode.chem_b, opts.RH_max,
            )
        act = f.activation_rate(n_ccn, nc, dt)
        act = jnp.where(rv > r_vs, act, 0.0)
        l_nc = l_nc + act
        l_rc = l_rc + act * f.ccnmass

    # --- condensation/evaporation (rhs_cellwise.hpp:170-199)
    if opts.cond:
        c_ok = (rc > f.rc_eps(rc)) & (nc > f.nc_eps(nc))
        rc_s = jnp.where(c_ok, rc, 1e-6)
        nc_s = jnp.where(c_ok, nc, 1e6)
        tau_c = f.tau_relax_c(T, p_full, f.r_drop_c(rc_s, nc_s, rhod), rhod * nc_s)
        l_rc = l_rc + jnp.where(c_ok, f.cond_evap_rate(T, p_full, rv, tau_c), 0.0)

        r_ok = (rr > f.rr_eps(rr)) & (nr > f.nr_eps(nr))
        rr_s = jnp.where(r_ok, rr, 1e-6)
        nr_s = jnp.where(r_ok, nr, 1e6)
        tau_r = f.tau_relax_r(T, rhod, rr_s, nr_s)
        evap_r = jnp.minimum(f.cond_evap_rate(T, p_full, rv, tau_r), 0.0)
        l_rr = l_rr + jnp.where(r_ok, evap_r, 0.0)
        # evaporation keeps the mean raindrop radius constant
        l_nr = l_nr + jnp.where(r_ok, evap_r * nr_s / rr_s, 0.0)

    # --- limiters (rhs_cellwise.hpp:201-219)
    cloud_lim = l_rc <= -rc / dt
    rain_lim = l_rr <= -rr / dt
    l_rc = jnp.maximum(l_rc, -rc / dt)
    l_rr = jnp.maximum(l_rr, -rr / dt)
    l_nr = jnp.maximum(l_nr, -nr / dt)
    l_nc = jnp.where(cloud_lim, -nc / dt, l_nc)
    l_nr = jnp.where(rain_lim, -nr / dt, l_nr)

    dot_rv = dot_rv - (l_rc + l_rr)
    dot_th = dot_th - (l_rc + l_rr) * theta_dry.d_th_d_rv(T, th)
    dot_rc = dot_rc + l_rc
    dot_rr = dot_rr + l_rr
    dot_nc = dot_nc + l_nc
    dot_nr = dot_nr + l_nr

    # --- collisions, skipped where all cloud water evaporated
    # (rhs_cellwise.hpp:228-299)
    collide = ~cloud_lim
    l_rc, l_rr, l_nc, l_nr = zero, zero, zero, zero

    if opts.acnv:
        a_ok = collide & (rc > f.rc_eps(rc)) & (nc > f.nc_eps(nc))
        rate = f.autoconv_rate(
            jnp.maximum(rc, 0.0), jnp.where(nc > 0, nc, 1.0), rhod,
            opts.acnv_A, opts.acnv_b, opts.acnv_c,
        )
        acnv_hits_cap = rate >= rc / dt
        rate = jnp.where(a_ok, jnp.minimum(rate, rc / dt), 0.0)
        l_rc = l_rc - rate
        l_rr = l_rr + rate
        # all fresh drizzle assumed at drizzle_radius (rhs_cellwise.hpp:252-255)
        l_nr = l_nr + rate / (
            4.0 / 3 * c.pi * c.rho_w * f.drizzle_radius**3
        )
        cloud_lim = cloud_lim | (a_ok & acnv_hits_cap)

    if opts.accr:
        k_ok = (
            collide & ~cloud_lim & ~rain_lim
            & (rc > f.rc_eps(rc)) & (nc > f.nc_eps(nc)) & (rr > f.rr_eps(rr))
        )
        rate = jnp.where(k_ok, f.accretion_rate(jnp.maximum(rc, 0.0), jnp.maximum(rr, 0.0)), 0.0)
        l_rc_new = l_rc - rate
        accr_hits_cap = l_rc_new <= -rc / dt
        l_rc = jnp.maximum(l_rc_new, -rc / dt)
        l_rr = l_rr + rate
        cloud_lim = cloud_lim | (k_ok & accr_hits_cap)

    if opts.acnv or opts.accr:
        # sink of nc combined for autoconversion + accretion
        # (KK2000 eq. 35; rhs_cellwise.hpp:272-295)
        s_ok = collide & ~cloud_lim & (nc > f.nc_eps(nc)) & (l_rr > f.rr_eps(rr))
        rdrop = f.r_drop_c(
            jnp.where(s_ok, rc, 1e-6), jnp.where(s_ok, nc, 1e6), rhod
        )
        sink = f.collision_sink_rate(l_rr, jnp.where(s_ok, rdrop, 1.0))
        sink = jnp.minimum(sink, nc / dt)
        l_nc = l_nc - jnp.where(s_ok, sink, 0.0)
        # if all cloud water was converted, zero out nc
        l_nc = jnp.where(collide & cloud_lim, -nc / dt, l_nc)

    dot_rc = dot_rc + jnp.where(collide, l_rc, 0.0)
    dot_rr = dot_rr + jnp.where(collide, l_rr, 0.0)
    dot_nc = dot_nc + jnp.where(collide, l_nc, 0.0)
    dot_nr = dot_nr + jnp.where(collide, l_nr, 0.0)
    return dot_th, dot_rv, dot_rc, dot_nc, dot_rr, dot_nr
