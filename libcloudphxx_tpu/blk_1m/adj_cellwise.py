"""Saturation adjustment for the single-moment bulk scheme.

JAX equivalent of reference include/libcloudph++/blk_1m/adj_cellwise.hpp.
The reference loops per cell with either a Newton-Raphson iteration
(adj_cellwise.hpp:90-182) or an adaptive RK4 path integration driven by a
per-cell ``while`` (adj_cellwise.hpp:186-319).  Here both are whole-grid
batched: NR unrolls its (static) iteration count into one fused elementwise
program; RK4 becomes a ``lax.while_loop`` over the full arrays with a per-cell
active mask, so XLA compiles a single divergence-free program.

All functions are functional: they return updated copies of (th, rv, rc, rr).
"""

import jax
import jax.numpy as jnp

from ..common import const_cp, constants as c, theta_dry, theta_std
from . import formulae
from .options import opts_t


def _T_p(opts, th, rv, rhod, p):
    """Temperature/pressure from the two supported theta conventions
    (reference adj_cellwise.hpp:60-72)."""
    opts.validate_theta_convention()
    if opts.th_dry:   # variable pressure, dry theta
        T = theta_dry.T(th, rhod)
        p_full = theta_dry.p(rhod, rv, T)
    else:             # constant pressure, standard theta
        T = th * theta_std.exner(p)
        p_full = p
    return T, p_full


def adj_cellwise_nwtrph(opts: opts_t, rhod, p, th, rv, rc, dt):
    """Newton-Raphson saturation adjustment (reference adj_cellwise.hpp:90-182).

    Returns (th, rv, rc) updated.  ``nwtrph_iters`` is static, so the loop
    unrolls into straight-line code.
    """
    if not opts.cond:
        return th, rv, rc

    T, p_full = _T_p(opts, th, rv, rhod, p)
    exner = None if opts.th_dry else theta_std.exner(p)
    L0 = const_cp.l_v(T)

    drc = jnp.zeros_like(rv)
    rv_tmp = rv
    th_tmp = th
    T_tmp = T
    p_cur = p_full
    for _ in range(opts.nwtrph_iters):
        p_vs = const_cp.p_vs(T_tmp)
        L = const_cp.l_v(T_tmp)
        coeff = L * L0 / (c.c_pd * c.R_v) / (T_tmp * T_tmp) / (1 - p_vs / p_cur)
        r_vs = const_cp.r_vs(T_tmp, p_cur)
        drc = drc + (rv_tmp - r_vs) / (1 + coeff * r_vs)
        rv_tmp = rv - drc
        th_tmp = th + th_tmp / T_tmp * L0 / c.c_pd * drc
        if opts.th_dry:
            T_tmp = theta_dry.T(th_tmp, rhod)
            p_cur = theta_dry.p(rhod, rv_tmp, T_tmp)
        else:
            T_tmp = th_tmp * exner

    # limiting: cannot condense more vapour than present nor evaporate more
    # cloud water than present (adj_cellwise.hpp:171)
    drc = jnp.minimum(rv, jnp.maximum(-rc, drc))

    rv = rv - drc
    rc = rc + drc
    th = th + th / T * L0 / c.c_pd * drc
    return th, rv, rc


def _dth_drv(opts, th, rv, rhod, p):
    """d(theta)/d(rv) along the condensation path — the ODE rhs of
    reference adj_cellwise.hpp:21-105 (detail::rhs)."""
    T, _ = _T_p(opts, th, rv, rhod, p)
    return theta_dry.d_th_d_rv(T, th)


def adj_cellwise_rk4(opts: opts_t, rhod, p, th, rv, rc, rr, dt, max_iters=10_000):
    """RK4 path-integrated saturation adjustment
    (reference adj_cellwise.hpp:189-319).

    The reference steps each cell's (th, rv) along the saturation path in
    increments of at most r_eps/2, with cloud-then-rain evaporation limits,
    until |rv - r_vs| <= r_eps.  Here the whole grid advances together in a
    bounded ``lax.while_loop``; converged cells are masked out.
    Returns (th, rv, rc, rr) updated.
    """
    if not opts.cond:
        return th, rv, rc, rr

    r_eps = opts.r_eps

    # Kessler rain-evaporation cap, computed once per call
    # (adj_cellwise.hpp:244-251)
    T0, p_full0 = _T_p(opts, th, rv, rhod, p)
    rs0 = const_cp.r_vs(T0, p_full0)
    drr_max0 = jnp.where(
        (rs0 > rv) & (rr > 0) & opts.revp,
        dt * formulae.evaporation_rate(rv, rs0, rr, rhod, p_full0),
        0.0,
    )

    def cond_state(state):
        th, rv, rc, rr, drr_max, alive, it = state
        return jnp.logical_and(jnp.any(alive), it < max_iters)

    def active_mask(th, rv, rc, rr, drr_max, alive):
        T, p_full = _T_p(opts, th, rv, rhod, p)
        rs = const_cp.r_vs(T, p_full)
        excess = rv - rs
        incloud = rc > 0
        cond_on = excess > r_eps
        evap_on = (
            opts.cevp
            & (excess < -r_eps)
            & (incloud | (opts.revp & (rr > 0) & (drr_max > 0)))
        )
        return (cond_on | evap_on) & alive, excess, incloud

    def body(state):
        th, rv, rc, rr, drr_max, alive, it = state
        active, excess, incloud = active_mask(th, rv, rc, rr, drr_max, alive)

        # step size: at most r_eps/2 towards saturation
        # (adj_cellwise.hpp:276-281)
        drv = -jnp.sign(excess) * jnp.minimum(0.5 * r_eps, 0.5 * jnp.abs(excess))
        evap = excess < 0
        drv = jnp.where(
            evap & incloud, jnp.minimum(rc, drv), drv
        )
        drv = jnp.where(
            evap & ~incloud, jnp.minimum(drr_max, jnp.minimum(rr, drv)), drv
        )
        drv = jnp.where(active, drv, 0.0)

        # one classic RK4 step of d(th)/d(rv) over [rv, rv+drv]
        # (adj_cellwise.hpp:289-295 via boost::odeint::runge_kutta4)
        f = lambda th_, rv_: _dth_drv(opts, th_, rv_, rhod, p)
        k1 = f(th, rv)
        k2 = f(th + 0.5 * drv * k1, rv + 0.5 * drv)
        k3 = f(th + 0.5 * drv * k2, rv + 0.5 * drv)
        k4 = f(th + drv * k3, rv + drv)
        th = th + drv / 6.0 * (k1 + 2 * k2 + 2 * k3 + k4)
        rv = rv + drv

        # attribute the change to cloud or rain water
        # (adj_cellwise.hpp:305-318)
        to_cloud = (excess > 0) | incloud
        rc = jnp.where(active & to_cloud, rc - drv, rc)
        rain_evap = active & ~to_cloud
        rr = jnp.where(rain_evap, rr - drv, rr)
        drr_max_new = jnp.where(rain_evap, drr_max - drv, drr_max)
        # Kessler cap exhausted -> cell leaves the loop
        alive = alive & ~(rain_evap & (drr_max_new <= 0))
        return th, rv, rc, rr, drr_max_new, alive, it + 1

    alive = jnp.ones(jnp.shape(rv), dtype=bool)
    th, rv, rc, rr, _, _, _ = jax.lax.while_loop(
        cond_state, body, (th, rv, rc, rr, drr_max0, alive, jnp.int32(0))
    )
    return th, rv, rc, rr


def adj_cellwise(opts: opts_t, rhod, p, th, rv, rc, rr, dt):
    """Dispatcher mirroring reference adj_cellwise.hpp:322-340.
    Returns (th, rv, rc, rr) updated."""
    if opts.adj_nwtrph:
        th, rv, rc = adj_cellwise_nwtrph(opts, rhod, p, th, rv, rc, dt)
        return th, rv, rc, rr
    return adj_cellwise_rk4(opts, rhod, p, th, rv, rc, rr, dt)
