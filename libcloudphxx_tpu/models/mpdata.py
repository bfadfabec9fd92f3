"""MPDATA advection on a 2-D (x, z) cell-centred grid.

The reference host model uses libmpdata++ (an external C++ library) for the
Eulerian advection of th/rv (reference models/kinematic_2D/src/icicle.cpp).
This is a from-scratch JAX implementation of the MPDATA scheme of
Smolarkiewicz (1984): a donor-cell pass followed by antidiffusive corrective
iterations, with a density-like G factor, periodic x and rigid (zero-flux) z
walls.  Everything is shifted-array arithmetic — one fused XLA program per
step, no halo copies.

Fields: psi (nx, nz) cell-centred; GC_x (nx+1, nz) and GC_z (nx, nz+1) are
G-weighted Courant numbers on the staggered faces; G (nx, nz).
"""

from functools import partial

import jax
import jax.numpy as jnp

EPS = 1e-15


def _frac(num, den):
    """Guarded ratio for the antidiffusive/FCT terms.

    libmpdata++'s positive-definite ``frac`` (formulae_mpdata_common.hpp)
    is where(den > 0, num/den, 0) — an EXACT zero test, reachable because
    positive-definite fields hold exact zeros in clear air.  The additive
    epsilon variant (Smolarkiewicz 1984's eps) is kept for A/B
    (LIBCLOUD_MPDATA_FRAC=eps)."""
    import os
    if os.environ.get("LIBCLOUD_MPDATA_FRAC", "exact") == "eps":
        return num / (den + EPS)
    return jnp.where(den > 0, num / jnp.where(den > 0, den, 1.0), 0.0)


def _donor_flux(psi_l, psi_r, gc):
    """Upwind flux through a face with G-weighted courant gc."""
    return jnp.maximum(gc, 0.0) * psi_l + jnp.minimum(gc, 0.0) * psi_r


def _pad_x(psi):
    """Periodic halo in x (axis 0)."""
    return jnp.concatenate([psi[-1:], psi, psi[:1]], axis=0)


def _pad_z(psi):
    """z halo (axis 1).  Default: zero-gradient (edge copy) — libmpdata++
    bcond::open's scalar halo.  LIBCLOUD_MPDATA_ZHALO=linear switches to
    linear extrapolation for A/B testing."""
    import os
    if os.environ.get("LIBCLOUD_MPDATA_ZHALO", "edge") == "linear":
        lo = 2.0 * psi[:, :1] - psi[:, 1:2]
        hi = 2.0 * psi[:, -1:] - psi[:, -2:-1]
        return jnp.concatenate([lo, psi, hi], axis=1)
    return jnp.concatenate([psi[:, :1], psi, psi[:, -1:]], axis=1)


def _advect_once(psi, gc_x, gc_z, G):
    """One upwind pass: psi_new = psi - (dF_x + dF_z) / G."""
    px = _pad_x(psi)
    # x faces: flux[i] through face between cell i-1 and i (0..nx)
    fx = _donor_flux(px[:-1], px[1:], gc_x)
    pz = _pad_z(psi)
    fz = _donor_flux(pz[:, :-1], pz[:, 1:], gc_z)
    return psi - ((fx[1:] - fx[:-1]) + (fz[:, 1:] - fz[:, :-1])) / G


def _antidiff_gc(psi, gc_x, gc_z, G):
    """Antidiffusive pseudo-velocities (Smolarkiewicz 1984 eqs. 13-14),
    for positive-definite psi."""
    px = _pad_x(psi)
    pz = _pad_z(psi)

    # --- x faces (nx+1, nz)
    # A = (psi_r - psi_l) / (psi_r + psi_l)
    A_x = _frac(px[1:] - px[:-1], px[1:] + px[:-1])
    Gx = 0.5 * (_pad_x(G)[:-1] + _pad_x(G)[1:])
    # cross-term B: average of psi z-differences around the x face
    pxz = _pad_z(px)  # (nx+2, nz+2)
    num = (pxz[1:, 2:] + pxz[:-1, 2:]) - (pxz[1:, :-2] + pxz[:-1, :-2])
    den = (pxz[1:, 2:] + pxz[:-1, 2:]) + (pxz[1:, :-2] + pxz[:-1, :-2])
    B_x = 0.5 * _frac(num, den)
    # gc_z averaged to the x face: mean of the four surrounding z faces
    gcz_p = jnp.concatenate([gc_z[-1:], gc_z, gc_z[:1]], axis=0)  # periodic x
    gcz_at_x = 0.25 * (
        gcz_p[:-1, :-1] + gcz_p[:-1, 1:] + gcz_p[1:, :-1] + gcz_p[1:, 1:]
    )
    gc_x2 = jnp.abs(gc_x) * (1.0 - jnp.abs(gc_x) / Gx) * A_x \
        - gc_x * gcz_at_x / Gx * B_x

    # --- z faces (nx, nz+1)
    A_z = _frac(pz[:, 1:] - pz[:, :-1], pz[:, 1:] + pz[:, :-1])
    Gz = 0.5 * (_pad_z(G)[:, :-1] + _pad_z(G)[:, 1:])
    pzx = _pad_x(pz)  # (nx+2, nz+2)
    num = (pzx[2:, 1:] + pzx[2:, :-1]) - (pzx[:-2, 1:] + pzx[:-2, :-1])
    den = (pzx[2:, 1:] + pzx[2:, :-1]) + (pzx[:-2, 1:] + pzx[:-2, :-1])
    B_z = 0.5 * _frac(num, den)
    gcx_p = jnp.concatenate([gc_x[:, :1], gc_x, gc_x[:, -1:]], axis=1)
    gcx_at_z = 0.25 * (
        gcx_p[:-1, :-1] + gcx_p[1:, :-1] + gcx_p[:-1, 1:] + gcx_p[1:, 1:]
    )
    gc_z2 = jnp.abs(gc_z) * (1.0 - jnp.abs(gc_z) / Gz) * A_z \
        - gc_z * gcx_at_z / Gz * B_z
    import os
    if os.environ.get("LIBCLOUD_MPDATA_WALL", "zero") == "zero":
        # no antidiffusive flux through top/bottom (a mask, not an
        # .at[].set scatter); LIBCLOUD_MPDATA_WALL=open keeps the wall-face
        # antidiffusive flux (libmpdata++ bcond::open behaviour A/B)
        col = jax.lax.broadcasted_iota(jnp.int32, gc_z2.shape, 1)
        gc_z2 = jnp.where((col == 0) | (col == gc_z2.shape[1] - 1), 0.0,
                          gc_z2)
    return gc_x2, gc_z2


def _fct_limit(psi_n, psi, gc_x, gc_z, G):
    """Non-oscillatory (FCT) limiting of the antidiffusive velocities
    (Smolarkiewicz & Grabowski 1990 eqs. 14-20; libmpdata++ opts::fct).

    psi_n is the field before the donor-cell pass, psi the field after it;
    gc_x/gc_z are the antidiffusive G-weighted courants to be limited."""
    pxn, px = _pad_x(psi_n), _pad_x(psi)
    pzn, pz = _pad_z(psi_n), _pad_z(psi)

    # local extrema over the 5-point stencil of BOTH psi_n and psi
    # (Smolarkiewicz & Grabowski 1990 eq. 14; LIBCLOUD_MPDATA_FCT_EXTREMA=
    # star restricts to the post-donor psi for A/B)
    import os
    star_only = os.environ.get("LIBCLOUD_MPDATA_FCT_EXTREMA",
                               "both") == "star"
    psi_max = jnp.maximum(jnp.maximum(px[:-2], px[2:]),
                          jnp.maximum(jnp.maximum(pz[:, :-2], pz[:, 2:]),
                                      psi))
    psi_min = jnp.minimum(jnp.minimum(px[:-2], px[2:]),
                          jnp.minimum(jnp.minimum(pz[:, :-2], pz[:, 2:]),
                                      psi))
    if not star_only:
        psi_max = jnp.maximum(
            psi_max,
            jnp.maximum(jnp.maximum(pxn[:-2], pxn[2:]),
                        jnp.maximum(jnp.maximum(pzn[:, :-2], pzn[:, 2:]),
                                    psi_n)))
        psi_min = jnp.minimum(
            psi_min,
            jnp.minimum(jnp.minimum(pxn[:-2], pxn[2:]),
                        jnp.minimum(jnp.minimum(pzn[:, :-2], pzn[:, 2:]),
                                    psi_n)))

    # donor-cell fluxes of psi with the antidiffusive courants
    fx = _donor_flux(px[:-1], px[1:], gc_x)     # (nx+1, nz), face f
    fz = _donor_flux(pz[:, :-1], pz[:, 1:], gc_z)

    # incoming / outgoing flux sums per cell
    f_in = (jnp.maximum(fx[:-1], 0.0) - jnp.minimum(fx[1:], 0.0)
            + jnp.maximum(fz[:, :-1], 0.0) - jnp.minimum(fz[:, 1:], 0.0))
    f_out = (jnp.maximum(fx[1:], 0.0) - jnp.minimum(fx[:-1], 0.0)
             + jnp.maximum(fz[:, 1:], 0.0) - jnp.minimum(fz[:, :-1], 0.0))

    beta_up = _frac((psi_max - psi) * G, f_in)
    beta_dn = _frac((psi - psi_min) * G, f_out)

    bup_x, bdn_x = _pad_x(beta_up), _pad_x(beta_dn)
    bup_z, bdn_z = _pad_z(beta_up), _pad_z(beta_dn)

    # limit each face by the donor cell's beta_dn and the receiver's beta_up
    lim_x = jnp.where(
        gc_x >= 0.0,
        jnp.minimum(1.0, jnp.minimum(bdn_x[:-1], bup_x[1:])),
        jnp.minimum(1.0, jnp.minimum(bup_x[:-1], bdn_x[1:])),
    )
    lim_z = jnp.where(
        gc_z >= 0.0,
        jnp.minimum(1.0, jnp.minimum(bdn_z[:, :-1], bup_z[:, 1:])),
        jnp.minimum(1.0, jnp.minimum(bup_z[:, :-1], bdn_z[:, 1:])),
    )
    return gc_x * lim_x, gc_z * lim_z


def _advect_body(psi, gc_x, gc_z, G, n_iters, fct):
    psi_prev = psi
    psi = _advect_once(psi, gc_x, gc_z, G)
    for _ in range(n_iters - 1):
        gc_x, gc_z = _antidiff_gc(psi, gc_x, gc_z, G)
        if fct:
            gc_x, gc_z = _fct_limit(psi_prev, psi, gc_x, gc_z, G)
        psi_prev = psi
        psi = _advect_once(psi, gc_x, gc_z, G)
    return psi


@partial(jax.jit, static_argnames=("n_iters", "fct"))
def advect(psi, gc_x, gc_z, G, n_iters=2, fct=False):
    """MPDATA advection of a positive-definite scalar; n_iters=1 is plain
    upwind, 2 adds one antidiffusive correction (libmpdata++ default).
    fct=True applies the non-oscillatory limiter to the corrective
    iterations (libmpdata++ opts::fct, the reference icicle configuration —
    models/kinematic_2D/src/icicle.cpp:85)."""
    G = jnp.broadcast_to(jnp.asarray(G, psi.dtype), psi.shape)
    return _advect_body(psi, gc_x, gc_z, G, n_iters, fct)


@partial(jax.jit, static_argnames=("n_iters", "fct"))
def advect2(psi_a, psi_b, gc_x, gc_z, G, n_iters=2, fct=False):
    """Advect TWO scalars sharing the same courants in one jitted program
    (th and rv of the kinematic step) — same math as two advect() calls.
    Jitted at top level: host-loop callers (the public-API driver) must
    not pay a re-trace per step."""
    G = jnp.broadcast_to(jnp.asarray(G, psi_a.dtype), psi_a.shape)
    return (_advect_body(psi_a, gc_x, gc_z, G, n_iters, fct),
            _advect_body(psi_b, gc_x, gc_z, G, n_iters, fct))
