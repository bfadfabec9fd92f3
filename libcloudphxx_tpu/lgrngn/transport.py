"""Super-droplet transport: advection, sedimentation, subsidence, walls.

JAX equivalent of reference src/impl/advection/particles_impl_adve.ipp
(implicit / explicit-Euler / predictor-corrector courant-interpolated schemes),
src/impl/sedimentation/particles_impl_sedi.ipp, src/impl/subsidence/
particles_impl_subs.ipp and src/impl/boundary_conditions/particles_impl_
bcnd.ipp (periodic/open walls + puddle bookkeeping).

Courant fields are Arakawa-C staggered, C-order flattened:
  courant_x: (nx+1, ny, nz), courant_y: (nx, ny+1, nz), courant_z:
  (nx, ny, nz+1) — the gather indices below reproduce the reference's
  lft/rgt/fre/hnd/blw/abv neighbour vectors (init_grid.ipp:94-155).
"""

import dataclasses

import jax
import jax.numpy as jnp

from ..common import constants as c
from . import hskpng
from .enums import as_t
from .state import State, StaticConfig


def _decompose(cfg: StaticConfig, ijk):
    """Linear cell index -> (i, j, k) with i outermost (init_grid.ipp:41-44)."""
    nz = max(1, cfg.nz)
    ny = max(1, cfg.ny)
    k = ijk % nz
    j = (ijk // nz) % ny
    i = ijk // (nz * ny)
    return i, j, k


def courant_indices(cfg: StaticConfig, ijk):
    """Gather indices into the staggered courant fields
    (reference init_grid.ipp:94-155: lft/rgt, fre/hnd, blw/abv)."""
    i, j, k = _decompose(cfg, ijk)
    nz, ny = max(1, cfg.nz), max(1, cfg.ny)
    lft = ijk
    rgt = ijk + ny * nz
    fre = ijk + i * nz
    hnd = fre + nz
    blw = ijk + i * ny + j
    abv = blw + 1
    return (lft, rgt), (fre, hnd), (blw, abv)


def _axis_implicit(x, dx, idx, C_l, C_r):
    """Backward-Euler interpolated advance (adve.ipp:28-61).
    Positions are absolute (cell grid anchored at 0); idx = floor(x/dx)."""
    dC = C_r - C_l
    return (x + dx * (C_l - idx * dC)) / (1.0 - dC)


def _axis_euler(x, dx, idx, C_l, C_r, apply=True):
    """Forward-Euler interpolated advance (adve.ipp:64-93).
    apply=False returns just the displacement."""
    dC = C_r - C_l
    disp = dC * (x - dx * idx) + dx * C_l
    return (x if apply else 0.0) + disp


def _gather_courants(cfg: StaticConfig, state: State, ijk):
    (lft, rgt), (fre, hnd), (blw, abv) = courant_indices(cfg, ijk)
    out = {}
    out["x"] = (state.courant_x[lft], state.courant_x[rgt])
    if cfg.n_dims == 3:
        out["y"] = (state.courant_y[fre], state.courant_y[hnd])
    if cfg.n_dims > 1:
        out["z"] = (state.courant_z[blw], state.courant_z[abv])
    return out


def _advance_positions(cfg, state, ijk, scheme_fn):
    C = _gather_courants(cfg, state, ijk)
    i, j, k = _decompose(cfg, ijk)
    x = scheme_fn(state.x, cfg.dx, i, *C["x"])
    y = state.y
    z = state.z
    if cfg.n_dims == 3:
        y = scheme_fn(state.y, cfg.dy, j, *C["y"])
    if cfg.n_dims > 1:
        z = scheme_fn(state.z, cfg.dz, k, *C["z"])
    return x, y, z


def _wrap(x, a, b):
    """Periodic wrap (bcnd.ipp detail::periodic:99-110)."""
    return a + jnp.remainder(x - a, b - a)


def adve(cfg: StaticConfig, state: State) -> State:
    """SD advection (reference adve.ipp:169-304)."""
    if cfg.n_dims == 0:
        return state
    scheme = as_t(cfg.adve_scheme)
    ijk = state.ijk

    if scheme == as_t.implicit:
        x, y, z = _advance_positions(cfg, state, ijk, _axis_implicit)
        return dataclasses.replace(state, x=x, y=y, z=z)
    if scheme == as_t.euler:
        x, y, z = _advance_positions(cfg, state, ijk, _axis_euler)
        return dataclasses.replace(state, x=x, y=y, z=z)

    # predictor-corrector (adve.ipp:184-304).  The reference shifts into a
    # halo coordinate system for distmem; single-domain periodic wrap is the
    # equivalent here (halo exchange arrives with the sharded build).
    x_old, y_old, z_old = state.x, state.y, state.z
    x, y, z = _advance_positions(cfg, state, ijk, _axis_euler)
    # keep z inside the domain (adve.ipp:213-226)
    if cfg.n_dims > 1:
        z = jnp.clip(z, cfg.z0 + 1e-8 * cfg.dz, cfg.z1 - 1e-8 * cfg.dz)
    # periodic wrap of x (and y), adjusting the stored old position so the
    # midpoint stays consistent (adve.ipp:229-252)
    x_wr = _wrap(x, cfg.x0, cfg.x1)
    x_old = x_old + (x_wr - x)
    x = x_wr
    if cfg.n_dims == 3:
        y_wr = _wrap(y, cfg.y0, cfg.y1)
        y_old = y_old + (y_wr - y)
        y = y_wr
    ijk_mid = hskpng.ijk_of_xyz(cfg, x, y, z)

    # corrector: x(t+1) = (x_pred + x_old)/2 + disp(x_pred)/2
    st_mid = dataclasses.replace(state, x=x, y=y, z=z)
    dx_, dy_, dz_ = _advance_positions(
        cfg, st_mid, ijk_mid,
        lambda *a: _axis_euler(*a, apply=False),
    )
    x = (x + x_old + dx_) / 2.0
    y = (y + y_old + dy_) / 2.0 if cfg.n_dims == 3 else state.y
    z = (z + z_old + dz_) / 2.0 if cfg.n_dims > 1 else state.z
    return dataclasses.replace(state, x=x, y=y, z=z)


def sedi(state: State, dt) -> State:
    """z -= dt * vt (reference sedi.ipp:13-24)."""
    return dataclasses.replace(state, z=state.z - dt * state.vt)


def subs(cfg: StaticConfig, state: State, w_LS, dt) -> State:
    """Large-scale subsidence from a per-level profile
    (reference subs.ipp:39-51); w_LS positive downwards."""
    _, _, k = _decompose(cfg, state.ijk)
    return dataclasses.replace(state, z=state.z - dt * w_LS[k])


def bcnd(cfg: StaticConfig, state: State) -> State:
    """Boundary conditions + puddle bookkeeping
    (reference bcnd.ipp:214-365)."""
    if cfg.n_dims == 0:
        return state
    x, y, z, n = state.x, state.y, state.z, state.n

    if not cfg.open_side_walls:
        x = _wrap(x, cfg.x0, cfg.x1)
        if cfg.n_dims == 3:
            y = _wrap(y, cfg.y0, cfg.y1)
    else:
        out_x = (x >= cfg.x1) | (x < cfg.x0)
        n = jnp.where(out_x, 0.0, n)
        if cfg.n_dims == 3:
            out_y = (y >= cfg.y1) | (y < cfg.y0)
            n = jnp.where(out_y, 0.0, n)

    puddle = state.puddle
    if cfg.n_dims > 1:
        if cfg.periodic_topbot_walls:
            z = _wrap(z, cfg.z0, cfg.z1)
        else:
            # open top: numerical strays removed (bcnd.ipp:226-236)
            n = jnp.where(z >= cfg.z1, 0.0, n)
            # bottom: precipitation accumulates into the puddle then the SDs
            # die (bcnd.ipp:240-350)
            fell = (z < cfg.z0) & (n > 0)
            nf = jnp.where(fell, n, 0.0)
            rw2 = state.rw2
            liq_vol = jnp.sum(
                4.0 / 3 * c.pi * nf * rw2 * jnp.sqrt(jnp.maximum(rw2, 0.0)))
            dry_vol = jnp.sum(4.0 / 3 * c.pi * nf * state.rd3)
            liq_num = jnp.sum(jnp.where(rw2 > 0, nf, 0.0))
            prtcl_num = jnp.sum(nf)
            from .state import (OUT_DRY_VOL, OUT_ICE_MASS, OUT_ICE_NUM,
                                OUT_LIQ_NUM, OUT_LIQ_VOL, OUT_PRTCL_NUM)
            puddle = puddle.at[OUT_LIQ_VOL].add(liq_vol)
            puddle = puddle.at[OUT_DRY_VOL].add(dry_vol)
            puddle = puddle.at[OUT_LIQ_NUM].add(liq_num)
            puddle = puddle.at[OUT_PRTCL_NUM].add(prtcl_num)
            if cfg.ice_switch:
                # frozen SDs reaching the ground (bcnd.ipp:301-327)
                from . import ice as ice_mod
                frozen = state.ice_a > 0
                nfi = jnp.where(frozen, nf, 0.0)
                mass = ice_mod.ice_mass(
                    state.ice_a, state.ice_c, state.ice_rho)
                puddle = puddle.at[OUT_ICE_MASS].add(jnp.sum(nfi * mass))
                puddle = puddle.at[OUT_ICE_NUM].add(jnp.sum(nfi))
            if cfg.chem_switch:
                # dissolved chemical masses rain out too (bcnd.ipp:330-340)
                for s in range(8):
                    puddle = puddle.at[s].add(jnp.sum(nf * state.chem[s]))
            n = jnp.where(fell, 0.0, n)

    return dataclasses.replace(state, x=x, y=y, z=z, n=n, puddle=puddle)


def post_step(cfg: StaticConfig, state: State) -> State:
    """Re-bin SDs into cells after transport (the reference's post_copy
    hskpng_ijk + count, post_copy.ipp:18-36).  Dead slots keep cell 0."""
    if cfg.n_dims == 0:
        return state
    ijk = hskpng.ijk_of_xyz(cfg, state.x, state.y, state.z)
    ijk = jnp.where(state.n > 0, ijk, 0)
    return dataclasses.replace(state, ijk=ijk.astype(jnp.int32))
