"""Housekeeping: cell thermodynamics, mean free paths, segment moments.

JAX equivalent of reference src/impl/housekeeping/.  The thrust
sort + reduce_by_key pipeline (hskpng_sort.ipp, hskpng_count.ipp,
particles_impl_moms.ipp) collapses to `jax.ops.segment_sum` over the per-SD
cell index — no sorting is needed for moments, since segment reductions
vectorize directly.
"""

import dataclasses

import jax
import jax.numpy as jnp

from ..common import const_cp, mean_free_path, moist_air, tetens, theta_dry, theta_std
from ..common import vterm as common_vterm
from .enums import RH_formula_t
from .state import State, StaticConfig


def RH_of(cfg: StaticConfig, p, rv, T):
    """The four RH formulas (reference hskpng_Tpr.ipp:68-105)."""
    f = RH_formula_t(cfg.RH_formula)
    if f == RH_formula_t.pv_cc:
        return moist_air.p_v(p, rv) / const_cp.p_vs(T)
    if f == RH_formula_t.rv_cc:
        return rv / const_cp.r_vs(T, p)
    if f == RH_formula_t.pv_tet:
        return moist_air.p_v(p, rv) / tetens.p_vs(T)
    if f == RH_formula_t.rv_tet:
        return rv / tetens.r_vs(T, p)
    raise ValueError(f)


def hskpng_Tpr(cfg: StaticConfig, state: State) -> State:
    """Diagnose per-cell T, p, RH, eta from th, rv, rhod
    (reference hskpng_Tpr.ipp:219-305)."""
    th, rv, rhod = state.th, state.rv, state.rhod
    if cfg.th_dry:
        T = theta_dry.T(th, rhod)
    else:
        T = th * theta_std.exner(state.p)
    if not cfg.const_p:
        p = theta_dry.p(rhod, rv, T)
    else:
        p = state.p
    RH = RH_of(cfg, p, rv, T)
    eta = common_vterm.visc(T)
    # parcel setup: the cell holds 1 kg of dry air (hskpng_Tpr.ipp:297-305)
    dv = 1.0 / rhod if cfg.n_dims == 0 else state.dv
    return dataclasses.replace(state, T=T, p=p, RH=RH, eta=eta, dv=dv)


def hskpng_mfp(T, p):
    """Mean free paths for the molecular transition correction
    (reference hskpng_mfp.ipp:20-50)."""
    return mean_free_path.lambda_D(T), mean_free_path.lambda_K(T, p)


def ijk_of_xyz(cfg: StaticConfig, x, y, z):
    """Position -> ravelled cell index (reference hskpng_ijk.ipp:86-253).

    The reference computes ``i = size_t(x / dx)`` with NO x0 offset — the
    Lagrangian domain crop [x0, x1] only restricts where particles live, the
    cell grid itself always starts at 0 (see dv_eval, init_grid.ipp:33-52).
    Division is done in double to avoid the i == nx edge (:224); clipping
    covers the remaining fp edge cases."""
    f64 = jnp.float64  # falls back to f32 when x64 is disabled

    def cell_of(pos, d, n):
        return jnp.clip(
            jnp.floor(pos.astype(f64) / d).astype(jnp.int32), 0, n - 1
        )

    idx = jnp.zeros(jnp.shape(x), jnp.int32)
    if cfg.nx > 1 or (cfg.n_dims >= 1 and cfg.nx >= 1):
        idx = idx * cfg.nx + cell_of(x, cfg.dx, cfg.nx)
    if cfg.ny > 1:
        idx = idx * cfg.ny + cell_of(y, cfg.dy, cfg.ny)
    if cfg.nz > 1 or (cfg.n_dims >= 2 and cfg.nz >= 1):
        idx = idx * cfg.nz + cell_of(z, cfg.dz, cfg.nz)
    return idx


def segment_moment(cfg: StaticConfig, n_filtered, attr, power, ijk,
                   dv=None, rhod=None, specific=True):
    """k-th moment of ``attr`` over selected SDs, per cell — the
    reduce_by_key replacement (reference particles_impl_moms.ipp:276-360).

    ``specific`` divides by cell volume and dry-air density (so moments read
    as mixing-ratio-like quantities); the parcel case (n_dims == 0) skips the
    normalisation, implicitly assuming 1 kg of air."""
    if power == 0:
        vals = n_filtered
    else:
        vals = n_filtered * jnp.where(n_filtered > 0, attr, 1.0) ** power
    mom = jax.ops.segment_sum(vals, ijk, num_segments=cfg.n_cell)
    if specific and cfg.n_dims > 0:
        mom = mom / dv / rhod
    return mom


def sd_count_per_cell(cfg: StaticConfig, n_filtered, ijk):
    """Number of (selected) super-droplets per cell
    (reference particles_diag.ipp:196-219)."""
    return jax.ops.segment_sum(
        (n_filtered > 0).astype(n_filtered.dtype), ijk, num_segments=cfg.n_cell
    )


def unpermute(perm, vals):
    """Undo a sort: ``vals`` are per-SD arrays in sorted order and ``perm``
    the original slot of each sorted position; returns them in slot order.

    A scatter by the permutation, not a second sort keyed on it: XLA's GPU
    permutation_sort_simplifier rewrites such a sort into a scatter whose
    types its own HLO verifier then rejects."""
    return tuple(jnp.zeros_like(v).at[perm].set(v, unique_indices=True)
                 for v in vals)
