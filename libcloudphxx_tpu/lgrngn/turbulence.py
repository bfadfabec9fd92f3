"""SGS turbulence (Grabowski & Abade 2017) for the SD population.

JAX equivalent of reference src/impl/housekeeping/particles_impl_
hskpng_{tke,turb_vel,turb_ss}.ipp and src/impl/advection/particles_impl_
turb_adve.ipp: per-cell TKE from the dissipation-rate field, an
Ornstein-Uhlenbeck update of per-SD velocity perturbations (up/vp/wp), a
relaxed supersaturation perturbation (ssp), and the turbulent displacement.
"""

import dataclasses

import jax
import jax.numpy as jnp

from ..common import turbulence as ga17
from .state import State, StaticConfig


def _mix_len_at_cells(cfg: StaticConfig, sgs_mix_len):
    """SGS mixing-length profile indexed by the vertical cell index
    (reference hskpng_tke.ipp:34-44)."""
    k = jnp.arange(cfg.n_cell) % max(1, cfg.nz)
    return sgs_mix_len[k]


def hskpng_tke(cfg: StaticConfig, state: State, sgs_mix_len):
    """diss_rate field -> TKE per cell, in place (hskpng_tke.ipp:30-45)."""
    lam = _mix_len_at_cells(cfg, sgs_mix_len)
    tke = ga17.tke(state.diss_rate, lam)
    return dataclasses.replace(state, diss_rate=tke)


def hskpng_turb_vel(cfg: StaticConfig, state: State, sgs_mix_len, dt,
                    only_vertical=False):
    """OU update of the per-SD turbulent velocity perturbations
    (hskpng_turb_vel.ipp:51-97); expects diss_rate to already hold TKE."""
    lam = _mix_len_at_cells(cfg, sgs_mix_len)
    tke = state.diss_rate
    tau = ga17.tau(jnp.maximum(tke, 1e-30), lam)
    tau_sd = tau[state.ijk]
    tke_sd = tke[state.ijk]

    key = state.key
    updates = {}
    names = (["wp"] if only_vertical
             else ["up", "wp", "vp"][: max(1, cfg.n_dims)])
    for name in names:
        key, sub = jax.random.split(key)
        r = jax.random.normal(sub, (cfg.n_sd_max,), state.rw2.dtype)
        updates[name] = ga17.update_turb_vel(
            getattr(state, name), tau_sd, dt, tke_sd, r
        )
    return dataclasses.replace(state, key=key, **updates)


def hskpng_turb_dot_ss(cfg: StaticConfig, state: State):
    """Supersaturation-perturbation tendency dot_ssp per SD
    (hskpng_turb_ss.ipp): tau_relax from the cell's 1st wet moment per
    volume, then dot_ssp = a_1 wp - ssp / tau_relax."""
    rw = jnp.sqrt(jnp.maximum(state.rw2, 0.0))
    mom1 = jax.ops.segment_sum(
        state.n * rw, state.ijk, num_segments=cfg.n_cell
    )
    tau_rlx = ga17.tau_relax(jnp.maximum(mom1 / state.dv, 1e-30))
    dot_ssp = ga17.dot_turb_ss(state.ssp, state.wp, tau_rlx[state.ijk])
    return dataclasses.replace(state, dot_ssp=dot_ssp)


def apply_sgs_supersat(state: State, dt_sub):
    """ssp += dot_ssp * dt/sstp_cond, applied each condensation substep
    (reference apply_perparticle_sgs_supersat.ipp:7-18)."""
    return dataclasses.replace(
        state, ssp=state.ssp + dt_sub * state.dot_ssp
    )


def turb_adve(cfg: StaticConfig, state: State, dt):
    """Displacement by the turbulent velocity perturbations
    (turb_adve.ipp:20-36); axis order (x, z, y) as the reference."""
    updates = {"x": state.x + state.up * dt}
    if cfg.n_dims > 1:
        updates["z"] = state.z + state.wp * dt
    if cfg.n_dims == 3:
        updates["y"] = state.y + state.vp * dt
    return dataclasses.replace(state, **updates)
