"""Ice phase: singular/time-dependent freezing, melting, depositional growth.

JAX equivalent of reference src/impl/ice/particles_impl_ice_nucl_
melt.ipp and particles_impl_ice_dep.ipp (plus common/ice_nucleation.hpp):
spheroid ice crystals carry equatorial/polar semi-axes (ice_a, ice_c) and an
apparent density; a frozen SD has rw2 == 0 and ice_a*ice_c > 0, so the liquid
condensation kernel skips it automatically.
"""

import dataclasses

import jax
import jax.numpy as jnp

from ..common import constants as c
from ..common import ice_nucleation, maxwell_mason, mean_free_path
from ..common import theta_dry, transition_regime, ventil
from . import hskpng
from .state import State, StaticConfig


def ice_mass(ice_a, ice_c, ice_rho):
    """Spheroid mass = 4/3 pi a^2 c rho (reference detail::ice_mass)."""
    return 4.0 / 3 * c.pi * ice_a * ice_a * ice_c * ice_rho


def _liquid_mom3(cfg, state):
    """Specific 3rd wet moment of liquid SDs per cell."""
    liquid = (state.rw2 > 0) & (state.n > 0)
    nf = jnp.where(liquid, state.n, 0.0)
    rw3 = state.rw2 * jnp.sqrt(jnp.maximum(state.rw2, 0.0))
    return hskpng.segment_moment(
        cfg, nf, rw3, 1.0, state.ijk, dv=state.dv, rhod=state.rhod,
        specific=True,
    )


def ice_nucl_melt(cfg: StaticConfig, state: State, dt, time_dep: bool,
                  inp_type=ice_nucleation.INP.mineral) -> State:
    """Freeze/melt phase changes with per-cell latent heating
    (reference ice_nucl_melt.ipp:20-230)."""
    mom3_before = _liquid_mom3(cfg, state)

    rw = jnp.sqrt(jnp.maximum(state.rw2, 0.0))
    axis = rw * (c.rho_w / c.rho_i) ** (1.0 / 3)
    T_sd = state.T[state.ijk]

    if time_dep:
        key, sub = jax.random.split(state.key)
        u01 = jax.random.uniform(sub, (cfg.n_sd_max,), state.rw2.dtype)
        p_fr = ice_nucleation.p_freeze(
            state.rd2_insol, jnp.maximum(state.rw2, 1e-300), T_sd, dt,
            inp_type,
        )
        freeze = (state.rw2 > 0) & (u01 < p_fr)
        state = dataclasses.replace(state, key=key)
    else:
        RH_sd = state.RH[state.ijk]
        freeze = (
            (state.rw2 > 0) & (state.T_freeze >= T_sd) & (RH_sd >= 1.0)
        )

    ice_a = jnp.where(freeze, axis, state.ice_a)
    ice_c = jnp.where(freeze, axis, state.ice_c)
    ice_rho = jnp.where(freeze, c.rho_i, state.ice_rho)
    rw2 = jnp.where(freeze, 0.0, state.rw2)

    # melting (ice_nucl_melt.ipp detail::melt)
    melt = (ice_a * ice_c > 0) & (T_sd > 273.15)
    rw2 = jnp.where(
        melt,
        (c.rho_i / c.rho_w * ice_c) ** (2.0 / 3) * ice_a ** (4.0 / 3),
        rw2,
    )
    ice_a = jnp.where(melt, 0.0, ice_a)
    ice_c = jnp.where(melt, 0.0, ice_c)
    ice_rho = jnp.where(melt, 0.0, ice_rho)

    state = dataclasses.replace(
        state, rw2=rw2, ice_a=ice_a, ice_c=ice_c, ice_rho=ice_rho
    )

    # latent heat of freezing/melting from the change of liquid content
    # (update_th_freezing, particles_impl_update_th_rv.ipp:188-240)
    mom3_after = _liquid_mom3(cfg, state)
    drw = (mom3_after - mom3_before) * 4.0 / 3 * c.pi * c.rho_w
    th = state.th + drw * theta_dry.d_th_d_rw_freeze(state.T, state.th)
    return dataclasses.replace(state, th=th)


def _drw2_dt_ice(r2, rd3, vt, rhod, rv, T, p, RH_i, eta, lambda_D, lambda_K,
                 RH_max):
    """d(r^2)/dt for ice via rdrdt_i with the same transition-regime and
    ventilation corrections as liquid (reference cond_common.ipp:332-430)."""
    r = jnp.sqrt(jnp.maximum(r2, 1e-300))
    Re = ventil.Re(vt, r, rhod, eta)
    Sc = ventil.Sc(eta, rhod, c.D_0)
    Pr = ventil.Pr(eta, c.c_pd, c.K_0)
    D = c.D_0 * transition_regime.beta(lambda_D / r) * (ventil.Sh(Sc, Re) / 2)
    K = c.K_0 * transition_regime.beta(lambda_K / r) * (ventil.Nu(Pr, Re) / 2)
    return 2.0 * maxwell_mason.rdrdt_i(
        D, K, rhod * rv, T, p, jnp.minimum(RH_i, RH_max)
    )


def ice_dep_substep(cfg: StaticConfig, state: State, dt_sub, RH_max):
    """Forward-Euler depositional growth of the spheroid axes over one
    condensation substep + per-cell rv/th update
    (reference ice_dep.ipp:13-133, advance_ice_ac cond_common.ipp:432-473).
    Returns the updated state."""
    is_ice = (state.ice_a > 0) & (state.ice_c > 0) & (state.n > 0)
    mass_before = hskpng.segment_moment(
        cfg, jnp.where(is_ice, state.n, 0.0),
        ice_mass(state.ice_a, state.ice_c, state.ice_rho), 1.0,
        state.ijk, dv=state.dv, rhod=state.rhod, specific=True,
    )

    g = lambda arr: arr[state.ijk]
    T_sd, p_sd, rhod_sd = g(state.T), g(state.p), g(state.rhod)
    rv_sd, eta_sd = g(state.rv), g(state.eta)
    # RH with respect to ice
    from ..common import const_cp, moist_air
    RH_i = moist_air.p_v(p_sd, rv_sd) / const_cp.p_vsi(T_sd)
    lam_D = mean_free_path.lambda_D(T_sd)
    lam_K = mean_free_path.lambda_K(T_sd, p_sd)

    a = jnp.where(is_ice, state.ice_a, 1e-6)
    ccc = jnp.where(is_ice, state.ice_c, 1e-6)
    da_dt = _drw2_dt_ice(a * a, state.rd3, state.vt, rhod_sd, rv_sd, T_sd,
                         p_sd, RH_i, eta_sd, lam_D, lam_K, RH_max) / (2 * a)
    dc_dt = _drw2_dt_ice(ccc * ccc, state.rd3, state.vt, rhod_sd, rv_sd,
                         T_sd, p_sd, RH_i, eta_sd, lam_D, lam_K, RH_max) \
        / (2 * ccc)
    a_new = jnp.maximum(a + dt_sub * da_dt, 1e-9)
    c_new = jnp.maximum(ccc + dt_sub * dc_dt, 1e-9)
    ice_a = jnp.where(is_ice, a_new, state.ice_a)
    ice_c = jnp.where(is_ice, c_new, state.ice_c)
    state = dataclasses.replace(state, ice_a=ice_a, ice_c=ice_c)

    mass_after = hskpng.segment_moment(
        cfg, jnp.where(is_ice, state.n, 0.0),
        ice_mass(state.ice_a, state.ice_c, state.ice_rho), 1.0,
        state.ijk, dv=state.dv, rhod=state.rhod, specific=True,
    )
    d_ice = mass_after - mass_before
    rv = state.rv - d_ice
    th = state.th - d_ice * theta_dry.d_th_d_rv_dep(state.T, state.th)
    return dataclasses.replace(state, rv=rv, th=th)
