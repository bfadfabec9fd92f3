"""Implicit per-droplet condensation/evaporation with per-cell substepping.

JAX equivalent of reference src/impl/condensation/ (percell path):
  - the backward-Euler wet-growth minfun combining Maxwell-Mason, kappa-Koehler
    activity, the Kelvin term, transition-regime beta(Kn) and Sh/Nu ventilation
    (cond_common.ipp:80-338),
  - the bracketed root solve (reference: TOMS-748 <=100 iters; here: the
    whole-population fixed-iteration Anderson-Bjoerck solver from ops/rootfind,
    one divergence-free instruction stream for every droplet),
  - the explicit-Euler fallback when the bracket has no sign change
    (cond_common.ipp:309-315) and the rw2 >= rd2 clamp (:318),
  - the per-cell theta/rv substepping loop (sstp_percell_step.ipp:7-49,
    particles_impl_cond.ipp:13-139) and latent-heat application
    (particles_impl_update_th_rv.ipp).

The whole substep loop is one `lax.fori_loop` whose body advances every
super-droplet at once — XLA fuses the minfun evaluations into a single
vectorized kernel over the population.
"""

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp

from ..common import constants as c
from ..common import kappa_koehler, kelvin, maxwell_mason, mean_free_path
from ..common import theta_dry, transition_regime, ventil
from ..ops.rootfind import solve_bracketed
from ..utils.device import on_accelerator
from . import hskpng
from .state import State, StaticConfig

# reference src/detail/config.hpp:181-205
COND_MLT = 2.0
ROOT_ITERS = 32      # f64: beyond the reference's 2^-15 toms748 tolerance


def _root_iters(dtype):
    """The reference's eps_tolerance is sizeof(real_t)*8/4 bits — 16 bits
    (2^-15) at double, only 8 bits (2^-7) at float (config.hpp:181-205).
    Anderson-Bjoerck converges superlinearly: on the bench population
    (76x76 kinematic step, 370k droplets, 10 substeps), 12 iterations sit
    at the same converged f32 noise floor as 16 (max rel drw2 3.8e-5 vs
    2.4e-5 against a 24-iteration reference; the reference's own f32
    tolerance is 8e-3).  The f64 parity path keeps 32.

    The 3.8e-5 figure is shape-specific (that one population);
    LIBCLOUD_ROOT_ITERS_F32 restores a higher count for atypical
    populations without a code edit."""
    import os
    if jnp.dtype(dtype).itemsize == 8:
        return 32
    return int(os.environ.get("LIBCLOUD_ROOT_ITERS_F32", "12"))


def drw2_dt(rw2, rd3, kpa, vt, rhod, rv, T, p, RH, eta, lambda_D, lambda_K,
            RH_max):
    """d(rw^2)/dt of a wet droplet (reference cond_common.ipp:122-163).

    = 2 * rdrdt(D_eff, K_eff, ...) with diffusivity/conductivity reduced by
    the transition-regime beta and enhanced by ventilation Sh/Nu."""
    rw = jnp.sqrt(rw2)
    rw3 = rw2 * rw

    Re = ventil.Re(vt, rw, rhod, eta)
    Sc = ventil.Sc(eta, rhod, c.D_0)
    Pr = ventil.Pr(eta, c.c_pd, c.K_0)

    D = c.D_0 * transition_regime.beta(lambda_D / rw) * (ventil.Sh(Sc, Re) / 2)
    K = c.K_0 * transition_regime.beta(lambda_K / rw) * (ventil.Nu(Pr, Re) / 2)

    return 2.0 * maxwell_mason.rdrdt(
        D, K, rhod * rv, T, p,
        jnp.minimum(RH, RH_max),
        kappa_koehler.a_w(rw3, rd3, kpa),
        kelvin.klvntrm(rw, T),
    )


def _advance_rw2_core(dt, rw2_old, rd3, kpa, vt, rhod, rv, T, p, RH, eta,
                      lambda_D, lambda_K, RH_max):
    """Backward-Euler advance of rw^2 over dt for the whole population
    (reference cond_common.ipp:187-338).

    Bracket [a, b] from a cond_mlt-scaled explicit guess; implicit root via
    fixed-iteration bracketing; explicit-Euler fallback when no sign change;
    clamped to the dry radius."""
    grow = partial(
        drw2_dt, rd3=rd3, kpa=kpa, vt=vt, rhod=rhod, rv=rv, T=T, p=p, RH=RH,
        eta=eta, lambda_D=lambda_D, lambda_K=lambda_K, RH_max=RH_max,
    )
    # guard dead/ice slots (rw2 <= 0 is skipped in the reference)
    alive = rw2_old > 0
    rw2_safe = jnp.where(alive, rw2_old, rd3 ** (2.0 / 3))

    drw2 = dt * grow(rw2_safe)
    rd2 = jnp.cbrt(rd3) ** 2

    a = jnp.maximum(rd2, rw2_safe + jnp.minimum(0.0, COND_MLT * drw2))
    b = rw2_safe + jnp.maximum(0.0, COND_MLT * drw2)

    minfun = lambda rw2: rw2_safe + dt * grow(rw2) - rw2
    # f(rw2_old) == drw2 by construction (cond_common.ipp:281-293)
    fa = jnp.where(drw2 > 0, drw2, minfun(a))
    fb = jnp.where(drw2 > 0, minfun(b), drw2)

    bracketed = (fa * fb <= 0) & (a < b) & (drw2 != 0)
    # implicit Euler where bracketed...
    rw2_root = solve_bracketed(
        minfun,
        jnp.where(bracketed, a, rw2_safe),
        jnp.where(bracketed, b, rw2_safe),
        iters=_root_iters(rw2_old.dtype),
    )
    # ...explicit Euler fallback otherwise (cond_common.ipp:309)
    rw2_new = jnp.where(bracketed, rw2_root, rw2_safe + drw2)
    rw2_new = jnp.maximum(rw2_new, rd2)  # no evaporation below dry size
    return jnp.where(alive & (drw2 != 0), rw2_new, rw2_old)


def _kernel_wanted(x):
    """Run the implicit solve as the Pallas kernel (ops/pallas_cond)?  For
    the f32 population on an accelerator, where it beats the plain form —
    rolled or unrolled — end to end on both engines (H100, PERF.md); CPU
    and the f64 parity path keep the plain XLA form."""
    return x.dtype == jnp.float32 and on_accelerator()


def advance_rw2(dt, rw2_old, rd3, kpa, vt, rhod, rv, T, p, RH, eta,
                lambda_D, lambda_K, RH_max):
    """The backward-Euler rw^2 advance with per-SD inputs: the Pallas
    kernel where _kernel_wanted and every input is a per-SD vector under
    one scalar dt, plain XLA otherwise — identical physics, see
    _advance_rw2_core."""
    cells = (rhod, rv, T, p, RH, eta, lambda_D, lambda_K)
    if (_kernel_wanted(rw2_old) and rw2_old.ndim == 1 and jnp.ndim(dt) == 0
            and all(jnp.shape(a) == rw2_old.shape
                    for a in (rd3, kpa, vt) + cells)):
        from ..ops.pallas_cond import advance_rw2_pallas
        return advance_rw2_pallas(_advance_rw2_core, dt, rw2_old, rd3, kpa,
                                  vt, cells, RH_max, cap=1)
    return _advance_rw2_core(dt, rw2_old, rd3, kpa, vt, *cells, RH_max)


def advance_rw2_rows(dt, rw2_old, rd3, kpa, vt, cells, RH_max):
    """The rw^2 advance on the dense cell-major layout: (n_cell, cap) SD
    planes and the eight ambient quantities (rhod, rv, T, p, RH, eta,
    lambda_D, lambda_K) as (n_cell,) cell vectors.  The kernel gathers the
    cell values by row; the plain form broadcasts them (XLA fuses the
    broadcast, nothing is materialised)."""
    if _kernel_wanted(rw2_old):
        from ..ops.pallas_cond import advance_rw2_pallas
        shape = rw2_old.shape
        out = advance_rw2_pallas(
            _advance_rw2_core, dt, rw2_old.ravel(), rd3.ravel(), kpa.ravel(),
            vt.ravel(), tuple(cells), RH_max, cap=shape[1])
        return out.reshape(shape)
    return _advance_rw2_core(dt, rw2_old, rd3, kpa, vt,
                             *(c[:, None] for c in cells), RH_max)


def _specific_mom3(cfg: StaticConfig, state: State):
    """Specific 3rd wet moment per cell (particles_impl_cond.ipp:105-135)."""
    rw3 = state.rw2 * jnp.sqrt(jnp.maximum(state.rw2, 0.0))
    return hskpng.segment_moment(
        cfg, state.n, rw3, 1.0, state.ijk,
        dv=state.dv, rhod=state.rhod, specific=True,
    )


def stale_mfp(state: State):
    """Mean free paths from the cell T/p as they stand BEFORE the substep
    loop's thermodynamic refresh — the reference computes hskpng_mfp once
    per step from the previous step's Tpr (particles_step.ipp:190-196: no
    hskpng_Tpr runs between sync_in and hskpng_mfp, so lambda_D/K date from
    the end of the previous step); keeping that staleness matters for the
    activation transient under sudden ambient jumps."""
    return hskpng.hskpng_mfp(state.T, state.p)


def cond_percell(cfg: StaticConfig, state: State, dt, RH_max,
                 turb_cond: bool = False, var_rho: bool = False,
                 lam=None) -> State:
    """The per-cell substepped condensation phase of step_cond
    (reference particles_step.ipp:237-256).

    th/rv (and rhod, when the host passes it each step — the reference's
    var_rho, particles_step.ipp:100 + sstp_percell_step.ipp:17-20) advance
    from their pre-sync values in sstp_cond equal increments of the
    host-model (advective) delta, interleaved with implicit droplet growth
    and per-cell latent heating.  ``lam`` is the stale (lambda_D, lambda_K)
    pair from stale_mfp; computed here as a fallback.

    Layout notes: the substep loop carries only the arrays that change (rw2 and
    the cell thermodynamics + SGS state) rather than the whole State pytree,
    and the per-cell liquid-water change is one segment-sum of the per-SD
    rw^3 difference instead of two full third moments — the difference form
    also avoids the f32 cancellation of two nearly equal big sums."""
    sstp = cfg.sstp_cond
    dt_sub = dt / sstp

    # the advective (host-model) delta accumulated since the last sstp_save
    # (sstp_percell_step.ipp:21-47): rewind th/rv to their pre-sync values,
    # then feed the delta back in sstp equal increments interleaved with
    # condensation.  For sstp == 1 one increment applies the whole delta,
    # reproducing the reference's early-return path.
    if cfg.exact_sstp_cond:
        # per-SD-shaped tmp arrays; this path only runs for sstp == 1
        # (reference particles_step.ipp:199: exact branch needs sstp > 1)
        delta_th = jnp.zeros_like(state.th)
        delta_rv = jnp.zeros_like(state.rv)
        delta_rh = jnp.zeros_like(state.th)
        var_rho = False
    else:
        delta_th = state.th - state.sstp_tmp_th
        delta_rv = state.rv - state.sstp_tmp_rv
        upd = dict(th=state.sstp_tmp_th, rv=state.sstp_tmp_rv)
        if var_rho and sstp > 1:
            # rhod is substepped too (sstp_percell_step.ipp:17-20 includes
            # rhod when var_rho)
            delta_rh = state.rhod - state.sstp_tmp_rh
            upd["rhod"] = state.sstp_tmp_rh
        else:
            delta_rh = jnp.zeros_like(state.th)
            var_rho = False
        state = dataclasses.replace(state, **upd)

    lambda_D, lambda_K = lam if lam is not None else stale_mfp(state)
    # loop invariants hoisted out of the substep loop (XLA does not move
    # gathers out of while loops): per-SD dry attributes and cell constants
    ijk = state.ijk
    lam_D_sd = lambda_D[ijk]
    lam_K_sd = lambda_K[ijk]
    # nominal per-SD weight; the (dv*rhod) normalisation is constant unless
    # rhod is substepped (parcel: dv = 1/rhod, so it cancels either way)
    wgt_nom = state.n * (4.0 / 3) * c.pi * c.rho_w

    if not cfg.ice_switch:
        # fast path: run the substep loop in cell-sorted SD order, so the
        # per-cell liquid-water sum is a cumsum + boundary difference instead
        # of a scatter-add; one sort in,
        # one inverse sort out for the single mutated per-SD array (rw2)
        return _cond_percell_sorted(
            cfg, state, dt_sub, sstp, RH_max, turb_cond, var_rho,
            delta_th, delta_rv, delta_rh, lam_D_sd, lam_K_sd, wgt_nom,
        )

    def substep(_, carry):
        st = carry
        st = dataclasses.replace(
            st, th=st.th + delta_th / sstp, rv=st.rv + delta_rv / sstp,
            rhod=(st.rhod + delta_rh / sstp if var_rho else st.rhod),
        )
        if turb_cond:
            # SGS supersaturation perturbation accumulates each substep and
            # adds to the ambient RH seen by each SD
            # (reference apply_perparticle_sgs_supersat.ipp + cond.ipp:62-86)
            from . import turbulence as turb_mod
            st = turb_mod.apply_sgs_supersat(st, dt_sub)
        st = hskpng.hskpng_Tpr(cfg, st)

        g = lambda arr: arr[ijk]  # cell -> SD gather
        RH_sd = g(st.RH) + (st.ssp if turb_cond else 0.0)
        rw2_old = st.rw2
        rw2_new = advance_rw2(
            dt_sub, rw2_old, st.rd3, st.kpa, st.vt,
            g(st.rhod), g(st.rv), g(st.T), g(st.p), RH_sd, g(st.eta),
            lam_D_sd, lam_K_sd, RH_max,
        )
        st = dataclasses.replace(st, rw2=rw2_new)

        # latent heating per cell from the summed per-SD rw^3 change
        # (particles_impl_cond.ipp:105-135 + update_th_rv.ipp:90-180);
        # specific moments divide by the CURRENT dv*rhod (moms_calc)
        wgt = wgt_nom / g(st.dv * st.rhod)
        drw3 = rw2_new * jnp.sqrt(rw2_new) - rw2_old * jnp.sqrt(
            jnp.maximum(rw2_old, 0.0))
        drv = -jax.ops.segment_sum(
            wgt * drw3, ijk, num_segments=cfg.n_cell
        )
        rv_new = st.rv + drv
        th_new = st.th + drv * theta_dry.d_th_d_rv(st.T, st.th)
        st = dataclasses.replace(st, th=th_new, rv=rv_new)
        if cfg.ice_switch:
            # depositional growth of ice each substep (particles_step.ipp:
            # 251-255 -> ice_dep)
            from . import ice as ice_mod
            st = ice_mod.ice_dep_substep(cfg, st, dt_sub, RH_max)
        return st

    # carry only what the loop mutates: rw2 + cell thermodynamics (+ SGS ssp)
    carried = ("rw2", "th", "rv", "rhod", "T", "p", "RH", "eta", "dv", "ssp",
               "dot_ssp", "key")
    if cfg.ice_switch:
        carried += ("ice_a", "ice_c", "ice_rho")
    full = state

    def substep_mini(i, mini):
        st = dataclasses.replace(full, **mini)
        st = substep(i, st)
        return {k: getattr(st, k) for k in carried}

    mini = jax.lax.fori_loop(
        0, sstp, substep_mini, {k: getattr(state, k) for k in carried}
    )
    if var_rho:
        # rhod ends at the host value it was rewound from
        mini["rhod"] = full.rhod + delta_rh
    return dataclasses.replace(state, **mini)


def _cond_percell_sorted(cfg, state, dt_sub, sstp, RH_max, turb_cond,
                         var_rho, delta_th, delta_rv, delta_rh,
                         lam_D_sd, lam_K_sd, wgt_nom):
    """Sorted-space body of cond_percell: identical physics, with the SD
    population traversed in cell order so the per-cell reduction is a
    segmented cumsum."""
    ijk = state.ijk
    n_sd = ijk.shape[0]
    pos = jnp.arange(n_sd, dtype=jnp.int32)

    payload = (state.rw2, state.rd3, state.kpa, state.vt,
               lam_D_sd, lam_K_sd, wgt_nom)
    if turb_cond:
        payload += (state.ssp, state.dot_ssp)
    sorted_ = jax.lax.sort((ijk, pos) + payload, num_keys=1)
    sijk, pos_s = sorted_[0], sorted_[1]
    (rw2_s, rd3_s, kpa_s, vt_s, lamD_s, lamK_s, wgt_s
     ) = sorted_[2:9]
    ssp_s = sorted_[9] if turb_cond else jnp.zeros(())
    dssp_s = sorted_[10] if turb_cond else jnp.zeros(())

    # when rhod is NOT substepped the (dv*rhod) weight normalisation is a
    # loop invariant — keep the hoisted form on the hot path
    if not var_rho:
        wgt_s = wgt_s / (state.dv * state.rhod)[sijk]

    # last sorted index of each cell (cells are contiguous runs)
    ends = jnp.searchsorted(sijk, jnp.arange(1, cfg.n_cell + 1,
                                             dtype=sijk.dtype)) - 1

    def cell_sum(vals):
        cs = jnp.cumsum(vals)
        tot = jnp.where(ends >= 0, cs[jnp.maximum(ends, 0)], 0.0)
        return jnp.diff(tot, prepend=jnp.zeros((1,), tot.dtype))

    def substep(_, carry):
        rw2c, th, rv, rhod, ssp = carry
        th = th + delta_th / sstp
        rv = rv + delta_rv / sstp
        if var_rho:
            rhod = rhod + delta_rh / sstp
        if turb_cond:
            ssp = ssp + dt_sub * dssp_s
        stt = hskpng.hskpng_Tpr(cfg, dataclasses.replace(
            state, th=th, rv=rv, rhod=rhod))
        g = lambda arr: arr[sijk]
        RH_sd = g(stt.RH) + (ssp if turb_cond else 0.0)
        rw2_new = advance_rw2(
            dt_sub, rw2c, rd3_s, kpa_s, vt_s,
            g(stt.rhod), g(stt.rv), g(stt.T), g(stt.p), RH_sd, g(stt.eta),
            lamD_s, lamK_s, RH_max,
        )
        drw3 = rw2_new * jnp.sqrt(rw2_new) - rw2c * jnp.sqrt(
            jnp.maximum(rw2c, 0.0))
        wsub = wgt_s / g(stt.dv * stt.rhod) if var_rho else wgt_s
        drv = -cell_sum(wsub * drw3)
        rv = stt.rv + drv
        th = stt.th + drv * theta_dry.d_th_d_rv(stt.T, stt.th)
        return (rw2_new, th, rv, rhod, ssp)

    # rolled: unrolling the substep loop multiplies compile time
    rw2_s, th, rv, rhod, ssp_s = jax.lax.fori_loop(
        0, sstp, substep, (rw2_s, state.th, state.rv, state.rhod, ssp_s)
    )

    # restore original SD order for the mutated per-SD arrays
    restored = hskpng.unpermute(
        pos_s, (rw2_s,) + ((ssp_s,) if turb_cond else ()))
    updates = dict(rw2=restored[0], th=th, rv=rv)
    if var_rho:
        updates["rhod"] = rhod
    if turb_cond:
        updates["ssp"] = restored[1]
    state = dataclasses.replace(state, **updates)
    return hskpng.hskpng_Tpr(cfg, state)


def sstp_save(state: State, exact: bool = False) -> State:
    """Snapshot rv/th/rhod(/p) for the next substepping cycle
    (reference sstp_save.ipp:7-35).  In exact (per-particle) mode each SD
    keeps its own copy of the cell values."""
    if exact:
        g = lambda arr: arr[state.ijk]
        return dataclasses.replace(
            state,
            sstp_tmp_th=g(state.th),
            sstp_tmp_rv=g(state.rv),
            sstp_tmp_rh=g(state.rhod),
            sstp_tmp_p=g(state.p),
        )
    return dataclasses.replace(
        state,
        sstp_tmp_th=state.th,
        sstp_tmp_rv=state.rv,
        sstp_tmp_rh=state.rhod,
    )


def cond_perparticle(cfg: StaticConfig, state: State, dt, RH_max,
                     turb_cond: bool = False, lam=None) -> State:
    """Exact per-particle condensation substepping
    (reference particles_step.ipp:219-232 + src/impl/condensation/
    perparticle/): each SD carries its own th/rv/rhod(/p) copy; the ambient
    (advective) change feeds in per-SD increments; growth and latent
    heating evolve the SD's private state; per-cell th/rv are updated once
    at the end.  Implements the sstp_cond_mix=True (instant in-cell mixing
    each substep) and False (no mixing) variants.

    Mean free paths are the STALE cell values (stale_mfp; the reference's
    perparticle_advance_rw2.ipp:13-30 gathers lambda_D/K[ijk] computed once
    before the loop), while viscosity follows the SD's private temperature
    — exactly the reference's split."""
    from ..common import theta_std
    from . import hskpng as hskpng_mod

    sstp = cfg.sstp_cond
    dt_sub = dt / sstp
    mix = bool(cfg.sstp_cond_mix)

    g = lambda arr: arr[state.ijk]
    lam_D_c, lam_K_c = lam if lam is not None else stale_mfp(state)
    lam_D = g(lam_D_c)
    lam_K = g(lam_K_c)
    # per-SD ambient deltas (calculate_noncond_perparticle_sstp_delta.ipp)
    dlt_rv = g(state.rv) - state.sstp_tmp_rv
    dlt_th = g(state.th) - state.sstp_tmp_th
    dlt_rh = g(state.rhod) - state.sstp_tmp_rh
    dlt_p = g(state.p) - state.sstp_tmp_p

    live = state.n > 0
    dv_sd = g(state.dv)

    def substep(_, st):
        tmp_rv = st.sstp_tmp_rv + dlt_rv / sstp
        tmp_th = st.sstp_tmp_th + dlt_th / sstp
        tmp_rh = st.sstp_tmp_rh + dlt_rh / sstp
        tmp_p = st.sstp_tmp_p + (dlt_p / sstp if cfg.const_p else 0.0)

        # per-SD thermodynamics (cond_perparticle_advance_rw2.ipp)
        if cfg.th_dry:
            Tp = theta_dry.T(tmp_th, jnp.maximum(tmp_rh, 1e-10))
        else:
            Tp = tmp_th * theta_std.exner(jnp.maximum(tmp_p, 1.0))
        if cfg.const_p:
            pp = tmp_p
        else:
            pp = theta_dry.p(tmp_rh, tmp_rv, Tp)
        RHp = hskpng_mod.RH_of(cfg, jnp.maximum(pp, 1.0), tmp_rv, Tp)
        if turb_cond:
            RHp = RHp + st.ssp
        from ..common import vterm as cv
        eta_p = cv.visc(Tp)

        rw3_old = st.rw2 * jnp.sqrt(jnp.maximum(st.rw2, 0.0))
        rw2_new = advance_rw2(
            dt_sub, st.rw2, st.rd3, st.kpa, st.vt,
            tmp_rh, tmp_rv, Tp, pp, RHp, eta_p, lam_D, lam_K, RH_max,
        )
        rw3_new = rw2_new * jnp.sqrt(jnp.maximum(rw2_new, 0.0))
        drw3 = jnp.where(live, rw3_new - rw3_old, 0.0)

        # drv from the SD's own 3rd-moment change
        # (apply_perparticle_drw3_to_perparticle_rv_and_th.ipp, rw3diff2drv)
        mlt = -(4.0 / 3) * c.pi * c.rho_w
        if cfg.n_dims > 0:
            drv = mlt * drw3 * st.n / tmp_rh / dv_sd
        else:
            drv = mlt * drw3 * st.n  # parcel: 1 kg of air
        if mix:
            cell_drv = jax.ops.segment_sum(
                drv, st.ijk, num_segments=cfg.n_cell
            )
            drv_eff = cell_drv[st.ijk]
        else:
            drv_eff = drv
        tmp_rv = tmp_rv + drv_eff
        dth = drv_eff * theta_dry.d_th_d_rv(Tp, tmp_th)
        if mix:
            # careful: the mixed dth is computed per SD from the mixed drv
            # then shared — but drv_eff is already the cell sum, so dth is
            # identical for every SD of a cell up to its private Tp/th;
            # the reference computes dth per SD from the per-SD drw3 and
            # mixes the *dth* sum (update_pstate), so do the same:
            dth_own = drv * theta_dry.d_th_d_rv(Tp, tmp_th)
            cell_dth = jax.ops.segment_sum(
                dth_own, st.ijk, num_segments=cfg.n_cell
            )
            tmp_th = st.sstp_tmp_th + dlt_th / sstp + cell_dth[st.ijk]
            tmp_rv = st.sstp_tmp_rv + dlt_rv / sstp + drv_eff
        else:
            tmp_th = tmp_th + dth

        return dataclasses.replace(
            st, rw2=rw2_new,
            sstp_tmp_rv=tmp_rv, sstp_tmp_th=tmp_th,
            sstp_tmp_rh=tmp_rh, sstp_tmp_p=tmp_p,
        )

    mom3_before = _specific_mom3(cfg, state)
    state = jax.lax.fori_loop(0, sstp, substep, state)

    if mix:
        # copy any SD's (identical) private cell state back to the cell
        # (update_state, particles_impl_update_th_rv.ipp:283-297)
        oob = cfg.n_cell
        tgt = jnp.where(live, state.ijk, oob)
        rv_new = state.rv.at[tgt].set(state.sstp_tmp_rv, mode="drop")
        th_new = state.th.at[tgt].set(state.sstp_tmp_th, mode="drop")
        state = dataclasses.replace(state, rv=rv_new, th=th_new)
    else:
        # cell-level closure from the total liquid-content change
        mom3_after = _specific_mom3(cfg, state)
        drv = (mom3_after - mom3_before) * (4.0 / 3) * c.pi * c.rho_w
        state = _apply_drv_to_cell_th_rv(cfg, state, drv)
    return state


def _apply_drv_to_cell_th_rv(cfg, state, drv):
    """Per-cell closure for the nomixing per-particle paths: rv -= drv and
    theta integrated along the drv path (dtheta/drv = d_th_d_rv(T(theta),
    theta), one RK4 stage per cell — O(drv^5) error).

    Deviation from the reference: update_th_rv
    (particles_impl_update_th_rv.ipp) applies the whole-step latent heating
    with a single d_th_d_rv evaluation, an O(drv^2) linearization that the
    per-particle substepping cannot reduce (the percell path avoids it by
    running update_th_rv every substep, particles_step.ipp:258); the exact
    path integration keeps the "exact" modes exact."""
    th_new, rv_new = apply_drv_to_th_rv(cfg, state.th, state.rv,
                                        state.rhod, state.p, drv)
    return dataclasses.replace(state, rv=rv_new, th=th_new)


def apply_drv_to_th_rv(cfg, th, rv, rhod, p, drv):
    """Cell-array core of _apply_drv_to_cell_th_rv (shared with the dense
    engine's exact-substepping closure)."""
    from ..common import theta_std

    if cfg.th_dry:
        f = lambda th: theta_dry.d_th_d_rv(
            theta_dry.T(th, jnp.maximum(rhod, 1e-10)), th)
    else:
        ex = theta_std.exner(jnp.maximum(p, 1.0))
        f = lambda th: theta_dry.d_th_d_rv(th * ex, th)

    h = -drv  # dtheta = f(theta) * d(-drv_applied)... sign: th += f*(-drv)
    k1 = f(th)
    k2 = f(th + 0.5 * h * k1)
    k3 = f(th + 0.5 * h * k2)
    k4 = f(th + h * k3)
    th_new = th + (h / 6.0) * (k1 + 2 * k2 + 2 * k3 + k4)
    return th_new, rv - drv


def _perparticle_thermo(cfg, tmp_th, tmp_rv, tmp_rh, tmp_p, ssp, turb_cond):
    """Per-SD thermodynamic closure from private ambient state
    (reference perparticle_nomixing_adaptive_sstp_cond.ipp:93-120:
    _calc_Tp/_calc_sstp_tmp_p/_calc_RH).  Mean free paths are NOT part of
    this closure — the reference uses the stale cell values (stale_mfp)."""
    from ..common import theta_std
    from ..common import vterm as cv
    from . import hskpng as hskpng_mod

    if cfg.th_dry:
        Tp = theta_dry.T(tmp_th, jnp.maximum(tmp_rh, 1e-10))
    else:
        Tp = tmp_th * theta_std.exner(jnp.maximum(tmp_p, 1.0))
    pp = tmp_p if cfg.const_p else theta_dry.p(tmp_rh, tmp_rv, Tp)
    RHp = hskpng_mod.RH_of(cfg, jnp.maximum(pp, 1.0), tmp_rv, Tp)
    if turb_cond:
        RHp = RHp + ssp
    eta_p = cv.visc(Tp)
    return Tp, pp, RHp, eta_p


def cond_perparticle_adaptive(cfg: StaticConfig, state: State, dt, RH_max,
                              turb_cond: bool = False, lam=None) -> State:
    """Adaptive per-SD condensation substepping, no in-cell mixing
    (reference perparticle_nomixing_adaptive_sstp_cond.ipp:8-335, driven
    from particles_step.ipp:199-218).

    Phase A (adaptation): per SD, try sstp = 1, 2, 4, ... <= sstp_cond;
    accept the first count whose d(rw^2) over one substep agrees with the
    half-size estimate to within sstp_cond_adapt_drw2_eps * rw2 (and whose
    magnitude stays below sstp_cond_adapt_drw2_max * rw2 — large-growth
    guard near activation, reference :168-177).  SDs that cross their
    critical radius in this step are overridden to sstp_cond_act substeps
    (:184-195).

    Phase B: every SD runs its own substep count inside one shared fixed-bound
    loop (masked lanes — one instruction stream for every SD, the reference's
    single-fused-loop rationale :212-214).  Ambient th/rv/rhod/p feed in
    per-substep increments; drw^3 drives the SD-private rv/theta (nomixing);
    the per-cell closure comes from the total liquid-content change, as
    apply_perparticle_cond_change_to_percell_rv_and_th does.

    Deviation from the reference: where the adaptation is abandoned
    (activation override / no convergence) we restore the exact saved
    pre-adaptation ambient state instead of replaying signed delta
    fractions (reference :197-200 is only exact for power-of-two
    sstp_cond)."""
    g = lambda arr: arr[state.ijk]
    # stale cell mean free paths (see cond_perparticle docstring)
    lam_D_c, lam_K_c = lam if lam is not None else stale_mfp(state)
    dot_ssp = state.dot_ssp if turb_cond else 0.0
    ssp0 = state.ssp if turb_cond else jnp.zeros_like(state.sstp_tmp_rv)
    tmp_p0 = (state.sstp_tmp_p if cfg.const_p
              else jnp.zeros_like(state.sstp_tmp_rv))

    mom3_before = _specific_mom3(cfg, state)
    rw2, tmp_rv, tmp_th, tmp_rh, tmp_p, ssp = perparticle_adaptive_core(
        cfg, dt, RH_max, turb_cond,
        n=state.n, rw2=state.rw2, rd3=state.rd3, kpa=state.kpa,
        vt=state.vt, dv_sd=g(state.dv),
        lam_D_sd=g(lam_D_c), lam_K_sd=g(lam_K_c),
        dlt_rv=g(state.rv) - state.sstp_tmp_rv,
        dlt_th=g(state.th) - state.sstp_tmp_th,
        dlt_rh=g(state.rhod) - state.sstp_tmp_rh,
        dlt_p=(g(state.p) - state.sstp_tmp_p) if cfg.const_p else 0.0,
        tmp_rv0=state.sstp_tmp_rv, tmp_th0=state.sstp_tmp_th,
        tmp_rh0=state.sstp_tmp_rh, tmp_p0=tmp_p0,
        ssp0=ssp0, dot_ssp=dot_ssp, T_sd=g(state.T),
    )

    new_fields = dict(
        rw2=rw2, sstp_tmp_rv=tmp_rv, sstp_tmp_th=tmp_th, sstp_tmp_rh=tmp_rh,
    )
    if cfg.const_p:
        new_fields["sstp_tmp_p"] = tmp_p
    if turb_cond:
        new_fields["ssp"] = ssp
    state = dataclasses.replace(state, **new_fields)

    # per-cell closure from the total liquid-content change
    # (apply_perparticle_cond_change_to_percell_rv_and_th)
    mom3_after = _specific_mom3(cfg, state)
    drv_cell = (mom3_after - mom3_before) * (4.0 / 3) * c.pi * c.rho_w
    return _apply_drv_to_cell_th_rv(cfg, state, drv_cell)


def perparticle_adaptive_core(cfg: StaticConfig, dt, RH_max, turb_cond, *,
                              n, rw2, rd3, kpa, vt, dv_sd,
                              lam_D_sd, lam_K_sd,
                              dlt_rv, dlt_th, dlt_rh, dlt_p,
                              tmp_rv0, tmp_th0, tmp_rh0, tmp_p0,
                              ssp0, dot_ssp, T_sd):
    """The per-SD (purely elementwise) body of cond_perparticle_adaptive —
    phase A adaptation + phase B masked substepping — over arrays of ANY
    layout: flat (n_part,) vectors or raveled dense (n_cell*cap,) planes.
    Shared verbatim by the flat engine (cond_perparticle_adaptive) and the
    dense engine (dense.step_cond_adaptive) so the two cannot drift; the
    callers own the layout-specific gathers and the per-cell closure.

    Returns (rw2, tmp_rv, tmp_th, tmp_rh, tmp_p, ssp)."""
    sstp_max = max(int(cfg.sstp_cond), 1)
    sstp_act = max(int(cfg.sstp_cond_act), 1)
    eps = cfg.sstp_cond_adapt_drw2_eps
    dmax = cfg.sstp_cond_adapt_drw2_max
    from types import SimpleNamespace
    live = n > 0
    # the phase A/B bodies below read the per-SD attributes through a
    # state-like view so they stay textually identical to the pre-split
    # flat implementation
    state = SimpleNamespace(rd3=rd3, kpa=kpa, vt=vt, n=n, rw2=rw2)

    def grow(tmp_rv, tmp_th, tmp_rh, tmp_p, ssp, rw2, dt_sub):
        Tp, pp, RHp, eta_p = _perparticle_thermo(
            cfg, tmp_th, tmp_rv, tmp_rh, tmp_p, ssp, turb_cond
        )
        rw2_new = advance_rw2(
            dt_sub, rw2, state.rd3, state.kpa, state.vt,
            tmp_rh, tmp_rv, Tp, pp, RHp, eta_p, lam_D_sd, lam_K_sd, RH_max,
        )
        return rw2_new, Tp

    # ---- phase A: pick per-SD substep counts (reference :130-201)
    tries = [1]
    while tries[-1] * 2 <= sstp_max:
        tries.append(tries[-1] * 2)

    tmp_rv, tmp_th, tmp_rh, tmp_p, ssp = (
        tmp_rv0, tmp_th0, tmp_rh0, tmp_p0, ssp0
    )
    sstp = jnp.full(state.n.shape, sstp_max, jnp.int32)
    done = jnp.zeros_like(live, dtype=bool)
    first_done = jnp.full_like(done, sstp_max == 1)
    drw2 = jnp.zeros_like(tmp_rv)

    for t in tries:
        mult = 1.0 if t == 1 else -1.0 / t
        upd = ~done
        tmp_rv = jnp.where(upd, tmp_rv + dlt_rv * mult, tmp_rv)
        tmp_th = jnp.where(upd, tmp_th + dlt_th * mult, tmp_th)
        tmp_rh = jnp.where(upd, tmp_rh + dlt_rh * mult, tmp_rh)
        if cfg.const_p:
            tmp_p = jnp.where(upd, tmp_p + dlt_p * mult, tmp_p)
        if turb_cond:
            ssp = jnp.where(upd, ssp + dot_ssp * dt * mult, ssp)

        rw2_t, _ = grow(tmp_rv, tmp_th, tmp_rh, tmp_p, ssp,
                        state.rw2, dt / t)
        drw2_t = rw2_t - state.rw2

        if t == 1:
            drw2 = drw2_t
            continue
        conv = (
            (jnp.abs(drw2_t * 2 - drw2) <= eps * state.rw2)
            & (jnp.abs(drw2) < dmax * state.rw2)
        )
        newly = conv & ~done
        sstp = jnp.where(newly, t // 2, sstp)
        # revert last delta addition -> state after one converged substep
        tmp_rv = jnp.where(newly, tmp_rv - dlt_rv * mult, tmp_rv)
        tmp_th = jnp.where(newly, tmp_th - dlt_th * mult, tmp_th)
        tmp_rh = jnp.where(newly, tmp_rh - dlt_rh * mult, tmp_rh)
        if cfg.const_p:
            tmp_p = jnp.where(newly, tmp_p - dlt_p * mult, tmp_p)
        if turb_cond:
            ssp = jnp.where(newly, ssp - dot_ssp * dt * mult, ssp)
        first_done = first_done | newly
        done = done | newly
        drw2 = jnp.where(done, drw2, drw2_t)

    # activation/deactivation override (reference :184-195)
    if sstp_act > 1:
        rc2 = kappa_koehler.rw3_cr(
            jnp.maximum(state.rd3, 1e-300),
            jnp.maximum(state.kpa, 1e-10),
            T_sd,
        ) ** (2.0 / 3)
        proj = state.rw2 + sstp * drw2
        crossing = ((state.rw2 < rc2) & (proj > rc2)) | (
            (state.rw2 > rc2) & (proj < rc2))
        sstp = jnp.where(crossing, sstp_act, sstp)
        first_done = first_done & ~crossing

    # abandonment: restore pristine pre-adaptation ambient state
    tmp_rv = jnp.where(first_done, tmp_rv, tmp_rv0)
    tmp_th = jnp.where(first_done, tmp_th, tmp_th0)
    tmp_rh = jnp.where(first_done, tmp_rh, tmp_rh0)
    tmp_p = jnp.where(first_done, tmp_p, tmp_p0)
    if turb_cond:
        ssp = jnp.where(first_done, ssp, ssp0)

    # ---- phase B: masked substepping (reference :206-263)
    n_steps = max(sstp_max, sstp_act)
    mlt = -(4.0 / 3) * c.pi * c.rho_w

    def substep(step, carry):
        rw2, tmp_rv, tmp_th, tmp_rh, tmp_p, ssp = carry
        active = (step < sstp) & live
        frac = 1.0 / sstp
        reuse = first_done & (step == 0)
        app = active & ~reuse

        tmp_rv_n = jnp.where(app, tmp_rv + dlt_rv * frac, tmp_rv)
        tmp_th_n = jnp.where(app, tmp_th + dlt_th * frac, tmp_th)
        tmp_rh_n = jnp.where(app, tmp_rh + dlt_rh * frac, tmp_rh)
        tmp_p_n = (jnp.where(app, tmp_p + dlt_p * frac, tmp_p)
                   if cfg.const_p else tmp_p)
        ssp_n = (jnp.where(app, ssp + dot_ssp * dt * frac, ssp)
                 if turb_cond else ssp)

        rw2_solve, Tp = grow(tmp_rv_n, tmp_th_n, tmp_rh_n, tmp_p_n, ssp_n,
                             rw2, dt * frac)
        rw2_new = jnp.where(reuse, rw2 + drw2, rw2_solve)
        rw2_new = jnp.where(active, rw2_new, rw2)

        rw3_old = rw2 * jnp.sqrt(jnp.maximum(rw2, 0.0))
        rw3_new = rw2_new * jnp.sqrt(jnp.maximum(rw2_new, 0.0))
        drw3 = jnp.where(active, rw3_new - rw3_old, 0.0)
        if cfg.n_dims > 0:
            drv = mlt * drw3 * state.n / tmp_rh_n / dv_sd
        else:
            drv = mlt * drw3 * state.n  # parcel: 1 kg dry air
        tmp_rv_n = tmp_rv_n + drv
        tmp_th_n = tmp_th_n + drv * theta_dry.d_th_d_rv(Tp, tmp_th_n)
        return (rw2_new, tmp_rv_n, tmp_th_n, tmp_rh_n, tmp_p_n, ssp_n)

    rw2, tmp_rv, tmp_th, tmp_rh, tmp_p, ssp = jax.lax.fori_loop(
        0, n_steps, substep,
        (state.rw2, tmp_rv, tmp_th, tmp_rh, tmp_p, ssp),
    )
    return rw2, tmp_rv, tmp_th, tmp_rh, tmp_p, ssp
