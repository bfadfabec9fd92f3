"""Dense cell-major SDM stepping backend (the occupancy-matrix layout).

The flat engine (state.py) stores the SD population as (n_sd_max,) vectors
keyed by a per-SD cell index — the direct analogue of the reference's sorted
thrust vectors (src/impl/particles_impl.ipp:66-146).  In that layout every
per-cell reduction is a sort+cumsum (or segment-sum) over the whole
population and every cell->SD read is a random-index gather.

This module is the cell-major redesign: the population lives in a dense
occupancy matrix of shape (n_cell, cap) with multiplicity n == 0 marking
empty slots.  Consequences:

  - cell -> SD "gathers" become row broadcasts (free, fused),
  - per-cell reductions (latent heating, moments) become row reductions
    (one fused pass, no sort/cumsum/segment ops),
  - the coalescence shuffle (reference particles_impl_coal.ipp:439-450:
    shuffle-sort + adjacent pairing) becomes a batched lane-wise sort of
    random keys — a cap-wide row sort instead of a global
    population-wide sort,
  - only re-binning after transport (once per model STEP, not per substep)
    needs a global sort + scatter.

Physics is shared with the flat engine (advance_rw2, kernel_value, vt_of,
RH_of...), so the two backends cannot drift; tests/test_dense.py gates the
dense step against the flat engine at f64.

Reference parity map:
  step_cond  = particles_step.ipp:237-256 percell substepping
  step_async = particles_step.ipp:339-494 (coal/adve/sedi/bcnd/re-bin)
"""

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp

from ..common import constants as c
from ..common import theta_dry
from . import coalescence as coal_mod
from . import hskpng
from . import vterm as vterm_mod
from .enums import as_t, kernel_t
from .state import (OUT_DRY_VOL, OUT_LIQ_NUM, OUT_LIQ_VOL, OUT_PRTCL_NUM,
                    PUDDLE_KEYS, State, StaticConfig)


@jax.tree_util.register_dataclass
@dataclasses.dataclass
class DenseState:
    """Cell-major SD population + per-cell thermodynamics.

    SD attribute matrices have shape (n_cell, cap); cell vectors (n_cell,).
    Empty slots carry n == 0.  Slot order within a row is meaningless (the
    coalescence shuffle permutes rows freely) — SD identity is the tuple of
    attributes riding together through every lane-wise sort."""

    # --- per-SD attributes (n_cell, cap)
    n: jax.Array
    rw2: jax.Array
    rd3: jax.Array
    kpa: jax.Array
    vt: jax.Array
    x: jax.Array
    z: jax.Array
    y: jax.Array               # (n_cell, cap) in 3-D, (0, 0) otherwise
    # --- per-cell fields (n_cell,)
    rhod: jax.Array
    p: jax.Array
    T: jax.Array
    RH: jax.Array
    eta: jax.Array
    dv: jax.Array
    sstp_tmp_th: jax.Array
    sstp_tmp_rv: jax.Array
    # --- courant fields, flattened staggered layout (same as State)
    courant_x: jax.Array
    courant_y: jax.Array       # empty outside 3-D
    courant_z: jax.Array
    # --- bookkeeping
    key: jax.Array
    puddle: jax.Array          # same slots as State.puddle
    overflow: jax.Array        # SDs dropped because a row filled up
    # per-SD private ambient copies for exact (per-particle) condensation
    # substepping (reference sstp_tmp_*, particles_impl.ipp:86-91); empty
    # (0, 0) planes outside exact mode.  Values are row-constant between
    # steps (sstp_save gathers cell values), so they need not ride the
    # in-row coalescence shuffle — only the re-binning (a moved SD keeps
    # its OLD cell's snapshot, like the reference's migration payload,
    # particles_impl.ipp:440-494)
    sd_th: jax.Array = dataclasses.field(
        default_factory=lambda: jnp.zeros((0, 0), jnp.float32))
    sd_rv: jax.Array = dataclasses.field(
        default_factory=lambda: jnp.zeros((0, 0), jnp.float32))
    sd_rh: jax.Array = dataclasses.field(
        default_factory=lambda: jnp.zeros((0, 0), jnp.float32))
    sd_p: jax.Array = dataclasses.field(
        default_factory=lambda: jnp.zeros((0, 0), jnp.float32))

    @property
    def cap(self):
        return self.n.shape[1]

    @property
    def n_cell(self):
        return self.n.shape[0]


def _supported(cfg: StaticConfig):
    """The dense backend covers the production kinematic workload plus
    const_p/th_std, every advection scheme, and all three condensation
    substepping modes (percell, exact fixed-count, adaptive); only
    ice/chem/SGS and diag_incloud_time stay on the flat engine."""
    if cfg.n_dims not in (2, 3):
        raise NotImplementedError("dense engine: 2-D/3-D only")
    if cfg.ice_switch or cfg.chem_switch or cfg.turb_cond_switch:
        raise NotImplementedError("dense engine: ice/chem/SGS not supported")
    if cfg.diag_incloud_time:
        raise NotImplementedError("dense engine: diag_incloud_time off only")


# ------------------------------------------------------------------ pack/
def _distribute(cfg: StaticConfig, cap, cell, vals):
    """Sort SD slots by target cell and gather them into a dense
    (n_cell, cap) matrix; cell == n_cell marks dead slots (dropped).
    Returns (dense_vals, n_overflowed).

    The attribute planes ride the stable sort by cell; then ONE 1-D
    scatter per plane places them: sorted position p belongs to cell
    c = cell_s[p] at lane l = p - (start of c's run), the run start coming
    from a cummax over run boundaries — no per-element gathers, and the
    scatters have unique targets."""
    n_cell = cfg.n_cell
    N = cell.shape[0]
    sorted_ = jax.lax.sort((cell.astype(jnp.int32),) + tuple(vals),
                           num_keys=1)
    cell_s, vals_s = sorted_[0], sorted_[1:]
    pos = jnp.arange(N, dtype=jnp.int32)
    prev = jnp.concatenate([jnp.full((1,), -1, jnp.int32), cell_s[:-1]])
    run_start = jax.lax.cummax(jnp.where(cell_s != prev, pos, jnp.int32(0)))
    l = pos - run_start
    in_dom = cell_s < n_cell
    tgt = jnp.where(in_dom & (l < cap), cell_s * cap + l, n_cell * cap)
    dense_vals = tuple(
        jnp.zeros((n_cell, cap), v.dtype).reshape(-1)
        .at[tgt].set(v, mode="drop").reshape(n_cell, cap)
        for v in vals_s)
    overflow = jnp.sum(jnp.where(in_dom & (l >= cap), 1, 0))
    return dense_vals, overflow


_ATTRS = ("n", "rw2", "rd3", "kpa", "vt", "x", "z")
# dense plane name -> flat State attribute (identity unless listed)
_FLAT_NAME = {"sd_th": "sstp_tmp_th", "sd_rv": "sstp_tmp_rv",
              "sd_rh": "sstp_tmp_rh", "sd_p": "sstp_tmp_p"}


def attrs_of(cfg: StaticConfig):
    """Per-SD planes of the dense layout for this config (y in 3-D;
    private ambient copies in exact-substepping mode)."""
    return _ATTRS + (("y",) if cfg.n_dims == 3 else ()) \
        + (("sd_th", "sd_rv", "sd_rh", "sd_p")
           if cfg.exact_sstp_cond else ())


def row_capacity(occupancy) -> int:
    """Row capacity for a population whose densest cell holds
    ``occupancy`` SDs: twice that, 8-lane aligned (no power-of-two
    rounding — every phase runs at any width)."""
    return max(8, -(-2 * int(occupancy) // 8) * 8)


def pack(cfg: StaticConfig, state: State, cap: int) -> DenseState:
    """Flat State -> DenseState (one global sort + scatter)."""
    _supported(cfg)
    attrs = attrs_of(cfg)
    cell = jnp.where(state.n > 0, state.ijk, cfg.n_cell)
    vals = tuple(getattr(state, _FLAT_NAME.get(a, a)) for a in attrs)
    dense_vals, overflow = _distribute(cfg, cap, cell, vals)
    d = dict(zip(attrs, dense_vals))
    if cfg.n_dims != 3:
        d["y"] = jnp.zeros((0, 0), state.x.dtype)
    return DenseState(
        rhod=state.rhod, p=state.p, T=state.T, RH=state.RH, eta=state.eta,
        dv=state.dv,
        sstp_tmp_th=state.sstp_tmp_th, sstp_tmp_rv=state.sstp_tmp_rv,
        courant_x=state.courant_x, courant_y=state.courant_y,
        courant_z=state.courant_z,
        key=state.key, puddle=state.puddle, overflow=overflow, **d,
    )


def repack(cfg: StaticConfig, d: DenseState, new_cap: int) -> DenseState:
    """Redistribute the dense population into a NEW row capacity (one
    global sort + scatter, like pack but dense->dense).  The occupancy-
    aware repack policy of the device-resident loop (run_device_lgrngn)
    uses this to keep cap tracking the evolved population instead of
    doubling per-lane costs forever."""
    n_cell, cap = d.n.shape
    attrs = attrs_of(cfg)
    flat = tuple(getattr(d, a).reshape(-1) for a in attrs)
    rows = jnp.repeat(jnp.arange(n_cell, dtype=jnp.int32), cap)
    cell = jnp.where(flat[0] > 0, rows, n_cell)
    dense_vals, overflow = _distribute(cfg, new_cap, cell, flat)
    upd = dict(zip(attrs, dense_vals))
    return dataclasses.replace(d, overflow=d.overflow + overflow, **upd)


def unpack(cfg: StaticConfig, d: DenseState, state: State) -> State:
    """DenseState -> flat State (alive slots first, truncated to n_sd_max).

    The caller must ensure the alive population fits n_sd_max (it always
    does: stepping never creates SDs)."""
    n_cell, cap = d.n.shape
    attrs = attrs_of(cfg)
    flat = {a: getattr(d, a).reshape(-1) for a in attrs}  # dense names
    alive = flat["n"] > 0
    ijk = jnp.where(
        alive,
        jnp.repeat(jnp.arange(n_cell, dtype=jnp.int32), cap), 0)
    deadkey = (~alive).astype(jnp.int32)
    sorted_ = jax.lax.sort(
        (deadkey, ijk) + tuple(flat[a] for a in attrs), num_keys=1)
    n_sd = state.n_sd_max
    upd = {_FLAT_NAME.get(a, a): sorted_[2 + i][:n_sd]
           for i, a in enumerate(attrs)}
    upd["ijk"] = sorted_[1][:n_sd]
    base = dict(th=d.sstp_tmp_th, rv=d.sstp_tmp_rv, p=d.p, T=d.T, RH=d.RH,
                eta=d.eta, key=d.key, puddle=d.puddle)
    if not cfg.exact_sstp_cond:
        base.update(sstp_tmp_th=d.sstp_tmp_th, sstp_tmp_rv=d.sstp_tmp_rv,
                    sstp_tmp_rh=d.rhod)
    return dataclasses.replace(state, **base, **upd)


# --------------------------------------------------------------- cond ----
def _Tpr(cfg: StaticConfig, th, rv, rhod, p0=None):
    """Per-cell T/p/RH/eta closure (hskpng_Tpr.ipp:219-305): th_dry or
    th_std+const_p (``p0`` is the fixed pressure profile)."""
    from ..common import theta_std
    from ..common import vterm as cv
    if cfg.th_dry:
        T = theta_dry.T(th, rhod)
    else:
        T = th * theta_std.exner(p0)
    p = p0 if cfg.const_p else theta_dry.p(rhod, rv, T)
    RH = hskpng.RH_of(cfg, p, rv, T)
    eta = cv.visc(T)
    return T, p, RH, eta


def step_cond(cfg: StaticConfig, d: DenseState, th, rv, dt, RH_max):
    """Condensation phase on the dense layout: percell substepping by
    default, per-particle (exact) fixed-count substepping when configured
    (same dispatch condition as the flat engine, particles.py
    step_cond_body / reference particles_step.ipp:199-236)."""
    if cfg.exact_sstp_cond and (cfg.sstp_cond > 1 or cfg.sstp_cond_act > 1):
        if cfg.adaptive_sstp_cond:
            return step_cond_adaptive(cfg, d, th, rv, dt, RH_max)
        return step_cond_exact(cfg, d, th, rv, dt, RH_max)
    return _step_cond_percell(cfg, d, th, rv, dt, RH_max)


def step_cond_exact(cfg: StaticConfig, d: DenseState, th, rv, dt, RH_max):
    """Exact per-particle condensation substepping, cell-major — the same
    math as condensation.cond_perparticle (reference particles_step.ipp:
    219-232 + src/impl/condensation/perparticle/) with the per-SD ambient
    copies as (n_cell, cap) planes, the in-cell mixing sums as row
    reductions, and the cell closure per row.  Ends with the exact-mode
    sstp_save (per-SD copies re-gathered from the updated cell values,
    sstp_save.ipp:13-34)."""
    from .condensation import (_perparticle_thermo, advance_rw2,
                               apply_drv_to_th_rv)

    sstp = cfg.sstp_cond
    dt_sub = dt / sstp
    mix = bool(cfg.sstp_cond_mix)
    row = lambda a: a[:, None]

    # stale mean free paths (previous step's T/p), then the Tpr refresh
    # from the freshly advected fields — the flat step_cond_body order
    lam_D_c, lam_K_c = hskpng.hskpng_mfp(d.T, d.p)
    T, p, RH, eta = _Tpr(cfg, th, rv, d.rhod, d.p)
    lam_D = row(lam_D_c)
    lam_K = row(lam_K_c)

    dlt_rv = row(rv) - d.sd_rv
    dlt_th = row(th) - d.sd_th
    dlt_rh = row(d.rhod) - d.sd_rh
    dlt_p = row(p) - d.sd_p
    live = d.n > 0
    dv_sd = row(d.dv)
    shape = d.rw2.shape

    def substep(_, carry):
        rw2, tmp_rv0, tmp_th0, tmp_rh, tmp_p = carry
        tmp_rv = tmp_rv0 + dlt_rv / sstp
        tmp_th = tmp_th0 + dlt_th / sstp
        tmp_rh = tmp_rh + dlt_rh / sstp
        tmp_p = tmp_p + (dlt_p / sstp if cfg.const_p else 0.0)

        Tp, pp, RHp, eta_p = _perparticle_thermo(
            cfg, tmp_th, tmp_rv, tmp_rh, tmp_p, 0.0, False)

        rw3_old = rw2 * jnp.sqrt(jnp.maximum(rw2, 0.0))
        rw2_new = advance_rw2(
            dt_sub, rw2.ravel(), d.rd3.ravel(), d.kpa.ravel(),
            d.vt.ravel(), tmp_rh.ravel(), tmp_rv.ravel(), Tp.ravel(),
            pp.ravel(), RHp.ravel(), eta_p.ravel(),
            jnp.broadcast_to(lam_D, shape).ravel(),
            jnp.broadcast_to(lam_K, shape).ravel(), RH_max,
        ).reshape(shape)
        rw3_new = rw2_new * jnp.sqrt(jnp.maximum(rw2_new, 0.0))
        drw3 = jnp.where(live, rw3_new - rw3_old, 0.0)

        mlt = -(4.0 / 3) * c.pi * c.rho_w
        drv = mlt * drw3 * d.n / tmp_rh / dv_sd
        if mix:
            # in-cell mixing each substep: the cell sums of drv and of the
            # per-SD dth are shared by every SD of the row
            # (update_pstate; flat cond_perparticle mix branch)
            drv_eff = jnp.sum(drv, axis=1, keepdims=True)
            dth_own = drv * theta_dry.d_th_d_rv(Tp, tmp_th)
            cell_dth = jnp.sum(dth_own, axis=1, keepdims=True)
            tmp_th = tmp_th0 + dlt_th / sstp + cell_dth
            tmp_rv = tmp_rv0 + dlt_rv / sstp + drv_eff
        else:
            tmp_rv = tmp_rv + drv
            tmp_th = tmp_th + drv * theta_dry.d_th_d_rv(Tp, tmp_th)
        return (rw2_new, tmp_rv, tmp_th, tmp_rh, tmp_p)

    if not mix:
        wgt = d.n / (d.dv * d.rhod)[:, None]
        rw3 = d.rw2 * jnp.sqrt(jnp.maximum(d.rw2, 0.0))
        mom3_before = jnp.sum(jnp.where(live, wgt * rw3, 0.0), axis=1)

    rw2, tmp_rv, tmp_th, tmp_rh, tmp_p = jax.lax.fori_loop(
        0, sstp, substep,
        (d.rw2, d.sd_rv, d.sd_th, d.sd_rh, d.sd_p))

    if mix:
        # every alive SD of a row carries IDENTICAL private cell values
        # (the mixing sums are row-shared); copy any one back to the cell
        # (update_state, particles_impl_update_th_rv.ipp:283-297)
        cnt = jnp.sum(jnp.where(live, 1, 0), axis=1)
        neg = jnp.array(-jnp.inf, tmp_rv.dtype)
        pick = lambda v: jnp.max(jnp.where(live, v, neg), axis=1)
        rv_c = jnp.where(cnt > 0, pick(tmp_rv), rv)
        th_c = jnp.where(cnt > 0, pick(tmp_th), th)
    else:
        rw3 = rw2 * jnp.sqrt(jnp.maximum(rw2, 0.0))
        mom3_after = jnp.sum(jnp.where(live, wgt * rw3, 0.0), axis=1)
        drv_cell = (mom3_after - mom3_before) * (4.0 / 3) * c.pi * c.rho_w
        th_c, rv_c = apply_drv_to_th_rv(cfg, th, rv, d.rhod, p, drv_cell)

    # sstp_save, exact mode: per-SD copies := the UPDATED cell values;
    # the p snapshot is the PRE-cond refresh (the reference's sstp_save
    # runs before step_async's hskpng_Tpr).  The cell T/p/RH/eta then
    # take the post-cond refresh that the flat pipeline gets at
    # step_async entry (particles.py:132-167) — the dense step_async
    # reads them directly.
    T2, p2, RH2, eta2 = _Tpr(cfg, th_c, rv_c, d.rhod, d.p)
    d = dataclasses.replace(
        d, rw2=rw2, T=T2, p=p2, RH=RH2, eta=eta2,
        sstp_tmp_th=th_c, sstp_tmp_rv=rv_c,
        sd_th=jnp.broadcast_to(row(th_c), shape),
        sd_rv=jnp.broadcast_to(row(rv_c), shape),
        sd_rh=jnp.broadcast_to(row(d.rhod), shape),
        sd_p=jnp.broadcast_to(row(p), shape),
    )
    return d, th_c, rv_c


def step_cond_adaptive(cfg: StaticConfig, d: DenseState, th, rv, dt,
                       RH_max):
    """Adaptive per-SD condensation substepping on the dense layout
    (reference perparticle_nomixing_adaptive_sstp_cond.ipp:8-335).

    The per-SD adaptation and masked substepping are purely elementwise,
    so the dense engine feeds the RAVELED (n_cell*cap,) planes through the
    SAME condensation.perparticle_adaptive_core the flat engine uses (the
    two cannot drift); only the gathers (row broadcasts here), the
    liquid-content row reduction and the cell closure are layout-specific.
    Ends with the exact-mode sstp_save like step_cond_exact."""
    from .condensation import (apply_drv_to_th_rv,
                               perparticle_adaptive_core)

    row = lambda a: a[:, None]
    shape = d.rw2.shape
    flat = lambda a: jnp.broadcast_to(a, shape).ravel()

    # stale mean free paths, then the Tpr refresh from the advected fields
    # (the flat step_cond_body order)
    lam_D_c, lam_K_c = hskpng.hskpng_mfp(d.T, d.p)
    T, p, RH, eta = _Tpr(cfg, th, rv, d.rhod, d.p)

    live = d.n > 0
    wgt = d.n / (d.dv * d.rhod)[:, None]
    rw3 = d.rw2 * jnp.sqrt(jnp.maximum(d.rw2, 0.0))
    mom3_before = jnp.sum(jnp.where(live, wgt * rw3, 0.0), axis=1)

    zero = jnp.zeros(shape, d.rw2.dtype).ravel()
    rw2, tmp_rv, tmp_th, tmp_rh, tmp_p, _ssp = perparticle_adaptive_core(
        cfg, dt, RH_max, False,
        n=d.n.ravel(), rw2=d.rw2.ravel(), rd3=d.rd3.ravel(),
        kpa=d.kpa.ravel(), vt=d.vt.ravel(), dv_sd=flat(row(d.dv)),
        lam_D_sd=flat(row(lam_D_c)), lam_K_sd=flat(row(lam_K_c)),
        dlt_rv=(row(rv) - d.sd_rv).ravel(),
        dlt_th=(row(th) - d.sd_th).ravel(),
        dlt_rh=(row(d.rhod) - d.sd_rh).ravel(),
        dlt_p=(row(p) - d.sd_p).ravel() if cfg.const_p else 0.0,
        tmp_rv0=d.sd_rv.ravel(), tmp_th0=d.sd_th.ravel(),
        tmp_rh0=d.sd_rh.ravel(),
        tmp_p0=d.sd_p.ravel() if cfg.const_p else zero,
        ssp0=zero, dot_ssp=0.0, T_sd=flat(row(T)),
    )
    rw2 = rw2.reshape(shape)

    rw3 = rw2 * jnp.sqrt(jnp.maximum(rw2, 0.0))
    mom3_after = jnp.sum(jnp.where(live, wgt * rw3, 0.0), axis=1)
    drv_cell = (mom3_after - mom3_before) * (4.0 / 3) * c.pi * c.rho_w
    th_c, rv_c = apply_drv_to_th_rv(cfg, th, rv, d.rhod, p, drv_cell)

    # sstp_save, exact mode (see step_cond_exact tail): per-SD copies :=
    # the UPDATED cell values; p snapshot is the pre-cond refresh
    T2, p2, RH2, eta2 = _Tpr(cfg, th_c, rv_c, d.rhod, d.p)
    d = dataclasses.replace(
        d, rw2=rw2, T=T2, p=p2, RH=RH2, eta=eta2,
        sstp_tmp_th=th_c, sstp_tmp_rv=rv_c,
        sd_th=jnp.broadcast_to(row(th_c), shape),
        sd_rv=jnp.broadcast_to(row(rv_c), shape),
        sd_rh=jnp.broadcast_to(row(d.rhod), shape),
        sd_p=jnp.broadcast_to(row(p), shape),
    )
    return d, th_c, rv_c


def _step_cond_percell(cfg: StaticConfig, d: DenseState, th, rv, dt, RH_max):
    """Percell substepped condensation on the dense layout — the physics of
    condensation.cond_percell/_cond_percell_sorted with the per-cell
    liquid-water sum as one row reduction (reference particles_step.ipp:
    237-256 + sstp_percell_step.ipp:7-49).

    th/rv are the freshly-advected cell fields (n_cell,); returns the
    post-condensation (DenseState, th, rv)."""
    sstp = cfg.sstp_cond
    dt_sub = dt / sstp

    delta_th = th - d.sstp_tmp_th
    delta_rv = rv - d.sstp_tmp_rv
    # rewind to the pre-sync values; feed the advective delta back in sstp
    # equal increments (sstp_percell_step.ipp:21-47)
    th0, rv0 = d.sstp_tmp_th, d.sstp_tmp_rv

    # loop invariants; mean free paths are STALE — from the cell T/p of the
    # previous step's end (matches the flat engine's stale_mfp and the
    # reference's once-per-step hskpng_mfp, particles_step.ipp:190-196)
    lam_D, lam_K = hskpng.hskpng_mfp(d.T, d.p)
    wgt = d.n * ((4.0 / 3) * c.pi * c.rho_w) / (d.dv * d.rhod)[:, None]

    from .condensation import advance_rw2_rows

    def substep(_, carry):
        rw2, th, rv = carry
        th = th + delta_th / sstp
        rv = rv + delta_rv / sstp
        T, p, RH, eta = _Tpr(cfg, th, rv, d.rhod, d.p)
        rw2_new = advance_rw2_rows(
            dt_sub, rw2, d.rd3, d.kpa, d.vt,
            (d.rhod, rv, T, p, RH, eta, lam_D, lam_K), RH_max)
        drw3 = rw2_new * jnp.sqrt(rw2_new) - rw2 * jnp.sqrt(
            jnp.maximum(rw2, 0.0))
        drv = -jnp.sum(wgt * drw3, axis=1)
        rv = rv + drv
        th = th + drv * theta_dry.d_th_d_rv(T, th)
        return rw2_new, th, rv

    rw2, th, rv = jax.lax.fori_loop(0, sstp, substep, (d.rw2, th0, rv0))
    T, p, RH, eta = _Tpr(cfg, th, rv, d.rhod, d.p)
    upd = {}
    if cfg.exact_sstp_cond:
        # exact mode dispatched here because sstp_cond == 1: still refresh
        # the per-SD ambient planes like the flat engine's per-step
        # sstp_save(exact=True) — they ride the re-binning, so leaving
        # them stale breaks state parity silently
        shape = d.rw2.shape
        row = lambda a: jnp.broadcast_to(a[:, None], shape)
        upd = dict(sd_th=row(th), sd_rv=row(rv), sd_rh=row(d.rhod),
                   sd_p=row(p))
    d = dataclasses.replace(
        d, rw2=rw2, T=T, p=p, RH=RH, eta=eta,
        sstp_tmp_th=th, sstp_tmp_rv=rv,  # sstp_save (sstp_save.ipp:7-35)
        **upd,
    )
    return d, th, rv


# --------------------------------------------------------------- coal ----
def _lshift(a):
    """a[:, i+1] with the last lane repeated (batched _shift_up)."""
    return jnp.concatenate([a[:, 1:], a[:, -1:]], axis=1)


def _rshift(a):
    """a[:, i-1] with the first lane repeated."""
    return jnp.concatenate([a[:, :1], a[:, :-1]], axis=1)


def _rshift_mask(m):
    """m[:, i-1] with False injected at lane 0."""
    return jnp.concatenate(
        [jnp.zeros_like(m[:, :1]), m[:, :-1]], axis=1)


def pair_and_collide(cfg: StaticConfig, params, sorted_vals, count,
                     dv_row, rhod_row, eta_row, dt, u01,
                     eff_table=None, r_max_um=0.0):
    """Post-shuffle pairing + Shima collision math on row-sorted SD blocks
    (reference particles_impl_coal.ipp:98-546 after the shuffle-sort).

    Pure jnp over (rows, cap) arrays.  ``sorted_vals`` is
    (n, rw2, rd3, kpa, vt) sorted by the random key within each row;
    ``u01`` the Bernoulli draws; row vectors are (rows, 1)-broadcastable.
    Returns (n, rw2, rd3, kpa, overflow_flag)."""
    n_a, rw2_a, rd3_a, kpa_a, vt_a = sorted_vals
    cap = n_a.shape[-1]

    # Shima 2009 sec 5.1.3 scale factor (coal.ipp:99-107)
    half = jnp.floor(count / 2)
    scale = jnp.where(count > 1, count * (count - 1) / 2.0 / half, 0.0)

    lane = jax.lax.broadcasted_iota(jnp.int32, n_a.shape, n_a.ndim - 1)
    is_pair = (lane % 2 == 0) & (lane + 1 < count)

    n_b = _lshift(n_a)
    rw2_b = _lshift(rw2_a)
    rd3_b = _lshift(rd3_a)
    kpa_b = _lshift(kpa_a)
    vt_b = _lshift(vt_a)

    K = coal_mod.kernel_value(
        cfg, params, n_a, n_b, rw2_a, rw2_b, vt_a, vt_b, rd3_a, rd3_b,
        eff_table=eff_table, r_max_um=r_max_um,
        rhod=rhod_row, eta=eta_row, diss_rate=0.0,
    )
    prob = dt / dv_row * scale * K
    prob = jnp.where(is_pair, prob, 0.0)

    # all-or-nothing multi-collision (coal.ipp:218-236)
    col_no = jnp.floor(prob)
    overflow = jnp.max(jnp.where(is_pair, col_no, 0.0)) >= 1.0
    col_no = col_no + (u01 < prob - col_no)

    a_is_big = n_a >= n_b
    n_big = jnp.where(a_is_big, n_a, n_b)
    n_small = jnp.where(a_is_big, n_b, n_a)
    ratio = jnp.where(n_small > 0,
                      jnp.floor(n_big / jnp.maximum(n_small, 1)), 0.0)
    col_no = jnp.minimum(col_no, ratio)
    happened = is_pair & (col_no > 0)

    rw2_big = jnp.where(a_is_big, rw2_a, rw2_b)
    rw2_small = jnp.where(a_is_big, rw2_b, rw2_a)
    rd3_big = jnp.where(a_is_big, rd3_a, rd3_b)
    rd3_small = jnp.where(a_is_big, rd3_b, rd3_a)
    kpa_big = jnp.where(a_is_big, kpa_a, kpa_b)
    kpa_small = jnp.where(a_is_big, kpa_b, kpa_a)

    # Shima eqs. 12-13 (coal.ipp:118-143)
    n_big_new = n_big - col_no * n_small
    rw3_small_new = col_no * rw2_big * jnp.sqrt(rw2_big) \
        + rw2_small * jnp.sqrt(rw2_small)
    rw2_small_new = jnp.cbrt(rw3_small_new) ** 2
    rd3_small_new = col_no * rd3_big + rd3_small
    kpa_small_new = jnp.where(
        rd3_small_new > 0,
        (col_no * kpa_big * rd3_big + kpa_small * rd3_small)
        / jnp.maximum(rd3_small_new, 1e-300),
        kpa_small,
    )

    # pair outcome applied through lane shifts (lane p holds the math,
    # lane p+1 reads it shifted) — exactly the flat engine's sorted-space
    # write-back, minus the sort-back.  The masks shift in float space
    # (0.0/1.0 shift identically)
    hp = _rshift_mask(happened.astype(n_a.dtype)) > 0
    bigp = _rshift(a_is_big.astype(n_a.dtype)) > 0

    n_s = jnp.where(happened & a_is_big, n_big_new, n_a)
    n_s = jnp.where(hp & ~bigp, _rshift(n_big_new), n_s)
    rw2_s = jnp.where(happened & ~a_is_big, rw2_small_new, rw2_a)
    rw2_s = jnp.where(hp & bigp, _rshift(rw2_small_new), rw2_s)
    rd3_s = jnp.where(happened & ~a_is_big, rd3_small_new, rd3_a)
    rd3_s = jnp.where(hp & bigp, _rshift(rd3_small_new), rd3_s)
    kpa_s = jnp.where(happened & ~a_is_big, kpa_small_new, kpa_a)
    kpa_s = jnp.where(hp & bigp, _rshift(kpa_small_new), kpa_s)
    return n_s, rw2_s, rd3_s, kpa_s, overflow


def _xor_partner(a, stride, lane):
    """a[:, lane ^ stride] for power-of-two ``stride`` — two static lane
    rolls + a parity select."""
    fwd = jnp.roll(a, -stride, axis=1)
    bwd = jnp.roll(a, stride, axis=1)
    return jnp.where((lane & stride) == 0, fwd, bwd)


def pair_and_collide_stride(cfg: StaticConfig, params, vals, stride,
                            dv_row, rhod_row, eta_row, dt, u01,
                            eff_table=None, r_max_um=0.0):
    """Shima collision math with XOR-stride partners: lane i pairs with
    lane i ^ stride, no per-substep shuffle sort.

    The reference re-randomises the in-cell pairing every coalescence substep
    with a full random-key sort (particles_impl_coal.ipp:439-450 +
    hskpng_sort.ipp:15-70).  Stride pairing shuffles ONCE per few substeps and
    cycles the XOR stride in between: conditional on a uniform random lane
    placement the matching {(sigma(i), sigma(i ^ s))} is a uniform random
    perfect matching for every s, successive strides never repeat a pair, and
    the scale factor below keeps the collision-count estimator unbiased for any
    number of formed pairs (the same correction the reference applies for its
    floor(k/2) pairs, coal.ipp:99-107).

    Pairs straddling a dead lane are skipped; ``scale`` = k(k-1)/2 /
    n_pairs over the k alive SDs generalises the reference's
    k(k-1)/2/floor(k/2).  Each lane computes its own pair's outcome from
    the partner planes (symmetric math, shared per-pair uniform draw), so
    there is no post-hoc write-back shift.  ``stride`` must be static
    (lane rolls).  Returns
    (n, rw2, rd3, kpa, overflow_flag)."""
    n_a = vals[0]
    lane = jax.lax.broadcasted_iota(jnp.int32, n_a.shape, n_a.ndim - 1)
    partners = tuple(_xor_partner(a, stride, lane) for a in vals)
    is_a = (lane & stride) == 0
    u_b = _xor_partner(u01, stride, lane)
    return pair_and_collide_partners(
        cfg, params, vals, partners, is_a, dv_row, rhod_row, eta_row,
        dt, u01, u_b, eff_table=eff_table, r_max_um=r_max_um)


def pair_and_collide_partners(cfg: StaticConfig, params, vals, partners,
                              is_a, dv_row, rhod_row, eta_row, dt,
                              u01, u01_b,
                              eff_table=None, r_max_um=0.0):
    """The symmetric collision math of pair_and_collide_stride given
    pre-fetched partner planes (see there for semantics): every lane
    holds one SD of a pair, ``partners`` its partner's (n, rw2, rd3,
    kpa, vt), ``is_a`` which lane of each pair carries the Bernoulli
    draw (``u01`` own draw, ``u01_b`` the partner's)."""
    n_a, rw2_a, rd3_a, kpa_a, vt_a = vals
    n_b, rw2_b, rd3_b, kpa_b, vt_b = partners

    alive = n_a > 0
    pair_ok = alive & (n_b > 0)
    one = jnp.ones_like(n_a)
    zero = jnp.zeros_like(n_a)
    count = jnp.sum(jnp.where(alive, one, zero), axis=-1, keepdims=True)
    npairs = jnp.sum(jnp.where(pair_ok & is_a, one, zero),
                     axis=-1, keepdims=True)
    scale = jnp.where((count > 1) & (npairs > 0),
                      count * (count - 1) / 2.0
                      / jnp.maximum(npairs, 1.0), 0.0)

    K = coal_mod.kernel_value(
        cfg, params, n_a, n_b, rw2_a, rw2_b, vt_a, vt_b, rd3_a, rd3_b,
        eff_table=eff_table, r_max_um=r_max_um,
        rhod=rhod_row, eta=eta_row, diss_rate=0.0,
    )
    prob = jnp.where(pair_ok, dt / dv_row * scale * K, 0.0)

    # all-or-nothing multi-collision (coal.ipp:218-236); the Bernoulli
    # draw must be the SAME on both lanes of a pair — take the a-lane's
    u_pair = jnp.where(is_a, u01, u01_b)
    col_no = jnp.floor(prob)
    overflow = jnp.max(jnp.where(pair_ok, col_no, 0.0)) >= 1.0
    col_no = col_no + (u_pair < prob - col_no)

    # role assignment is symmetric with an is_a tiebreak on equal n
    self_is_big = (n_a > n_b) | ((n_a == n_b) & is_a)
    n_big = jnp.where(self_is_big, n_a, n_b)
    n_small = jnp.where(self_is_big, n_b, n_a)
    ratio = jnp.where(n_small > 0,
                      jnp.floor(n_big / jnp.maximum(n_small, 1)), 0.0)
    col_no = jnp.minimum(col_no, ratio)
    happened = pair_ok & (col_no > 0)

    rw2_big = jnp.where(self_is_big, rw2_a, rw2_b)
    rw2_small = jnp.where(self_is_big, rw2_b, rw2_a)
    rd3_big = jnp.where(self_is_big, rd3_a, rd3_b)
    rd3_small = jnp.where(self_is_big, rd3_b, rd3_a)
    kpa_big = jnp.where(self_is_big, kpa_a, kpa_b)
    kpa_small = jnp.where(self_is_big, kpa_b, kpa_a)

    # Shima eqs. 12-13 (coal.ipp:118-143), applied to SELF per role
    n_big_new = n_big - col_no * n_small
    rw3_small_new = col_no * rw2_big * jnp.sqrt(rw2_big) \
        + rw2_small * jnp.sqrt(rw2_small)
    rw2_small_new = jnp.cbrt(rw3_small_new) ** 2
    rd3_small_new = col_no * rd3_big + rd3_small
    kpa_small_new = jnp.where(
        rd3_small_new > 0,
        (col_no * kpa_big * rd3_big + kpa_small * rd3_small)
        / jnp.maximum(rd3_small_new, 1e-300),
        kpa_small,
    )

    n_s = jnp.where(happened & self_is_big, n_big_new, n_a)
    rw2_s = jnp.where(happened & ~self_is_big, rw2_small_new, rw2_a)
    rd3_s = jnp.where(happened & ~self_is_big, rd3_small_new, rd3_a)
    kpa_s = jnp.where(happened & ~self_is_big, kpa_small_new, kpa_a)
    return n_s, rw2_s, rd3_s, kpa_s, overflow


def coal_substep(cfg: StaticConfig, d: DenseState, params, dt, key,
                 eff_table, r_max_um):
    """One SDM coalescence substep, cell-major (reference
    particles_impl_coal.ipp:273-546).

    The reference's global shuffle-sort becomes one batched lane-wise sort
    of random keys per row: alive slots draw u01 < 1, empty slots key 2.0 so
    they sort past every live SD; all pair attributes ride the sort as
    values.  No sort-back is needed — slot order within a row carries no
    meaning."""
    n_cell, cap = d.n.shape
    u = jax.random.uniform(key, (n_cell, cap))
    alive = d.n > 0
    skey = jnp.where(alive, u, 2.0)

    ops = (skey, d.n, d.rw2, d.rd3, d.kpa, d.vt, d.x, d.z) \
        + ((d.y,) if cfg.n_dims == 3 else ())
    sorted_ = jax.lax.sort(ops, dimension=1, num_keys=1)
    x_s, z_s = sorted_[6], sorted_[7]
    y_s = sorted_[8] if cfg.n_dims == 3 else d.y
    vt_a = sorted_[5]

    count = jnp.sum(alive, axis=1).astype(d.n.dtype)[:, None]
    u01 = jax.random.uniform(jax.random.fold_in(key, 1), (n_cell, cap))
    n_s, rw2_s, rd3_s, kpa_s, ovf = pair_and_collide(
        cfg, params, sorted_[1:6], count,
        d.dv[:, None], d.rhod[:, None], d.eta[:, None], dt, u01,
        eff_table=eff_table, r_max_um=r_max_um,
    )
    puddle = d.puddle
    if cfg.pure_const_multi:
        # adaptive sstp_coal growth request (coal.ipp:224-227)
        from .state import OUT_COAL_OVERFLOW
        puddle = puddle.at[OUT_COAL_OVERFLOW].max(
            ovf.astype(puddle.dtype))
    return dataclasses.replace(
        d, n=n_s, rw2=rw2_s, rd3=rd3_s, kpa=kpa_s, vt=vt_a, x=x_s, y=y_s,
        z=z_s, puddle=puddle)


def coal(cfg: StaticConfig, d: DenseState, params, dt, sstp_coal: int):
    """The sstp_coal coalescence loop with per-substep terminal-velocity
    refresh (particles_step.ipp:382-404 + hskpng_vterm_invalid)."""
    dt_sub = dt / sstp_coal
    row = lambda a: a[:, None]
    eff_table, r_max_um = coal_mod.load_efficiency_table(kernel_t(cfg.kernel))

    def body(_, carry):
        d = carry
        key, sub = jax.random.split(d.key)
        vt = vterm_mod.vt_of(cfg, d.rw2, row(d.T), row(d.p), row(d.rhod),
                             row(d.eta))
        d = dataclasses.replace(d, vt=vt, key=key)
        return coal_substep(cfg, d, params, dt_sub, sub, eff_table, r_max_um)

    d = jax.lax.fori_loop(0, sstp_coal, body, d)
    vt = vterm_mod.vt_of(cfg, d.rw2, row(d.T), row(d.p), row(d.rhod),
                         row(d.eta))
    return dataclasses.replace(d, vt=vt)


# ---------------------------------------------------------- transport ----
def _row_courants(cfg: StaticConfig, d: DenseState):
    """Per-cell left/right(/front/hind)/below/above courants as (n_cell,)
    slices of the staggered fields — the dense replacement for the per-SD
    courant gathers (reference init_grid.ipp:94-155 lft/rgt/fre/hnd/blw/
    abv).  Returns (C_l, C_r, C_b, C_a) in 2-D, plus (C_f, C_h) in 3-D."""
    nx, nz = cfg.nx, cfg.nz
    if cfg.n_dims == 3:
        ny = cfg.ny
        cx = d.courant_x.reshape(nx + 1, ny, nz)
        cy = d.courant_y.reshape(nx, ny + 1, nz)
        cz = d.courant_z.reshape(nx, ny, nz + 1)
        return (cx[:-1].reshape(-1), cx[1:].reshape(-1),
                cz[:, :, :-1].reshape(-1), cz[:, :, 1:].reshape(-1),
                cy[:, :-1].reshape(-1), cy[:, 1:].reshape(-1))
    cx = d.courant_x.reshape(nx + 1, nz)
    cz = d.courant_z.reshape(nx, nz + 1)
    C_l = cx[:-1, :].reshape(-1)
    C_r = cx[1:, :].reshape(-1)
    C_b = cz[:, :-1].reshape(-1)
    C_a = cz[:, 1:].reshape(-1)
    return C_l, C_r, C_b, C_a


def adve_sedi_bcnd(cfg: StaticConfig, d: DenseState, dt, do_sedi: bool,
                   do_adve: bool = True, do_subs: bool = False, w_LS=None,
                   x_wrap: bool = True):
    """Advection + sedimentation + subsidence + walls/puddle in one pass
    (adve.ipp:28-93 implicit/euler, sedi.ipp:13-24, subs.ipp:39-51,
    bcnd.ipp:214-365).

    Cell->SD courant reads are row broadcasts of sliced staggered fields."""
    n_cell, cap = d.n.shape
    nz = cfg.nz
    ny = max(1, cfg.ny)
    idx = jnp.arange(n_cell, dtype=jnp.int32)
    i_row = (idx // (nz * ny))[:, None].astype(d.x.dtype)
    j_row = ((idx // nz) % ny)[:, None].astype(d.x.dtype)
    k_row = (idx % nz)[:, None].astype(d.x.dtype)

    if cfg.n_dims == 3:
        C_l, C_r, C_b, C_a, C_f, C_h = _row_courants(cfg, d)
    else:
        C_l, C_r, C_b, C_a = _row_courants(cfg, d)
    row = lambda a: a[:, None]

    y = d.y
    if do_adve and cfg.n_dims == 3 \
            and as_t(cfg.adve_scheme) != as_t.pred_corr:
        # y axis (fre/hnd faces), same schemes as x (pred_corr handles y
        # inside its own branch below)
        if as_t(cfg.adve_scheme) == as_t.implicit:
            dCy = row(C_h - C_f)
            y = (d.y + cfg.dy * (row(C_f) - j_row * dCy)) / (1.0 - dCy)
        else:
            dCy = row(C_h - C_f)
            y = d.y + dCy * (d.y - cfg.dy * j_row) + cfg.dy * row(C_f)

    if not do_adve:
        x, z = d.x, d.z
    elif as_t(cfg.adve_scheme) == as_t.implicit:
        dCx = row(C_r - C_l)
        x = (d.x + cfg.dx * (row(C_l) - i_row * dCx)) / (1.0 - dCx)
        dCz = row(C_a - C_b)
        z = (d.z + cfg.dz * (row(C_b) - k_row * dCz)) / (1.0 - dCz)
    elif as_t(cfg.adve_scheme) == as_t.euler:
        dCx = row(C_r - C_l)
        x = d.x + dCx * (d.x - cfg.dx * i_row) + cfg.dx * row(C_l)
        dCz = row(C_a - C_b)
        z = d.z + dCz * (d.z - cfg.dz * k_row) + cfg.dz * row(C_b)
    else:  # pred_corr (adve.ipp:184-304, mirroring transport.adve)
        from . import transport as transport_mod
        x_old, z_old, y_old = d.x, d.z, d.y
        dCx = row(C_r - C_l)
        x = d.x + dCx * (d.x - cfg.dx * i_row) + cfg.dx * row(C_l)
        dCz = row(C_a - C_b)
        z = d.z + dCz * (d.z - cfg.dz * k_row) + cfg.dz * row(C_b)
        if cfg.n_dims == 3:
            dCy = row(C_h - C_f)
            y = d.y + dCy * (d.y - cfg.dy * j_row) + cfg.dy * row(C_f)
        z = jnp.clip(z, cfg.z0 + 1e-8 * cfg.dz, cfg.z1 - 1e-8 * cfg.dz)
        if x_wrap and not cfg.open_side_walls:
            x_wr = cfg.x0 + jnp.remainder(x - cfg.x0, cfg.x1 - cfg.x0)
            x_old = x_old + (x_wr - x)
            x = x_wr
            if cfg.n_dims == 3:
                y_wr = cfg.y0 + jnp.remainder(y - cfg.y0, cfg.y1 - cfg.y0)
                y_old = y_old + (y_wr - y)
                y = y_wr
        # corrector courants at the predictor cell — cross-row, so a
        # per-SD gather into the SMALL staggered fields (the one gather
        # the dense layout cannot turn into a broadcast); the index math
        # is shared with the flat engine (transport.courant_indices)
        yy = y if cfg.n_dims == 3 else x
        ijk_mid = hskpng.ijk_of_xyz(cfg, x, yy, z).astype(jnp.int32)
        (lft, rgt), (fre, hnd), (blw, abv) = transport_mod.courant_indices(
            cfg, ijk_mid)
        i_m, j_m, k_m = transport_mod._decompose(cfg, ijk_mid)
        i_m = i_m.astype(d.x.dtype)
        k_m = k_m.astype(d.x.dtype)
        Cl_m = d.courant_x[lft]
        Cr_m = d.courant_x[rgt]
        Cb_m = d.courant_z[blw]
        Ca_m = d.courant_z[abv]
        dx_ = (Cr_m - Cl_m) * (x - cfg.dx * i_m) + cfg.dx * Cl_m
        dz_ = (Ca_m - Cb_m) * (z - cfg.dz * k_m) + cfg.dz * Cb_m
        x = (x + x_old + dx_) / 2.0
        z = (z + z_old + dz_) / 2.0
        if cfg.n_dims == 3:
            j_m = j_m.astype(d.x.dtype)
            Cf_m = d.courant_y[fre]
            Ch_m = d.courant_y[hnd]
            dy_ = (Ch_m - Cf_m) * (y - cfg.dy * j_m) + cfg.dy * Cf_m
            y = (y + y_old + dy_) / 2.0

    if do_sedi:
        z = z - dt * d.vt
    if do_subs and w_LS is not None:
        # w_LS positive-downwards profile by k level (subs.ipp:39-51)
        z = z - dt * w_LS[idx % nz][:, None]

    n = d.n
    puddle = d.puddle
    # x walls (x_wrap=False on the device mesh: cross-slab movers ride the
    # ring in parallel/dense_mesh.rebin_sharded instead)
    if not x_wrap:
        pass
    elif not cfg.open_side_walls:
        x = cfg.x0 + jnp.remainder(x - cfg.x0, cfg.x1 - cfg.x0)
    else:
        n = jnp.where((x >= cfg.x1) | (x < cfg.x0), 0.0, n)
    # y side walls (3-D; bcnd.ipp treats y like x)
    if cfg.n_dims == 3:
        if not cfg.open_side_walls:
            y = cfg.y0 + jnp.remainder(y - cfg.y0, cfg.y1 - cfg.y0)
        else:
            n = jnp.where((y >= cfg.y1) | (y < cfg.y0), 0.0, n)
    # z walls
    if cfg.periodic_topbot_walls:
        z = cfg.z0 + jnp.remainder(z - cfg.z0, cfg.z1 - cfg.z0)
    else:
        n = jnp.where(z >= cfg.z1, 0.0, n)
        fell = (z < cfg.z0) & (n > 0)
        nf = jnp.where(fell, n, 0.0)
        rw2 = d.rw2
        liq_vol = jnp.sum(
            4.0 / 3 * c.pi * nf * rw2 * jnp.sqrt(jnp.maximum(rw2, 0.0)))
        dry_vol = jnp.sum(4.0 / 3 * c.pi * nf * d.rd3)
        puddle = puddle.at[OUT_LIQ_VOL].add(liq_vol)
        puddle = puddle.at[OUT_DRY_VOL].add(dry_vol)
        puddle = puddle.at[OUT_LIQ_NUM].add(
            jnp.sum(jnp.where(rw2 > 0, nf, 0.0)))
        puddle = puddle.at[OUT_PRTCL_NUM].add(jnp.sum(nf))
        n = jnp.where(fell, 0.0, n)

    return dataclasses.replace(d, x=x, y=y, z=z, n=n, puddle=puddle)


def _rebin_global(cfg: StaticConfig, d: DenseState, tgt) -> DenseState:
    """Global-sort redistribution: one multi-operand sort over the whole
    population + one scatter per plane.  Handles arbitrary cell jumps —
    the exact fallback for SDs that move more than one cell per axis per
    step."""
    n_cell, cap = d.n.shape
    attrs = attrs_of(cfg)
    flat = tuple(getattr(d, a).reshape(-1) for a in attrs)
    cell = jnp.where(flat[0] > 0, tgt.reshape(-1), n_cell).astype(jnp.int32)
    dense_vals, overflow = _distribute(cfg, cap, cell, flat)
    upd = dict(zip(attrs, dense_vals))
    return dataclasses.replace(d, overflow=d.overflow + overflow, **upd)


def _shift_merge(planes, key, match, shift):
    """Candidate segments for a row-shifted redistribution: for each shift s
    in ``shifts``, destination row r sees the SDs of source row r-s (mod
    n_cell) whose per-SD target row (``match`` plane) equals r.  Returns the
    (n_cell, len(shifts)*cap) concatenated planes + sort key (0 = alive
    candidate, 1 = filler), lanes masked so a candidate appears exactly
    once."""
    segs, keys = [], []
    for s in shift:
        m = match if s == 0 else jnp.roll(match, s, axis=0)
        ok = (m == jax.lax.broadcasted_iota(jnp.int32, m.shape, 0)) \
            & (key if s == 0 else jnp.roll(key, s, axis=0))
        segs.append(tuple(p if s == 0 else jnp.roll(p, s, axis=0)
                          for p in planes))
        keys.append(ok)
    cat = lambda xs: jnp.concatenate(xs, axis=1)
    merged = tuple(cat([seg[i] for seg in segs])
                   for i in range(len(planes)))
    alive = cat(keys)
    # zero out non-candidates so filler lanes carry no stale attributes
    merged = tuple(jnp.where(alive, p, jnp.zeros_like(p)) for p in merged)
    return merged, jnp.where(alive, 0, 1).astype(jnp.int32)


def _rebin_neighbor(cfg: StaticConfig, d: DenseState, tgt) -> DenseState:
    """CFL-bounded redistribution: under |courant| <= 1 (and sedimentation
    < dz per dt) an SD moves at most ONE cell per axis per STEP, so
    post-transport re-binning only needs adjacent-row exchange — one
    roll+mask+lane-sort pass per axis (z, then y in 3-D, then x) instead
    of the global sort + 8 random-index gathers.

    Reference analog: the sorted-flag discipline around hskpng_ijk
    (particles_impl_hskpng_ijk.ipp:86-253, particles_impl.ipp:153) — the
    reference re-sorts lazily; here the dense layout re-bins structurally.

    Row index is (i*ny + j)*nz + k: z-neighbours are row±1 and
    y-neighbours row±nz (neither wraps for alive SDs — wrap moves hit the
    global fallback in rebin()); x-neighbours are row±ny*nz with
    jnp.roll's mod-n_cell wraparound implementing x-periodicity exactly."""
    n_cell, cap = d.n.shape
    nz = max(1, cfg.nz)
    ny = max(1, cfg.ny)
    attrs = attrs_of(cfg)
    planes = tuple(getattr(d, a) for a in attrs)
    alive = d.n > 0
    rows = jax.lax.broadcasted_iota(jnp.int32, tgt.shape, 0)

    n_alive0 = jnp.sum(jnp.where(alive, 1, 0))

    # per-phase intermediate targets: fix k, then j, then i
    def phase_tgt(rows_now, tgt_now, axis):
        if axis == "z":
            return rows_now + (tgt_now % nz - rows_now % nz)
        if axis == "y":
            return rows_now + ((tgt_now // nz) % ny
                               - (rows_now // nz) % ny) * nz
        return tgt_now  # x: the final row

    phases = [("z", (0, 1, -1))]
    if cfg.n_dims == 3:
        phases.append(("y", (0, nz, -nz)))
    phases.append(("x", (0, ny * nz, -(ny * nz))))

    for axis, shifts in phases:
        ptgt = phase_tgt(rows, tgt, axis)
        last = axis == phases[-1][0]
        carry = planes if last else planes + (tgt,)
        merged, key = _shift_merge(carry, alive, ptgt, shifts)
        sorted_ = jax.lax.sort((key,) + merged, dimension=1, num_keys=1)
        planes = tuple(p[:, :cap] for p in sorted_[1:1 + len(attrs)])
        if not last:
            tgt = sorted_[1 + len(attrs)][:, :cap]
        alive = sorted_[0][:, :cap] == 0
        planes = (jnp.where(alive, planes[0], 0.0),) + planes[1:]

    n_alive1 = jnp.sum(jnp.where(alive, 1, 0))
    upd = dict(zip(attrs, planes))
    return dataclasses.replace(
        d, overflow=d.overflow + (n_alive0 - n_alive1), **upd)


def rebin(cfg: StaticConfig, d: DenseState) -> DenseState:
    """Redistribute SDs to the rows of their (possibly new) cells after
    transport — the post_copy hskpng_ijk equivalent (post_copy.ipp:18-36).

    Default: the CFL-bounded neighbour exchange (_rebin_neighbor); SDs that
    moved more than one cell on some axis (possible only when sedimentation
    covers > dz in one dt) trigger the exact global-sort path via lax.cond.
    LIBCLOUD_DENSE_REBIN=global forces the old path for A/B."""
    import os
    n_cell, cap = d.n.shape
    nz, ny, nx = cfg.nz, max(1, cfg.ny), cfg.nx
    alive = d.n > 0
    yy = d.y if cfg.n_dims == 3 else d.x
    tgt = hskpng.ijk_of_xyz(cfg, d.x, yy, d.z).astype(jnp.int32)
    tgt = jnp.where(alive, tgt, n_cell)  # dead slots match no row

    if os.environ.get("LIBCLOUD_DENSE_REBIN", "neighbor") == "global" \
            or nx < 3 or nz < 3 or (cfg.n_dims == 3 and ny < 3):
        # tiny grids: roll shifts alias (|shift| >= n_cell/2) — stay global
        return _rebin_global(cfg, d, tgt)

    rows = jax.lax.broadcasted_iota(jnp.int32, tgt.shape, 0)
    dk = jnp.abs(tgt % nz - rows % nz)
    di = (tgt // (ny * nz) - rows // (ny * nz)) % nx
    covered = (dk <= 1) & ((di == 0) | (di == 1) | (di == nx - 1))
    if cfg.n_dims == 3:
        # y moves must be strictly adjacent (y wrap -> global fallback)
        dj = jnp.abs((tgt // nz) % ny - (rows // nz) % ny)
        covered = covered & (dj <= 1)
    all_covered = jnp.all(jnp.where(alive, covered, True))
    return jax.lax.cond(
        all_covered,
        lambda dd: _rebin_neighbor(cfg, dd, tgt),
        lambda dd: _rebin_global(cfg, dd, tgt),
        d)


def step_async(cfg: StaticConfig, d: DenseState, params, dt,
               sstp_coal: int, do_coal: bool, do_sedi: bool,
               do_adve: bool = True, do_subs: bool = False,
               w_LS=None) -> DenseState:
    """The transport-phase pipeline on the dense layout (reference
    particles_step.ipp:339-494): vterm refresh -> coalescence -> advection
    -> sedimentation -> subsidence -> boundaries/puddle -> re-binning."""
    row = lambda a: a[:, None]
    vt = vterm_mod.vt_of(cfg, d.rw2, row(d.T), row(d.p), row(d.rhod),
                         row(d.eta))
    d = dataclasses.replace(d, vt=vt)
    if do_coal:
        d = coal(cfg, d, params, dt, sstp_coal)
    if do_adve or do_sedi or do_subs:
        d = adve_sedi_bcnd(cfg, d, dt, do_sedi, do_adve, do_subs, w_LS)
        d = rebin(cfg, d)
    return d


# --------------------------------------------------------------- diag ----
def moment(d: DenseState, rng_lo2, rng_hi2, power, specific=True):
    """Per-cell wet-radius moment over an rw^2 range — row reduction
    (the dense diag_wet_rng+diag_wet_mom, particles_impl_moms.ipp)."""
    sel = (d.n > 0) & (d.rw2 >= rng_lo2) & (d.rw2 < rng_hi2)
    nf = jnp.where(sel, d.n, 0.0)
    if power == 0:
        vals = nf
    else:
        vals = nf * jnp.where(sel, d.rw2, 1.0) ** (power / 2.0)
    mom = jnp.sum(vals, axis=1)
    if specific:
        mom = mom / (d.dv * d.rhod)
    return mom
