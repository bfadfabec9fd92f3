"""The particles_t API — the Euler-Lagrange coupling surface of the SDM engine.

JAX equivalent of reference include/libcloudph++/lgrngn/particles.hpp:16-134
(particles_proto_t) and src/particles_{ctor,init,step,diag}.ipp.  The public
contract is the reference's three-phase stepping (init / step_sync==sync_in+
step_cond / step_async) with the same strict call-order state machine
(particles_impl.ipp:32, particles_step.ipp:44-47,169-175,343-345), while the
numerics live in pure jitted functions over the State pytree.

Host arrays passed to ``init``/``step_sync`` are numpy arrays that get written
back in place on sync-out, mirroring the arrinfo_t ABI (arrinfo.hpp:10-49).
"""

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

import math

from . import coalescence, condensation, hskpng, init as init_mod
from . import source as source_mod
from . import transport, turbulence
from . import vterm as vterm_mod
from .enums import backend_t, kernel_t
from .opts import opts_init_t, opts_t
from .state import PUDDLE_KEYS, State, StaticConfig, empty_state
from ..utils.device import on_accelerator


def _as_flat(arr, n_cell, name):
    if arr is None:
        return None
    if isinstance(arr, jax.Array):
        # device-array ABI (the JAX arrinfo_t analog,
        # arrinfo.hpp:10-49): a jax.Array is an immutable device handle, so
        # no defensive copy is needed and no host round trip happens — the
        # caller gets updated values from step_cond's return instead of an
        # in-place write-back
        a = arr.reshape(-1)
        if a.size != n_cell:
            raise ValueError(
                f"lgrngn: {name} has {a.size} elements, expected {n_cell}"
            )
        return a
    # always COPY: jnp.asarray on CPU zero-copies numpy buffers, which would
    # alias device state to the caller's arrays — the reference's sync is a
    # copy (particles_impl_sync.ipp:15-69), and callers routinely mutate
    # their arrays in place between syncs
    a = np.array(arr, dtype=np.float64).reshape(-1)
    if a.size != n_cell:
        raise ValueError(
            f"lgrngn: {name} has {a.size} elements, expected {n_cell}"
        )
    return a


def _rc2_of(state: State, T_sd):
    """Critical (activation) radius squared per SD via the Koehler-maximum
    root solve (reference detail::rw3_cr used in update_incloud_time,
    diag_rw_ge_rc)."""
    from ..common import kappa_koehler
    rw3_cr = kappa_koehler.rw3_cr(
        jnp.maximum(state.rd3, 1e-300), jnp.maximum(state.kpa, 1e-10), T_sd
    )
    return rw3_cr ** (2.0 / 3)


def step_cond_body(cfg: StaticConfig, state: State, dt, RH_max,
                   turb_cond: bool = False, ice_nucl: bool = False,
                   do_cond: bool = True, var_rho: bool = False):
    """The full condensation-phase pipeline as a pure function — shared by
    the single-device jit below and the multi-device shard_map front-end
    (parallel/multi.py), so mesh and serial backends cannot drift.

    ``var_rho`` mirrors the reference's per-step flag (particles_step.ipp:
    100): true when the host passed rhod this sync, which makes the percell
    substepping feed the rhod change incrementally too."""
    # mean free paths date from the PREVIOUS step's thermodynamic state
    # (reference hskpng_mfp runs before any Tpr refresh,
    # particles_step.ipp:190-196) — compute them before the Tpr below
    lam = condensation.stale_mfp(state) if do_cond else None
    state = hskpng.hskpng_Tpr(cfg, state)
    if cfg.ice_switch and ice_nucl:
        # freezing/melting phase changes (particles_step.ipp:183-185)
        from . import ice as ice_mod
        state = ice_mod.ice_nucl_melt(
            cfg, state, dt, cfg.time_dep_ice_nucl
        )
        state = hskpng.hskpng_Tpr(cfg, state)
    if not do_cond:
        return state
    if cfg.exact_sstp_cond and (cfg.sstp_cond > 1 or cfg.sstp_cond_act > 1):
        # exact per-particle substepping (particles_step.ipp:199-236)
        if cfg.adaptive_sstp_cond:
            state = condensation.cond_perparticle_adaptive(
                cfg, state, dt, RH_max, turb_cond=turb_cond, lam=lam
            )
        else:
            state = condensation.cond_perparticle(
                cfg, state, dt, RH_max, turb_cond=turb_cond, lam=lam
            )
        state = condensation.sstp_save(state, exact=True)
        return state
    if cfg.diag_incloud_time:
        # (reference particles_impl_update_incloud_time.ipp:38-66)
        rc2 = _rc2_of(state, state.T[state.ijk])
        import dataclasses as _dc
        state = _dc.replace(
            state,
            incloud_time=jnp.where(
                state.rw2 > rc2, state.incloud_time + dt, 0.0
            ),
        )
    state = condensation.cond_percell(cfg, state, dt, RH_max,
                                      turb_cond=turb_cond, var_rho=var_rho,
                                      lam=lam)
    state = condensation.sstp_save(state, exact=cfg.exact_sstp_cond)
    return state


@partial(jax.jit, static_argnums=(0, 4, 5, 6, 7))
def _step_cond_jit(cfg: StaticConfig, state: State, dt, RH_max,
                   turb_cond: bool = False, ice_nucl: bool = False,
                   do_cond: bool = True, var_rho: bool = False):
    return step_cond_body(cfg, state, dt, RH_max, turb_cond, ice_nucl,
                          do_cond, var_rho)


@partial(jax.jit, static_argnums=0)
def _tpr_jit(cfg: StaticConfig, state: State):
    return hskpng.hskpng_Tpr(cfg, state)


@partial(jax.jit, static_argnums=(0, 3, 4, 5))
def _step_chem_jit(cfg: StaticConfig, state: State, dt,
                   do_dsl: bool, do_dsc: bool, do_rct: bool):
    from . import chemistry
    state = hskpng.hskpng_Tpr(cfg, state)
    return chemistry.sstp_chem_loop(cfg, state, dt, do_dsl, do_dsc, do_rct)


@partial(jax.jit, static_argnums=(0, 1, 2))
def _step_async_jit(cfg: StaticConfig, sstp_coal: int, switches: tuple,
                    state: State, params, w_LS, sgs_mix_len, dt):
    """The transport phase pipeline (reference particles_step.ipp:339-494):
    Tpr -> vterm -> coalescence substeps -> SGS turbulence -> advection ->
    turbulent displacement -> sedimentation -> subsidence -> boundary
    conditions/puddle -> re-binning."""
    (do_coal, do_adve, do_sedi, do_subs, do_turb_adve, do_turb_cond,
     do_rcyc, do_turb_coal) = switches
    state = hskpng.hskpng_Tpr(cfg, state)
    state = vterm_mod.hskpng_vterm_all(cfg, state)
    if do_coal:
        state = coalescence.coal(cfg, state, params, dt, sstp_coal,
                                 turb_coal=do_turb_coal)
    if do_turb_adve or do_turb_cond:
        # SGS block (particles_step.ipp:406-426)
        state = turbulence.hskpng_tke(cfg, state, sgs_mix_len)
        state = turbulence.hskpng_turb_vel(
            cfg, state, sgs_mix_len, dt, only_vertical=not do_turb_adve
        )
        if do_turb_cond:
            state = turbulence.hskpng_turb_dot_ss(cfg, state)
    if do_adve:
        state = transport.adve(cfg, state)
    if do_turb_adve:
        state = turbulence.turb_adve(cfg, state, dt)
    if do_sedi:
        state = transport.sedi(state, dt)
    if do_subs:
        state = transport.subs(cfg, state, w_LS, dt)
    state = transport.bcnd(cfg, state)
    if do_rcyc:
        from . import recycle
        state = recycle.rcyc(cfg, state)
    state = transport.post_step(cfg, state)
    return state


@partial(jax.jit, static_argnums=0)
def _mass_dens_jit(cfg: StaticConfig, state: State, n_filtered, rad, sig0):
    """Kernel-density mass estimate at radius ``rad``
    (reference particles_impl_mass_dens.ipp:8-113); xp = 1/2 for wet."""
    live = (state.n > 0).astype(state.rw2.dtype)
    count = jax.ops.segment_sum(live, state.ijk, num_segments=cfg.n_cell)
    sig = sig0 / jnp.maximum(count, 1.0) ** 0.2
    sig_sd = sig[state.ijk]
    x = jnp.maximum(state.rw2, 1e-300)
    vals = (
        n_filtered / sig_sd * x ** 1.5
        * jnp.exp(-((0.5 * jnp.log(x) - jnp.log(rad)) / sig_sd) ** 2 / 2.0)
    )
    mom = jax.ops.segment_sum(vals, state.ijk, num_segments=cfg.n_cell)
    from ..common import constants as c
    prefactor = 4.0 / 3.0 * c.rho_w * jnp.sqrt(c.pi / 2.0)
    return prefactor * mom / state.dv


@partial(jax.jit, static_argnums=(0, 2))
def _moms_calc_jit(cfg, state, power, n_filtered, attr):
    return hskpng.segment_moment(
        cfg, n_filtered, attr, power, state.ijk,
        dv=state.dv, rhod=state.rhod, specific=True,
    )


class particles_t:
    """Reference particles_proto_t equivalent (particles.hpp:16-134)."""

    engine = "flat"     # the SD layout behind step_cond / step_async

    def __init__(self, backend: backend_t, opts_init: opts_init_t):
        self.backend = backend
        self.opts_init = opts_init
        if opts_init.n_sd_max == 0:
            raise ValueError("lgrngn: n_sd_max == 0")
        if opts_init.dt <= 0:
            raise ValueError("lgrngn: opts_init.dt must be positive")
        if opts_init.th_dry == opts_init.const_p:
            raise ValueError(
                "lgrngn: exactly one of th_dry/const_p must be true"
            )
        self.cfg = StaticConfig.from_opts_init(opts_init)
        self.state = empty_state(self.cfg)
        # call-order state machine (reference particles_impl.ipp:32)
        self._init_called = False
        self._should_now_run_async = False
        self._should_now_run_cond = False
        # diag selection cache (the reference's n_filtered temp vector)
        self._n_filtered = None
        self._outbuf = np.zeros(self.cfg.n_cell)
        # source/relaxation super-step counters (particles_step.ipp:451-479)
        self._src_ctr = 0
        self._rlx_ctr = 0
        self._src_rng = np.random.default_rng(opts_init.rng_seed + 1)
        # adaptive coalescence substep growth: const-multi collision
        # overflow requests one more substep (reference coal.ipp:224-227 +
        # particles_step.ipp:394-400; kept persistent here — the growth is
        # meant to carry to later steps)
        self._sstp_coal_extra = 0

    def _cfg_for_dt(self, cfg, dt):
        """Variable-dt substep rescale (reference
        particles_impl_adjust_timesteps.ipp:17-21): substep counts > 1 scale
        by ceil(sstp * dt / opts_init.dt)."""
        if dt == self.cfg.dt:
            return cfg
        def adj(s):
            return int(math.ceil(s * dt / self.cfg.dt)) if s > 1 else s
        return dataclasses.replace(
            cfg, sstp_cond=adj(cfg.sstp_cond),
            sstp_cond_act=adj(cfg.sstp_cond_act),
            sstp_chem=adj(cfg.sstp_chem))

    # ---- device-work hooks: the multi-device front-end
    # (parallel/multi.py) overrides these with shard_map'd equivalents
    def _step_cond_impl(self, *args):
        return _step_cond_jit(self._cfg_for_dt(self.cfg, args[1]), *args)

    def _step_chem_impl(self, *args):
        return _step_chem_jit(self._cfg_for_dt(self.cfg, args[1]), *args)

    def _step_async_impl(self, *args):
        return _step_async_jit(self.cfg, *args)

    def _tpr_impl(self):
        return _tpr_jit(self.cfg, self.state)

    def _moms_calc_impl(self, power, n_filtered, attr):
        return _moms_calc_jit(self.cfg, self.state, power, n_filtered, attr)

    def _sd_count_impl(self, n_filtered):
        return hskpng.sd_count_per_cell(self.cfg, n_filtered, self.state.ijk)

    def _mass_dens_impl(self, n_filtered, rad, sig0):
        return _mass_dens_jit(self.cfg, self.state, n_filtered, rad, sig0)

    def _cell_to_host(self, arr):
        """Device per-cell array -> host-layout numpy (identity here; the
        multi-device front-end unpads its sharded layout)."""
        return np.asarray(arr)

    def _cell_out(self, arr):
        """Device per-cell array -> the (n_cell,) device array handed back
        to device-array callers (identity here; the multi-device front-end
        unpads its sharded layout)."""
        return arr

    def _segment_max_impl(self, vals):
        mx = jax.ops.segment_max(
            vals, self.state.ijk, num_segments=self.cfg.n_cell)
        return jnp.maximum(mx, 0.0)

    def _precip_rate_impl(self, ice: bool):
        """1st non-specific moment of (rw^3 | ice mass) * vt
        (particles_diag.ipp:561-607)."""
        st = self._tpr_impl()
        st = vterm_mod.hskpng_vterm_all(self.cfg, st)
        if ice:
            from . import ice as ice_mod
            vals = ice_mod.ice_mass(st.ice_a, st.ice_c, st.ice_rho)
        else:
            vals = st.rw2 ** 1.5
        return jax.ops.segment_sum(
            self._n_filtered * vals * st.vt, st.ijk,
            num_segments=self.cfg.n_cell)

    def _courant_updates(self, courant_x, courant_y, courant_z):
        """Validate + flatten Arakawa-C staggered courant fields."""
        cfg = self.cfg
        updates = {}
        sizes = {
            "courant_x": (cfg.nx + 1) * cfg.ny * cfg.nz,
            "courant_y": cfg.nx * (cfg.ny + 1) * cfg.nz,
            "courant_z": cfg.nx * cfg.ny * (cfg.nz + 1),
        }
        for name, arr in (("courant_x", courant_x), ("courant_y", courant_y),
                          ("courant_z", courant_z)):
            if arr is None:
                continue
            a = np.array(arr, dtype=np.float64).reshape(-1)  # copy (see _as_flat)
            if a.size != sizes[name]:
                raise ValueError(
                    f"lgrngn: {name} has {a.size} elements, "
                    f"expected {sizes[name]}"
                )
            updates[name] = jnp.asarray(a)
        return updates

    # ------------------------------------------------------------------ init
    def _chem_updates(self, ambient_chem):
        """Validate + flatten the {chem_species: array} trace-gas map
        (reference particles_step.ipp:68-72, :146-153)."""
        from ..common.chem import chem_gas_n
        if self.cfg.chem_switch:
            if not ambient_chem or len(ambient_chem) != chem_gas_n:
                raise RuntimeError(
                    "libcloudphxx: chemistry was not switched off and "
                    "ambient_chem is empty"
                )
        elif ambient_chem:
            raise RuntimeError(
                "libcloudphxx: chemistry was switched off and ambient_chem "
                "is not empty"
            )
        if not ambient_chem:
            return None
        gases = np.zeros((chem_gas_n, self.cfg.n_cell))
        for key, arr in ambient_chem.items():
            gases[int(key)] = _as_flat(arr, self.cfg.n_cell,
                                       f"ambient_chem[{int(key)}]")
        return jnp.asarray(gases)

    def _chem_sync_out(self, ambient_chem):
        """Write updated trace-gas mixing ratios back into the host arrays
        (particles_step.ipp:319-327)."""
        if not ambient_chem:
            return
        dev = np.asarray(self.state.ambient_chem)
        for key, arr in ambient_chem.items():
            np.asarray(arr).reshape(-1)[:] = dev[int(key)]

    # ------------------------------------------------------------------ init
    def init(self, th, rv, rhod, p=None, courant_x=None, courant_y=None,
             courant_z=None, ambient_chem=None, Cx=None, Cy=None, Cz=None):
        """(reference src/particles_init.ipp:16-131).  ``Cx``/``Cy``/``Cz``
        are binding-style aliases for the courant fields."""
        courant_x = courant_x if courant_x is not None else Cx
        courant_y = courant_y if courant_y is not None else Cy
        courant_z = courant_z if courant_z is not None else Cz
        if self._init_called:
            raise RuntimeError("libcloudphxx: init() may be called just once")
        self._init_called = True
        oi = self.opts_init
        n_cell = self.cfg.n_cell

        th = _as_flat(th, n_cell, "th")
        rv = _as_flat(rv, n_cell, "rv")
        rhod = _as_flat(rhod, n_cell, "rhod")
        p_arr = _as_flat(p, n_cell, "p")
        if self.cfg.const_p and p_arr is None:
            raise ValueError("lgrngn: const_p requires a pressure profile")

        st = self.state
        st = dataclasses.replace(
            st,
            th=jnp.asarray(th),
            rv=jnp.asarray(rv),
            rhod=jnp.asarray(rhod),
            p=jnp.asarray(p_arr if p_arr is not None else np.zeros(n_cell)),
            key=jax.random.PRNGKey(oi.rng_seed),
        )
        if self.cfg.n_dims > 0:
            # cropped cell volumes (reference init_grid.ipp dv_eval:33-52)
            st = dataclasses.replace(
                st, dv=jnp.asarray(init_mod.cell_dv(self.cfg))
            )
        cupd = self._courant_updates(courant_x, courant_y, courant_z)
        if cupd:
            st = dataclasses.replace(st, **cupd)

        st = hskpng.hskpng_Tpr(self.cfg, st)

        # SD creation with the init seed (particles_init.ipp:30-32, :130)
        seed = (
            oi.rng_seed_init if oi.rng_seed_init_switch else oi.rng_seed
        )
        if not oi.no_ccn_at_init:
            if getattr(oi, "reference_rng_init", False):
                from . import refinit
                dv0 = (1.0 / np.asarray(rhod) if self.cfg.n_dims == 0
                       else init_mod.cell_dv(self.cfg))
                st = refinit.init_SD_reference(
                    self.cfg, oi, st, seed, rhod, dv0)
            else:
                rng = np.random.default_rng(seed)
                st = init_mod.init_SD(self.cfg, oi, st, rng, rhod)
            st = init_mod.init_wet(self.cfg, st, oi.RH_max)

        chem_gases = self._chem_updates(ambient_chem)
        if self.cfg.chem_switch:
            # initial NH4HSO4 aerosol split (init_chem.ipp:178-225)
            from . import chemistry
            st = dataclasses.replace(
                st,
                ambient_chem=chem_gases,
                chem=jnp.where(
                    st.n > 0,
                    chemistry.init_chem_aq(st.rd3, self.cfg.chem_rho),
                    0.0,
                ),
            )
            st = chemistry.sstp_save_chem(st)

        st = condensation.sstp_save(st, exact=self.cfg.exact_sstp_cond)
        self.state = st
        self._should_now_run_cond = False
        self._should_now_run_async = False

    # ------------------------------------------------------------- stepping
    def sync_in(self, th=None, rv=None, rhod=None, courant_x=None,
                courant_y=None, courant_z=None, ambient_chem=None,
                diss_rate=None):
        """(reference particles_step.ipp:32-158)"""
        if not self._init_called:
            raise RuntimeError(
                "libcloudphxx: please call init() before calling step_sync()"
            )
        if self._should_now_run_async:
            raise RuntimeError(
                "libcloudphxx: please call step_async() before calling "
                "step_sync() again"
            )
        n_cell = self.cfg.n_cell
        updates = {}
        for name, arr in (("th", th), ("rv", rv), ("rhod", rhod),
                          ("diss_rate", diss_rate)):
            a = _as_flat(arr, n_cell, name)
            if a is not None:
                updates[name] = jnp.asarray(a)
        updates.update(self._courant_updates(courant_x, courant_y, courant_z))
        if self.cfg.chem_switch or ambient_chem:
            gases = self._chem_updates(ambient_chem)
            if gases is not None:
                updates["ambient_chem"] = gases
        if updates:
            self.state = dataclasses.replace(self.state, **updates)
        # var_rho flag: the host passed a (possibly changing) density this
        # sync (reference particles_step.ipp:100)
        self._var_rho = rhod is not None
        self._should_now_run_cond = True

    def step_cond(self, opts: opts_t, th=None, rv=None, ambient_chem=None):
        """(reference particles_step.ipp:161-336).  Writes the updated th/rv
        back into the passed numpy arrays (sync-out).  Device-array callers
        (th/rv passed as jax.Array — the arrinfo analog) get the
        updated fields as a returned (th, rv) pair instead: jax arrays are
        immutable handles, and skipping the host write-back keeps the whole
        step asynchronous (no device round trip per step)."""
        if not self._should_now_run_cond:
            raise RuntimeError(
                "libcloudphxx: please call sync_in() before calling step_cond()"
            )
        self._should_now_run_cond = False
        dt = float(opts.dt) if opts.dt > 0 else self.cfg.dt
        if opts.dt > 0 and not self.opts_init.variable_dt_switch:
            # reference adjust_timesteps.ipp:16 (called from step_cond too)
            raise RuntimeError(
                "libcloudphxx: opts.dt specified, but "
                "opts_init.variable_dt_switch is false"
            )
        if opts.turb_cond and not self.cfg.turb_cond_switch:
            raise RuntimeError(
                "libcloudphxx: turb_cond_switch=False, but turb_cond==True"
            )
        device_io = isinstance(th, jax.Array) or isinstance(rv, jax.Array)
        if opts.cond or (opts.ice_nucl and self.cfg.ice_switch):
            self.state = self._step_cond_impl(
                self.state, dt, float(opts.RH_max),
                bool(opts.turb_cond),
                bool(opts.ice_nucl and self.cfg.ice_switch),
                bool(opts.cond),
                bool(getattr(self, "_var_rho", False)),
            )
            # sync out
            if not device_io:
                if th is not None:
                    np.asarray(th).reshape(-1)[:] = self._cell_to_host(
                        self.state.th)
                if rv is not None:
                    np.asarray(rv).reshape(-1)[:] = self._cell_to_host(
                        self.state.rv)
        # chemistry substeps (particles_step.ipp:272-310)
        do_chem = (opts.chem_dsl or opts.chem_dsc or opts.chem_rct)
        if do_chem:
            if not self.cfg.chem_switch:
                raise RuntimeError(
                    "libcloudphxx: all chemistry was switched off in "
                    "opts_init"
                )
            self.state = self._step_chem_impl(
                self.state,
                dt, bool(opts.chem_dsl), bool(opts.chem_dsc),
                bool(opts.chem_rct),
            )
            if opts.chem_dsl:
                self._chem_sync_out(ambient_chem)
        from ..utils import debug as _dbg
        if _dbg.enabled():
            _dbg.nancheck_state(self.state, "step_cond")
        self._should_now_run_async = True
        if device_io:
            return self._cell_out(self.state.th), self._cell_out(self.state.rv)

    def step_sync(self, opts: opts_t, th, rv, rhod=None, courant_x=None,
                  courant_y=None, courant_z=None, ambient_chem=None,
                  diss_rate=None):
        """step_sync = sync_in + step_cond (reference particles_step.ipp:15-29).
        Returns the updated (th, rv) device pair for device-array callers
        (see step_cond), None for the reference's numpy write-back ABI."""
        self.sync_in(th=th, rv=rv, rhod=rhod, courant_x=courant_x,
                     courant_y=courant_y, courant_z=courant_z,
                     ambient_chem=ambient_chem, diss_rate=diss_rate)
        return self.step_cond(opts, th=th, rv=rv, ambient_chem=ambient_chem)

    def step_async(self, opts: opts_t):
        """Transport phase (reference particles_step.ipp:339-494).
        Coalescence runs here; advection/sedimentation arrive with the 2-D
        milestone.  The call-order bookkeeping is the reference's."""
        if not self._should_now_run_async:
            raise RuntimeError(
                "libcloudphxx: please call step_sync() before calling "
                "step_async() again"
            )
        self._should_now_run_async = False

        dt = float(opts.dt) if opts.dt > 0 else self.cfg.dt
        if opts.dt > 0 and not self.opts_init.variable_dt_switch:
            raise RuntimeError(
                "libcloudphxx: opts.dt specified, but "
                "opts_init.variable_dt_switch is false"
            )
        do_coal = bool(opts.coal and self.cfg.coal_switch)
        if do_coal and self.cfg.kernel == kernel_t.undefined.value:
            raise RuntimeError(
                "libcloudphxx: opts.coal == True requires opts_init.kernel"
            )
        do_adve = bool(opts.adve and self.cfg.n_dims > 0)
        do_turb_adve = bool(opts.turb_adve
                            and self.opts_init.turb_adve_switch)
        do_turb_cond = bool(opts.turb_cond and self.cfg.turb_cond_switch)
        if opts.turb_coal and not self.opts_init.turb_coal_switch:
            raise RuntimeError(
                "libcloudphxx: turb_coal_switch=False, but turb_coal==True"
            )
        do_turb_coal = bool(opts.turb_coal)
        do_rcyc = bool(opts.rcyc)
        do_sedi = bool(opts.sedi and self.cfg.sedi_switch
                       and self.cfg.n_dims > 0)
        do_subs = bool(opts.subs and self.cfg.n_dims > 0)
        if do_sedi and self.cfg.terminal_velocity == 0:
            raise RuntimeError(
                "libcloudphxx: opts.sedi requires opts_init.terminal_velocity"
            )

        # substep count follows a variable dt (adjust_timesteps.ipp:14-24)
        # plus any adaptive growth from const-multi collision overflow
        sstp = self.opts_init.sstp_coal
        if opts.dt > 0 and sstp > 1:
            sstp = math.ceil(sstp * dt / self.cfg.dt)
        sstp += self._sstp_coal_extra
        # constant device arrays (opts_init is fixed after construction) —
        # cached so the hot loop does not pay one host->device transfer per
        # step per array
        if not hasattr(self, "_async_consts"):
            self._async_consts = (
                jnp.asarray(np.asarray(self.opts_init.kernel_parameters,
                                       dtype=np.float64)),
                jnp.asarray(
                    np.asarray(self.opts_init.w_LS, dtype=np.float64)
                    if len(self.opts_init.w_LS)
                    else np.zeros(max(1, self.cfg.nz))),
                jnp.asarray(
                    np.asarray(self.opts_init.SGS_mix_len, dtype=np.float64)
                    if len(self.opts_init.SGS_mix_len)
                    else np.full(max(1, self.cfg.nz), self.cfg.dz)),
            )
        params, w_LS, sgs_mix_len = self._async_consts
        # aerosol source every supstp_src steps (particles_step.ipp:451-479)
        if opts.src and (opts.src_dry_distros or opts.src_dry_sizes):
            self._src_ctr += 1
            self._apply_sources(opts, dt)

        # CCN relaxation every supstp_rlx steps (particles_step.ipp:463-473)
        if opts.rlx and self.opts_init.rlx_switch \
                and self.opts_init.rlx_dry_distros:
            self._rlx_ctr += 1
            if self._rlx_ctr % int(self.opts_init.supstp_rlx) == 0:
                from . import relax as relax_mod
                eng = self._src_engine()
                relax_mod.rlx_dry_distros(
                    self.cfg, self.opts_init, eng, dt, self._src_rng
                )
                self._absorb_engine(eng)

        if do_coal or do_adve or do_sedi or do_subs or do_turb_adve \
                or do_turb_cond or do_rcyc:
            self.state = self._step_async_impl(
                int(sstp),
                (do_coal, do_adve, do_sedi, do_subs, do_turb_adve,
                 do_turb_cond, do_rcyc, do_turb_coal),
                self.state, params, w_LS, sgs_mix_len, dt,
            )
        if do_coal and self.cfg.pure_const_multi:
            # consume the adaptive-substep request flag
            # (particles_step.ipp:394-400)
            from .state import N_PUDDLE, OUT_COAL_OVERFLOW
            pud = np.asarray(self.state.puddle)
            if pud.reshape(-1, N_PUDDLE)[:, OUT_COAL_OVERFLOW].max() > 0:
                self._sstp_coal_extra += 1
                pud = pud.copy()
                pud.reshape(-1, N_PUDDLE)[:, OUT_COAL_OVERFLOW] = 0.0
                self.state = dataclasses.replace(
                    self.state, puddle=jnp.asarray(pud))
        from ..utils import debug as _dbg
        if _dbg.enabled():
            _dbg.nancheck_state(self.state, "step_async")

    def _src_engine(self):
        """Backend adapter for source/relaxation (refreshes T/RH first —
        the reference's src/rlx read the current Tpr state)."""
        return source_mod.StateEngine(self.cfg, _tpr_jit(self.cfg,
                                                         self.state))

    def _absorb_engine(self, eng):
        self.state = eng.state

    def _apply_sources(self, opts, dt):
        eng = self._src_engine()
        oi = self.opts_init
        from .enums import src_t
        due_distros = {
            k: v for k, v in opts.src_dry_distros.items()
            if self._src_ctr % int(v[2]) == 0
        }
        if due_distros:
            if oi.src_type == src_t.matching:
                source_mod.src_matching_distros(
                    self.cfg, oi, eng, due_distros, dt, self._src_rng,
                    oi.RH_max,
                )
            else:
                source_mod.src_simple_distros(
                    self.cfg, oi, eng, due_distros, dt, self._src_rng,
                    oi.RH_max,
                )
        due_sizes = {
            k: {r: spec for r, spec in sizes.items()
                if self._src_ctr % int(spec[2]) == 0}
            for k, sizes in opts.src_dry_sizes.items()
        }
        due_sizes = {k: v for k, v in due_sizes.items() if v}
        if due_sizes:
            source_mod.src_dry_sizes(
                self.cfg, oi, eng, due_sizes, dt, self._src_rng, oi.RH_max,
            )
        self._absorb_engine(eng)

    # ----------------------------------------------------------- diagnostics
    def _require_init(self):
        if not self._init_called:
            raise RuntimeError("libcloudphxx: init() has not been called")

    def _set_outbuf(self, per_cell):
        self._outbuf = np.asarray(per_cell, dtype=np.float64)

    def diag_pressure(self):
        self._require_init()
        self._set_outbuf(self._tpr_impl().p)

    def diag_temperature(self):
        self._require_init()
        self._set_outbuf(self._tpr_impl().T)

    def diag_RH(self):
        self._require_init()
        self._set_outbuf(self._tpr_impl().RH)

    # --- selection filters (reference particles_diag.ipp:224-340)
    def diag_all(self):
        self._require_init()
        self._n_filtered = self.state.n

    def diag_dry_rng(self, r_min, r_max):
        self._require_init()
        rd3 = self.state.rd3
        sel = (rd3 >= r_min**3) & (rd3 < r_max**3)
        self._n_filtered = jnp.where(sel, self.state.n, 0.0)

    def diag_wet_rng(self, r_min, r_max):
        self._require_init()
        rw2 = self.state.rw2
        sel = (rw2 >= r_min**2) & (rw2 < r_max**2)
        self._n_filtered = jnp.where(sel, self.state.n, 0.0)

    def diag_kappa_rng(self, k_min, k_max):
        self._require_init()
        kpa = self.state.kpa
        sel = (kpa >= k_min) & (kpa < k_max)
        self._n_filtered = jnp.where(sel, self.state.n, 0.0)

    def _cons(self, sel):
        if self._n_filtered is None:
            raise RuntimeError("libcloudphxx: consecutive filter without "
                               "a previous selection")
        self._n_filtered = jnp.where(sel, self._n_filtered, 0.0)

    def diag_dry_rng_cons(self, r_min, r_max):
        rd3 = self.state.rd3
        self._cons((rd3 >= r_min**3) & (rd3 < r_max**3))

    def diag_wet_rng_cons(self, r_min, r_max):
        rw2 = self.state.rw2
        self._cons((rw2 >= r_min**2) & (rw2 < r_max**2))

    def diag_kappa_rng_cons(self, k_min, k_max):
        kpa = self.state.kpa
        self._cons((kpa >= k_min) & (kpa < k_max))

    def _check_selected(self):
        if self._n_filtered is None:
            raise RuntimeError(
                "libcloudphxx: please select SDs before calling a moment diag"
            )

    def diag_sd_conc(self):
        """SD count (not multiplicity) per cell of the selected population
        (reference particles_diag.ipp:196-219)."""
        self._check_selected()
        self._set_outbuf(self._sd_count_impl(self._n_filtered))

    def diag_dry_mom(self, n):
        self._check_selected()
        self._set_outbuf(self._moms_calc_impl(
            n / 3.0, self._n_filtered, self.state.rd3))

    def diag_wet_mom(self, n):
        self._check_selected()
        self._set_outbuf(self._moms_calc_impl(
            n / 2.0, self._n_filtered, self.state.rw2))

    def diag_kappa_mom(self, n):
        self._check_selected()
        self._set_outbuf(self._moms_calc_impl(
            float(n), self._n_filtered, self.state.kpa))

    def _require_ice(self):
        if not self.opts_init.ice_switch:
            raise RuntimeError(
                "libcloudphxx: ice is switched off in opts_init, "
                "but diag_ice was called"
            )

    def diag_ice(self):
        """Select frozen SDs (reference particles_diag.ipp:276-283)."""
        self._require_ice()
        self._n_filtered = jnp.where(self.state.ice_a > 0, self.state.n, 0.0)

    def diag_water(self):
        """Select liquid SDs (particles_diag.ipp:285-290)."""
        self._require_init()
        self._n_filtered = jnp.where(self.state.rw2 > 0, self.state.n, 0.0)

    def diag_ice_cons(self):
        self._require_ice()
        self._cons(self.state.ice_a > 0)

    def diag_water_cons(self):
        self._require_init()
        self._cons(self.state.rw2 > 0)

    def diag_ice_a_rng(self, a_min, a_max):
        self._require_ice()
        a = self.state.ice_a
        self._n_filtered = jnp.where(
            (a >= a_min) & (a < a_max), self.state.n, 0.0)

    def diag_ice_c_rng(self, c_min, c_max):
        self._require_ice()
        cc = self.state.ice_c
        self._n_filtered = jnp.where(
            (cc >= c_min) & (cc < c_max), self.state.n, 0.0)

    def diag_ice_a_rng_cons(self, a_min, a_max):
        self._require_ice()
        a = self.state.ice_a
        self._cons((a >= a_min) & (a < a_max))

    def diag_ice_c_rng_cons(self, c_min, c_max):
        self._require_ice()
        cc = self.state.ice_c
        self._cons((cc >= c_min) & (cc < c_max))

    def diag_ice_a_mom(self, n):
        self._require_ice()
        self._check_selected()
        self._set_outbuf(self._moms_calc_impl(
            float(n), self._n_filtered, self.state.ice_a))

    def diag_ice_c_mom(self, n):
        self._require_ice()
        self._check_selected()
        self._set_outbuf(self._moms_calc_impl(
            float(n), self._n_filtered, self.state.ice_c))

    def diag_ice_mix_ratio(self):
        """Specific ice mass per cell (particles_diag.ipp:443-454)."""
        self._require_ice()
        self._check_selected()
        from . import ice as ice_mod
        mass = ice_mod.ice_mass(
            self.state.ice_a, self.state.ice_c, self.state.ice_rho)
        self._set_outbuf(self._moms_calc_impl(
            1.0, self._n_filtered, mass))

    def diag_precip_rate_ice_mass(self):
        """1st non-specific moment of ice_mass * vt
        (particles_diag.ipp:590-607)."""
        self._require_ice()
        self._check_selected()
        from . import ice as ice_mod
        self._set_outbuf(self._precip_rate_impl(ice=True))

    def diag_rw_ge_rc(self):
        """Select activated SDs: rw >= critical radius
        (reference particles_diag.ipp:384-409)."""
        self._require_init()
        st = self._tpr_impl()
        rc2 = _rc2_of(st, st.T[st.ijk])
        self._n_filtered = jnp.where(st.rw2 >= rc2, st.n, 0.0)

    def diag_RH_ge_Sc(self):
        """Select SDs whose ambient RH exceeds their critical supersaturation
        (reference particles_diag.ipp:353-381)."""
        from ..common import kappa_koehler
        self._require_init()
        st = self._tpr_impl()
        S_cr = kappa_koehler.S_cr(
            jnp.maximum(st.rd3, 1e-300), jnp.maximum(st.kpa, 1e-10),
            st.T[st.ijk],
        )
        self._n_filtered = jnp.where(st.RH[st.ijk] >= S_cr, st.n, 0.0)

    def diag_precip_rate(self):
        """1st non-specific moment of rw^3 * vt of the selected SDs
        (reference particles_diag.ipp:561-588)."""
        self._check_selected()
        self._set_outbuf(self._precip_rate_impl(ice=False))

    def diag_max_rw(self):
        """Largest wet radius per cell (reference particles_diag.ipp:609-643)."""
        self._require_init()
        rw = jnp.sqrt(jnp.maximum(self.state.rw2, 0.0))
        rw = jnp.where(self.state.n > 0, rw, 0.0)
        self._set_outbuf(self._segment_max_impl(rw))

    def diag_vel_div(self):
        """Flow-field divergence per cell [1/s]
        (reference particles_diag.ipp:501-556)."""
        self._require_init()
        from . import transport
        cfg = self.cfg
        ijk = jnp.arange(cfg.n_cell)
        (lft, rgt), (fre, hnd), (blw, abv) = transport.courant_indices(
            cfg, ijk
        )
        div = jnp.zeros(cfg.n_cell)
        if cfg.n_dims >= 1:
            div = div + self.state.courant_x[rgt] - self.state.courant_x[lft]
        if cfg.n_dims == 3:
            div = div + self.state.courant_y[hnd] - self.state.courant_y[fre]
        if cfg.n_dims > 1:
            div = div + self.state.courant_z[abv] - self.state.courant_z[blw]
        self._set_outbuf(div / self.cfg.dt)

    def diag_incloud_time_mom(self, n):
        """(reference particles_diag.ipp:484-492)"""
        if not self.opts_init.diag_incloud_time:
            raise RuntimeError(
                "libcloudphxx: diag_incloud_time_mom called, but "
                "opts_init.diag_incloud_time == false"
            )
        self._check_selected()
        self._set_outbuf(self._moms_calc_impl(
            float(n), self._n_filtered, self.state.incloud_time))

    def diag_wet_mass_dens(self, rad, sig0):
        """Mass-density KDE at wet radius ``rad``
        (reference particles_diag.ipp:494-499 + mass_dens.ipp)."""
        self._check_selected()
        self._set_outbuf(self._mass_dens_impl(
            self._n_filtered, float(rad), float(sig0)))

    def diag_up_mom(self, n):
        """Moment of the SGS x-velocity perturbation
        (reference particles.hpp:117)."""
        self._check_selected()
        self._set_outbuf(self._moms_calc_impl(
            float(n), self._n_filtered, self.state.up))

    def diag_vp_mom(self, n):
        """(reference particles.hpp:118)"""
        self._check_selected()
        self._set_outbuf(self._moms_calc_impl(
            float(n), self._n_filtered, self.state.vp))

    def diag_wp_mom(self, n):
        """(reference particles.hpp:119)"""
        self._check_selected()
        self._set_outbuf(self._moms_calc_impl(
            float(n), self._n_filtered, self.state.wp))

    def diag_chem(self, species):
        """Specific per-cell mass of a dissolved chem species
        (reference particles_diag.ipp diag_chem + moms_calc over chem_bgn)."""
        self._require_init()
        if not self.cfg.chem_switch:
            raise RuntimeError(
                "libcloudphxx: all chemistry was switched off in opts_init"
            )
        self._check_selected()
        self._set_outbuf(self._moms_calc_impl(
            1.0, self._n_filtered, self.state.chem[int(species)]))

    # -------------------------------------------------- checkpoint/resume
    def save(self, path):
        """Full-state checkpoint: every State leaf (plus the call-order
        machine) to one npz.  The reference has no library-level
        checkpointing (host models reach state via get_attr, SURVEY
        section 5); here the pytree state makes it first-class."""
        self._require_init()
        leaves = {f.name: np.asarray(getattr(self.state, f.name))
                  for f in dataclasses.fields(State)}
        leaves["__flags__"] = np.array([
            self._init_called, self._should_now_run_cond,
            self._should_now_run_async], dtype=bool)
        leaves["__counters__"] = np.array([self._src_ctr, self._rlx_ctr])
        np.savez_compressed(path, **leaves)

    def load(self, path):
        """Restore a checkpoint written by save() into this instance
        (opts_init must match the one used at save time)."""
        with np.load(path) as d:
            cur = self.state
            leaves = {}
            for f in dataclasses.fields(State):
                ref = getattr(cur, f.name)
                leaves[f.name] = jnp.asarray(d[f.name], ref.dtype)
                if leaves[f.name].shape != ref.shape:
                    raise ValueError(
                        f"lgrngn load: shape mismatch for {f.name} "
                        f"({leaves[f.name].shape} vs {ref.shape}) — "
                        "was the checkpoint written with other opts_init?")
            flags = d["__flags__"]
            ctrs = d["__counters__"]
        self.state = self._put_state(State(**leaves))
        self._init_called = bool(flags[0])
        self._should_now_run_cond = bool(flags[1])
        self._should_now_run_async = bool(flags[2])
        self._src_ctr, self._rlx_ctr = int(ctrs[0]), int(ctrs[1])

    def _put_state(self, state):
        return state

    def diag_puddle(self):
        """(reference particles_impl_bcnd.ipp puddle accumulators)"""
        self._require_init()
        vals = np.asarray(self.state.puddle)
        return dict(zip(PUDDLE_KEYS, vals.tolist()))

    def outbuf(self):
        """Last diagnostic, as a (n_cell,) float64 numpy array
        (reference particles.hpp outbuf + fill_outbuf.ipp:13-37)."""
        return np.ascontiguousarray(self._outbuf)

    def get_attr(self, name):
        """Raw per-SD attribute dump (reference fill_outbuf.ipp:39-100;
        attr name set :42, with the reference's "kappa" spelling alongside
        the internal "kpa")."""
        self._require_init()
        mapping = {
            "rd3": self.state.rd3, "rw2": self.state.rw2,
            "kpa": self.state.kpa, "kappa": self.state.kpa,
            "n": self.state.n,
            "x": self.state.x, "y": self.state.y, "z": self.state.z,
            "vt": self.state.vt,
            "incloud_time": self.state.incloud_time,
            "rd2_insol": self.state.rd2_insol,
            "T_freeze": self.state.T_freeze,
            "ice_a": self.state.ice_a, "ice_c": self.state.ice_c,
            "ice_rho": self.state.ice_rho,
            "up": self.state.up, "vp": self.state.vp, "wp": self.state.wp,
        }
        if name not in mapping:
            raise ValueError(f"lgrngn: unknown attribute {name!r}")
        ice_attrs = {"ice_a", "ice_c", "ice_rho", "rd2_insol", "T_freeze"}
        if name in ice_attrs and not self.opts_init.ice_switch:
            raise RuntimeError(
                "libcloudphxx: ice attribute requested with ice_switch off"
            )
        return np.asarray(mapping[name])


def auto_engine() -> str:
    """The engine the factory's ``auto`` mode gives a dense-capable
    configuration: "dense" on an accelerator (on the H100 it runs the
    canonical bench step in well under half the flat engine's time —
    PERF.md), "flat" on the host CPU."""
    return "dense" if on_accelerator() else "flat"


def factory(backend: backend_t, opts_init: opts_init_t) -> particles_t:
    """Runtime backend dispatch (reference src/lib.cpp:12-44).  Single-device
    backends map onto one JAX execution path; multi_CUDA (or
    opts_init.dev_count > 1) selects the device-mesh front-end
    (reference lib.cpp:30-38 + multi_gpu_impl.ipp).

    Engine auto-selection (``auto_engine``): on an accelerator,
    configurations the dense cell-major engine covers (dense._supported)
    get the dense engine; LIBCLOUD_ENGINE=dense forces it on any backend
    (used by the CPU conformance tests), =flat disables it."""
    import os
    dev_count = int(getattr(opts_init, "dev_count", 0))
    if dev_count > 1 or (backend == backend_t.multi_CUDA
                         and len(jax.devices()) > 1):
        from ..parallel.multi import particles_multi_t
        return particles_multi_t(backend, opts_init,
                                 n_devices=dev_count or None)
    eng = os.environ.get("LIBCLOUD_ENGINE", "auto")
    if eng == "dense" or (eng == "auto" and auto_engine() == "dense"):
        from .dense_front import dense_capable, particles_dense_t
        probe = particles_dense_t(backend, opts_init)
        if dense_capable(probe.cfg):
            return probe
    return particles_t(backend, opts_init)
