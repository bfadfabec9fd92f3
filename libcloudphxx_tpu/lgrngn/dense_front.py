"""Public-API front-end for the dense cell-major engine.

``particles_dense_t`` is a drop-in ``particles_t`` whose stepping hooks run
on the resident (n_cell, cap) occupancy matrix (lgrngn/dense.py) instead of
the flat per-SD vectors, while every diagnostic, source/relaxation,
checkpoint and get_attr call transparently syncs back to the flat layout
first.  The reference has ONE
engine running all features at full speed (src/particles_step.ipp:161-494);
here the dense engine covers the performance-critical configuration set
(2-D, percell substepping, warm physics) and hands anything else to the
flat code path per-call.

Layout residency protocol:
  - ``self._loc``     : where the authoritative SD population lives
                        ("flat" or "dense").
  - ``_ensure_dense`` : pack (one global sort) before dense stepping.
  - ``_ensure_flat``  : unpack before any consumer of the flat layout;
                        hooked into ``_require_init`` so the whole ~45-call
                        diag surface (which all starts there) is covered.
Switching costs one global sort each way, paid only when the caller
interleaves stepping with diagnostics (the reference pays the analogous
sort in hskpng_sort / moms_calc anyway).
"""

import dataclasses

import jax
import numpy as np

from . import dense
from .particles import particles_t, _step_async_jit
from .state import StaticConfig

_step_cond_dense = jax.jit(dense.step_cond, static_argnums=(0,))
_step_async_dense = jax.jit(
    dense.step_async,
    static_argnums=(0,),
    static_argnames=("sstp_coal", "do_coal", "do_sedi", "do_adve",
                     "do_subs"))


# per-SD attributes carried through the dense layout; the rest keep a stale
# (pre-pack) ordering once dense stepping has run — loudly rejected in
# get_attr rather than silently wrong
_CARRIED = {"n", "rw2", "rd3", "kpa", "kappa", "x", "y", "z", "vt"}


def dense_capable(cfg: StaticConfig) -> bool:
    """Does the dense engine support this construction-time config?"""
    try:
        dense._supported(cfg)
        return True
    except NotImplementedError:
        return False


class particles_dense_t(particles_t):
    """particles_t with the dense cell-major engine behind step_cond /
    step_async (selected by the factory for supported configs)."""

    engine = "dense"

    def init(self, *args, **kwargs):
        super().init(*args, **kwargs)
        counts = np.bincount(
            np.asarray(self.state.ijk)[np.asarray(self.state.n) > 0],
            minlength=self.cfg.n_cell)
        # row overflow during the run raises loudly (no silent drops)
        self._cap = dense.row_capacity(counts.max())
        self._loc = "flat"
        self._d = None
        self._dense_stepped = False
        self._last_rhod_host = None

    # ------------------------------------------------ residency switching
    def _ensure_dense(self):
        if self._loc != "dense":
            self._d = jax.jit(dense.pack, static_argnums=(0, 2))(
                self.cfg, self.state, self._cap)
            if float(self._d.overflow):
                raise RuntimeError(
                    f"lgrngn dense engine: initial population exceeds row "
                    f"capacity {self._cap}")
            self._loc = "dense"

    def _check_overflow(self):
        """Deferred row-overflow gate: reading the device counter forces a host
        sync, so the hot stepping loop accumulates it on-device and this check
        runs at every flat-sync point (diag surface, save, get_attr) instead of
        once per step.  Overflow still never passes silently — it raises at the
        next point the caller observes the population."""
        if self._d is not None and self._loc == "dense":
            dropped = float(self._d.overflow)
            if dropped:
                raise RuntimeError(
                    f"lgrngn dense engine: {dropped:.0f} SDs dropped on row "
                    f"overflow (capacity {self._cap}) — raise n_sd_max/cap")

    def _ensure_flat(self):
        if self._loc == "dense":
            self._check_overflow()
            self.state = jax.jit(dense.unpack, static_argnums=0)(
                self.cfg, self._d, self.state)
            self._loc = "flat"

    def _require_init(self):
        super()._require_init()
        self._ensure_flat()

    def _src_engine(self):
        self._ensure_flat()
        return super()._src_engine()

    def get_attr(self, name):
        if self._dense_stepped and name not in _CARRIED:
            raise RuntimeError(
                f"lgrngn dense engine: attribute {name!r} is not carried "
                f"through the dense layout (carried: {sorted(_CARRIED)})")
        return super().get_attr(name)

    def save(self, path):
        self._ensure_flat()
        return super().save(path)

    def load(self, path):
        out = super().load(path)
        # the restored flat state is authoritative; drop any dense copy
        self._loc = "flat"
        self._d = None
        return out

    # ------------------------------------------------------ sync tracking
    def sync_in(self, th=None, rv=None, rhod=None, **kwargs):
        if rhod is None:
            self._rhod_changed = False
        elif isinstance(rhod, jax.Array):
            # device-array ABI: comparing values would force a host round
            # trip per step; the SAME handle means the SAME values
            # (jax arrays are immutable), anything else counts as changed
            self._rhod_changed = rhod is not self._last_rhod_host
            self._last_rhod_host = rhod
        else:
            r = np.asarray(rhod, dtype=np.float64).reshape(-1)
            prev = self._last_rhod_host
            self._rhod_changed = (
                prev is None or isinstance(prev, jax.Array)
                or not np.array_equal(r, prev))
            self._last_rhod_host = r.copy()
        super().sync_in(th=th, rv=rv, rhod=rhod, **kwargs)

    # --------------------------------------------------------- step hooks
    def _step_cond_impl(self, state, dt, RH_max, turb_cond, ice_nucl, cond,
                        var_rho):
        # features the dense cond path does not cover -> flat for this call
        # (rhod substepping matters only when the host-passed density
        # actually changed, sstp_percell_step.ipp:17-20)
        if (turb_cond or ice_nucl or not cond
                or (var_rho and getattr(self, "_rhod_changed", False))):
            self._ensure_flat()
            return super()._step_cond_impl(state, dt, RH_max, turb_cond,
                                           ice_nucl, cond, var_rho)
        self._ensure_dense()
        cfg_dt = self._cfg_for_dt(self.cfg, dt)
        cast = lambda a: a.astype(self._d.n.dtype)
        d = dataclasses.replace(
            self._d, rhod=cast(state.rhod),
            courant_x=cast(state.courant_x),
            courant_y=cast(state.courant_y),
            courant_z=cast(state.courant_z))
        d, thc, rvc = _step_cond_dense(cfg_dt, d, cast(state.th),
                                       cast(state.rv), dt, RH_max)
        self._d = d
        self._dense_stepped = True
        return dataclasses.replace(
            state, th=thc, rv=rvc, T=d.T, p=d.p, RH=d.RH, eta=d.eta,
            sstp_tmp_th=d.sstp_tmp_th, sstp_tmp_rv=d.sstp_tmp_rv,
            key=d.key)

    def _step_async_impl(self, sstp, switches, state, params, w_LS,
                         sgs_mix_len, dt):
        (do_coal, do_adve, do_sedi, do_subs, do_turb_adve, do_turb_cond,
         do_rcyc, do_turb_coal) = switches
        if (do_turb_adve or do_turb_cond or do_rcyc or do_turb_coal
                or self._loc != "dense"):
            # unsupported toggles — or cond ran flat this step (layouts must
            # not interleave within one step) — use the flat pipeline
            self._ensure_flat()
            return _step_async_jit(self.cfg, sstp, switches, state, params,
                                   w_LS, sgs_mix_len, dt)
        d = _step_async_dense(
            self.cfg, self._d, params.astype(self._d.n.dtype), dt,
            sstp_coal=int(sstp), do_coal=bool(do_coal),
            do_sedi=bool(do_sedi), do_adve=bool(do_adve),
            do_subs=bool(do_subs), w_LS=w_LS.astype(self._d.n.dtype))
        self._d = d
        self._dense_stepped = True
        # overflow gate deferred to the next flat-sync point
        # (_check_overflow) — reading it here would force one host round
        # trip per step
        return dataclasses.replace(state, puddle=d.puddle, key=d.key)
