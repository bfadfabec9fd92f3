"""Terminal-velocity housekeeping for the SD population.

JAX equivalent of reference src/impl/housekeeping/particles_impl_
hskpng_vterm.ipp, including the beard77fast 10k-bin vt0 cache
(get_vt0_bin:17-35).
"""

import numpy as np

import jax.numpy as jnp

from ..common import vterm as cv
from .enums import vt_t
from .state import StaticConfig

# beard77fast sea-level vt cache (reference src/detail/config.hpp:207-210 +
# init_vterm.ipp): 10k bins in ln(r); the gather replaces ~20
# transcendental ops per SD per refresh
VT0_BINS = 10000
VT0_LN_R_MIN = float(np.log(0.5e-6))
VT0_LN_R_MAX = float(np.log(3.5e-3))
_VT0_TABLE = None


def _vt0_table():
    global _VT0_TABLE
    if _VT0_TABLE is None:
        import jax

        # the table is a compile-time constant; build it eagerly even when
        # first touched from inside a jit trace
        with jax.ensure_compile_time_eval():
            lnr = np.linspace(VT0_LN_R_MIN, VT0_LN_R_MAX, VT0_BINS)
            _VT0_TABLE = np.asarray(
                cv.vt_beard77_v0(jnp.asarray(np.exp(lnr)))
            )
    return _VT0_TABLE


def vt_of(cfg: StaticConfig, rw2, T, p, rhod, eta):
    """Population terminal velocity by the selected formula
    (reference hskpng_vterm.ipp:37-100)."""
    rw = jnp.sqrt(jnp.maximum(rw2, 1e-300))
    formula = vt_t(cfg.terminal_velocity)
    if formula == vt_t.beard76:
        v = cv.vt_beard76(rw, T, p, rhod, eta)
    elif formula == vt_t.beard77:
        v = cv.vt_beard77_fact(rw, p, rhod, eta) * cv.vt_beard77_v0(rw)
    elif formula == vt_t.beard77fast:
        # binned sea-level vt0 (get_vt0_bin, hskpng_vterm.ipp:17-35)
        # times the altitude factor
        lnr = 0.5 * jnp.log(jnp.maximum(rw2, 1e-300))
        pos = (lnr - VT0_LN_R_MIN) / (VT0_LN_R_MAX - VT0_LN_R_MIN)
        idx = jnp.clip((pos * VT0_BINS).astype(jnp.int32), 0, VT0_BINS - 1)
        vt0 = jnp.asarray(_vt0_table(), rw.dtype)[idx]
        v = cv.vt_beard77_fact(rw, p, rhod, eta) * vt0
    elif formula == vt_t.khvorostyanov_spherical:
        v = cv.vt_khvorostyanov(rw, T, rhod, eta, spherical=True)
    elif formula == vt_t.khvorostyanov_nonspherical:
        v = cv.vt_khvorostyanov(rw, T, rhod, eta, spherical=False)
    else:
        v = jnp.zeros_like(rw)
    return jnp.where(rw2 > 0, v, 0.0)


def hskpng_vterm_all(cfg: StaticConfig, state):
    """Recompute vt of every SD (reference hskpng_vterm_all)."""
    import dataclasses
    g = lambda arr: arr[state.ijk]
    vt = vt_of(cfg, state.rw2, g(state.T), g(state.p), g(state.rhod),
               g(state.eta))
    return dataclasses.replace(state, vt=vt)
