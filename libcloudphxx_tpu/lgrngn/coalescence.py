"""Monte-Carlo all-or-nothing coalescence (Shima et al. 2009 SDM).

JAX equivalent of reference src/impl/coalescence/particles_impl_coal.ipp
and src/detail/kernels.hpp.  The thrust shuffle-sort + adjacent-pair for_each
becomes: one argsort of (cell, random) keys (dead slots pushed past all
cells), vectorized pair probability/collision math over every adjacent even
position, and conflict-free scatters back to the attribute arrays (each SD
belongs to at most one pair).
"""

import dataclasses
import os
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from ..common import constants as c
from . import hskpng
from . import vterm as vterm_mod
from .enums import kernel_t
from .state import State, StaticConfig

_KERNEL_DATA_DIR = os.path.join(os.path.dirname(__file__), "kernel_data")
_TABLE_CACHE = {}

# which kernel_t values use which tabulated efficiency dataset
TABULATED = {
    kernel_t.hall: "hall",
    kernel_t.hall_davis_no_waals: "hall_davis_no_waals",
    kernel_t.hall_pinsky_1000mb_grav: "hall_pinsky_1000mb_grav",
    kernel_t.hall_pinsky_cumulonimbus: "hall_pinsky_cumulonimbus",
    kernel_t.hall_pinsky_stratocumulus: "hall_pinsky_stratocumulus",
    kernel_t.vohl_davis_no_waals: "vohl_davis_no_waals",
    # onishi turbulent kernels share the stagnant-air efficiency tables
    kernel_t.onishi_hall: "hall",
    kernel_t.onishi_hall_davis_no_waals: "hall_davis_no_waals",
}


def load_efficiency_table(kern: kernel_t):
    """Load a tabulated efficiency dataset as a dense symmetric device
    constant (extracted from the reference's packed triangular data headers
    by tools/extract_kernel_tables.py).  Returns (table, r_max_um)."""
    name = TABULATED.get(kern)
    if name is None:
        return jnp.zeros((1, 1)), 0.0
    if name not in _TABLE_CACHE:
        with np.load(os.path.join(_KERNEL_DATA_DIR, f"{name}.npz")) as d:
            # cache host-side; jnp conversion happens per call so a traced
            # constant never leaks out of a jit scope
            _TABLE_CACHE[name] = (
                np.asarray(d["efficiencies"]), float(d["r_max_um"]))
    table, r_max = _TABLE_CACHE[name]
    return jnp.asarray(table), r_max


def _kernel_index(r_um):
    """Radius [um] -> table index: 1 um steps to 100 um, 10 um above
    (reference src/detail/kernel_utils.hpp:12-18)."""
    return jnp.where(
        r_um <= 100.0, r_um, 100.0 + (r_um - 100.0) / 10.0
    ).astype(jnp.int32)


def interpolated_efficiency(table, r_max_um, rw_a, rw_b):
    """Bilinear collision-efficiency lookup over the nonuniform radius grid
    (reference src/detail/kernel_interpolation.hpp:9-67), as one vectorized
    2-D gather."""

    def prep(r_m):
        r = jnp.minimum(r_m * 1e6, r_max_um - 1e-6)
        big = r >= 100.0
        x0 = jnp.where(big, jnp.floor(r / 10.0) * 10.0, jnp.floor(r))
        dx = jnp.where(big, 10.0, 1.0)
        i0 = _kernel_index(x0)
        i1 = _kernel_index(x0 + dx)
        w_hi = r - x0        # weight of the upper node
        w_lo = x0 + dx - r   # weight of the lower node
        return i0, i1, w_hi, w_lo, dx

    i0, i1, w1h, w1l, d1 = prep(rw_a)
    j0, j1, w2h, w2l, d2 = prep(rw_b)
    return (
        table[i0, j0] * w1l * w2l
        + table[i1, j0] * w1h * w2l
        + table[i0, j1] * w1l * w2h
        + table[i1, j1] * w1h * w2h
    ) / d1 / d2


# Wang et al. 2009 turbulent collision-efficiency enhancement, table 1
# (reference src/detail/wang_collision_enhancement.hpp:11-110)
_WANG_R0 = jnp.array([10e-6, 20e-6, 30e-6, 40e-6, 50e-6, 60e-6, 100e-6])
_WANG_RAT = jnp.linspace(0.0, 1.0, 11)
_WANG_ETA = jnp.array([
    [[1.74, 1.74, 1.773, 1.49, 1.207, 1.207, 1.0],
     [4.976, 4.976, 3.593, 2.519, 1.445, 1.445, 1.0]],
    [[1.46, 1.46, 1.421, 1.245, 1.069, 1.069, 1.0],
     [2.984, 2.984, 2.181, 1.691, 1.201, 1.201, 1.0]],
    [[1.32, 1.32, 1.245, 1.123, 1.000, 1.000, 1.0],
     [1.988, 1.988, 1.475, 1.313, 1.150, 1.150, 1.0]],
    [[1.250, 1.250, 1.148, 1.087, 1.025, 1.025, 1.0],
     [1.490, 1.490, 1.187, 1.156, 1.126, 1.126, 1.0]],
    [[1.186, 1.186, 1.066, 1.060, 1.056, 1.056, 1.0],
     [1.249, 1.249, 1.088, 1.090, 1.092, 1.092, 1.0]],
    [[1.045, 1.045, 1.000, 1.014, 1.028, 1.028, 1.0],
     [1.139, 1.139, 1.130, 1.091, 1.051, 1.051, 1.0]],
    [[1.070, 1.070, 1.030, 1.038, 1.046, 1.046, 1.0],
     [1.220, 1.220, 1.190, 1.138, 1.086, 1.086, 1.0]],
    [[1.000, 1.000, 1.054, 1.042, 1.029, 1.029, 1.0],
     [1.325, 1.325, 1.267, 1.165, 1.063, 1.063, 1.0]],
    [[1.223, 1.223, 1.117, 1.069, 1.021, 1.021, 1.0],
     [1.716, 1.716, 1.345, 1.223, 1.100, 1.100, 1.0]],
    [[1.570, 1.570, 1.244, 1.166, 1.088, 1.088, 1.0],
     [3.788, 3.788, 1.501, 1.311, 1.120, 1.120, 1.0]],
    [[20.3, 20.3, 14.6, 8.61, 2.60, 2.60, 1.0],
     [36.52, 36.52, 19.16, 22.80, 26.0, 26.0, 1.0]],
])


def wang_enhancement(r1, r2, eps):
    """Turbulent collision-efficiency enhancement (Wang et al. 2009);
    branchless bilinear interpolation in (collector radius, radius ratio)
    (reference wang_collision_enhancement.hpp:44-88)."""
    R = jnp.maximum(r1, r2)
    r = jnp.minimum(r1, r2)
    n_eps = (eps > 2.5e-2).astype(jnp.int32)
    # searchsorted: first R0 > R / first rat > ratio
    n_R0 = jnp.searchsorted(_WANG_R0, R, side="right")
    ratio = r / jnp.maximum(R, 1e-300)
    n_rat = jnp.clip(
        jnp.searchsorted(_WANG_RAT, ratio, side="right"), 1, 10
    )
    small = n_R0 == 0
    n_R0c = jnp.clip(n_R0, 1, 6)
    w0 = R - _WANG_R0[n_R0c - 1]
    w1 = _WANG_R0[n_R0c] - R
    w2 = ratio - _WANG_RAT[n_rat - 1]
    w3 = _WANG_RAT[n_rat] - ratio
    interp = (
        _WANG_ETA[n_rat - 1, n_eps, n_R0c - 1] * w1 * w3
        + _WANG_ETA[n_rat - 1, n_eps, n_R0c] * w0 * w3
        + _WANG_ETA[n_rat, n_eps, n_R0c - 1] * w1 * w2
        + _WANG_ETA[n_rat, n_eps, n_R0c] * w0 * w2
    ) / (_WANG_R0[n_R0c] - _WANG_R0[n_R0c - 1]) \
        / (_WANG_RAT[n_rat] - _WANG_RAT[n_rat - 1])
    out = jnp.where(small, _WANG_ETA[n_rat, n_eps, 0], interp)
    return jnp.where(R > 100e-6, 1.0, out)


def onishi_nograv(r1, r2, Re_l, eps, dnu, ratio_den):
    """Turbulent collision kernel without gravitational settling
    (Onishi 2005/2013/2014; Wang et al. 2000 <|Wr|>; Zhou et al. 2001 g12) —
    branchless port of reference src/detail/kernel_onishi_nograv.hpp:30-160.

    Note: the reference computes the Kolmogorov scale with pow(x, 1/4) where
    1/4 is C++ *integer* division (== 0), i.e. l_eta = 1 m; here the intended
    (nu^3/eps)^(1/4) is used."""
    eps_s = jnp.maximum(eps, 1e-30)
    urms = jnp.sqrt(Re_l / jnp.sqrt(15.0 / dnu / eps_s))
    CR = r1 + r2
    taup1 = ratio_den * 4.0 * r1 * r1 / 18.0 / dnu
    taup2 = ratio_den * 4.0 * r2 * r2 / 18.0 / dnu
    leta = (dnu**3 / eps_s) ** 0.25
    tauk = leta * leta / dnu
    Te = Re_l * tauk / jnp.sqrt(15.0)

    theta1 = 2.5 * taup1 / Te
    theta2 = 2.5 * taup2 / Te
    phi = jnp.maximum(theta2 / theta1, theta1 / theta2)
    cw = 1.0 + 0.6 * jnp.exp(-jnp.maximum(phi - 1.0, 0.0) ** 1.5)
    gamma = phi * 0.183 * urms * urms / (dnu * dnu / leta / leta)

    WrS2 = (dnu * dnu * CR * CR) / leta**4 / 15.0
    WrA2 = (
        urms * urms * gamma / (gamma - 1.0)
        * ((theta1 + theta2) - 4.0 * theta1 * theta2 / (theta1 + theta2)
           * jnp.sqrt((1.0 + theta1 + theta2)
                      / (1.0 + theta1) / (1.0 + theta2)))
        * (1.0 / (1.0 + theta1) / (1.0 + theta2)
           - 1.0 / (1.0 + gamma * theta1) / (1.0 + gamma * theta2))
    )
    WrA2 = cw * WrA2 / 3.0  # Ayala 2008
    Wr = jnp.sqrt(2.0 / c.pi * (WrA2 + WrS2))

    A1, A2, A3 = 110.0, 0.38, 0.16
    alpha = jnp.maximum(jnp.log10(0.26 * jnp.sqrt(Re_l)) / jnp.log10(2.0),
                        1e-20)
    CA = 0.06 * Re_l**0.30
    CB = 0.4
    StA = (A2 / A1 * Re_l) ** 0.25
    StB = jnp.cbrt(A2 / A3) ** 2 * jnp.cbrt(Re_l)
    St1 = taup1 / tauk
    St2 = taup2 / tauk

    def g_mono(St, St_other):
        y1 = jnp.where(St_other <= StA, A1 * St * St, 0.0)
        y2 = jnp.where(St_other <= StA, 0.0, A2 * Re_l / (St * St))
        y3 = A3 * jnp.sqrt(Re_l / St)
        za = 0.5 * (1.0 - jnp.tanh((jnp.log10(St) - jnp.log10(StA)) / CA))
        zb = 0.5 * (1.0 + jnp.tanh((jnp.log10(St) - jnp.log10(StB)) / CB))
        return y1 * za**alpha + y2 * (1.0 - za) ** alpha + y3 * zb + 1.0

    gR1 = g_mono(St1, St2)
    gR2 = g_mono(St2, St1)
    xai = jnp.maximum(taup2 / taup1, taup1 / taup2)
    RG12 = 2.6 * jnp.exp(-xai) + 0.205 * jnp.exp(-0.0206 * xai) \
        * 0.5 * (1.0 + jnp.tanh(xai - 3.0))
    gR = 1.0 + RG12 * jnp.sqrt(jnp.maximum(gR1 - 1.0, 0.0)) \
        * jnp.sqrt(jnp.maximum(gR2 - 1.0, 0.0))

    out = 2.0 * c.pi * CR * CR * Wr * gR
    return jnp.where(eps < 1e-10, 0.0, out)


def kernel_value(cfg: StaticConfig, params, n_a, n_b, rw2_a, rw2_b,
                 vt_a, vt_b, rd3_a, rd3_b,
                 eff_table=None, r_max_um=0.0,
                 rhod=1.0, eta=1.8e-5, diss_rate=0.0):
    """Collision kernel K(a,b) including the max-multiplicity factor
    (reference kernels.hpp:40-255).  ``params`` = opts_init.kernel_parameters
    as a device array (may be empty); ``eff_table`` the dense tabulated
    efficiencies for the table-based kernels."""
    kern = kernel_t(cfg.kernel)
    n_max = jnp.maximum(n_a, n_b)
    if kern == kernel_t.golovin:
        # (kernels.hpp:40-80)
        b = params[0]
        return (
            c.pi * 4.0 / 3.0 * b * n_max
            * (rw2_a * jnp.sqrt(rw2_a) + rw2_b * jnp.sqrt(rw2_b))
        )

    # geometric base (kernels.hpp:84-125)
    rw_a = jnp.sqrt(rw2_a)
    rw_b = jnp.sqrt(rw2_b)
    geo = (
        c.pi * n_max * jnp.abs(vt_a - vt_b)
        * (rw2_a + rw2_b + 2.0 * rw_a * rw_b)
    )
    if kern == kernel_t.geometric:
        # a single user parameter turns this into geometric-with-multiplier
        # (reference kernels.hpp:128-142, init_kernel.ipp:30-45)
        if params.shape[0] >= 1:
            return geo * params[0]
        return geo
    if kern == kernel_t.long:
        # Long 1974 efficiency below 50 um (kernels.hpp:146-176)
        r_L = jnp.maximum(rw_a, rw_b)
        r_s = jnp.minimum(rw_a, rw_b)
        eff = jnp.where(
            r_s <= 3e-6, 0.0, 4.5e8 * r_L * r_L * (1.0 - 3e-6 / r_s)
        )
        return jnp.where(r_L < 50e-6, geo * eff, geo)
    if kern in (kernel_t.hall, kernel_t.hall_davis_no_waals,
                kernel_t.hall_pinsky_1000mb_grav,
                kernel_t.hall_pinsky_cumulonimbus,
                kernel_t.hall_pinsky_stratocumulus,
                kernel_t.vohl_davis_no_waals):
        # (kernels.hpp:179-207)
        return geo * interpolated_efficiency(eff_table, r_max_um, rw_a, rw_b)
    if kern in (kernel_t.onishi_hall, kernel_t.onishi_hall_davis_no_waals):
        # turbulent kernel (kernels.hpp:210-255): stagnant efficiency x Wang
        # enhancement x sqrt(geometric^2 + onishi^2); params[0] doubles as
        # Re_lambda (nograv) and epsilon (Wang), as in the reference
        # n_max multiplies the whole kernel (it belongs to the pair
        # probability); the reference includes it only in the geometric term
        nograv = onishi_nograv(
            rw_a, rw_b, params[0], diss_rate, eta / rhod, c.rho_w / rhod
        ) * n_max
        eff = interpolated_efficiency(eff_table, r_max_um, rw_a, rw_b)
        enh = wang_enhancement(rw_a, rw_b, params[0])
        return eff * enh * jnp.sqrt(geo * geo + nograv * nograv)
    raise NotImplementedError(f"lgrngn: kernel {kern} not implemented yet")


def _shift_up(arr):
    """arr[i+1] with the last element repeated — a contiguous slice instead
    of a gather."""
    return jnp.concatenate([arr[1:], arr[-1:]])


def _shift_down(arr):
    """arr[i-1] with the first element repeated (value lanes — only read
    where the shifted mask is set)."""
    return jnp.concatenate([arr[:1], arr[:-1]])


def _shift_down_mask(mask):
    """mask[i-1] with False injected at lane 0 (lane 0 has no predecessor,
    so a pair starting there must not re-apply to itself)."""
    return jnp.concatenate([jnp.zeros((1,), mask.dtype), mask[:-1]])


def coal_substep(cfg: StaticConfig, state: State, params, dt, key,
                 eff_table=None, r_max_um=0.0, turb_coal=False) -> State:
    """One coalescence substep over the whole population
    (reference particles_impl_coal.ipp:273-546).

    The shuffle-sort carries every pair-needed SD attribute as a sort
    *value* (one multi-operand lax.sort), so the pairing needs no
    permutation gathers."""
    n_sd = cfg.n_sd_max
    dead = state.n <= 0
    cellkey = jnp.where(dead, jnp.int32(cfg.n_cell),
                        state.ijk).astype(jnp.int32)

    k_shuffle, k_u01 = jax.random.split(key)
    shuffle = jax.random.uniform(k_shuffle, (n_sd,))
    pos = jnp.arange(n_sd, dtype=jnp.int32)

    # random permutation within each cell: one sort by (cell, random) with
    # the original index and all pair attributes riding as values
    carried = (state.n, state.rw2, state.rd3, state.kpa, state.vt)
    extra = ()
    if cfg.chem_switch:
        extra += tuple(state.chem[i] for i in range(8))
    if cfg.diag_incloud_time:
        extra += (state.incloud_time,)
    sorted_ = jax.lax.sort(
        (cellkey, shuffle, pos) + carried + extra, num_keys=2
    )
    sijk, orig = sorted_[0], sorted_[2]
    n_a, rw2_a, rd3_a, kpa_a, vt_a = sorted_[3:8]
    extra_a = sorted_[8:]

    # per-cell SD counts and offsets from the sorted keys (binary search
    # instead of a scatter-add; dead slots sort past all cells)
    bounds = jnp.searchsorted(
        sijk, jnp.arange(cfg.n_cell + 1, dtype=sijk.dtype)
    )
    count = (bounds[1:] - bounds[:-1]).astype(state.n.dtype)
    # Shima 2009 sec 5.1.3 scale factor n(n-1)/2 / floor(n/2)
    # (coal.ipp:99-107)
    half = jnp.floor(count / 2)
    scale = jnp.where(count > 1, count * (count - 1) / 2.0 / half, 0.0)
    off = bounds[:-1]  # exclusive scan (coal.ipp:313-327)

    in_domain = sijk < cfg.n_cell
    cell = jnp.minimum(sijk, cfg.n_cell - 1)
    off_here = jnp.where(in_domain, off[cell], 0).astype(pos.dtype)
    cix = pos - off_here

    # candidate pairs: even in-cell index, neighbour in the same cell
    # (coal.ipp:196-216); the neighbour's attributes come from a shift-by-one
    sijk_nxt = _shift_up(sijk)
    is_pair = (
        (cix % 2 == 0)
        & in_domain
        & (sijk_nxt == sijk)
        & (pos < n_sd - 1)
    )

    a = orig
    b = _shift_up(orig)
    n_b = _shift_up(n_a)
    rw2_b = _shift_up(rw2_a)
    rd3_b = _shift_up(rd3_a)
    kpa_b = _shift_up(kpa_a)
    vt_b = _shift_up(vt_a)
    dv = state.dv[cell]

    K = kernel_value(
        cfg, params, n_a, n_b, rw2_a, rw2_b, vt_a, vt_b, rd3_a, rd3_b,
        eff_table=eff_table, r_max_um=r_max_um,
        rhod=state.rhod[cell], eta=state.eta[cell],
        # opts.turb_coal gates whether kernels see the ambient turbulence
        # (reference coal.ipp:439-450: the _turb tuple feeds diss_rate to
        # the onishi/Wang terms only when turb_coal is on)
        diss_rate=state.diss_rate[cell] if turb_coal else 0.0,
    )
    prob = dt / dv * scale[cell] * K
    prob = jnp.where(is_pair, prob, 0.0)

    # integer collisions + Bernoulli remainder (all-or-nothing
    # multi-collision, coal.ipp:218-236)
    col_no = jnp.floor(prob)
    puddle = state.puddle
    if cfg.pure_const_multi:
        # a const-multi pair with floor(prob) >= 1 requests adaptive
        # sstp_coal growth (coal.ipp:224-227); sticky flag, host-consumed
        from .state import OUT_COAL_OVERFLOW
        puddle = puddle.at[OUT_COAL_OVERFLOW].max(
            (jnp.max(jnp.where(is_pair, col_no, 0.0)) >= 1.0
             ).astype(puddle.dtype))
    u01 = jax.random.uniform(k_u01, (n_sd,))
    col_no = col_no + (u01 < prob - col_no)

    # big = higher-multiplicity SD loses multiplicity; small absorbs mass
    # (>= so equal multiplicities flag the 'a' droplet for recycling,
    # coal.ipp:243-246)
    a_is_big = n_a >= n_b
    n_big = jnp.where(a_is_big, n_a, n_b)
    n_small = jnp.where(a_is_big, n_b, n_a)
    ratio = jnp.where(n_small > 0, jnp.floor(n_big / jnp.maximum(n_small, 1)), 0.0)
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
    rw3_small_new = col_no * rw2_big * jnp.sqrt(rw2_big) + \
        rw2_small * jnp.sqrt(rw2_small)
    rw2_small_new = jnp.cbrt(rw3_small_new) ** 2
    rd3_small_new = col_no * rd3_big + rd3_small
    # rd3-weighted kappa mixing (reference post-pass summator coal.ipp:470-500)
    kpa_small_new = jnp.where(
        rd3_small_new > 0,
        (col_no * kpa_big * rd3_big + kpa_small * rd3_small)
        / jnp.maximum(rd3_small_new, 1e-300),
        kpa_small,
    )

    # apply the pair outcome IN SORTED SPACE (lane p holds the pair math;
    # lane p+1 reads it through a shift), then one scatter by the original
    # slot index restores attribute order (hskpng.unpermute)
    hp = _shift_down_mask(happened)
    bigp = _shift_down(a_is_big)

    n_s = jnp.where(happened & a_is_big, n_big_new, n_a)
    n_s = jnp.where(hp & ~bigp, _shift_down(n_big_new), n_s)
    rw2_s = jnp.where(happened & ~a_is_big, rw2_small_new, rw2_a)
    rw2_s = jnp.where(hp & bigp, _shift_down(rw2_small_new), rw2_s)
    rd3_s = jnp.where(happened & ~a_is_big, rd3_small_new, rd3_a)
    rd3_s = jnp.where(hp & bigp, _shift_down(rd3_small_new), rd3_s)
    kpa_s = jnp.where(happened & ~a_is_big, kpa_small_new, kpa_a)
    kpa_s = jnp.where(hp & bigp, _shift_down(kpa_small_new), kpa_s)

    back_vals = [n_s, rw2_s, rd3_s, kpa_s]
    if cfg.chem_switch:
        # dissolved chemical masses add up (coal.ipp:459-468 post-summator);
        # the per-species rows rode the sort as values
        chem_a = jnp.stack(extra_a[0:8])
        chem_b = jnp.stack([_shift_up(row) for row in extra_a[0:8]])
        chem_big = jnp.where(a_is_big, chem_a, chem_b)
        chem_small = jnp.where(a_is_big, chem_b, chem_a)
        chem_small_new = chem_small + col_no * chem_big
        for i in range(8):
            row = jnp.where(happened & ~a_is_big, chem_small_new[i],
                            chem_a[i])
            row = jnp.where(hp & bigp, _shift_down(chem_small_new[i]), row)
            back_vals.append(row)
    if cfg.diag_incloud_time:
        # the merged droplet keeps the longer in-cloud residence
        # (coal.ipp incloud_time max post-summator)
        ict_a = extra_a[-1]
        t_max = jnp.maximum(ict_a, _shift_up(ict_a))
        row = jnp.where(happened & ~a_is_big, t_max, ict_a)
        row = jnp.where(hp & bigp, _shift_down(t_max), row)
        back_vals.append(row)

    unsorted = hskpng.unpermute(orig, back_vals)
    updates = dict(n=unsorted[0], rw2=unsorted[1], rd3=unsorted[2],
                   kpa=unsorted[3])
    if cfg.chem_switch:
        updates["chem"] = jnp.stack(unsorted[4:12])
    if cfg.diag_incloud_time:
        updates["incloud_time"] = unsorted[-1]
    # invalidate vt of the grown droplet: recomputed wholesale after the
    # substep (reference marks detail::invalid then hskpng_vterm_invalid)
    return dataclasses.replace(state, puddle=puddle, **updates)


def coal(cfg: StaticConfig, state: State, params, dt, sstp_coal: int,
         turb_coal: bool = False) -> State:
    """The sstp_coal-substep coalescence loop of step_async
    (reference particles_step.ipp:382-404), with terminal velocities
    refreshed between substeps (hskpng_vterm_invalid)."""
    dt_sub = dt / sstp_coal
    eff_table, r_max_um = load_efficiency_table(kernel_t(cfg.kernel))

    # carry only the attributes coalescence mutates (plus the RNG key);
    # hauling the whole State through the XLA while loop costs real copies
    carried = ("n", "rw2", "rd3", "kpa", "vt", "key", "puddle")
    if cfg.chem_switch:
        carried += ("chem",)
    if cfg.diag_incloud_time:
        carried += ("incloud_time",)
    full = state
    # the ambient cell values seen by each SD are invariant during the
    # coalescence loop (ijk and th/rv don't change here) — hoist the
    # cell->SD gathers of the vterm refresh out of the substep loop
    ijk = state.ijk
    T_sd, p_sd = state.T[ijk], state.p[ijk]
    rhod_sd, eta_sd = state.rhod[ijk], state.eta[ijk]

    def body(_, mini):
        st = dataclasses.replace(full, **{k: mini[k] for k in carried
                                          if k != "key"})
        key, sub = jax.random.split(mini["key"])
        # hskpng_vterm_invalid equivalent: refresh vt from the current rw2
        vt = vterm_mod.vt_of(cfg, st.rw2, T_sd, p_sd, rhod_sd, eta_sd)
        st = dataclasses.replace(st, vt=vt)
        st = coal_substep(cfg, st, params, dt_sub, sub,
                          eff_table=eff_table, r_max_um=r_max_um,
                          turb_coal=turb_coal)
        out = {k: getattr(st, k) for k in carried if k != "key"}
        out["key"] = key
        return out

    mini = jax.lax.fori_loop(
        0, sstp_coal, body, {k: getattr(state, k) for k in carried}
    )
    state = dataclasses.replace(state, **mini)
    vt = vterm_mod.vt_of(cfg, state.rw2, T_sd, p_sd, rhod_sd, eta_sd)
    return dataclasses.replace(state, vt=vt)
