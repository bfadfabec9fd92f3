"""Super-droplet initialisation.

JAX equivalent of reference src/impl/initialization/ (28 files, SURVEY
section 2.2).  Initialisation happens once, host-side: distribution analysis
runs in numpy (mirroring init_dist_analysis.ipp), sampling fills the
fixed-capacity state arrays, and the kappa-Koehler equilibrium wet radius is
solved on-device with the batched bracketing solver (init_wet.ipp:18-77).

Modes implemented: ``sd_conc`` (stratified ln-radius sampling, exact SD count
per cell — init_SD_with_distros_sd_conc.ipp), ``sd_const_multi`` (uniform
ln-radius sampling with constant multiplicity — init_SD_with_distros_
const_multi.ipp), and ``dry_sizes`` (fixed radius/concentration pairs).
"""

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np

from ..common import constants as c
from ..common import kappa_koehler
from . import hskpng
from .state import State, StaticConfig

# reference src/detail/config.hpp:21-24
RD_MIN_INIT = 1e-14
RD_MAX_INIT = 1e-3
CONST_MULTI_THRESHOLD = 1e20


def cell_dv(cfg: StaticConfig) -> np.ndarray:
    """Per-cell sample volume with the Lagrangian-domain crop
    (reference init_grid.ipp dv_eval:33-52): cells partially outside
    [x0,x1]x[y0,y1]x[z0,z1] get proportionally smaller volumes (the
    libmpdata++ coupling uses x0=dx/2, x1=(nx-.5)*dx half-cell crops,
    kin_cloud_2d_lgrngn.hpp:167-170)."""
    def axis(n, d, a0, a1):
        i = np.arange(max(1, n))
        return np.maximum(
            0.0, np.minimum((i + 1) * d, a1) - np.maximum(i * d, a0)
        )

    wx = axis(cfg.nx, cfg.dx, cfg.x0, cfg.x1)
    wy = axis(cfg.ny, cfg.dy, cfg.y0, cfg.y1)
    wz = axis(cfg.nz, cfg.dz, cfg.z0, cfg.z1)
    # i outermost, k innermost (ravel order of ijk)
    return (wx[:, None, None] * wy[None, :, None] * wz[None, None, :]).ravel()


def conc_factor_cells(cfg: StaticConfig, oi) -> np.ndarray | None:
    """Per-cell aerosol concentration factor from the per-level profile
    ``opts_init.aerosol_conc_factor`` (reference opts_init.hpp:140;
    applied by k = cell % nz in particles_impl_init_count_num.ipp:65-70 and
    particles_impl_init_n.ipp:100-110).  Returns (n_cell,) or None."""
    factor = np.asarray(getattr(oi, "aerosol_conc_factor", []) or [],
                        dtype=float)
    if factor.size == 0:
        return None
    # sanity checks mirror init_sanity_check.ipp:119-127
    if cfg.n_dims < 2:
        raise RuntimeError(
            "libcloudph++: aerosol_conc_factor can only be used in 2D and 3D")
    if factor.size != cfg.nz:
        raise RuntimeError(
            "libcloudph++: aerosol_conc_factor size needs to be either 0 "
            "or nz")
    if not oi.aerosol_independent_of_rhod:
        raise RuntimeError(
            "libcloudph++: aerosol_conc_factor can only be used if "
            "aerosol_independent_of_rhod==true")
    return factor[np.arange(cfg.n_cell) % cfg.nz]


def _eval_distro(fun, lnrd):
    """Evaluate a user distribution over an array of ln(rd).

    Vectorized call first (numpy-aware callables evaluate the whole
    population at once); scalar-only callables (reference-style
    unary_function equivalents) fall back to np.vectorize."""
    lnrd = np.asarray(lnrd, dtype=float)
    try:
        out = np.asarray(fun(lnrd), dtype=float)
        if out.shape == lnrd.shape:
            return out
    except Exception:
        pass
    return np.vectorize(lambda v: float(fun(v)), otypes=[float])(lnrd)


def _dist_analysis_sd_conc(fun, sd_conc, cell_vol, rd_min=-1.0, rd_max=-1.0):
    """Detect the [rd_min, rd_max] support of n(ln rd) and the multiplicity
    coefficient (reference init_dist_analysis.ipp:17-80).

    Returns (log_rd_min, log_rd_max, multiplier)."""
    if rd_min >= 0 and rd_max >= 0:
        mult = math.log(rd_max / rd_min) / sd_conc * cell_vol
        return math.log(rd_min), math.log(rd_max), mult
    if not (rd_min < 0 and rd_max < 0):
        raise ValueError("opts_init.rd_min * opts_init.rd_max < 0")

    lo, hi = RD_MIN_INIT, RD_MAX_INIT
    while True:
        mult = math.log(hi / lo) / sd_conc * cell_vol
        # the reference evaluates these into an integer multiplicity type,
        # so sub-1 values count as zero (init_dist_analysis.ipp:63-65)
        n_min = int(float(fun(math.log(lo))) * mult)
        n_max = int(float(fun(math.log(hi))) * mult)
        if lo == RD_MIN_INIT and n_min != 0:
            raise RuntimeError(
                f"Initial dry distribution non-zero ({n_min}) at rd_min_init"
            )
        if hi == RD_MAX_INIT and n_max != 0:
            raise RuntimeError(
                f"Initial dry distribution non-zero ({n_max}) at rd_max_init"
            )
        if n_min == 0:
            lo *= 1.01
        elif n_max == 0:
            hi /= 1.01
        else:
            return math.log(lo), math.log(hi), mult


def _dist_analysis_const_multi(fun):
    """Support detection for const-multi mode: bound where the distribution
    falls below max/threshold (reference init_dist_analysis.ipp:83-122)."""
    lnr = np.linspace(math.log(RD_MIN_INIT), math.log(RD_MAX_INIT), 20001)
    vals = _eval_distro(fun, lnr)
    peak = vals.max()
    bound = peak / CONST_MULTI_THRESHOLD
    above = np.nonzero(vals > bound)[0]
    if len(above) == 0:
        raise RuntimeError("const-multi distribution analysis: empty support")
    return float(lnr[above[0]]), float(lnr[above[-1]])


def _sample_const_multi(fun, log_lo, log_hi, multi, oi, cfg, dv_host,
                        rhod_host, rng):
    """Constant-multiplicity sampling over [log_lo, log_hi], vectorized over
    all cells (reference init_count_num_const_multi + init_dry_const_multi):
    per-cell SD count = round(integral * dv * rhod/rho_stp / multi), ln(rd)
    drawn by inverse-CDF sampling.  Returns (lnrd, multiplicity, ijk)."""
    n_cell = cfg.n_cell
    lnr = np.linspace(log_lo, log_hi, 10001)
    vals = _eval_distro(fun, lnr)
    conc = np.trapezoid(vals, lnr)  # [1/m3] @ STP

    n_in_cell = conc * np.asarray(dv_host, float)
    if not oi.aerosol_independent_of_rhod:
        n_in_cell = n_in_cell * np.asarray(rhod_host) / c.rho_stp
    factor = conc_factor_cells(cfg, oi)
    if factor is not None:
        n_in_cell = n_in_cell * factor
    counts = np.floor(n_in_cell / multi + 0.5).astype(np.int64)
    total = int(counts.sum())
    if total == 0:
        return (np.zeros(0), np.zeros(0), np.zeros(0, np.int64))
    ijk = np.repeat(np.arange(n_cell, dtype=np.int64), counts)
    cdf = np.concatenate([[0.0], np.cumsum(
        0.5 * (vals[1:] + vals[:-1]) * np.diff(lnr))])
    cdf /= cdf[-1]
    lnrd = np.interp(rng.random(total), cdf, lnr)
    return lnrd, np.full(total, float(multi)), ijk


def init_SD(cfg: StaticConfig, oi, state: State, rng: np.random.Generator,
            rhod_host: np.ndarray) -> State:
    """Create the initial super-droplet population in ``state``'s
    fixed-capacity arrays (reference init_SD_with_distros.ipp +
    init_SD_with_sizes.ipp orchestration)."""
    n_cell = cfg.n_cell
    cell_vol = (
        1.0 / float(rhod_host[0]) if cfg.n_dims == 0
        else cfg.dx * cfg.dy * cfg.dz
    )

    # host-side accumulation, then one device upload
    lnrd_l, n_l, kpa_l, ijk_l, insol_l = [], [], [], [], []

    def key_parts(key):
        """(kappa, rd_insol) key, reference distro_t.hpp:9-57."""
        if isinstance(key, tuple):
            return key[0], (key[1] if len(key) > 1 else 0.0)
        return key, 0.0

    if cfg.n_dims == 0:
        dv_host = 1.0 / np.asarray(rhod_host)
    else:
        dv_host = cell_dv(cfg)

    if oi.dry_distros and oi.sd_conc > 0:
        # --- sd_conc mode (init_SD_with_distros_sd_conc.ipp:14-45)
        analyses = {}
        for key, fun in oi.dry_distros.items():
            kappa = key[0] if isinstance(key, tuple) else key
            analyses[key] = _dist_analysis_sd_conc(
                fun, oi.sd_conc, cell_vol, oi.rd_min, oi.rd_max
            )
        tot_rng = sum(a[1] - a[0] for a in analyses.values())

        for key, fun in oi.dry_distros.items():
            kappa, rd_insol = key_parts(key)
            log_lo, log_hi, mult = analyses[key]
            fraction = (log_hi - log_lo) / tot_rng
            count = int(fraction * oi.sd_conc + 0.5)  # SDs per cell
            if count == 0:
                continue
            # rounding correction (init_SD_with_distros_sd_conc.ipp:27-29)
            mult *= oi.sd_conc / count

            # stratified ln(rd) sampling within each cell
            # (init_dry_sd_conc.ipp:27-37 calc_lnrd)
            u01 = rng.random((n_cell, count))
            strata = (np.arange(count)[None, :] + u01) / count
            lnrd = log_lo + strata * (log_hi - log_lo)

            # multiplicity = n(lnrd) * multiplier, STP-corrected by rhod,
            # volume-adjusted (init_n.ipp:80-135)
            n_of = _eval_distro(fun, lnrd) * mult
            if not oi.aerosol_independent_of_rhod:
                n_of *= np.asarray(rhod_host)[:, None] / c.rho_stp
            factor = conc_factor_cells(cfg, oi)
            if factor is not None:
                n_of = n_of * factor[:, None]
            if cfg.n_dims > 0:
                n_of *= dv_host[:, None] / (cfg.dx * cfg.dy * cfg.dz)
            multiplicity = np.floor(n_of + 0.5)

            lnrd_l.append(lnrd.ravel())
            n_l.append(multiplicity.ravel())
            kpa_l.append(np.full(n_cell * count, kappa))
            ijk_l.append(np.repeat(np.arange(n_cell), count))
            insol_l.append(np.full(n_cell * count, rd_insol))

            if oi.sd_conc_large_tail:
                # --- large-tail extension: multiplicity-1 SDs sampled from
                # the distribution tail above the sd_conc range
                # (init_SD_with_distros_tail.ipp: const_multi=1 particles
                # over [log_rd_max_sd_conc, log_rd_max_const_multi])
                _, tail_hi = _dist_analysis_const_multi(fun)
                if tail_hi > log_hi:
                    t_lnrd, t_n, t_ijk = _sample_const_multi(
                        fun, log_hi, tail_hi, 1, oi, cfg, dv_host,
                        rhod_host, rng)
                    lnrd_l.append(t_lnrd)
                    n_l.append(t_n)
                    kpa_l.append(np.full(t_lnrd.size, kappa))
                    ijk_l.append(t_ijk)
                    insol_l.append(np.full(t_lnrd.size, rd_insol))

    elif oi.dry_distros and oi.sd_const_multi > 0:
        # --- const-multi mode (init_SD_with_distros_const_multi.ipp)
        for key, fun in oi.dry_distros.items():
            kappa, rd_insol = key_parts(key)
            log_lo, log_hi = _dist_analysis_const_multi(fun)
            lnrd, mlt, ijk = _sample_const_multi(
                fun, log_lo, log_hi, oi.sd_const_multi, oi, cfg, dv_host,
                rhod_host, rng)
            lnrd_l.append(lnrd)
            n_l.append(mlt)
            kpa_l.append(np.full(lnrd.size, kappa))
            ijk_l.append(ijk)
            insol_l.append(np.full(lnrd.size, rd_insol))

    if oi.dry_sizes:
        # --- dry_sizes mode (init_SD_with_sizes.ipp); vectorized over cells
        for key, sizes in oi.dry_sizes.items():
            kappa, rd_insol = key_parts(key)
            for radius, (conc, sd_count) in sizes.items():
                sd_count = int(sd_count)
                number = conc * dv_host
                if not oi.aerosol_independent_of_rhod:
                    number = number * np.asarray(rhod_host) / c.rho_stp
                factor = conc_factor_cells(cfg, oi)
                if factor is not None:
                    number = number * factor
                # per-cell multiplicity, repeated over the sd_count slots
                multiplicity = np.floor(number / sd_count + 0.5)
                total = n_cell * sd_count
                lnrd_l.append(np.full(total, math.log(radius)))
                n_l.append(np.repeat(multiplicity, sd_count))
                kpa_l.append(np.full(total, kappa))
                ijk_l.append(np.repeat(np.arange(n_cell), sd_count))
                insol_l.append(np.full(total, rd_insol))

    if not lnrd_l:
        raise ValueError(
            "lgrngn init: no SD init mode selected "
            "(set sd_conc, sd_const_multi or dry_sizes)"
        )

    lnrd = np.concatenate(lnrd_l)
    mult = np.concatenate(n_l)
    kpa = np.concatenate(kpa_l)
    ijk = np.concatenate(ijk_l).astype(np.int32)
    rd_insol = np.concatenate(insol_l)
    n_part = lnrd.size
    if n_part > cfg.n_sd_max:
        raise RuntimeError(
            f"lgrngn init: n_part ({n_part}) exceeds n_sd_max ({cfg.n_sd_max})"
        )

    pad = cfg.n_sd_max - n_part
    dtype = state.rd3.dtype

    def padded(arr, fill=0.0):
        return jnp.asarray(
            np.concatenate([arr, np.full(pad, fill)]), dtype
        )

    # decompose ravelled ijk back into (i, j, k) per the ordering of
    # hskpng.ijk_of_xyz (i outermost, k innermost); positions uniform within
    # the cell intersected with the Lagrangian domain (init_xyz.ipp:17-35:
    # x = u01*min(x1,(i+1)dx) + (1-u01)*max(x0, i*dx))
    idx = ijk.copy()
    dims = []
    if cfg.nz > 1 or cfg.n_dims >= 2:
        dims.append(("z", cfg.nz, cfg.z0, cfg.z1, cfg.dz))
    if cfg.ny > 1:
        dims.insert(0, ("y", cfg.ny, cfg.y0, cfg.y1, cfg.dy))
    if cfg.n_dims >= 1:
        dims.insert(0, ("x", cfg.nx, cfg.x0, cfg.x1, cfg.dx))
    coords = {"x": np.zeros(n_part), "y": np.zeros(n_part),
              "z": np.zeros(n_part)}
    for name, n_axis, a0, a1, da in reversed(dims):
        axis_idx = idx % n_axis
        idx //= n_axis
        u01 = rng.random(n_part)
        lo = np.maximum(a0, axis_idx * da)
        hi = np.minimum(a1, (axis_idx + 1) * da)
        coords[name] = u01 * hi + (1.0 - u01) * lo

    state = dataclasses.replace(
        state,
        n=padded(mult),
        rd3=padded(np.exp(3.0 * lnrd), fill=1e-30),
        kpa=padded(kpa),
        x=padded(coords["x"]),
        y=padded(coords["y"]),
        z=padded(coords["z"]),
        ijk=jnp.asarray(
            np.concatenate([ijk, np.zeros(pad, np.int32)]), jnp.int32
        ),
        vt=jnp.zeros((cfg.n_sd_max,), dtype),
        rd2_insol=padded(rd_insol**2),
    )
    if cfg.ice_switch and not cfg.time_dep_ice_nucl:
        # singular freezing temperatures (reference init_T_freeze.ipp:16-31)
        from ..common import ice_nucleation
        u = jnp.asarray(np.concatenate(
            [rng.random(n_part), np.full(pad, 0.5)]), dtype)
        T_freeze = ice_nucleation.T_freeze_CDF_inv(state.rd2_insol, u)
        state = dataclasses.replace(state, T_freeze=T_freeze)
    return state


def init_wet(cfg: StaticConfig, state: State, RH_max) -> State:
    """Equilibrium wet radius at min(RH, RH_max) via the batched
    kappa-Koehler root solve (reference init_wet.ipp:18-77)."""
    RH_sd = jnp.minimum(state.RH[state.ijk], RH_max)
    T_sd = state.T[state.ijk]
    rw3 = kappa_koehler.rw3_eq(state.rd3, state.kpa, RH_sd, T_sd)
    rw2 = rw3 ** (2.0 / 3)
    return dataclasses.replace(
        state, rw2=jnp.where(state.n > 0, rw2, 0.0)
    )
