"""Aerosol sources: creation of new super-droplets during the simulation.

JAX equivalent of reference src/impl/sources_and_relaxation_of_SDs/
(src_dry_distros_simple.ipp, src_dry_distros_matching.ipp, src_dry_sizes.ipp,
src.ipp).  Source injection happens once every ``supstp_src`` steps, so it
runs host-side (numpy sampling, like init) and lands in the fixed-capacity
state arrays through dead slots — the same architecture as the reference,
where source SDs append to the resized device vectors.

Source distributions represent particles created *per unit time* @ STP
(opts.src_dry_distros = {(kappa, rd_insol): (fun, src_sd_conc, supstp)});
the effective dt is supstp * dt.
"""

import dataclasses
import math

import jax.numpy as jnp
import numpy as np

from ..common import constants as c
from . import init as init_mod
from .state import State, StaticConfig


def _box_cells(cfg: StaticConfig, oi):
    """Cells inside the source box, rounded to cell boundaries
    (reference opts_init.hpp:156-158; in 3-D the box is bounded in y too
    by src_y0/src_y1)."""
    i0 = int(np.floor(oi.src_x0 / cfg.dx))
    i1 = max(i0 + 1, int(np.ceil(oi.src_x1 / cfg.dx)))
    if cfg.n_dims > 1:
        k0 = int(np.floor(oi.src_z0 / cfg.dz))
        k1 = max(k0 + 1, int(np.ceil(oi.src_z1 / cfg.dz)))
    else:
        k0, k1 = 0, 1
    if cfg.ny > 1:
        j0 = int(np.floor(oi.src_y0 / cfg.dy))
        j1 = max(j0 + 1, int(np.ceil(oi.src_y1 / cfg.dy)))
    else:
        j0, j1 = 0, 1
    cells = []
    nz = max(1, cfg.nz)
    ny = max(1, cfg.ny)
    for i in range(i0, min(i1, cfg.nx)):
        for j in range(j0, min(j1, ny)):
            for k in range(k0, min(k1, nz)):
                cells.append((i * ny + j) * nz + k)
    return np.asarray(cells, dtype=np.int64)


def _fresh_attr_names(cfg: StaticConfig):
    """Per-SD attributes that must be RESET on slot revival (a dead slot
    keeps its last occupant's values) — everything that migrates, so new
    SDs start clean like the reference's appended vectors."""
    from ..parallel.decomp import migrating_attrs
    return migrating_attrs(cfg) + ("ijk",)


def _inject(state: State, new, rng, cfg: StaticConfig):
    """Place new SDs (dict of host arrays) into dead slots; attributes not
    supplied are zeroed (fresh SDs, like the reference's appended+initialised
    vectors rather than revived garbage)."""
    n_new = new["n"].size
    if n_new == 0:
        return state, 0
    n_host = np.asarray(state.n)
    dead = np.nonzero(n_host <= 0)[0]
    if dead.size < n_new:
        raise RuntimeError(
            f"lgrngn source: {n_new} new SDs but only {dead.size} free slots "
            f"(n_sd_max too small)"
        )
    slots = jnp.asarray(dead[:n_new])
    updates = {}
    for name in _fresh_attr_names(cfg):
        arr = getattr(state, name)
        if arr.size == 0:
            continue
        vals = new.get(name)
        if vals is None:
            vals = np.zeros(n_new)
        updates[name] = arr.at[slots].set(jnp.asarray(vals, arr.dtype))
    if cfg.chem_switch and state.chem.size:
        updates["chem"] = state.chem.at[:, slots].set(0.0)
    return dataclasses.replace(state, **updates), n_new


class StateEngine:
    """Serial backend adapter for source/relaxation: direct host access to
    the State.  The mesh front-end provides a sharded twin
    (parallel/multi.MeshSrcEngine) with the same interface, so the candidate
    generation code (and its RNG stream) is shared bit-for-bit."""

    def __init__(self, cfg: StaticConfig, state: State):
        self.cfg = cfg
        self.state = state

    def cell(self, name):
        """Global per-cell field as a host array."""
        return np.asarray(getattr(self.state, name))

    def _augment_fresh(self, cfg, new):
        """Exact-substepping mode: new SDs carry their cell's current
        ambient state as their private copy (reference
        particles_impl_post_adding_SD.ipp:42 -> init_perparticle_sstp)."""
        if cfg.exact_sstp_cond:
            cells = np.asarray(new["ijk"], np.int64)
            for tname, cname in (("sstp_tmp_th", "th"),
                                 ("sstp_tmp_rv", "rv"),
                                 ("sstp_tmp_rh", "rhod"),
                                 ("sstp_tmp_p", "p")):
                new[tname] = self.cell(cname)[cells]
        return new

    def inject(self, new) -> int:
        """Place new SDs (host arrays, global coordinates) into dead slots."""
        new = self._augment_fresh(self.cfg, new)
        self.state, added = _inject(self.state, new, None, self.cfg)
        return added

    def rlx_counts(self, kappa_rng, rd3_edges):
        """Bin-resolved per-level CCN multiplicity sums: (n_bins, nz).
        Multiplicities are integer-valued f64, so the sum is exact and
        backend-independent."""
        cfg = self.cfg
        nz = max(1, cfg.nz)
        st = self.state
        n = np.asarray(st.n)
        rd3 = np.asarray(st.rd3)
        kpa = np.asarray(st.kpa)
        k = np.asarray(st.ijk) % nz
        nb = len(rd3_edges) - 1
        alive = n > 0
        in_k = alive & (kpa >= kappa_rng[0]) & (kpa < kappa_rng[1])
        b = np.searchsorted(rd3_edges, rd3, side="right") - 1
        ok = in_k & (b >= 0) & (b < nb)
        return np.bincount(
            b[ok] * nz + k[ok], weights=n[ok], minlength=nb * nz
        ).reshape(nb, nz)

    def percell_population(self):
        """(n, rd3, kpa, ijk_global) host views for the matching source."""
        st = self.state
        return (np.asarray(st.n), np.asarray(st.rd3),
                np.asarray(st.kpa), np.asarray(st.ijk).astype(np.int64))

    def add_multiplicity(self, updates):
        """n += updates, indexed like percell_population's arrays."""
        self.state = dataclasses.replace(
            self.state,
            n=self.state.n + jnp.asarray(updates, self.state.n.dtype))


def _positions_in_cells(cfg: StaticConfig, cells, rng):
    nz = max(1, cfg.nz)
    ny = max(1, cfg.ny)
    i = cells // (nz * ny)
    j = (cells // nz) % ny
    k = cells % nz
    x = (i + rng.random(cells.size)) * cfg.dx
    y = (j + rng.random(cells.size)) * cfg.dy if cfg.ny > 1 \
        else np.zeros(cells.size)
    z = (k + rng.random(cells.size)) * cfg.dz if cfg.n_dims > 1 \
        else np.zeros(cells.size)
    return x, y, z


def _equilibrium_rw2(eng, cells, rd3, kappa, RH_max):
    """Wet equilibrium at the target cell's current conditions
    (reference src uses init_wet on the appended SDs)."""
    from ..common import kappa_koehler
    RH = np.minimum(eng.cell("RH")[cells], RH_max)
    T = eng.cell("T")[cells]
    rw3 = kappa_koehler.rw3_eq(
        jnp.asarray(rd3), jnp.full(rd3.shape, kappa),
        jnp.asarray(RH), jnp.asarray(T),
    )
    return np.asarray(rw3) ** (2.0 / 3)


def src_simple_distros(cfg: StaticConfig, oi, eng, src_dry_distros, dt, rng,
                       RH_max):
    """'simple' source: fresh SDs sampled from the per-time distribution
    (reference src_dry_distros_simple.ipp:20-90).  ``eng`` is the backend
    adapter (StateEngine here, MeshSrcEngine on the device mesh); all
    candidate generation and RNG consumption is backend-independent."""
    cells = _box_cells(cfg, oi)
    rhod_host = eng.cell("rhod")
    total = 0
    for key, (fun, src_sd_conc, supstp) in src_dry_distros.items():
        kappa = key[0] if isinstance(key, tuple) else key
        dt_eff = supstp * dt
        cell_vol = cfg.dx * cfg.dy * cfg.dz if cfg.n_dims > 0 \
            else 1.0 / float(rhod_host[0])
        log_lo, log_hi, mult = init_mod._dist_analysis_sd_conc(
            fun, src_sd_conc, cell_vol * dt_eff
        )
        count = int(src_sd_conc)
        u01 = rng.random((cells.size, count))
        strata = (np.arange(count)[None, :] + u01) / count
        lnrd = log_lo + strata * (log_hi - log_lo)
        n_of = init_mod._eval_distro(fun, lnrd) * mult
        if not oi.aerosol_independent_of_rhod:
            n_of *= rhod_host[cells][:, None] / c.rho_stp
        conc_fac = init_mod.conc_factor_cells(cfg, oi)
        if conc_fac is not None:
            # the aerosol_conc_factor profile scales source multiplicities
            # too (init_n.ipp:100-110, shared by src_dry_distros_simple)
            n_of = n_of * conc_fac[cells][:, None]
        multiplicity = np.floor(n_of + 0.5)

        cell_rep = np.repeat(cells, count)
        keep = multiplicity.ravel() > 0
        cell_rep = cell_rep[keep]
        lnrd_f = lnrd.ravel()[keep]
        mult_f = multiplicity.ravel()[keep]
        x, y, z = _positions_in_cells(cfg, cell_rep, rng)
        rd3 = np.exp(3.0 * lnrd_f)
        rw2 = _equilibrium_rw2(eng, cell_rep, rd3, kappa, RH_max)
        new = dict(
            n=mult_f, rd3=rd3, rw2=rw2,
            kpa=np.full(mult_f.size, kappa),
            x=x, z=z, y=y,
            vt=np.zeros(mult_f.size),
            ijk=cell_rep.astype(np.int32),
        )
        total += eng.inject(new)
    return total


def src_matching_distros(cfg: StaticConfig, oi, eng, src_dry_distros, dt,
                         rng, RH_max):
    """'matching' source: boost multiplicities of existing SDs whose dry
    radius matches a source bin; create SDs only for unmatched bins
    (reference src_dry_distros_matching.ipp, simplified to
    closest-in-bin matching)."""
    cells = _box_cells(cfg, oi)
    rhod_host = eng.cell("rhod")
    n_host, rd3_host, kpa_host, ijk_host = eng.percell_population()
    total_created = 0
    mult_updates = np.zeros_like(n_host)

    for key, (fun, src_sd_conc, supstp) in src_dry_distros.items():
        kappa = key[0] if isinstance(key, tuple) else key
        dt_eff = supstp * dt
        cell_vol = cfg.dx * cfg.dy * cfg.dz if cfg.n_dims > 0 \
            else 1.0 / float(rhod_host[0])
        log_lo, log_hi, mult = init_mod._dist_analysis_sd_conc(
            fun, src_sd_conc, cell_vol * dt_eff
        )
        nbins = int(src_sd_conc)
        edges = np.linspace(log_lo, log_hi, nbins + 1)
        mids = 0.5 * (edges[:-1] + edges[1:])
        n_per_bin_stp = init_mod._eval_distro(fun, mids) * mult

        new_lists = {k: [] for k in
                     ("n", "rd3", "rw2_cell", "kpa", "cell")}
        conc_fac = init_mod.conc_factor_cells(cfg, oi)
        for cell in cells:
            factor = (1.0 if oi.aerosol_independent_of_rhod
                      else rhod_host[cell] / c.rho_stp)
            if conc_fac is not None:
                factor = factor * conc_fac[cell]
            target = np.floor(n_per_bin_stp * factor + 0.5)
            # existing SDs of this kappa in this cell
            here = np.nonzero(
                (ijk_host == cell) & (n_host > 0)
                & (np.abs(kpa_host - kappa) < 1e-12)
            )[0]
            lnrd_here = np.log(np.maximum(rd3_host[here], 1e-300)) / 3.0
            bin_of = np.searchsorted(edges, lnrd_here) - 1
            for b in range(nbins):
                if target[b] <= 0:
                    continue
                in_bin = here[bin_of == b]
                if in_bin.size:
                    # boost the closest-in-radius existing SD
                    j = in_bin[np.argmin(np.abs(lnrd_here[bin_of == b]
                                                - mids[b]))]
                    mult_updates[j] += target[b]
                else:
                    new_lists["n"].append(target[b])
                    new_lists["rd3"].append(math.exp(3.0 * mids[b]))
                    new_lists["kpa"].append(kappa)
                    new_lists["cell"].append(cell)

        if new_lists["n"]:
            cell_rep = np.asarray(new_lists["cell"], dtype=np.int64)
            rd3 = np.asarray(new_lists["rd3"])
            x, y, z = _positions_in_cells(cfg, cell_rep, rng)
            rw2 = _equilibrium_rw2(eng, cell_rep, rd3, kappa, RH_max)
            new = dict(
                n=np.asarray(new_lists["n"]), rd3=rd3, rw2=rw2,
                kpa=np.asarray(new_lists["kpa"]),
                x=x, z=z, y=y,
                vt=np.zeros(rd3.size),
                ijk=cell_rep.astype(np.int32),
            )
            total_created += eng.inject(new)

    if mult_updates.any():
        eng.add_multiplicity(mult_updates)
    return total_created


def src_dry_sizes(cfg: StaticConfig, oi, eng, src_sizes, dt, rng, RH_max):
    """Size-pair source: {(kappa, rd_insol): {radius: (conc_per_s, sd_count,
    supstp)}} (reference src_dry_sizes.ipp)."""
    cells = _box_cells(cfg, oi)
    rhod_host = eng.cell("rhod")
    total = 0
    for key, sizes in src_sizes.items():
        kappa = key[0] if isinstance(key, tuple) else key
        for radius, spec in sizes.items():
            conc_per_s, sd_count, supstp = spec
            sd_count = int(sd_count)
            dt_eff = supstp * dt
            for cell in cells:
                dv = cfg.dx * cfg.dy * cfg.dz if cfg.n_dims > 0 \
                    else 1.0 / float(rhod_host[cell])
                number = conc_per_s * dt_eff * dv
                if not oi.aerosol_independent_of_rhod:
                    number *= rhod_host[cell] / c.rho_stp
                conc_fac = init_mod.conc_factor_cells(cfg, oi)
                if conc_fac is not None:
                    number *= conc_fac[cell]
                multiplicity = math.floor(number / sd_count + 0.5)
                if multiplicity <= 0:
                    continue
                cell_rep = np.full(sd_count, cell, dtype=np.int64)
                rd3 = np.full(sd_count, radius**3)
                x, y, z = _positions_in_cells(cfg, cell_rep, rng)
                rw2 = _equilibrium_rw2(eng, cell_rep, rd3, kappa, RH_max)
                new = dict(
                    n=np.full(sd_count, float(multiplicity)), rd3=rd3,
                    rw2=rw2, kpa=np.full(sd_count, kappa),
                    x=x, z=z, y=y,
                    vt=np.zeros(sd_count),
                    ijk=cell_rep.astype(np.int32),
                )
                total += eng.inject(new)
    return total
