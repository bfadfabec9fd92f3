"""CCN relaxation: horizontal-mean concentration restoring.

JAX equivalent of reference src/impl/sources_and_relaxation_of_SDs/
particles_impl_rlx_dry_distros.ipp: per (kappa, z-range), compare the
bin-resolved horizontally-summed CCN count against the expected profile and
create SDs (rlx_sd_per_bin per deficient level/bin) whose multiplicity fills
the deficit over the relaxation timescale.  Runs every supstp_rlx steps.

The population statistics come from the backend engine
(``eng.rlx_counts``): a host bincount on the serial backend, a sharded
segment-sum + psum on the device mesh (parallel/multi.MeshSrcEngine).
Multiplicity sums are integer-valued f64, so both backends produce
bit-identical counts and the host-RNG candidate stream stays identical —
the mesh keeps the serial run's exact global semantics (better than the
reference's multi_CUDA per-GPU local means, particles_multi_gpu_ctor.ipp:41)
without gathering the population.
"""

import math

import numpy as np

from ..common import constants as c
from . import init as init_mod
from . import source as source_mod
from .state import StaticConfig

RLX_CONC_TOLERANCE = 0.1  # reference src/detail/config.hpp:33


def rlx_dry_distros(cfg: StaticConfig, oi, eng, dt, rng):
    """Returns n_created; new SDs are injected through ``eng``."""
    nz = max(1, cfg.nz)
    rhod_prof = eng.cell("rhod")[:nz]  # vertical fastest (x-outer layout)

    # total ln-radius range over all relaxation distros
    analyses = {}
    for kappa, spec in oi.rlx_dry_distros.items():
        fun = spec[0]
        log_lo, log_hi, _ = init_mod._dist_analysis_sd_conc(
            fun, max(1, int(oi.rlx_bins)), 1.0
        )
        analyses[kappa] = (log_lo, log_hi)
    tot_rng = sum(hi - lo for lo, hi in analyses.values())

    total_created = 0
    for kappa, spec in oi.rlx_dry_distros.items():
        fun, kappa_rng, z_rng = spec[0], spec[1], spec[2]
        log_lo, log_hi = analyses[kappa]
        n_bins = max(1, int(oi.rlx_bins * (log_hi - log_lo) / tot_rng))
        bin_size = (log_hi - log_lo) / n_bins
        z_min_idx = int(z_rng[0] / cfg.dz)
        z_max_idx = int(z_rng[1] / cfg.dz)

        # horizontal volume of each level inside the domain
        hor_vol = (cfg.x1 - cfg.x0) * (cfg.y1 - cfg.y0) * cfg.dz

        # bin-resolved per-level multiplicity sums, (n_bins, nz), from the
        # backend (exact: integer-valued f64 sums are order-independent)
        rd3_edges = np.exp(
            3.0 * (log_lo + bin_size * np.arange(n_bins + 1)))
        counts = eng.rlx_counts(kappa_rng, rd3_edges)

        for b in range(n_bins):
            lnrd_lo = log_lo + b * bin_size
            actual = counts[b]

            expected = float(fun(lnrd_lo + 0.5 * bin_size)) * bin_size \
                * hor_vol * np.ones(nz)
            if not oi.aerosol_independent_of_rhod:
                expected *= rhod_prof / c.rho_stp
            levels = np.arange(nz)
            expected[(levels < z_min_idx) | (levels >= z_max_idx)] = 0.0

            missing = np.maximum(expected - actual, 0.0)
            create = (expected > 0) & (missing / np.maximum(expected, 1e-300)
                                       > RLX_CONC_TOLERANCE)
            if not create.any():
                continue
            sd_per_bin = max(1, int(oi.rlx_sd_per_bin + 0.5))
            ks = np.repeat(levels[create], sd_per_bin)
            mult = np.repeat(
                np.floor(missing[create] / sd_per_bin
                         * min(dt / oi.rlx_timescale, 1.0) + 0.5),
                sd_per_bin,
            )
            keep = mult > 0
            ks, mult = ks[keep], mult[keep]
            if ks.size == 0:
                continue
            i = (rng.random(ks.size) * cfg.nx).astype(np.int64)
            cells = i * nz + ks
            lnrd = lnrd_lo + rng.random(ks.size) * bin_size
            rd3 = np.exp(3.0 * lnrd)
            x = (i + rng.random(ks.size)) * cfg.dx
            z = (ks + rng.random(ks.size)) * cfg.dz
            rw2 = source_mod._equilibrium_rw2(eng, cells, rd3, kappa, 0.95)
            new = dict(
                n=mult, rd3=rd3, rw2=rw2,
                kpa=np.full(ks.size, kappa),
                x=x, z=z, y=np.zeros(ks.size),
                vt=np.zeros(ks.size),
                ijk=cells.astype(np.int32),
            )
            total_created += eng.inject(new)
    return total_created
