"""icicle-tpu — the host-model command line driver.

JAX equivalent of the reference's icicle CLI
(models/kinematic_2D/src/icicle.cpp:90-235 + opts_common.hpp:41-104): runs
the ICMW8-case-1 kinematic model with any of the three microphysics schemes
and records per-outfreq field snapshots plus the out_dry/out_wet
moment-range diagnostics (kin_cloud_2d_lgrngn.hpp:33-95).

Output: one HDF5 file per output step when h5py is available (matching the
reference's timestepNNNNNNNNNN.h5 naming), npz otherwise; a const file with
the setup attributes; and a puddle.dat text stream
(kin_cloud_2d_common.hpp:46-48).

Moment-spec mini-language (opts_common.hpp:41-104):
    "r1:r2|n1,n2;r3:r4|n3;..."   e.g.  ".5e-6:25e-6|0,1,2,3;25e-6:1|0,3,6"
"""

import argparse
import os

import numpy as np


def parse_outmoms(spec: str):
    """Parse the reference's out_dry/out_wet mini-language into
    [((r_min, r_max), [moments...]), ...] (opts_common.hpp:68-104)."""
    out = []
    spec = spec.strip().strip('"')
    if not spec:
        return out
    for rng_moms in spec.split(";"):
        rng_moms = rng_moms.strip()
        if not rng_moms:
            continue
        rng, _, moms = rng_moms.partition("|")
        r_min, _, r_max = rng.partition(":")
        moments = [int(m) for m in moms.split(",")] if moms else [0]
        out.append(((float(r_min), float(r_max)), moments))
    return out


def _writer(outdir, basename, fields, attrs=None):
    try:
        import h5py
        path = os.path.join(outdir, basename + ".h5")
        with h5py.File(path, "w") as f:
            for k, v in fields.items():
                f.create_dataset(k, data=np.float32(v))
            for k, v in (attrs or {}).items():
                f.attrs[k] = v
    except ImportError:  # pragma: no cover
        path = os.path.join(outdir, basename + ".npz")
        np.savez(path, **fields, **{f"attr_{k}": v
                                    for k, v in (attrs or {}).items()})
    return path


def record_chem(model):
    """Aqueous-phase chemistry output (kin_cloud_2d_lgrngn_chem.hpp
    diag_chem:50-84, with the reference's dataset names)."""
    from ..common import chem as chem_mod
    cs = chem_mod.chem_species_t
    p = model.prtcls
    shape = (model.nx, model.nz)
    names = {cs.SO2: "chem_S_IV_aq", cs.S_VI: "chem_S_VI_aq",
             cs.O3: "chem_O3_aq", cs.H2O2: "chem_H2O2_aq",
             cs.H: "chem_H_aq", cs.CO2: "chem_C_IV_aq",
             cs.NH3: "chem_N_III_aq", cs.HNO3: "chem_N_V_aq"}
    rec = {}
    p.diag_all()
    for sp, name in names.items():
        p.diag_chem(sp)
        rec[name] = p.outbuf().reshape(shape)
    for sp, arr in model.chem_gases.items():
        rec[f"chem_{cs(sp).name}_g"] = arr
    return rec


def record_lgrngn_moments(model, out_dry, out_wet):
    """The per-outfreq moment recording of the lgrngn coupler
    (kin_cloud_2d_lgrngn.hpp diag():33-95)."""
    p = model.prtcls
    shape = (model.nx, model.nz)
    rec = {}
    p.diag_all()
    p.diag_sd_conc()
    rec["sd_conc"] = p.outbuf().reshape(shape)
    for rng_num, (rng, moms) in enumerate(out_dry):
        p.diag_dry_rng(*rng)
        for mom in moms:
            p.diag_dry_mom(mom)
            rec[f"rd_rng{rng_num:03d}_mom{mom}"] = p.outbuf().reshape(shape)
    for rng_num, (rng, moms) in enumerate(out_wet):
        p.diag_wet_rng(*rng)
        for mom in moms:
            p.diag_wet_mom(mom)
            rec[f"rw_rng{rng_num:03d}_mom{mom}"] = p.outbuf().reshape(shape)
    # rw3(rd) — 3rd wet moment of each dry range (kin_cloud_2d_lgrngn:82-95)
    for rng_num, (rng, _) in enumerate(out_dry):
        p.diag_dry_rng(*rng)
        p.diag_wet_mom(3)
        rec[f"rw3ofrd_rng{rng_num:03d}_mom3"] = p.outbuf().reshape(shape)
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser(
        prog="icicle-tpu",
        description="2-D kinematic cloud model (ICMW8 case 1)")
    ap.add_argument("--micro", required=True,
                    choices=["blk_1m", "blk_2m", "lgrngn", "lgrngn_chem"])
    ap.add_argument("--nx", type=int, default=76)
    ap.add_argument("--nz", type=int, default=76)
    ap.add_argument("--nt", type=int, default=3600)
    ap.add_argument("--spinup", type=int, default=2400)
    ap.add_argument("--outfreq", type=int, default=200)
    ap.add_argument("--outdir", default="out")
    ap.add_argument("--backend", default="serial")
    ap.add_argument("--sd_conc", type=int, default=64)
    ap.add_argument("--sstp_cond", type=int, default=1)
    ap.add_argument("--sstp_coal", type=int, default=1)
    ap.add_argument("--rng_seed", type=int, default=44)
    ap.add_argument("--reference_rng", action="store_true",
                    help="bit-compatible mt19937/float32 SD init")
    ap.add_argument("--out_dry", default="0:1|0")
    ap.add_argument("--out_wet", default=".5e-6:25e-6|0,1,2,3;25e-6:1|0,3,6")
    ap.add_argument("--relax_th_rv", default="false")
    args = ap.parse_args(argv)

    from .. import lgrngn
    from .kinematic_2d import Kinematic2D

    os.makedirs(args.outdir, exist_ok=True)
    out_dry = parse_outmoms(args.out_dry)
    out_wet = parse_outmoms(args.out_wet)

    kw = {}
    if args.micro in ("lgrngn", "lgrngn_chem"):
        kw.update(
            sd_conc=args.sd_conc, sstp_cond=args.sstp_cond,
            sstp_coal=args.sstp_coal,
            n_sd_max=args.nx * args.nz * args.sd_conc,
            reference_rng=args.reference_rng,
            kernel_parameters=[0.5],
            terminal_velocity=lgrngn.vt_t.khvorostyanov_spherical,
            backend=getattr(lgrngn.backend_t, args.backend,
                            lgrngn.backend_t.serial),
            rng_seed=args.rng_seed,
        )
    relax = str(args.relax_th_rv).strip().lower() in ("1", "true", "yes")
    model = Kinematic2D(nx=args.nx, nz=args.nz, micro=args.micro,
                        grid="node", fct=True, relax_th_rv=relax, **kw)
    model.ante_loop()
    s = model.setup
    _writer(args.outdir, "const",
            {"G": model.rhod,
             "T": np.arange(0, args.nt + 1, args.outfreq, dtype=float)},
            attrs={"X": s.X, "Z": s.Z, "dt": s.dt, "th_0": s.th_0,
                   "rv_0": s.rv_0, "p_0": s.p_0, "w_max": s.w_max,
                   "kappa": s.kappa, "mean_rd1": s.mean_rd1,
                   "mean_rd2": s.mean_rd2, "sdev_rd1": s.sdev_rd1,
                   "sdev_rd2": s.sdev_rd2, "n1_stp": s.n1_stp,
                   "n2_stp": s.n2_stp, "z_0": s.z_0})

    puddle_f = open(os.path.join(args.outdir, "puddle.dat"), "w")

    def record(t, fields_pre=None):
        """One output step; ``fields_pre`` carries the pre-microphysics
        th/rv of the reference's output ordering (kin_cloud_2d_lgrngn.hpp:
        222-291: fields recorded post-advection pre-micro, SD diagnostics
        post-micro)."""
        fields = dict(fields_pre) if fields_pre is not None \
            else {"th": model.th, "rv": model.rv}
        if args.micro in ("lgrngn", "lgrngn_chem"):
            fields.update(record_lgrngn_moments(model, out_dry, out_wet))
            if args.micro == "lgrngn_chem":
                fields.update(record_chem(model))
            for k, v in model.prtcls.diag_puddle().items():
                puddle_f.write(f"{k} {v}\n")
            puddle_f.write("\n")
        else:
            fields["rc"] = model.rc
            fields["rr"] = model.rr
            if args.micro == "blk_2m":
                fields["nc"] = model.nc
                fields["nr"] = model.nr
        _writer(args.outdir, f"timestep{t:010d}", fields)

    record(0)
    for t in range(1, args.nt + 1):
        if args.micro in ("lgrngn", "lgrngn_chem"):
            spin = t <= args.spinup
            do_relax = model._relax_hooks(spin)
            model.advect_scalars()
            if do_relax:
                model._apply_relax()
            rec = (t % args.outfreq == 0)
            if rec:
                fields_pre = {"th": model.th.copy(), "rv": model.rv.copy()}
            model.micro_step(spinup=spin)
            if rec:
                record(t, fields_pre=fields_pre)
        else:
            model.step(spinup=(t <= args.spinup))
            if t % args.outfreq == 0:
                record(t)
        if t % max(1, args.outfreq) == 0:
            print(f"step {t}/{args.nt}", flush=True)
    puddle_f.close()
    print(f"output in {args.outdir}")


if __name__ == "__main__":
    main()
