"""Smoke run of the kinematic-2D super-droplet path on one NVIDIA GPU.

Drives the system's main path through the entry points a user calls, at
the canonical GMD-2015 size (76x76 cells, sd_conc=64, sstp_cond=
sstp_coal=10: 369,664 super-droplets, f32), and checks what comes out:

  1. device   — refuses to run unless JAX's first device is a GPU; prints
                the card (nvidia-smi name, power limit), JAX version,
                device kind and count
  2. kernels  — the condensation kernel (ops/pallas_cond) compiled for the
                card at the canonical width, against the plain XLA form
  3. lgrngn   — Kinematic2D.run_device_lgrngn, dense and flat engines:
                ms/step, SD-updates/s, peak memory, physics checks
  4. public   — factory -> init / step_sync / step_async for 20 steps, the
                two halves timed separately, conservation checks
  5. f64      — dense vs flat engine parity under x64, coalescence off
  6. bulk     — blk_1m and blk_2m device-resident runs at 76x76
  7. CLI      — the icicle CLI on the reference CI setup (60x60, nt=20)

Every number is printed beside the card's name and power limit; the last
line of standard output is one JSON object naming the device.  No phase
catches its own failure.

``--multi`` runs only the multi-device paths on four cards — the factory
with dev_count=4 and the sharded dense step, each against the one-card
serial run of the same configuration — and nothing else.

Usage: python chip_smoke.py [--multi]
"""

import argparse
import json
import os
import sys
import tempfile
import time

import jax
import jax.numpy as jnp
import numpy as np

N_STEPS = 50          # timed steps per engine in phase 3
PUBLIC_STEPS = 20     # timed steps through the public API in phase 4
PARITY_STEPS = 10     # f64 dense-vs-flat steps in phase 5
BULK_STEPS = 300      # blk_1m / blk_2m steps in phase 6
MULTI_STEPS = 5       # steps of each multi-device comparison

# condensation kernel vs plain XLA, f32 (phase 2): both evaluate the same
# jnp expression; fusion, reassociation and the GPU's exp/log
# implementations differ in the last bits, and the 12-iteration root find
# can move a lane to the other side of its bracket test.  The bulk of the
# lanes must agree to 1e-4 (the solver's own converged f32 noise floor,
# condensation._root_iters) and every lane to 2^-7, the reference's own f32
# root-find tolerance (src/detail/config.hpp:181-205).
COND_P999_RTOL = 1e-4
COND_MAX_RTOL = 2.0 ** -7
# f64 dense-vs-flat parity (phase 5): the CPU test's tolerances
# (tests/test_dense.py::test_full_run_matches_flat_no_coal); the engines
# differ only in summation order
PARITY_TH_RTOL = 1e-9
PARITY_RV_RTOL = 1e-7
# multi-device vs one card (--multi), f32, coalescence off: per-SD math is
# identical, only the order of the per-cell sums differs
MULTI_TH_RTOL = 1e-5
MULTI_RV_RTOL = 1e-4
MULTI_MASS_RTOL = 1e-6


def log(msg):
    print(msg, flush=True)


def timed_ms(fn, args, reps=20):
    """Median wall time of fn(*args) in ms, each call ending in
    block_until_ready (the first, compiling call excluded)."""
    jax.block_until_ready(fn(*args))
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        ts.append(time.perf_counter() - t0)
    return float(np.median(ts)) * 1e3


# ------------------------------------------------------------- phase 1 --
def phase_device():
    import bench
    dev = bench.device_info()
    log(f"card: {dev['card']}")
    log(f"jax {jax.__version__}; device_kind {dev['kind']!r}; "
        f"{dev['count']} device(s)")
    return dev


# ------------------------------------------------------------- phase 2 --
def phase_kernels(card, model=None):
    """The condensation kernel at the canonical width against the plain
    XLA form, on the canonical population's first substep."""
    import bench
    from libcloudphxx_tpu.lgrngn import condensation as cond
    from libcloudphxx_tpu.ops.pallas_cond import advance_rw2_pallas

    model = model or bench.canonical_model()
    sd, cells, alive, dt = bench.cond_inputs(model)
    args = sd + cells

    plain = jax.jit(lambda rw2, rd3, kpa, vt, *c: cond._advance_rw2_core(
        dt, rw2, rd3, kpa, vt, *(x[:, None] for x in c), 44.0))
    kern = jax.jit(lambda rw2, rd3, kpa, vt, *c: advance_rw2_pallas(
        cond._advance_rw2_core, dt, rw2.ravel(), rd3.ravel(), kpa.ravel(),
        vt.ravel(), c, 44.0, cap=rw2.shape[1]).reshape(rw2.shape))
    ref = np.asarray(plain(*args))
    out = np.asarray(kern(*args))
    live = np.asarray(alive)
    if not np.isfinite(out[live]).all():
        raise AssertionError("condensation kernel: non-finite rw2")
    if not np.array_equal(out[~live], ref[~live]):
        raise AssertionError("condensation kernel: dead lanes changed")
    rel = np.abs(out - ref)[live] / np.abs(ref)[live]
    p999 = float(np.quantile(rel, 0.999))
    if not (p999 <= COND_P999_RTOL and rel.max() <= COND_MAX_RTOL):
        raise AssertionError(
            f"condensation kernel vs plain XLA: p99.9 rel {p999:.2e} "
            f"(limit {COND_P999_RTOL:.0e}), max rel {rel.max():.2e} "
            f"(limit {COND_MAX_RTOL:.1e})")
    t_k = timed_ms(kern, args)
    t_p = timed_ms(plain, args)
    log(f"kernels: advance_rw2 at {out.size} lanes ({int(live.sum())} "
        f"alive SDs), f32: kernel {t_k:.4f} ms, plain XLA {t_p:.4f} ms "
        f"per call; max rel diff {rel.max():.2e}, p99.9 {p999:.2e} "
        f"[{card}]")
    return {"cond_kernel_ms": t_k, "cond_plain_ms": t_p}


# ------------------------------------------------------------- phase 3 --
def phase_lgrngn(card, n_steps=N_STEPS, model=None):
    import bench
    model = model or bench.canonical_model()
    n_sd = int(np.sum(model.prtcls.get_attr("n") > 0))
    out = {}
    for engine in ("dense", "flat"):
        best, checks = bench.run_engine(model, engine, n_steps, reps=2,
                                        log=log)
        ms = best / n_steps * 1e3
        out[engine] = ms
        log(f"lgrngn run_device_lgrngn engine={engine}: {ms:.3f} ms/step, "
            f"{n_sd * n_steps / best:.4e} SD-updates/s, peak_bytes_in_use "
            f"{bench.peak_bytes()}; water rel err "
            f"{checks['water_rel_err']:.2e}, dry rel err "
            f"{checks['dry_rel_err']:.2e} [{card}]")
    return out


# ------------------------------------------------------------- phase 4 --
def phase_public(card, n_steps=PUBLIC_STEPS, model=None):
    import bench
    from libcloudphxx_tpu.lgrngn.particles import auto_engine
    model = model or bench.canonical_model()
    engine = model.prtcls.engine
    if engine != auto_engine():
        raise AssertionError(f"factory gave {engine}, auto_engine() says "
                             f"{auto_engine()}")
    water0, dry0 = bench.water_dry_totals(model)
    bench.run_public(model, 3)                         # compile + warm
    halves = []
    bench.run_public(model, n_steps, halves=halves)
    checks = bench.physics_checks(model, water0, dry0)
    sync_ms = float(np.median([h[0] for h in halves])) * 1e3
    async_ms = float(np.median([h[1] for h in halves])) * 1e3
    log(f"public API (factory -> step_sync/step_async), engine={engine}, "
        f"{n_steps} steps: step_sync half (MPDATA + condensation) "
        f"{sync_ms:.3f} ms, step_async half (coalescence + transport + "
        f"re-binning) {async_ms:.3f} ms (medians, each half ending in "
        f"block_until_ready); water rel err {checks['water_rel_err']:.2e},"
        f" dry rel err {checks['dry_rel_err']:.2e} [{card}]")
    return {"engine": engine, "sync_ms": sync_ms, "async_ms": async_ms}


# ------------------------------------------------------------- phase 5 --
def phase_f64_parity(card, nx=76, nz=76, sd_conc=64, n_steps=PARITY_STEPS):
    """Dense vs flat engine under x64 with coalescence off (the
    deterministic pipeline), compared on th/rv and the SD population."""
    from libcloudphxx_tpu.lgrngn.state import StaticConfig
    from libcloudphxx_tpu.models import Kinematic2D

    def model():
        m = Kinematic2D(nx=nx, nz=nz, micro="lgrngn", sd_conc=sd_conc,
                        sstp_cond=10, sstp_coal=10,
                        n_sd_max=sd_conc * nx * nz)
        oi = m.prtcls.opts_init
        oi.coal_switch = False
        m.prtcls.cfg = StaticConfig.from_opts_init(oi)
        return m

    with jax.enable_x64(True):
        ma, mb = model(), model()
        if ma.prtcls.state.rw2.dtype != jnp.float64:
            raise AssertionError("f64 parity: state is not float64")
        ma.run_device_lgrngn(n_steps, engine="flat")
        mb.run_device_lgrngn(n_steps, engine="dense")
        th_err = float(np.max(np.abs(mb.th - ma.th) / np.abs(ma.th)))
        rv_err = float(np.max(np.abs(mb.rv - ma.rv) / np.abs(ma.rv)))
        na = np.asarray(ma.prtcls.state.n)
        nb = np.asarray(mb.prtcls.state.n)
        ra = np.sort(np.asarray(ma.prtcls.state.rw2)[na > 0])
        rb = np.sort(np.asarray(mb.prtcls.state.rw2)[nb > 0])
    if not (th_err <= PARITY_TH_RTOL and rv_err <= PARITY_RV_RTOL):
        raise AssertionError(
            f"f64 parity: th rel {th_err:.2e} (limit {PARITY_TH_RTOL:.0e}),"
            f" rv rel {rv_err:.2e} (limit {PARITY_RV_RTOL:.0e})")
    if ra.shape != rb.shape or np.sum(na) != np.sum(nb):
        raise AssertionError("f64 parity: SD populations differ")
    rw_err = float(np.max(np.abs(rb - ra) / ra))
    if not rw_err <= PARITY_RV_RTOL:
        raise AssertionError(f"f64 parity: sorted rw2 rel {rw_err:.2e}")
    log(f"f64 parity {nx}x{nz} sd_conc={sd_conc}, {n_steps} steps, "
        f"coalescence off: dense vs flat th max rel {th_err:.2e}, rv "
        f"{rv_err:.2e}, sorted rw2 {rw_err:.2e} [{card}]")
    return {"th_rel": th_err, "rv_rel": rv_err}


# ------------------------------------------------------------- phase 6 --
def phase_bulk(card, nx=76, nz=76, n_steps=BULK_STEPS):
    from libcloudphxx_tpu.models import Kinematic2D
    out = {}
    for micro in ("blk_1m", "blk_2m"):
        m = Kinematic2D(nx=nx, nz=nz, micro=micro)
        m.ante_loop()
        t0 = time.perf_counter()
        m.run_device(n_steps, spinup=n_steps // 3)
        secs = time.perf_counter() - t0
        names = ("th", "rv", "rc", "rr") + (
            ("nc", "nr") if micro == "blk_2m" else ())
        for k in names:
            v = getattr(m, k)
            if not np.isfinite(v).all():
                raise AssertionError(f"{micro}: non-finite {k}")
        if not ((m.th > 250).all() and (m.th < 350).all()):
            raise AssertionError(f"{micro}: th outside [250, 350] K")
        if not ((m.rv > 0).all() and (m.rv < 0.03).all()):
            raise AssertionError(f"{micro}: rv outside (0, 0.03)")
        for k in names[2:]:
            if getattr(m, k).min() < -1e-8 * max(1.0, getattr(m, k).max()):
                raise AssertionError(f"{micro}: negative {k}")
        if not (m.rc.max() > 0):
            raise AssertionError(f"{micro}: no cloud water formed")
        out[micro] = secs
        log(f"bulk {micro} {nx}x{nz}, {n_steps} steps: {secs:.2f} s "
            f"(compile included); rc max {m.rc.max():.3e}, rr max "
            f"{m.rr.max():.3e}, puddle {m.puddle_flux:.3e} [{card}]")
    return out


# ------------------------------------------------------------- phase 7 --
def phase_cli(card, nx=60, nz=60, nt=20, spinup=10):
    from libcloudphxx_tpu.models import cli
    with tempfile.TemporaryDirectory() as out:
        t0 = time.perf_counter()
        cli.main(["--micro=lgrngn", f"--nx={nx}", f"--nz={nz}",
                  f"--nt={nt}", f"--spinup={spinup}", "--outfreq=10",
                  f"--outdir={out}"])
        secs = time.perf_counter() - t0
        files = sorted(os.listdir(out))
        for t in (0, 10, 20):
            if not any(f.startswith(f"timestep{t:010d}.") for f in files):
                raise AssertionError(f"CLI: no output for step {t}")
        for f in ("puddle.dat",):
            if f not in files:
                raise AssertionError(f"CLI: {f} missing")
        if not any(f.startswith("const.") for f in files):
            raise AssertionError("CLI: const file missing")
    log(f"CLI --micro=lgrngn {nx}x{nz} nt={nt} spinup={spinup}: {secs:.2f} "
        f"s (compile included), {len(files)} output files [{card}]")
    return {"seconds": secs}


# --------------------------------------------------------------- multi --
def _multi_model(nx, nz, sd_conc, dev_count=0):
    from libcloudphxx_tpu.lgrngn.state import StaticConfig
    from libcloudphxx_tpu.models import Kinematic2D
    kw = {"dev_count": dev_count} if dev_count else {}
    # 2x headroom: each device holds its slab's SDs plus the migrants
    m = Kinematic2D(nx=nx, nz=nz, micro="lgrngn", sd_conc=sd_conc,
                    sstp_cond=10, sstp_coal=10,
                    n_sd_max=2 * sd_conc * nx * nz, opts_init_kw=kw)
    oi = m.prtcls.opts_init
    oi.coal_switch = False
    m.prtcls.cfg = StaticConfig.from_opts_init(oi)
    if hasattr(m.prtcls, "cfg_l"):
        import dataclasses
        m.prtcls.cfg_l = dataclasses.replace(m.prtcls.cfg_l,
                                             coal_switch=False)
    return m


def _totals(m):
    """(alive multiplicity + puddle particle count, alive SD count)."""
    n = m.prtcls.get_attr("n").astype(np.float64)
    pud = m.prtcls.diag_puddle()
    return float(n.sum()) + pud["particle_number"], int((n > 0).sum())


def _compare(name, ref, got, n0, card):
    th_err = float(np.max(np.abs(got["th"] - ref["th"]) / ref["th"]))
    rv_err = float(np.max(np.abs(got["rv"] - ref["rv"]))
                   / np.max(np.abs(ref["rv"])))
    mass_err = abs(got["mult"] - n0) / n0
    if not (th_err <= MULTI_TH_RTOL and rv_err <= MULTI_RV_RTOL):
        raise AssertionError(
            f"{name}: th rel {th_err:.2e} (limit {MULTI_TH_RTOL:.0e}), rv "
            f"rel {rv_err:.2e} (limit {MULTI_RV_RTOL:.0e}) vs one card")
    if not mass_err <= MULTI_MASS_RTOL:
        raise AssertionError(f"{name}: multiplicity not conserved "
                             f"(rel {mass_err:.2e})")
    if got["overflow"] != 0 or got["n_sd"] != ref["n_sd"]:
        raise AssertionError(f"{name}: {got['overflow']} SDs dropped on "
                             f"overflow; {got['n_sd']} SDs alive vs "
                             f"{ref['n_sd']} on one card")
    log(f"{name}: vs one card th max rel {th_err:.2e}, rv {rv_err:.2e}; "
        f"multiplicity rel change {mass_err:.2e}, overflow 0, SDs "
        f"{got['n_sd']} (one card {ref['n_sd']}) [{card}]")


def phase_multi_factory(card, n_dev, nx=76, nz=76, sd_conc=64,
                        n_steps=MULTI_STEPS):
    """particles_multi_t (factory, dev_count=n_dev) through the public API
    against the one-card serial run, coalescence off."""
    import bench
    res = {}
    for dc in (0, n_dev):
        m = _multi_model(nx, nz, sd_conc, dev_count=dc)
        n0, _ = _totals(m)
        t0 = time.perf_counter()
        bench.run_public(m, n_steps)
        secs = time.perf_counter() - t0
        mult, n_sd = _totals(m)
        res[dc] = dict(th=m.th.copy(), rv=m.rv.copy(), mult=mult,
                       n_sd=n_sd, overflow=0, n0=n0)
        log(f"factory dev_count={dc or 1} ({type(m.prtcls).__name__}): "
            f"{n_steps} steps in {secs:.2f} s (compile included) [{card}]")
    _compare(f"factory dev_count={n_dev}", res[0], res[n_dev], res[0]["n0"],
             card)


def phase_multi_dense(card, n_dev, nx=76, nz=76, sd_conc=64,
                      n_steps=MULTI_STEPS, widths=None):
    """The sharded dense step (parallel/dense_mesh) over uneven x slabs
    against the serial dense step, coalescence off."""
    import dataclasses
    from jax.sharding import NamedSharding, PartitionSpec as P
    from libcloudphxx_tpu.lgrngn import dense as dm
    from libcloudphxx_tpu.models import mpdata
    from libcloudphxx_tpu.parallel import decomp, dense_mesh

    m = _multi_model(nx, nz, sd_conc)
    cfg = m.prtcls.cfg
    dt = float(m.setup.dt)
    params = jnp.zeros((0,), m.prtcls.state.rw2.dtype)
    cap = m.dense_capacity()
    d0 = jax.jit(dm.pack, static_argnums=(0, 2))(cfg, m.prtcls.state, cap)
    pud0 = np.asarray(d0.puddle).astype(np.float64)
    n0 = float(np.asarray(d0.n, np.float64).sum())
    th0, rv0 = jnp.asarray(m.th), jnp.asarray(m.rv)
    adv = lambda th, rv: mpdata.advect2(th, rv, m.gc_x, m.gc_z, m.G,
                                        n_iters=m.mpdata_iters, fct=m.fct)

    @jax.jit
    def serial(d, th, rv):
        th, rv = adv(th, rv)
        d, thc, rvc = dm.step_cond(cfg, d, th.reshape(-1), rv.reshape(-1),
                                   dt, 44.0)
        d = dm.step_async(cfg, d, params, dt, cfg.sstp_coal, False, True)
        return d, thc.reshape(nx, nz), rvc.reshape(nx, nz)

    d, th, rv = d0, th0, rv0
    for _ in range(n_steps):
        d, th, rv = serial(d, th, rv)
    jax.block_until_ready(d.n)
    n_alive = np.asarray(d.n)
    ref = dict(th=np.asarray(th), rv=np.asarray(rv), n_sd=int(
        (n_alive > 0).sum()))
    if float(d.overflow):
        raise AssertionError("serial dense: row overflow")

    widths = widths or decomp.slab_widths(nx, n_dev)
    mesh = decomp.make_mesh(n_dev)
    cfg_l = dataclasses.replace(cfg, nx=max(widths),
                                n_cell=max(widths) * nz, x0=0.0,
                                x1=max(widths) * cfg.dx)
    dom = decomp.device_put_domains(cfg, mesh, widths)
    step = dense_mesh.dense_step_sharded(cfg_l, cfg.sstp_coal, 4 * nz * 8,
                                         False, True, 44.0)
    spec = dense_mesh.dense_specs()
    dom_spec = decomp.ShardDomain(lo=P("x"), hi=P("x"), nxl=P("x"))
    shstep = jax.jit(jax.shard_map(
        lambda d_, th_, rv_, dm_: step(d_, th_, rv_, dm_, params, dt),
        mesh=mesh, in_specs=(spec, P("x"), P("x"), dom_spec),
        out_specs=(spec, P("x"), P("x")),
        # the condensation kernel's pallas_call inside the step
        check_vma=False))
    sharding = jax.tree_util.tree_map(lambda s: NamedSharding(mesh, s),
                                      spec)
    dmesh = jax.device_put(dense_mesh.scatter_dense(cfg, d0, n_dev, widths),
                           sharding)
    th, rv = th0, rv0
    t0 = time.perf_counter()
    for _ in range(n_steps):
        th, rv = adv(th, rv)
        th_s = dense_mesh.pad_cell_field(cfg, np.asarray(th).reshape(-1),
                                         n_dev, widths)
        rv_s = dense_mesh.pad_cell_field(cfg, np.asarray(rv).reshape(-1),
                                         n_dev, widths)
        dmesh, th_s, rv_s = shstep(dmesh, th_s, rv_s, dom)
        th = jnp.asarray(dense_mesh.unpad_cell_field(
            cfg, th_s, n_dev, widths)).reshape(nx, nz)
        rv = jnp.asarray(dense_mesh.unpad_cell_field(
            cfg, rv_s, n_dev, widths)).reshape(nx, nz)
    jax.block_until_ready(dmesh.n)
    secs = time.perf_counter() - t0
    res = dense_mesh.gather_dense(cfg, dmesh, n_dev, widths)
    pud = res["puddle"].astype(np.float64)
    from libcloudphxx_tpu.lgrngn.state import OUT_PRTCL_NUM
    mult = float(res["n"].astype(np.float64).sum()) \
        + float(pud[OUT_PRTCL_NUM] - pud0[OUT_PRTCL_NUM])
    got = dict(th=np.asarray(th), rv=np.asarray(rv), mult=mult,
               n_sd=int(res["n"].size), overflow=res["overflow"])
    log(f"sharded dense step, slabs {widths}: {n_steps} steps in "
        f"{secs:.2f} s (compile included) [{card}]")
    _compare(f"sharded dense ({n_dev} devices)", ref, got, n0, card)


# ---------------------------------------------------------------- main --
def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--multi", action="store_true",
                    help="run only the four-card mesh paths")
    args = ap.parse_args(argv)

    from libcloudphxx_tpu.utils import enable_compilation_cache
    enable_compilation_cache()
    dev = phase_device()
    card = dev["card"]
    if args.multi:
        if dev["count"] < 4:
            raise RuntimeError(f"--multi needs 4 devices, found "
                               f"{dev['count']}")
        phase_multi_factory(card, 4)
        phase_multi_dense(card, 4, widths=[20, 19, 19, 18])
    else:
        import bench
        model = bench.canonical_model()
        phase_kernels(card, model)
        phase_lgrngn(card, model=model)
        phase_public(card, model=model)
        phase_f64_parity(card)
        phase_bulk(card)
        phase_cli(card)
    print(json.dumps({"ok": True, "device": {
        "platform": dev["platform"], "kind": dev["kind"],
        "count": dev["count"]}}), flush=True)


if __name__ == "__main__":
    sys.exit(main())
