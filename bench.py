"""Benchmark: SDM super-droplet updates per second per chip.

Runs the canonical GMD-2015 kinematic workload configuration (76x76 cells,
sd_conc=64, sstp_cond=sstp_coal=10 — BASELINE.md canonical + travis config)
fully device-resident and reports one JSON line.

The headline times the engine the public factory gives users for this
configuration (``lgrngn.particles.auto_engine``), through
``Kinematic2D.run_device_lgrngn``; the same workload then runs through the
public three-phase API (factory -> step_sync/step_async).  Every timed rep
must pass its water and dry-mass conservation checks.  The run needs an
accelerator: it fails on the host CPU rather than print a CPU number.

An "SD update" = one super-droplet advanced through one full model timestep.
"""

import json
import subprocess
import sys
import time

import jax
import numpy as np

NX = NZ = 76
SD_CONC = 64
SSTP_COND = 10
SSTP_COAL = 10
N_STEPS = 100


def canonical_model(**kw):
    """The bench workload (BASELINE.md canonical configuration)."""
    from libcloudphxx_tpu.models import Kinematic2D
    return Kinematic2D(
        nx=NX, nz=NZ, micro="lgrngn", sd_conc=SD_CONC,
        sstp_cond=SSTP_COND, sstp_coal=SSTP_COAL,
        n_sd_max=SD_CONC * NX * NZ, **kw)


def cond_inputs(model):
    """The condensation kernel's inputs on the canonical population, as
    the dense engine's first substep sees them: the (rw2, rd3, kpa, vt)
    planes, the 8 ambient cell vectors, the alive mask and the substep."""
    import jax.numpy as jnp
    from libcloudphxx_tpu.lgrngn import dense, hskpng
    p = model.prtcls
    d = jax.jit(dense.pack, static_argnums=(0, 2))(
        p.cfg, p.state, model.dense_capacity())
    th = jnp.asarray(model.th).reshape(-1)
    rv = jnp.asarray(model.rv).reshape(-1)
    lam_D, lam_K = hskpng.hskpng_mfp(d.T, d.p)
    T, pp, RH, eta = dense._Tpr(p.cfg, th, rv, d.rhod, d.p)
    cells = (d.rhod, rv, T, pp, RH, eta, lam_D, lam_K)
    dt = 1.0 / p.cfg.sstp_cond
    return (d.rw2, d.rd3, d.kpa, d.vt), cells, d.n > 0, dt


def device_info():
    """The device every result is reported against: JAX's platform,
    device_kind and device count, plus the card's name and power limit as
    nvidia-smi reports them.  Raises when JAX finds no GPU."""
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise RuntimeError(
            f"no GPU: JAX's default device is {dev.platform!r}; this "
            f"measurement does not run on the host CPU")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip()
    return {"platform": dev.platform, "kind": dev.device_kind,
            "count": len(jax.devices()), "card": card.splitlines()[0]}


def peak_bytes():
    """peak_bytes_in_use of the first device (what the program's arrays
    took, not what the process reserved)."""
    return int(jax.devices()[0].memory_stats().get("peak_bytes_in_use", 0))


def physics_checks(model, water0, dry0):
    """Per-rep physics gates: a silently-corrupted population must not be
    able to print a headline number.

    - total water (vapour + liquid + puddle) conserved vs the initial state
    - dry-aerosol volume (SDs + puddle) conserved
    - th/rv/rw2 within physical ranges, everything finite
    Returns the dict merged into the JSON line; raises on violation."""
    p = model.prtcls
    n = p.get_attr("n")
    rw2 = p.get_attr("rw2")
    rd3 = p.get_attr("rd3")
    alive = n > 0
    water, dry = water_dry_totals(model)
    if not (np.isfinite(model.th).all() and np.isfinite(model.rv).all()):
        raise AssertionError("bench checks: non-finite th/rv")
    if not ((model.th > 250.0).all() and (model.th < 350.0).all()):
        raise AssertionError("bench checks: th outside [250, 350] K")
    if not ((model.rv > 0.0).all() and (model.rv < 0.03).all()):
        raise AssertionError("bench checks: rv outside (0, 0.03)")
    if not (np.isfinite(rw2[alive]).all() and (rw2[alive] > 0).all()):
        raise AssertionError("bench checks: non-physical rw2")
    if not rw2[alive].max() < (5e-3) ** 2:
        raise AssertionError("bench checks: rw > 5 mm")
    if not (rd3[alive] > 0).all():
        raise AssertionError("bench checks: non-positive rd3")
    dw = abs(water - water0) / water0
    dd = abs(dry - dry0) / dry0
    if not dw < 1e-3:
        raise AssertionError(f"bench checks: water conservation off by "
                             f"{dw:.2e}")
    if not dd < 1e-4:
        raise AssertionError(f"bench checks: dry-mass conservation off by "
                             f"{dd:.2e}")
    return {"water_rel_err": float(dw), "dry_rel_err": float(dd)}


def water_dry_totals(model):
    """Total water mass [kg] (vapour + liquid + puddle) and dry-aerosol
    volume-sum [m^3-equivalent n*rd^3] incl. the puddle accumulators."""
    from libcloudphxx_tpu.common import constants as c
    p = model.prtcls
    n = p.get_attr("n")
    rw2 = p.get_attr("rw2")
    rd3 = p.get_attr("rd3")
    alive = n > 0
    dv = np.asarray(p.state.dv)
    rhod = np.asarray(p.state.rhod)
    rv = np.asarray(model.rv).reshape(-1)
    vap = float((rhod * dv * rv).sum())
    liq = float(
        (4.0 / 3) * np.pi * c.rho_w * (n[alive] * rw2[alive] ** 1.5).sum())
    pud = p.diag_puddle()
    liq += c.rho_w * pud["liquid_volume"]
    dry = float((n[alive] * rd3[alive]).sum()) \
        + pud["dry_volume"] / ((4.0 / 3) * np.pi)
    return vap + liq, dry


def run_engine(model, engine, n_steps, reps=3, log=None):
    """Best of ``reps`` timed runs of the SAME canonical from-init
    workload through run_device_lgrngn: every rep restores the initial
    state, so each times the identical program at the identical row
    capacity.  Physics checks run after every timed rep.  Returns (best
    seconds, checks of the last rep)."""
    log = log or (lambda msg: print(msg, file=sys.stderr, flush=True))
    state0 = model.prtcls.state
    th0, rv0 = model.th.copy(), model.rv.copy()

    def reset():
        model.prtcls.state = state0
        model.th, model.rv = th0.copy(), rv0.copy()

    water0, dry0 = water_dry_totals(model)
    t0 = time.perf_counter()
    model.run_device_lgrngn(n_steps, engine=engine)  # compile + warm
    log(f"# {engine}: warm-up run (compile included) "
        f"{time.perf_counter() - t0:.1f} s")
    best = float("inf")
    checks = None
    for _ in range(reps):
        reset()
        t0 = time.perf_counter()
        model.run_device_lgrngn(n_steps, engine=engine)
        jax.block_until_ready(model.prtcls.state.th)
        elapsed = time.perf_counter() - t0
        checks = physics_checks(model, water0, dry0)
        log(f"# {engine} rep: {elapsed / n_steps * 1e3:.3f} ms/step (checks "
            f"ok: water {checks['water_rel_err']:.1e}, dry "
            f"{checks['dry_rel_err']:.1e})")
        best = min(best, elapsed)
    reset()
    return best, checks


def _block_on_population(p):
    """Wait for the last step_async of particles ``p`` to finish."""
    d = getattr(p, "_d", None)
    if getattr(p, "_loc", "") == "dense" and d is not None:
        jax.block_until_ready(d.n)
    else:
        jax.block_until_ready(p.state.n)


def run_public(model, n_steps, halves=None):
    """Drive the PUBLIC 3-phase contract with the device-array ABI: th/rv
    stay jax.Array handles, step_sync returns the updated pair, and nothing
    round-trips to the host inside the loop.

    With ``halves`` (a list), each step ends each half with
    block_until_ready and appends (sync_s, async_s): the sync half is
    MPDATA + step_sync (condensation), the async half step_async
    (coalescence, transport, re-binning)."""
    import jax.numpy as jnp
    from libcloudphxx_tpu.models import mpdata
    p = model.prtcls
    opts = model.opts
    opts.adve = opts.cond = opts.sedi = opts.coal = True
    opts.RH_max = 44.0
    nx, nz = model.nx, model.nz
    th = jnp.asarray(model.th)
    rv = jnp.asarray(model.rv)
    for _ in range(n_steps):
        t0 = time.perf_counter()
        th, rv = mpdata.advect2(th, rv, model.gc_x, model.gc_z, model.G,
                                n_iters=model.mpdata_iters, fct=model.fct)
        th, rv = p.step_sync(opts, th, rv)
        th = th.reshape(nx, nz)
        rv = rv.reshape(nx, nz)
        if halves is not None:
            jax.block_until_ready((th, rv))
            t1 = time.perf_counter()
        p.step_async(opts)
        if halves is not None:
            _block_on_population(p)
            halves.append((t1 - t0, time.perf_counter() - t1))
    jax.block_until_ready((th, rv))
    _block_on_population(p)
    model.th = np.asarray(th)
    model.rv = np.asarray(rv)


def main():
    from libcloudphxx_tpu.lgrngn.particles import auto_engine
    from libcloudphxx_tpu.utils import enable_compilation_cache

    enable_compilation_cache()
    dev = device_info()
    print(f"# device: {dev}", file=sys.stderr, flush=True)
    model = canonical_model()
    n_sd = int(np.sum(model.prtcls.get_attr("n") > 0))
    print(f"# init done: {n_sd} SDs", file=sys.stderr, flush=True)

    engine = auto_engine()
    if model.prtcls.engine != engine:
        raise RuntimeError(f"factory gave the {model.prtcls.engine} engine, "
                           f"auto_engine() says {engine}")
    elapsed, checks = run_engine(model, engine, N_STEPS)
    sd_updates_per_s = n_sd * N_STEPS / elapsed

    # the same workload through the PUBLIC 3-phase API — the engine the
    # factory gave this model — so the headline is demonstrably the
    # library's speed, not the demo driver's
    water0, dry0 = water_dry_totals(model)
    run_public(model, 5)                    # compile + warm
    t0 = time.perf_counter()
    run_public(model, N_STEPS)
    public_ms = (time.perf_counter() - t0) / N_STEPS * 1e3
    public_checks = physics_checks(model, water0, dry0)
    print(f"# public-API path: {public_ms:.3f} ms/step", file=sys.stderr,
          flush=True)

    print(json.dumps({
        "metric": "SD-updates/s/chip (kinematic_2D 76x76 sd_conc=64 "
                  f"sstp_cond=10 sstp_coal=10, {engine} engine)",
        "value": sd_updates_per_s,
        "unit": "SD-updates/s",
        "ms_per_step": elapsed / N_STEPS * 1e3,
        "engine": engine,
        "public_api_ms_per_step": public_ms,
        "public_api_water_rel_err": public_checks["water_rel_err"],
        "checks": "ok",
        **checks,
        "device": dev,
    }))


if __name__ == "__main__":
    main()
