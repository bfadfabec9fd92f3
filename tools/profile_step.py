"""Where the time of one dense-engine step goes, on the GPU, at the canonical
bench size (76x76, sd_conc=64, sstp_cond=sstp_coal=10, f32).

Part 1 — each phase jitted on its own and timed on the canonical
population (median of REPS calls, each ending in block_until_ready):
MPDATA (th + rv), condensation (dense.step_cond), coalescence (dense.coal),
transport + re-binning (adve_sedi_bcnd + rebin), and the fused step.
Standalone phases lose the fusion across phase boundaries, so their sum
need not equal the fused step.

Part 2 — a profiler trace of TRACE_STEPS chained steps of
``run_device_lgrngn``: device busy share of the window (union of kernel
intervals on the GPU streams) and the kernels that take the most device
time.  The trace lands in chiprun_out/trace (a directory .gitignore lists).

Usage: python tools/profile_step.py
"""

import glob
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import bench  # noqa: E402
from libcloudphxx_tpu.lgrngn import dense  # noqa: E402
from libcloudphxx_tpu.models import mpdata  # noqa: E402
from libcloudphxx_tpu.utils import enable_compilation_cache  # noqa: E402

REPS = 20
TRACE_STEPS = 10


def median_ms(fn, *args):
    jax.block_until_ready(fn(*args))
    ts = []
    for _ in range(REPS):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        ts.append(time.perf_counter() - t0)
    return float(np.median(ts)) * 1e3


def phases(model, card):
    p = model.prtcls
    cfg = p.cfg
    dt = model.setup.dt
    params = jnp.asarray(np.asarray(p.opts_init.kernel_parameters,
                                    dtype=float))
    d = jax.jit(dense.pack, static_argnums=(0, 2))(
        cfg, p.state, model.dense_capacity())
    th, rv = jnp.asarray(model.th), jnp.asarray(model.rv)
    adv = jax.jit(lambda a, b: mpdata.advect2(
        a, b, model.gc_x, model.gc_z, model.G, n_iters=model.mpdata_iters,
        fct=model.fct))
    cond = jax.jit(lambda d, a, b: dense.step_cond(
        cfg, d, a.reshape(-1), b.reshape(-1), dt, 44.0))
    coal = jax.jit(lambda d: dense.coal(cfg, d, params, dt, cfg.sstp_coal))
    move = jax.jit(lambda d: dense.rebin(cfg, dense.adve_sedi_bcnd(
        cfg, d, dt, True)))
    step = jax.jit(model._lgrngn_step_fn_dense(False))
    d1 = cond(d, th, rv)[0]
    rows = [("MPDATA th+rv", median_ms(adv, th, rv)),
            ("condensation (step_cond)", median_ms(cond, d, th, rv)),
            ("coalescence (coal)", median_ms(coal, d1)),
            ("transport + re-binning", median_ms(move, d1)),
            ("fused step", median_ms(step, (d, th, rv)))]
    print(f"# part 1: standalone phases, ms per call [{card}]", flush=True)
    for name, ms in rows:
        print(f"{name:>28}: {ms:8.4f} ms [{card}]", flush=True)


def trace(model, card):
    out = os.path.join(ROOT, "chiprun_out", "trace")
    model.run_device_lgrngn(TRACE_STEPS, engine="dense")   # warm
    with jax.profiler.trace(out):
        t0 = time.perf_counter()
        model.run_device_lgrngn(TRACE_STEPS, engine="dense")
        jax.block_until_ready(model.prtcls.state.th)
        wall = time.perf_counter() - t0
    path = sorted(glob.glob(os.path.join(out, "**", "*.xplane.pb"),
                            recursive=True))[-1]
    pd = jax.profiler.ProfileData.from_file(path)
    spans, per_kernel = [], {}
    for plane in pd.planes:
        if not plane.name.startswith("/device:GPU"):
            continue
        for line in plane.lines:
            if not line.name.startswith("Stream"):
                continue
            for ev in line.events:
                spans.append((ev.start_ns, ev.start_ns + ev.duration_ns))
                k = per_kernel.setdefault(ev.name, [0.0, 0])
                k[0] += ev.duration_ns
                k[1] += 1
    spans.sort()
    busy, end = 0.0, -1.0
    for s, e in spans:
        if s > end:
            busy += e - s
            end = e
        elif e > end:
            busy += e - end
            end = e
    window = (spans[-1][1] - spans[0][0]) if spans else 0.0
    print(f"# part 2: trace of {TRACE_STEPS} chained steps: wall "
          f"{wall * 1e3:.3f} ms, device window {window / 1e6:.3f} ms, busy "
          f"{busy / 1e6:.3f} ms, idle share of the device window "
          f"{1 - busy / max(window, 1):.3f} [{card}]", flush=True)
    total = sum(v[0] for v in per_kernel.values())
    for name, (ns, n) in sorted(per_kernel.items(),
                                key=lambda kv: -kv[1][0])[:20]:
        print(f"{ns / 1e6 / TRACE_STEPS:9.4f} ms/step "
              f"{100 * ns / total:5.1f}% x{n // TRACE_STEPS:<4d} "
              f"{name[:90]} [{card}]", flush=True)


def main():
    enable_compilation_cache()
    dev = bench.device_info()
    print(f"# device: {dev}", flush=True)
    model = bench.canonical_model()
    phases(model, dev["card"])
    trace(model, dev["card"])


if __name__ == "__main__":
    main()
