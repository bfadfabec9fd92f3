"""A/B of the condensation kernel (ops/pallas_cond) against plain XLA on
the GPU, at the canonical bench size (76x76, sd_conc=64: 369,664 SDs in a
5776 x cap dense layout, f32).

Part 1 — one rw2 advance (one condensation substep) on the real bench
population: the plain XLA form as it stands, the same code with the
root-find loop unrolled (``solve_bracketed(unroll=True)``), and the kernel
over a sweep of (block, num_warps).  Each variant's result is compared with
the plain form on the alive SDs.

Part 2 — end to end: ms/step of ``Kinematic2D.run_device_lgrngn`` for the
dense and the flat engine with the kernel, with the plain form and with the
unrolled plain form, in turns (K P U U P K K U U K).  The persistent
compilation cache keeps the re-traces after each ``jax.clear_caches()`` cheap.

Usage: python tools/ab_cond_kernel.py [n_steps]
"""

import os
import sys
import time
from functools import partial

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import jax  # noqa: E402
import numpy as np  # noqa: E402

import bench  # noqa: E402
from libcloudphxx_tpu.lgrngn import condensation as cond  # noqa: E402
from libcloudphxx_tpu.ops import pallas_cond, rootfind  # noqa: E402
from libcloudphxx_tpu.utils import enable_compilation_cache  # noqa: E402

SWEEP = [(64, 2), (64, 4), (128, 2), (128, 4), (128, 8), (256, 4),
         (256, 8), (512, 8)]


def median_ms(fn, args, reps=30):
    jax.block_until_ready(fn(*args))
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        ts.append(time.perf_counter() - t0)
    return float(np.median(ts)) * 1e3


def part1(model, card):
    sd, cells, alive, dt = bench.cond_inputs(model)
    plain = jax.jit(lambda rw2, rd3, kpa, vt, *c: cond._advance_rw2_core(
        dt, rw2, rd3, kpa, vt, *(x[:, None] for x in c), 44.0))
    orig = cond.solve_bracketed
    cond.solve_bracketed = partial(rootfind.solve_bracketed, unroll=True)
    try:
        unrolled = jax.jit(
            lambda rw2, rd3, kpa, vt, *c: cond._advance_rw2_core(
                dt, rw2, rd3, kpa, vt, *(x[:, None] for x in c), 44.0))
        jax.block_until_ready(unrolled(*sd, *cells))
    finally:
        cond.solve_bracketed = orig
    args = sd + cells
    ref = np.asarray(plain(*args))
    live = np.asarray(alive)
    print(f"# part 1: one rw2 advance, {int(live.sum())} alive SDs in "
          f"{ref.size} lanes, f32 [{card}]", flush=True)

    def report(name, fn):
        try:
            out = np.asarray(fn(*args))
            ms = median_ms(fn, args)
        except Exception as e:  # noqa: BLE001 — report and go on
            print(f"{name:>24}: FAILED {type(e).__name__}: "
                  f"{str(e)[:400]}", flush=True)
            return
        rel = np.abs(out - ref)[live] / np.abs(ref)[live]
        print(f"{name:>24}: {ms:8.4f} ms  max rel {rel.max():.2e}  "
              f"p99.9 {np.quantile(rel, 0.999):.2e}  [{card}]", flush=True)

    report("plain XLA", plain)
    report("plain XLA, unrolled", unrolled)
    for block, warps in SWEEP:
        kern = jax.jit(
            lambda rw2, rd3, kpa, vt, *c, b=block, w=warps:
            pallas_cond.advance_rw2_pallas(
                cond._advance_rw2_core, dt, rw2.ravel(), rd3.ravel(),
                kpa.ravel(), vt.ravel(), c, 44.0, cap=rw2.shape[1],
                block=b, num_warps=w).reshape(rw2.shape))
        report(f"kernel b={block} w={warps}", kern)


def part2(n_steps, card):
    modes = {
        "kernel": {},
        "plain": {"_kernel_wanted": lambda x: False},
        "plain-unrolled": {
            "_kernel_wanted": lambda x: False,
            "solve_bracketed": partial(rootfind.solve_bracketed,
                                       unroll=True)},
    }
    saved = {k: getattr(cond, k) for k in ("_kernel_wanted",
                                           "solve_bracketed")}
    order = ["kernel", "plain", "plain-unrolled", "plain-unrolled",
             "plain", "kernel", "kernel", "plain-unrolled",
             "plain-unrolled", "kernel"]
    print(f"# part 2: run_device_lgrngn ms/step over {n_steps} steps, "
          f"turns {order} [{card}]", flush=True)
    for engine in ("dense", "flat"):
        model = bench.canonical_model()
        state0 = model.prtcls.state
        th0, rv0 = model.th.copy(), model.rv.copy()
        for mode in order:
            for k, v in saved.items():
                setattr(cond, k, v)
            for k, v in modes[mode].items():
                setattr(cond, k, v)
            jax.clear_caches()
            model._lgrngn_runners = {}
            times = []
            for _ in range(2):          # warm (compile), then timed
                model.prtcls.state = state0
                model.th, model.rv = th0.copy(), rv0.copy()
                t0 = time.perf_counter()
                model.run_device_lgrngn(n_steps, engine=engine)
                jax.block_until_ready(model.prtcls.state.th)
                times.append(time.perf_counter() - t0)
            print(f"{engine:>6} {mode:>15}: {times[1] / n_steps * 1e3:9.3f} "
                  f"ms/step (first run incl. compile {times[0]:.1f} s) "
                  f"[{card}]", flush=True)
    for k, v in saved.items():
        setattr(cond, k, v)


def main():
    n_steps = int(sys.argv[1]) if len(sys.argv) > 1 else 50
    enable_compilation_cache()
    dev = bench.device_info()
    card = dev["card"]
    print(f"# device: {dev}", flush=True)
    part1(bench.canonical_model(), card)
    part2(n_steps, card)


if __name__ == "__main__":
    main()
