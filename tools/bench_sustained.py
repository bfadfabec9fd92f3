"""Sustained-workload throughput: the REAL GMD case, not the from-init rep.

bench.py times the canonical from-init 100-step window (row capacity 128); the
evolved population under rain concentrates SDs and can force larger row
capacities.  This probe runs the icicle defaults (nt=3600, spinup=2400 —
reference icicle.cpp:100-105) with the occupancy-aware repack policy
(run_device_lgrngn repack_every / chunk_log) and reports:

  - from-init ms/step (the bench.py protocol number, for reference)
  - per-chunk ms/step with the occupancy/capacity trajectory
  - sustained ms/step = median over the final TAIL steps' chunks
    (medians exclude compile-contaminated chunks: a capacity the run has
    not seen before pays a fresh compile inside its chunk)

Writes chiprun_out/sustained.json (a directory .gitignore lists).

Usage: python tools/bench_sustained.py [nt] [spinup]
"""

import json
import os
import sys
import time

import jax


import numpy as np  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import bench  # noqa: E402
from libcloudphxx_tpu.models import Kinematic2D  # noqa: E402
from libcloudphxx_tpu.utils import enable_compilation_cache  # noqa: E402

NX = NZ = 76
SD_CONC = 64
NT = int(sys.argv[1]) if len(sys.argv) > 1 else 3600
SPINUP = int(sys.argv[2]) if len(sys.argv) > 2 else 2400
REPACK = 50
# measure the sustained window over the final third (capped at 1000 steps)
# so short smoke invocations stay well-formed too
TAIL = min(1000, max(100, NT // 3))


def main():
    t_all = time.perf_counter()
    enable_compilation_cache()
    dev = bench.device_info()
    print(f"# device: {dev}", flush=True)
    model = Kinematic2D(
        nx=NX, nz=NZ, micro="lgrngn", sd_conc=SD_CONC,
        sstp_cond=10, sstp_coal=10, n_sd_max=SD_CONC * NX * NZ,
    )
    n_sd = int(np.sum(model.prtcls.get_attr("n") > 0))
    print(f"# init: {n_sd} SDs", flush=True)

    # the bench.py protocol number for reference: warm, then time the
    # from-init window
    state0 = model.prtcls.state
    th0, rv0 = model.th.copy(), model.rv.copy()
    model.run_device_lgrngn(100, engine="dense")
    model.prtcls.state = state0
    model.th, model.rv = th0.copy(), rv0.copy()
    t0 = time.perf_counter()
    model.run_device_lgrngn(100, engine="dense")
    jax.block_until_ready(model.prtcls.state.th)
    from_init_ms = (time.perf_counter() - t0) / 100 * 1e3
    print(f"# from-init: {from_init_ms:.2f} ms/step", flush=True)

    # the full sustained run, repack policy active, per-chunk host log
    model.prtcls.state = state0
    model.th, model.rv = th0.copy(), rv0.copy()
    log = []
    model.run_device_lgrngn(NT, spinup=SPINUP, engine="dense",
                            repack_every=REPACK, chunk_log=log)
    jax.block_until_ready(model.prtcls.state.th)

    step = 0
    seen_caps = set()
    for e in log:
        e["step0"] = step
        step += e["steps"]
        e["ms"] = round(e["seconds"] / e["steps"] * 1e3, 2)
        # a capacity first seen in this chunk paid its compile inside it
        e["fresh_cap"] = e["cap"] not in seen_caps
        seen_caps.add(e["cap"])
        print(f"# steps {e['step0']:>5}+{e['steps']:<4} "
              f"{'spin' if e['spinup'] else 'main'} occ {e['occ']:>3} "
              f"cap {e['cap']:>3} {e['ms']:>8.2f} ms/step"
              f"{'  (fresh cap)' if e['fresh_cap'] else ''}", flush=True)

    tail = [e for e in log if e["step0"] >= NT - TAIL]
    clean = [e["ms"] for e in tail if not e["fresh_cap"]]
    sustained_ms = float(np.median(clean)) if clean else float("nan")
    sustained_mean = (float(np.mean(clean)) if clean else float("nan"))

    n = model.prtcls.get_attr("n")
    alive = int((n > 0).sum())
    out = {
        "nt": NT, "spinup": SPINUP, "repack_every": REPACK,
        "margin": 1.25, "tail_steps": TAIL,
        "from_init_ms_per_step": round(from_init_ms, 2),
        "sustained_ms_per_step": round(sustained_ms, 2),
        "sustained_mean_ms_per_step": round(sustained_mean, 2),
        "sustained_over_from_init": round(from_init_ms / sustained_ms, 3),
        "sd_updates_per_s_sustained": round(alive * 1e3 / sustained_ms, 1),
        "alive_sds_end": alive,
        "occ_max": max(e["occ"] for e in log),
        "cap_trajectory": sorted(seen_caps),
        "chunks": [{k: e[k] for k in
                    ("step0", "steps", "spinup", "occ", "cap", "ms")}
                   for e in log],
        "wallclock_s": round(time.perf_counter() - t_all, 1),
        "device": dev,
    }
    print(json.dumps({k: v for k, v in out.items() if k != "chunks"},
                     indent=1), flush=True)
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "sustained.json"),
              "w") as f:
        json.dump(out, f, indent=1)


if __name__ == "__main__":
    main()
