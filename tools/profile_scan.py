"""Loop strategies for the device-resident lgrngn run, timed on the GPU.

The engines default to host-chained steps (dense) and lax.scan (flat);
this tool measures the dense step under:
  chained      - python loop over one jitted step (the dense default)
  scan         - jax.lax.scan over the same step
  scan+donate  - scan with the carry donated (jit donate_argnums)
  window K     - python loop over jitted scan-of-K-step chunks
A resident device loop matters for multi-host runs and for overlapping
the Eulerian half-step as the reference does (kin_cloud_2d_lgrngn.hpp:
254-276).
"""
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import jax.numpy as jnp
import numpy as np

N = 30


def timeit(fn, carry, reps=N):
    out = fn(carry)
    jax.block_until_ready(out)
    t0 = time.perf_counter()
    c = carry
    for _ in range(reps):
        c = fn(c)
    jax.block_until_ready(c)
    return (time.perf_counter() - t0) / reps * 1e3


def main():
    import bench
    from libcloudphxx_tpu.models import Kinematic2D
    from libcloudphxx_tpu.lgrngn import dense as dm
    from libcloudphxx_tpu.utils import enable_compilation_cache

    enable_compilation_cache()
    print(f"# device: {bench.device_info()}", flush=True)

    m = Kinematic2D(nx=76, nz=76, micro="lgrngn", sd_conc=64,
                    sstp_cond=10, sstp_coal=10, n_sd_max=64 * 76 * 76)
    cfg = m.prtcls.cfg
    cap = m.dense_capacity()
    d = jax.jit(dm.pack, static_argnums=(0, 2))(cfg, m.prtcls.state, cap)
    carry = (d, jnp.asarray(m.th), jnp.asarray(m.rv))
    f = m._lgrngn_step_fn_dense(False)

    fj = jax.jit(f)
    t = timeit(fj, carry)
    print(f"chained:          {t:8.2f} ms/step", flush=True)

    sc = jax.jit(lambda c: jax.lax.scan(
        lambda cc, _: (f(cc), None), c, None, length=N)[0])
    out = sc(carry); jax.block_until_ready(out)
    t0 = time.perf_counter(); out = sc(carry); jax.block_until_ready(out)
    print(f"scan({N}):         {(time.perf_counter()-t0)/N*1e3:8.2f} "
          f"ms/step", flush=True)

    scd = jax.jit(lambda c: jax.lax.scan(
        lambda cc, _: (f(cc), None), c, None, length=N)[0],
        donate_argnums=0)
    out = scd(jax.tree.map(jnp.copy, carry)); jax.block_until_ready(out)
    t0 = time.perf_counter()
    out = scd(jax.tree.map(jnp.copy, carry)); jax.block_until_ready(out)
    print(f"scan+donate({N}):  {(time.perf_counter()-t0)/N*1e3:8.2f} "
          f"ms/step", flush=True)

    for K in (5, 10):
        w = jax.jit(lambda c: jax.lax.scan(
            lambda cc, _: (f(cc), None), c, None, length=K)[0])
        t = timeit(w, carry, reps=max(2, N // K))
        print(f"window K={K}:     {t/K:8.2f} ms/step", flush=True)


if __name__ == "__main__":
    main()
