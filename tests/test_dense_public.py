"""The dense cell-major engine behind the PUBLIC particles_t API
(lgrngn/dense_front.py, selected by the factory via LIBCLOUD_ENGINE).

Gates: with coalescence off the dense engine must match the flat engine
essentially exactly through the full public surface (step_sync/step_async/
diag_*/puddle); with coalescence on, the RNG realisations differ by
construction, so gates are conservation + cond-dominated fields.
"""

import os
from math import log, sqrt, pi

import numpy as np
import pytest

from libcloudphxx_tpu import lgrngn


def lognormal(lnr):
    mean_r, stdev, n_tot = 0.04e-6 / 2, 1.4, 60e6
    return (n_tot * np.exp(-((np.asarray(lnr) - log(mean_r)) ** 2)
                           / 2 / log(stdev) ** 2)
            / log(stdev) / sqrt(2 * pi))


NX, NZ = 6, 5


def _run(engine, do_coal, steps=5):
    os.environ["LIBCLOUD_ENGINE"] = engine
    try:
        oi = lgrngn.opts_init_t()
        oi.dry_distros = {(0.61, 0.0): lognormal}
        oi.coal_switch = do_coal
        if do_coal:
            oi.kernel = lgrngn.kernel_t.geometric
        oi.terminal_velocity = lgrngn.vt_t.beard77
        oi.sedi_switch = True
        oi.dt = 1
        oi.nx, oi.nz = NX, NZ
        oi.dx = oi.dz = 100.0
        oi.x1, oi.z1 = NX * 100.0, NZ * 100.0
        oi.sd_conc = 20
        oi.n_sd_max = 20 * NX * NZ
        oi.sstp_cond = 3
        oi.sstp_coal = 2
        opts = lgrngn.opts_t()
        opts.adve = opts.cond = opts.sedi = True
        opts.coal = do_coal
        opts.chem_dsl = False
        rhod = np.ones((NX, NZ))
        th = 289.0 * np.ones((NX, NZ))
        rv = 7.5e-3 * np.ones((NX, NZ))
        Cx = 0.2 * np.ones((NX + 1, NZ))
        Cz = -0.1 * np.ones((NX, NZ + 1))
        p = lgrngn.factory(lgrngn.backend_t.serial, oi)
        p.init(th, rv, rhod, Cx=Cx, Cz=Cz)
        for _ in range(steps):
            p.step_sync(opts, th, rv, rhod)
            p.step_async(opts)
        p.diag_all(); p.diag_sd_conc(); sd = p.outbuf().copy()
        p.diag_all(); p.diag_wet_mom(0); m0 = p.outbuf().copy()
        p.diag_all(); p.diag_wet_mom(3); m3 = p.outbuf().copy()
        p.diag_RH(); RH = p.outbuf().copy()
        return dict(cls=type(p).__name__, th=th, rv=rv, sd=sd, m0=m0,
                    m3=m3, RH=RH, puddle=p.diag_puddle(), prtcls=p)
    finally:
        os.environ.pop("LIBCLOUD_ENGINE", None)


def test_factory_selects_dense():
    r = _run("dense", False, steps=1)
    assert r["cls"] == "particles_dense_t"
    r = _run("flat", False, steps=1)
    assert r["cls"] == "particles_t"


def test_dense_public_exact_no_coal():
    d = _run("dense", False)
    f = _run("flat", False)
    np.testing.assert_allclose(d["th"], f["th"], rtol=1e-12)
    np.testing.assert_allclose(d["rv"], f["rv"], rtol=1e-10)
    np.testing.assert_allclose(d["m0"], f["m0"], rtol=1e-9)
    np.testing.assert_allclose(d["m3"], f["m3"], rtol=1e-9)
    np.testing.assert_allclose(d["RH"], f["RH"], rtol=1e-10)
    np.testing.assert_array_equal(d["sd"], f["sd"])
    for k, v in f["puddle"].items():
        assert d["puddle"][k] == pytest.approx(v, rel=1e-9, abs=1e-300)


def test_dense_public_with_coal_statistical():
    d = _run("dense", True)
    f = _run("flat", True)
    # cond-dominated thermodynamics barely feel the pairing realisation
    np.testing.assert_allclose(d["th"], f["th"], rtol=1e-5)
    np.testing.assert_allclose(d["rv"], f["rv"], rtol=1e-3)
    # SD slots survive all-or-nothing collisions identically
    np.testing.assert_array_equal(d["sd"], f["sd"])
    # 3rd moment (liquid water) conserved by coal: near-exact
    np.testing.assert_allclose(d["m3"].sum(), f["m3"].sum(), rtol=1e-3)
    # droplet number decreases under coalescence in both engines
    assert d["m0"].sum() < 20 * NX * NZ * 1e9


def test_dense_public_interleaved_diag_and_attrs():
    """Diagnostics mid-run force flat sync; carried get_attr works, the
    non-carried attributes fail loudly instead of silently stale."""
    os.environ["LIBCLOUD_ENGINE"] = "dense"
    try:
        oi = lgrngn.opts_init_t()
        oi.dry_distros = {(0.61, 0.0): lognormal}
        oi.coal_switch = False
        oi.terminal_velocity = lgrngn.vt_t.beard77
        oi.dt = 1
        oi.nx, oi.nz = NX, NZ
        oi.dx = oi.dz = 100.0
        oi.x1, oi.z1 = NX * 100.0, NZ * 100.0
        oi.sd_conc = 8
        oi.n_sd_max = 8 * NX * NZ
        opts = lgrngn.opts_t()
        opts.adve = opts.cond = True
        opts.sedi = opts.coal = opts.chem_dsl = False
        rhod = np.ones((NX, NZ))
        th = 289.0 * np.ones((NX, NZ))
        rv = 7.5e-3 * np.ones((NX, NZ))
        p = lgrngn.factory(lgrngn.backend_t.serial, oi)
        p.init(th, rv, rhod,
               Cx=0.1 * np.ones((NX + 1, NZ)),
               Cz=np.zeros((NX, NZ + 1)))
        n0 = p.get_attr("n")
        total0 = n0[n0 > 0].sum()
        for i in range(4):
            p.step_sync(opts, th, rv, rhod)
            p.step_async(opts)
            p.diag_all()
            p.diag_sd_conc()
            assert p.outbuf().sum() == pytest.approx(8 * NX * NZ)
        n1 = p.get_attr("n")
        assert n1[n1 > 0].sum() == pytest.approx(total0)
        x = p.get_attr("x")
        assert np.isfinite(x).all()
        with pytest.raises(RuntimeError, match="not carried"):
            p.get_attr("up")
    finally:
        os.environ.pop("LIBCLOUD_ENGINE", None)


@pytest.mark.parametrize("variant", ["const_p", "pred_corr"])
def test_dense_public_widened_configs(variant):
    """Round-4 widened dense coverage: const_p/th_std and pred_corr run
    through the dense engine and match the flat engine exactly (no coal)."""
    import jax.numpy as jnp
    from libcloudphxx_tpu.common import theta_dry

    def run(engine):
        os.environ["LIBCLOUD_ENGINE"] = engine
        try:
            oi = lgrngn.opts_init_t()
            oi.dry_distros = {(0.61, 0.0): lognormal}
            oi.coal_switch = False
            oi.sedi_switch = True
            oi.terminal_velocity = lgrngn.vt_t.beard77
            oi.dt = 1
            oi.nx, oi.nz = NX, NZ
            oi.dx = oi.dz = 100.0
            oi.x1, oi.z1 = NX * 100.0, NZ * 100.0
            oi.sd_conc = 16
            oi.n_sd_max = 16 * NX * NZ
            oi.sstp_cond = 2
            if variant == "const_p":
                oi.th_dry = False
                oi.const_p = True
            else:
                oi.adve_scheme = lgrngn.as_t.pred_corr
            opts = lgrngn.opts_t()
            opts.adve = opts.cond = opts.sedi = True
            opts.coal = opts.chem_dsl = False
            rhod = np.ones((NX, NZ))
            rv = 7.5e-3 * np.ones((NX, NZ))
            if variant == "const_p":
                T0 = 289.0 * np.ones((NX, NZ))
                p0 = 90000.0 * np.ones((NX, NZ))
                th = np.asarray(
                    289.0 * (100000.0 / 90000.0) ** (287.0 / 1005.0)
                ) * np.ones((NX, NZ))
            else:
                th = 289.0 * np.ones((NX, NZ))
            Cx = 0.2 * np.ones((NX + 1, NZ))
            Cz = -0.1 * np.ones((NX, NZ + 1))
            p = lgrngn.factory(lgrngn.backend_t.serial, oi)
            if variant == "const_p":
                p.init(th, rv, rhod, p0, Cx=Cx, Cz=Cz)
            else:
                p.init(th, rv, rhod, Cx=Cx, Cz=Cz)
            assert type(p).__name__ == (
                "particles_dense_t" if engine == "dense" else "particles_t")
            for _ in range(4):
                p.step_sync(opts, th, rv, rhod)
                p.step_async(opts)
            p.diag_all(); p.diag_wet_mom(0); m0 = p.outbuf().copy()
            p.diag_all(); p.diag_wet_mom(3); m3 = p.outbuf().copy()
            p.diag_RH(); RH = p.outbuf().copy()
            return th, rv, m0, m3, RH
        finally:
            os.environ.pop("LIBCLOUD_ENGINE", None)

    th_d, rv_d, m0_d, m3_d, RH_d = run("dense")
    th_f, rv_f, m0_f, m3_f, RH_f = run("flat")
    np.testing.assert_allclose(th_d, th_f, rtol=1e-12)
    np.testing.assert_allclose(rv_d, rv_f, rtol=1e-10)
    np.testing.assert_allclose(m0_d, m0_f, rtol=1e-9)
    np.testing.assert_allclose(m3_d, m3_f, rtol=1e-9)
    np.testing.assert_allclose(RH_d, RH_f, rtol=1e-10)


@pytest.mark.parametrize("do_coal,scheme", [
    (False, "implicit"), (True, "implicit"), (False, "pred_corr")])
def test_dense_public_3d(do_coal, scheme):
    """Round-4: the dense engine runs 3-D through the public factory path
    (row = (i*ny+j)*nz + k; rebin phases z -> y -> x; all three advection
    schemes incl. the two-pass predictor-corrector) and matches the flat
    engine — exactly with coalescence off, conservatively with it on."""
    N = 4

    def run(engine):
        os.environ["LIBCLOUD_ENGINE"] = engine
        try:
            oi = lgrngn.opts_init_t()
            oi.dry_distros = {(0.61, 0.0): lognormal}
            oi.coal_switch = do_coal
            if scheme == "pred_corr":
                oi.adve_scheme = lgrngn.as_t.pred_corr
            if do_coal:
                oi.kernel = lgrngn.kernel_t.geometric
            oi.terminal_velocity = lgrngn.vt_t.beard77
            oi.sedi_switch = True
            oi.dt = 1
            oi.nx = oi.ny = oi.nz = N
            oi.dx = oi.dy = oi.dz = 100.0
            oi.x1 = oi.y1 = oi.z1 = N * 100.0
            oi.sd_conc = 16
            oi.n_sd_max = 16 * N**3
            oi.sstp_cond = 2
            oi.sstp_coal = 2
            opts = lgrngn.opts_t()
            opts.adve = opts.cond = opts.sedi = True
            opts.coal = do_coal
            opts.chem_dsl = False
            rhod = np.ones((N, N, N))
            th = 289.0 * np.ones((N, N, N))
            rv = 7.5e-3 * np.ones((N, N, N))
            Cx = 0.2 * np.ones((N + 1, N, N))
            Cy = -0.15 * np.ones((N, N + 1, N))
            Cz = -0.1 * np.ones((N, N, N + 1))
            p = lgrngn.factory(lgrngn.backend_t.serial, oi)
            p.init(th, rv, rhod, Cx=Cx, Cy=Cy, Cz=Cz)
            assert type(p).__name__ == (
                "particles_dense_t" if engine == "dense" else "particles_t")
            for _ in range(4):
                p.step_sync(opts, th, rv, rhod)
                p.step_async(opts)
            p.diag_all(); p.diag_sd_conc(); sd = p.outbuf().copy()
            p.diag_all(); p.diag_wet_mom(0); m0 = p.outbuf().copy()
            p.diag_all(); p.diag_wet_mom(3); m3 = p.outbuf().copy()
            n = p.get_attr("n"); y = p.get_attr("y")
            return th, rv, sd, m0, m3, n[n > 0].sum(), y[n > 0]
        finally:
            os.environ.pop("LIBCLOUD_ENGINE", None)

    th_d, rv_d, sd_d, m0_d, m3_d, tot_d, y_d = run("dense")
    th_f, rv_f, sd_f, m0_f, m3_f, tot_f, y_f = run("flat")
    if not do_coal:
        np.testing.assert_allclose(th_d, th_f, rtol=1e-12)
        np.testing.assert_allclose(rv_d, rv_f, rtol=1e-10)
        np.testing.assert_allclose(m0_d, m0_f, rtol=1e-9)
        np.testing.assert_allclose(m3_d, m3_f, rtol=1e-9)
        np.testing.assert_array_equal(sd_d, sd_f)
        # row-broadcast vs per-SD-gather arithmetic differs at 1 ulp
        np.testing.assert_allclose(np.sort(y_d), np.sort(y_f), rtol=1e-12)
    else:
        np.testing.assert_allclose(th_d, th_f, rtol=1e-5)
        assert tot_d == pytest.approx(tot_f, rel=5e-2)
        np.testing.assert_allclose(m3_d.sum(), m3_f.sum(), rtol=1e-2)
    # y advection really moved SDs off the injection values
    assert np.unique(np.round(y_d, 6)).size > N


@pytest.mark.parametrize("do_coal", [False, True])
def test_dense_public_f32_matches_flat(do_coal):
    """The f32 dense pipeline behind the PUBLIC 3-phase API (the precision
    the GPU runs) against the f32 flat engine.  Without coalescence the
    two agree to f32 rounding of their different summation orders; with
    it, the pairing realisations differ by construction (conservation +
    cond-dominated fields)."""
    import jax
    with jax.enable_x64(False):
        d = _run("dense", do_coal)
        f = _run("flat", do_coal)
    assert d["cls"] == "particles_dense_t" and f["cls"] == "particles_t"
    assert d["prtcls"].state.rw2.dtype == np.float32
    np.testing.assert_array_equal(d["sd"], f["sd"])
    if not do_coal:
        np.testing.assert_allclose(d["th"], f["th"], rtol=2e-6)
        np.testing.assert_allclose(d["rv"], f["rv"], rtol=2e-5)
        np.testing.assert_allclose(d["m0"], f["m0"], rtol=1e-5)
        np.testing.assert_allclose(d["m3"], f["m3"], rtol=1e-4)
        for k, v in f["puddle"].items():
            assert d["puddle"][k] == pytest.approx(v, rel=1e-4, abs=1e-300)
    else:
        np.testing.assert_allclose(d["th"], f["th"], rtol=1e-5)
        np.testing.assert_allclose(d["rv"], f["rv"], rtol=1e-3)
        np.testing.assert_allclose(d["m3"].sum(), f["m3"].sum(), rtol=1e-3)
