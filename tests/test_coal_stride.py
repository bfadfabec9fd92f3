"""XOR-stride coalescence pairing (dense.pair_and_collide_stride /
pair_and_collide_partners), a candidate replacement for the per-substep
shuffle sort.

Three gates:
  1. EXACT: on alive-first-compacted rows, stride-1 pairing IS the
     reference's adjacent pairing — results must match pair_and_collide
     bitwise (same draws, same scale: floor(k/2) pairs both ways).
  2. CONSERVATION: any stride conserves the 3rd wet moment, dry volume
     and kappa*rd3, and never increases SD count / total multiplicity.
  3. STATISTICS: a box Golovin run with a stride schedule (one
     random shuffle per stride cycle, strides 2^0..2^5 in between)
     reproduces the Scott-1967 analytic spectrum at the same RMSD gate
     as the reference-faithful per-substep shuffle (reference oracle:
     tests/python/physics/coalescence_golovin.py).
"""

from math import pi

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from libcloudphxx_tpu import lgrngn
from libcloudphxx_tpu.lgrngn import dense as dense_mod
from libcloudphxx_tpu.lgrngn.state import StaticConfig


def _cfg(kernel=None, params=(1500.0,)):
    oi = lgrngn.opts_init_t()
    oi.dt = 1.0
    oi.n_sd_max = 1
    oi.kernel = kernel or lgrngn.kernel_t.golovin
    oi.kernel_parameters = list(params)
    oi.terminal_velocity = lgrngn.vt_t.beard77
    return StaticConfig.from_opts_init(oi)


def _random_rows(rng, rows, cap, occ, compact):
    n = np.zeros((rows, cap))
    rw = rng.uniform(5e-6, 5e-5, size=(rows, cap))
    for r in range(rows):
        k = occ if np.isscalar(occ) else occ[r]
        lanes = np.arange(k) if compact else rng.choice(cap, k, False)
        n[r, lanes] = rng.integers(1, 2**20, size=k)
    rw2 = np.where(n > 0, rw**2, 0.0)
    rd3 = np.where(n > 0, (rw * 1e-2) ** 3, 0.0)
    kpa = np.where(n > 0, rng.uniform(0.1, 1.2, size=n.shape), 0.0)
    vt = np.where(n > 0, rng.uniform(0.0, 2.0, size=n.shape), 0.0)
    return tuple(jnp.asarray(a) for a in (n, rw2, rd3, kpa, vt))


def test_stride1_equals_adjacent_pairing():
    """On compacted rows stride-1 pairing is the reference pairing."""
    rng = np.random.default_rng(5)
    cfg = _cfg()
    params = jnp.asarray([1500.0])
    rows, cap = 8, 64
    for occ in ([4] * rows, list(rng.integers(2, cap, rows))):
        vals = _random_rows(rng, rows, cap, np.array(occ), compact=True)
        count = jnp.asarray(np.array(occ, float))[:, None]
        u01 = jnp.asarray(rng.random((rows, cap)))
        dv = jnp.ones((rows, 1))
        rho = jnp.ones((rows, 1))
        eta = jnp.full((rows, 1), 1.8e-5)
        # huge dt so collisions certainly happen
        ref = dense_mod.pair_and_collide(
            cfg, params, vals, count, dv, rho, eta, 500.0, u01)
        got = dense_mod.pair_and_collide_stride(
            cfg, params, vals, 1, dv, rho, eta, 500.0, u01)
        for a, b, name in zip(ref[:4], got[:4],
                              ("n", "rw2", "rd3", "kpa")):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b),
                                          err_msg=name)
        assert bool(ref[4]) == bool(got[4])


@pytest.mark.parametrize("stride", [1, 2, 8, 16])
def test_stride_conservation(stride):
    rng = np.random.default_rng(stride)
    cfg = _cfg()
    params = jnp.asarray([1500.0])
    rows, cap = 16, 64
    occ = rng.integers(2, cap, rows)
    vals = _random_rows(rng, rows, cap, occ, compact=False)
    n0, rw2_0, rd3_0, kpa_0, _ = (np.asarray(v) for v in vals)
    u01 = jnp.asarray(rng.random((rows, cap)))
    dv = jnp.ones((rows, 1))
    rho = jnp.ones((rows, 1))
    eta = jnp.full((rows, 1), 1.8e-5)
    n1, rw2_1, rd3_1, kpa_1, _ovf = (
        np.asarray(a) for a in dense_mod.pair_and_collide_stride(
            cfg, params, vals, stride, dv, rho, eta, 200.0, u01))
    # water (3rd wet moment), dry volume, kappa-weighted dry volume
    assert (n1 * rw2_1**1.5).sum() == pytest.approx(
        (n0 * rw2_0**1.5).sum(), rel=1e-12)
    assert (n1 * rd3_1).sum() == pytest.approx(
        (n0 * rd3_0).sum(), rel=1e-12)
    assert (n1 * kpa_1 * rd3_1).sum() == pytest.approx(
        (n0 * kpa_0 * rd3_0).sum(), rel=1e-12)
    assert n1.sum() <= n0.sum()
    assert ((n1 > 0).sum()) <= ((n0 > 0).sum())
    assert (n1 >= 0).all()
    # something actually collided at this dt
    assert not np.array_equal(n1, n0)


# ---------------------------------------------------------- Golovin ----
SIM_TIME = 800.0
R_ZERO = 30.084e-6
N_ZERO = 2.0**23
B_GOLOVIN = 1500.0
N_BOX = 128
CAP = 256
SD_CONC = 256


def spherevol(r):
    return 4.0 / 3.0 * r**3 * np.pi


def expvolumelnr(lnr):
    r = np.exp(lnr)
    return N_ZERO * 3.0 * r**3 / R_ZERO**3 * np.exp(-((r / R_ZERO) ** 3))


def golovin_analytic(v, t, n0, v0, b):
    from scipy import special
    x = v / v0
    T = b * n0 * v0 * t
    tau = 1 - np.exp(-T)
    z = 2 * x * np.sqrt(tau)
    res = (n0 / v0 * special.ive(1, z) * (1 - tau)
           * np.exp(z - x * (tau + 1)) / x / np.sqrt(tau))
    return 0.0 if not np.isfinite(res) else res


BINS = 10.0 ** (-6 + np.arange(150) / 50.0)


def _mass_dens(n, rw2, rad, sig0=0.62):
    alive = n > 0
    count = alive.sum(axis=1, keepdims=True)
    sig = sig0 / np.maximum(count, 1.0) ** 0.2
    x = np.maximum(rw2, 1e-300)
    vals = (n / sig * x**1.5
            * np.exp(-((0.5 * np.log(x) - np.log(rad)) / sig) ** 2 / 2.0))
    from libcloudphxx_tpu.common import constants as c
    pref = 4.0 / 3.0 * c.rho_w * np.sqrt(c.pi / 2.0)
    return pref * vals.sum() / N_BOX


@pytest.mark.slow
def test_golovin_spectrum_stride_schedule():
    """One shuffle per stride cycle, strides cycled in between."""
    cfg = _cfg()
    params = jnp.asarray([B_GOLOVIN])
    rng = np.random.default_rng(7)
    lnr_lo, lnr_hi = np.log(R_ZERO / 30), np.log(R_ZERO * 12)
    strata = (np.arange(SD_CONC)[None, :]
              + rng.random((N_BOX, SD_CONC))) / SD_CONC
    lnrd = lnr_lo + strata * (lnr_hi - lnr_lo)
    mult = np.floor(expvolumelnr(lnrd) * (lnr_hi - lnr_lo) / SD_CONC + 0.5)
    rw = np.exp(lnrd)

    n = np.zeros((N_BOX, CAP)); n[:, :SD_CONC] = mult
    rw2 = np.zeros((N_BOX, CAP)); rw2[:, :SD_CONC] = rw**2
    rd3 = np.zeros((N_BOX, CAP)); rd3[:, :SD_CONC] = (rw * 1e-3) ** 3
    kpa = np.where(n > 0, 1e-10, 0.0)

    dv = jnp.ones((N_BOX, 1))
    rho = jnp.ones((N_BOX, 1))
    eta = jnp.full((N_BOX, 1), 1.8e-5)
    sstp = 100
    dt_sub = SIM_TIME / sstp
    n_strides = 6

    @jax.jit
    def shuffle(key, planes):
        u = jax.random.uniform(key, planes[0].shape)
        skey = jnp.where(planes[0] > 0, u, 2.0)
        out = jax.lax.sort((skey,) + planes, dimension=1, num_keys=1)
        return out[1:]

    import functools

    @functools.partial(jax.jit, static_argnums=0)
    def substep(stride, key, planes):
        nn, rw2_, rd3_, kpa_, vt = planes
        u01 = jax.random.uniform(key, nn.shape)
        nn, rw2_, rd3_, kpa_, _ = dense_mod.pair_and_collide_stride(
            cfg, params, (nn, rw2_, rd3_, kpa_, vt), stride,
            dv, rho, eta, dt_sub, u01)
        return (nn, rw2_, rd3_, kpa_, vt)

    key = jax.random.PRNGKey(1234)
    planes = tuple(jnp.asarray(a) for a in (n, rw2, rd3, kpa, n * 0.0))
    for i in range(sstp):
        key, k1, k2 = jax.random.split(key, 3)
        if i % n_strides == 0:
            planes = shuffle(k1, planes)
        planes = substep(1 << (i % n_strides), k2, planes)

    n1 = np.float64(np.asarray(planes[0]))
    rw2_1 = np.float64(np.asarray(planes[1]))
    m3_0 = (n * rw2**1.5).sum()
    m3_1 = (n1 * rw2_1**1.5).sum()
    assert m3_1 == pytest.approx(m3_0, rel=5e-7)
    assert n1.sum() < 0.6 * n.sum()

    n0_conc = n[:, :SD_CONC].sum() / N_BOX
    spec = np.array([
        _mass_dens(n1, rw2_1, (BINS[i] + BINS[i + 1]) / 2)
        for i in range(BINS.size - 1)])
    ana = np.array([
        golovin_analytic(spherevol((BINS[i] + BINS[i + 1]) / 2),
                         SIM_TIME, n0_conc, spherevol(R_ZERO), B_GOLOVIN)
        * spherevol((BINS[i] + BINS[i + 1]) / 2) ** 2 * 3000.0
        for i in range(BINS.size - 1)])
    mask = (spec > 0) | (ana > 0)
    err = np.sqrt(np.mean((spec[mask] - ana[mask]) ** 2))
    assert err < 3.5e-5, err


def test_stride_const_multi_overflow_flag():
    """Equal multiplicities (const-multi init): colliding pairs leave the
    big SD at n=0 (recycling candidates, coal.ipp:243-246) and a
    multi-collision demand raises the overflow flag that drives the
    adaptive sstp_coal growth (coal.ipp:224-227)."""
    rng = np.random.default_rng(3)
    cfg = _cfg()
    params = jnp.asarray([1500.0])
    rows, cap = 8, 64
    n = np.zeros((rows, cap))
    n[:, :32] = 2**16    # constant multiplicity
    rw = rng.uniform(2e-5, 6e-5, (rows, cap))
    rw2 = np.where(n > 0, rw**2, 0.0)
    rd3 = np.where(n > 0, 1e-21, 0.0)
    kpa = np.where(n > 0, 0.61, 0.0)
    vt = np.zeros_like(n)
    vals = tuple(jnp.asarray(a) for a in (n, rw2, rd3, kpa, vt))
    u01 = jnp.asarray(rng.random((rows, cap)))
    dv = jnp.ones((rows, 1))
    rho = jnp.ones((rows, 1))
    eta = jnp.full((rows, 1), 1.8e-5)
    n1, rw2_1, rd3_1, kpa_1, ovf = dense_mod.pair_and_collide_stride(
        cfg, params, vals, 2, dv, rho, eta, 5000.0, u01)
    n1 = np.asarray(n1)
    assert bool(ovf)                       # multi-collision demanded
    assert ((n1 == 0) & (np.asarray(rw2_1) > 0)).any()  # flagged slots
    # water conserved through the equal-multiplicity collisions too
    assert (n1 * np.asarray(rw2_1)**1.5).sum() == pytest.approx(
        (n * rw2**1.5).sum(), rel=1e-12)
