"""The 2-D prescribed-flow kinematic cloud model ("icicle").

JAX equivalent of reference models/kinematic_2D/: the GMD-2015 /
8th ICMW case-1 setup (models/kinematic_2D/src/opts_common.hpp:48-66,
cases/icmw8_case1.hpp:84-219) driving any of the three microphysics schemes.
The Eulerian advection of th/rv is the from-scratch JAX MPDATA in
models/mpdata.py; the streamfunction psi = -sin(pi z/Z) cos(2 pi x/X)
generates an exactly divergence-free G-weighted courant field by discrete
differencing (icmw8_case1.hpp:174-219).
"""

import dataclasses
from functools import partial
from math import exp, log, pi, sqrt

import jax
import jax.numpy as jnp
import numpy as np

from .. import blk_1m as blk_1m_mod
from .. import blk_2m as blk_2m_mod
from .. import lgrngn as lgrngn_mod
from ..common import constants as c
from ..common import hydrostatic, theta_dry, theta_std
from . import mpdata


@dataclasses.dataclass
class Setup:
    """ICMW8 case 1 defaults (reference opts_common.hpp:48-66)."""
    th_0: float = 289.0        # [K] standard potential temperature
    rv_0: float = 7.5e-3       # [kg/kg]
    p_0: float = 101500.0      # [Pa]
    w_max: float = 0.6         # [m/s]
    z_0: float = 0.0
    X: float = 1500.0          # [m]
    Z: float = 1500.0          # [m]
    dt: float = 1.0            # [s]
    mean_rd1: float = 0.02e-6
    mean_rd2: float = 0.075e-6
    sdev_rd1: float = 1.4
    sdev_rd2: float = 1.6
    n1_stp: float = 60e6
    n2_stp: float = 40e6
    kappa: float = 0.61
    chem_b: float = 0.55
    # trace-gas volume mixing ratios + aerosol density for lgrngn_chem
    # (reference opts_common.hpp:64-103; thesis_AJ_2017 cases set nonzero
    # values, CLI defaults are 0)
    SO2_g_0: float = 0.2e-9
    O3_g_0: float = 50e-9
    H2O2_g_0: float = 0.5e-9
    CO2_g_0: float = 360e-6
    NH3_g_0: float = 0.1e-9
    HNO3_g_0: float = 0.1e-9
    chem_rho: float = 1.8e3
    # th/rv relaxation (reference opts_common.hpp:65-66, 96-97)
    tau_rlx: float = 300.0
    z_rlx: float = 200.0

    def lognormal_lnrd(self, lnr):
        """Bimodal aerosol n(ln rd) @STP (icmw8_case1.hpp:61-78)."""
        out = 0.0
        for mean, sdev, n_tot in (
            (self.mean_rd1, self.sdev_rd1, self.n1_stp),
            (self.mean_rd2, self.sdev_rd2, self.n2_stp),
        ):
            # np ufuncs so the whole-population init evaluates vectorized
            out = out + (
                n_tot
                * np.exp(-((lnr - np.log(mean)) ** 2) / (2 * np.log(sdev) ** 2))
                / np.log(sdev) / np.sqrt(2 * np.pi)
            )
        return out

    def lognormal_lnrd_f32(self, lnr):
        """float32-faithful replica of the reference's log_dry_radii functor
        (icmw8_case1.hpp:63-78 with real_t=float; lognormal::n_e computes the
        exponent in double because C++ pow(float, int) promotes).  Used with
        opts_init.reference_rng_init for bit-compatible multiplicities."""
        from ..lgrngn.refinit import logf
        f32 = np.float32
        lnr = np.asarray(lnr, f32)
        out = np.zeros_like(lnr)
        for mean, sdev, n_tot in (
            (self.mean_rd1, self.sdev_rd1, self.n1_stp),
            (self.mean_rd2, self.sdev_rd2, self.n2_stp),
        ):
            lm = logf(f32(mean))[()]
            ls = logf(f32(sdev))[()]
            d = (lnr - lm).astype(np.float64)
            e = f32(np.exp(-(d ** 2) / np.float64(f32(2)) / np.float64(ls) ** 2))
            out = f32(out + f32(n_tot) * e / ls
                      / f32(np.sqrt(f32(2) * f32(np.pi))))
        return out


def rhod_profile(setup: Setup, z):
    """Hydrostatic dry-air density (icmw8_case1.hpp:119-136)."""
    p = hydrostatic.p(z, setup.th_0, setup.rv_0, setup.z_0, setup.p_0)
    return theta_std.rhod(p, setup.th_0, setup.rv_0)


def mixr_helper_profile(setup: Setup, z):
    """moles of air per kg of dry air at altitude z — converts trace-gas
    volume mixing ratios into mass mixing ratios
    (icmw8_case1.hpp mixr_helper:139-163)."""
    p = hydrostatic.p(z, setup.th_0, setup.rv_0, setup.z_0, setup.p_0)
    rhod = theta_std.rhod(p, setup.th_0, setup.rv_0)
    th_d = theta_dry.std2dry(setup.th_0, setup.rv_0)
    T = theta_dry.T(th_d, rhod)
    return p / c.kaBoNA / T / rhod


def make_gc(setup: Setup, nx, nz, dx, dz):
    """G-weighted courant fields from the discrete streamfunction
    (icmw8_case1.hpp:174-219); exactly divergence-free by telescoping."""
    A = setup.w_max * setup.X / (2 * np.pi)
    psi = lambda xX, zZ: -np.sin(np.pi * zZ) * np.cos(2 * np.pi * xX)

    xe = np.arange(nx + 1) * dx / setup.X       # x of x-faces
    zc = (np.arange(nz + 1)) * dz / setup.Z     # z of cell corners
    # GC_x[i, k] through the x face at x_e[i], spanning corners k..k+1
    gc_x = (
        -A
        * (psi(xe[:, None], zc[None, 1:]) - psi(xe[:, None], zc[None, :-1]))
        / dz * setup.dt / dx
    )
    xc = np.arange(nx + 1) * dx / setup.X
    gc_z = (
        A
        * (psi(xc[None, 1:], zc[:, None]) - psi(xc[None, :-1], zc[:, None]))
        / dx * setup.dt / dz
    ).T
    return gc_x, gc_z


def make_gc_node(setup: Setup, nx, nz, dx, dz):
    """G-weighted courants on the libmpdata++ node-centred grid
    (icmw8_case1.hpp intcond:174-219): scalar points at (i*dx, j*dz) with
    dx = X/(nx-1); x faces at (c-1/2)*dx (c = 0..nx), z faces at (c-1/2)*dz.
    ψ is differenced over one cell width centred on the face."""
    A = setup.w_max * (nx - 1) * dx / np.pi / 2.0
    psi = lambda xX, zZ: -np.sin(np.pi * zZ) * np.cos(2 * np.pi * xX)

    cx = np.arange(nx + 1)          # x-face index c <-> physical (c-.5)*dx
    j = np.arange(nz)
    gc_x = (
        -A
        * (psi((cx[:, None] - .5) / (nx - 1), (j[None, :] + .5) / (nz - 1))
           - psi((cx[:, None] - .5) / (nx - 1), (j[None, :] - .5) / (nz - 1)))
        / dz * setup.dt / dx
    )
    i = np.arange(nx)
    cz = np.arange(nz + 1)
    gc_z = (
        A
        * (psi((i[:, None] + .5) / (nx - 1), (cz[None, :] - .5) / (nz - 1))
           - psi((i[:, None] - .5) / (nx - 1), (cz[None, :] - .5) / (nz - 1)))
        / dx * setup.dt / dz
    )
    return gc_x, gc_z


class Kinematic2D:
    """End-to-end kinematic cloud model; the acceptance vehicle mirroring
    reference models/kinematic_2D/src/icicle.cpp + kin_cloud_2d_*.hpp."""

    def __init__(self, nx=76, nz=76, setup: Setup = None, micro="lgrngn",
                 sd_conc=64, sstp_cond=1, sstp_coal=1, n_sd_max=None,
                 backend=None, mpdata_iters=2, grid="cell", fct=False,
                 reference_rng=False, kernel_parameters=None,
                 terminal_velocity=None, rng_seed=None,
                 relax_th_rv=False, opts_init_kw=None):
        """grid="cell": simple cell-centred grid (dx = X/nx), grid="node":
        the libmpdata++ node-centred interpretation the reference icicle
        uses (dx = X/(nx-1), scalar points at j*dz, SDM domain cropped to
        [dx/2, (nx-.5)dx] — kin_cloud_2d_lgrngn.hpp:162-170, icmw8_case1.hpp
        setopts:171-176).  fct enables the MPDATA non-oscillatory limiter
        (reference ct_params opts::fct, icicle.cpp:85)."""
        self.setup = setup or Setup()
        s = self.setup
        self.nx, self.nz = nx, nz
        self.grid = grid
        if grid == "node":
            self.dx = s.X / (nx - 1)
            self.dz = s.Z / (nz - 1)
            z_scalar = np.arange(nz) * self.dz      # scalar points at j*dz
            z_zface = (np.arange(nz + 1) - 0.5) * self.dz
            gc_x, gc_z = make_gc_node(s, nx, nz, self.dx, self.dz)
        else:
            self.dx = s.X / nx
            self.dz = s.Z / nz
            z_scalar = (np.arange(nz) + 0.5) * self.dz
            z_zface = np.arange(nz + 1) * self.dz
            gc_x, gc_z = make_gc(s, nx, nz, self.dx, self.dz)
        self.micro = micro
        self.mpdata_iters = mpdata_iters
        self.fct = fct

        rhod_col = np.asarray(rhod_profile(s, jnp.asarray(z_scalar)))
        self.rhod = np.broadcast_to(rhod_col, (nx, nz)).copy()

        # uniform dry-theta / vapour initial state (icmw8_case1.hpp:166-168)
        if reference_rng:
            # reference real_t=float value (289.99197 in the fig_a refdata)
            f = np.float32
            th_d = float(f(s.th_0) * np.power(
                f(1) + f(s.rv_0) * f(c.R_v) / f(c.R_d),
                f(c.R_d) / f(c.c_pd), dtype=f))
        else:
            th_d = float(theta_dry.std2dry(s.th_0, s.rv_0))
        self.th = np.full((nx, nz), th_d)
        self.rv = np.full((nx, nz), s.rv_0)

        self.gc_x = jnp.asarray(gc_x)
        self.gc_z = jnp.asarray(gc_z)
        self.G = jnp.asarray(self.rhod)

        # plain courants for the SDM (kin_cloud_2d_lgrngn.hpp:180-196:
        # GC divided by rhod).  NOTE the reference divides by
        # rhod(j * this->dj) / rhod((j-.5) * this->dj) where dj is
        # libmpdata++'s grid step, which icicle never sets — it stays at its
        # default of 1, so the divisor is rhod evaluated at z = j METRES
        # (nearly rhod(0) everywhere), not at z = j*dz.  The golden refdata
        # was produced with that behaviour, so node mode reproduces it
        # (confirmed: with rhod(j*dz) the fig_a sd_conc field diverges by up
        # to 7 SDs/cell; with rhod(j*1 m) it matches to +/-1).
        if grid == "node":
            div_x = np.asarray(rhod_profile(s, jnp.asarray(
                np.arange(nz, dtype=float))))
            div_z = np.asarray(rhod_profile(s, jnp.asarray(
                np.arange(nz + 1) - 0.5)))
        else:
            div_x = rhod_col
            div_z = np.asarray(rhod_profile(s, jnp.asarray(z_zface)))
        self.C_x = gc_x / div_x[None, :]
        self.C_z = gc_z / div_z[None, :]

        if micro in ("lgrngn", "lgrngn_chem"):
            oi = lgrngn_mod.opts_init_t()
            distro = (s.lognormal_lnrd_f32 if reference_rng
                      else s.lognormal_lnrd)
            oi.dry_distros = {(s.kappa, 0.0): distro}
            oi.nx, oi.nz = nx, nz
            oi.dx, oi.dz = self.dx, self.dz
            if grid == "node":
                # libmpdata grid interpretation: half-cell crop on each side
                # (kin_cloud_2d_lgrngn.hpp:167-170)
                oi.x0, oi.z0 = self.dx / 2, self.dz / 2
                oi.x1 = (nx - 0.5) * self.dx
                oi.z1 = (nz - 0.5) * self.dz
            else:
                oi.x1, oi.z1 = s.X, s.Z
            oi.dt = s.dt
            oi.sd_conc = sd_conc
            oi.n_sd_max = n_sd_max or 2 * sd_conc * nx * nz
            oi.sstp_cond = sstp_cond
            oi.sstp_coal = sstp_coal
            oi.reference_rng_init = reference_rng
            if rng_seed is not None:
                oi.rng_seed = rng_seed
            oi.kernel = lgrngn_mod.kernel_t.geometric
            # icicle halves the geometric collection efficiency
            # (opts_lgrngn.hpp:340-343)
            oi.kernel_parameters = (
                list(kernel_parameters) if kernel_parameters is not None
                else [])
            oi.terminal_velocity = (
                terminal_velocity if terminal_velocity is not None
                else lgrngn_mod.vt_t.beard77fast)
            # applied LAST so every key can override the defaults above;
            # unknown keys raise instead of silently creating attributes
            for k, v in (opts_init_kw or {}).items():
                if not hasattr(oi, k):
                    raise ValueError(
                        f"kinematic_2d: unknown opts_init field {k!r}")
                setattr(oi, k, v)
            ambient_chem = None
            if micro == "lgrngn_chem":
                # trace-gas fields from volume mixing ratios
                # (kin_cloud_2d_lgrngn_chem.hpp hook_ante_loop:101-128)
                from ..common import chem as chem_mod
                oi.chem_switch = True
                oi.chem_rho = s.chem_rho
                mixr = np.asarray(mixr_helper_profile(
                    s, jnp.asarray(z_scalar)))
                cs = chem_mod.chem_species_t
                gas0 = {
                    cs.SO2: s.SO2_g_0 * chem_mod.M_SO2,
                    cs.O3: s.O3_g_0 * chem_mod.M_O3,
                    cs.H2O2: s.H2O2_g_0 * chem_mod.M_H2O2,
                    cs.CO2: s.CO2_g_0 * chem_mod.M_CO2,
                    cs.NH3: s.NH3_g_0 * chem_mod.M_NH3,
                    cs.HNO3: s.HNO3_g_0 * chem_mod.M_HNO3,
                }
                self.chem_gases = {
                    sp: np.broadcast_to(mixr * v, (nx, nz)).copy()
                    for sp, v in gas0.items()
                }
                ambient_chem = self.chem_gases
            self.prtcls = lgrngn_mod.factory(
                backend or lgrngn_mod.backend_t.CUDA, oi
            )
            self.prtcls.init(self.th, self.rv, self.rhod,
                             Cx=self.C_x, Cz=self.C_z,
                             ambient_chem=ambient_chem)
            self.opts = lgrngn_mod.opts_t()
            if micro == "lgrngn_chem":
                self.opts.chem_dsl = True
                self.opts.chem_dsc = True
                self.opts.chem_rct = True
            else:
                self.opts.chem_dsl = False
        elif micro == "blk_1m":
            self.opts = blk_1m_mod.opts_t()
            self.rc = np.zeros((nx, nz))
            self.rr = np.zeros((nx, nz))
        elif micro == "blk_2m":
            self.opts = blk_2m_mod.opts_t(dry_distros=(
                blk_2m_mod.lognormal_mode_t(s.mean_rd1, s.sdev_rd1,
                                            s.n1_stp, s.chem_b),
                blk_2m_mod.lognormal_mode_t(s.mean_rd2, s.sdev_rd2,
                                            s.n2_stp, s.chem_b),
            ))
            self.rc = np.zeros((nx, nz))
            self.nc = np.zeros((nx, nz))
            self.rr = np.zeros((nx, nz))
            self.nr = np.zeros((nx, nz))
        else:
            raise ValueError(micro)

        self.t = 0.0
        self.puddle_flux = 0.0
        # th/rv relaxation toward the post-spinup horizontal means
        # (kin_cloud_2d_common.hpp:61-77, update_rhs:90-117)
        self.relax_th_rv = relax_th_rv
        self._th_eq = None
        self._rv_eq = None
        self._z_scalar = z_scalar

    # ------------------------------------------------------------- stepping
    def _advect(self, *fields):
        out = []
        for f in fields:
            # np.array (copy): jax device buffers view as read-only, but the
            # SDM sync-out writes back into these host arrays in place
            out.append(np.array(mpdata.advect(
                jnp.asarray(f), self.gc_x, self.gc_z, self.G,
                n_iters=self.mpdata_iters, fct=self.fct,
            )))
        return out

    def advect_scalars(self):
        """The Eulerian (libmpdata++) part of one lgrngn step: MPDATA
        advection of th/rv (+ the six trace gases for lgrngn_chem).  Split
        out so a driver can record fields between advection and microphysics
        like the reference output does (kin_cloud_2d_lgrngn.hpp:222-225:
        parent hook_post_step — which includes output — runs before
        step_sync)."""
        self.th, self.rv = self._advect(self.th, self.rv)
        if self.micro == "lgrngn_chem":
            for sp in list(self.chem_gases):
                (self.chem_gases[sp],) = self._advect(self.chem_gases[sp])

    def micro_step(self, spinup=False):
        """The microphysics part of one lgrngn step (hook_post_step body).
        During spinup, coalescence and sedimentation are off and RH is capped
        at 1% supersaturation (set_rain, kin_cloud_2d_lgrngn.hpp:121-126);
        lgrngn_chem also holds oxidation off during spinup (set_chem,
        kin_cloud_2d_lgrngn_chem.hpp:89-99)."""
        opts = self.opts
        opts.sedi = opts.coal = not spinup
        opts.RH_max = 1.01 if spinup else 44.0
        chem = self.micro == "lgrngn_chem"
        if chem:
            opts.chem_rct = not spinup
        self.prtcls.step_sync(
            opts, self.th, self.rv, self.rhod,
            ambient_chem=self.chem_gases if chem else None)
        self.prtcls.step_async(opts)

    def _relax_hooks(self, spinup):
        """hook_ante_step: capture the relaxation goals at spinup end;
        returns whether the rhs applies this step
        (kin_cloud_2d_common.hpp:52-77)."""
        if not self.relax_th_rv:
            return False
        if not spinup and self._th_eq is None:
            self._th_eq = self.th.mean(axis=0)
            self._rv_eq = self.rv.mean(axis=0)
        return self._th_eq is not None and not spinup

    def _apply_relax(self):
        """Per-cell relaxation rhs toward the saved horizontal means, tau
        growing exponentially with altitude (update_rhs:90-117)."""
        s = self.setup
        tau = s.tau_rlx * np.exp(self._z_scalar / s.z_rlx)
        self.th = self.th + s.dt * (self._th_eq - self.th) / tau
        self.rv = self.rv + s.dt * (self._rv_eq - self.rv) / tau

    def step(self, spinup=False):
        """One model step: MPDATA advection of the scalar fields, then the
        microphysics hook (reference icicle.cpp:77 + hook_post_step)."""
        s = self.setup
        do_relax = self._relax_hooks(spinup)
        if self.micro in ("lgrngn", "lgrngn_chem"):
            self.advect_scalars()
            if do_relax:
                # reference order: mpdata_rhs applies the relaxation before
                # the microphysics hook (hook_post_step parent call)
                self._apply_relax()
            self.micro_step(spinup=spinup)
        elif self.micro == "blk_1m":
            self.th, self.rv, self.rc, self.rr = self._advect(
                self.th, self.rv, self.rc, self.rr
            )
            if do_relax:
                self._apply_relax()
            o = self.opts
            if spinup:
                # reference set_rain only gates autoconversion for blk_1m
                # (kin_cloud_2d_blk_1m.hpp:46-47)
                o = dataclasses.replace(o, conv=False)
            th, rv, rc, rr = (jnp.asarray(a) for a in
                              (self.th, self.rv, self.rc, self.rr))
            rhod = jnp.asarray(self.rhod)
            pz = jnp.zeros_like(th)
            th, rv, rc, rr = blk_1m_mod.adj_cellwise(
                o, rhod, pz, th, rv, rc, rr, s.dt
            )
            zero = jnp.zeros_like(th)
            if o.adj_nwtrph:
                dth, drv, drc, drr = blk_1m_mod.rhs_cellwise_revap(
                    o, zero, zero, zero, zero,
                    rhod, pz, th, rv, rc, rr, s.dt,
                )
            else:
                dth, drv = zero, zero
                drc, drr = blk_1m_mod.rhs_cellwise(o, zero, zero, rc, rr)
            drr, flux = blk_1m_mod.rhs_columnwise(o, drr, rhod, rr, self.dz)
            self.puddle_flux += float(jnp.sum(flux)) * s.dt
            # rhs applied unclamped, like libmpdata++'s euler_b psi += dt*rhs
            self.th = np.asarray(th + s.dt * dth)
            self.rv = np.asarray(rv + s.dt * drv)
            self.rc = np.asarray(rc + s.dt * drc)
            self.rr = np.asarray(rr + s.dt * drr)
        elif self.micro == "blk_2m":
            self.th, self.rv, self.rc, self.nc, self.rr, self.nr = \
                self._advect(self.th, self.rv, self.rc, self.nc,
                             self.rr, self.nr)
            if do_relax:
                self._apply_relax()
            o = self.opts
            if spinup:
                # reference set_rain: acnv off + 1% RH cap
                # (kin_cloud_2d_blk_2m.hpp:96-101)
                o = dataclasses.replace(o, acnv=False, RH_max=1.01)
            else:
                o = dataclasses.replace(o, RH_max=44.0)
            th, rv, rc, nc, rr, nr = (jnp.asarray(a) for a in (
                self.th, self.rv, self.rc, self.nc, self.rr, self.nr))
            rhod = jnp.asarray(self.rhod)
            zero = jnp.zeros_like(th)
            dth, drv, drc, dnc, drr, dnr = blk_2m_mod.rhs_cellwise(
                o, zero, zero, zero, zero, zero, zero,
                rhod, th, rv, rc, nc, rr, nr, s.dt,
            )
            drr, dnr, flux = blk_2m_mod.rhs_columnwise(
                o, drr, dnr, rhod, rr, nr, s.dt, self.dz
            )
            self.puddle_flux += float(jnp.sum(flux)) * s.dt
            self.th = np.asarray(th + s.dt * dth)
            self.rv = np.asarray(rv + s.dt * drv)
            self.rc = np.asarray(rc + s.dt * drc)
            self.nc = np.asarray(nc + s.dt * dnc)
            self.rr = np.asarray(rr + s.dt * drr)
            self.nr = np.asarray(nr + s.dt * dnr)
        self.t += s.dt

    def ante_loop(self):
        """blk_1m deals with initial supersaturation by one saturation
        adjustment before the time loop (kin_cloud_2d_blk_1m.hpp
        hook_ante_loop:49-58 condevap) — the t=0 output already contains
        cloud water aloft."""
        if self.micro != "blk_1m":
            return
        s = self.setup
        th, rv, rc, rr = (jnp.asarray(a) for a in
                          (self.th, self.rv, self.rc, self.rr))
        pz = jnp.zeros_like(th)
        th, rv, rc, rr = blk_1m_mod.adj_cellwise(
            self.opts, jnp.asarray(self.rhod), pz, th, rv, rc, rr, s.dt)
        self.th, self.rv, self.rc, self.rr = map(np.asarray, (th, rv, rc, rr))

    def run(self, nt, spinup=0):
        for i in range(nt):
            self.step(spinup=i < spinup)

    # ----------------------------------------- device-resident lgrngn loop
    def _lgrngn_step_fn(self, spinup: bool):
        """One fused model step (MPDATA + step_sync + step_async) as a pure
        function over (State, th, rv) — everything the reference splits
        across libmpdata++, step_sync and a std::async step_async
        (kin_cloud_2d_lgrngn.hpp:220-295) becomes a single XLA program."""
        from ..lgrngn.particles import _step_async_jit, _step_cond_jit
        p = self.prtcls
        cfg = p.cfg
        oi = p.opts_init
        dt = self.setup.dt
        RH_max = 1.01 if spinup else 44.0
        do_coal = (not spinup) and cfg.coal_switch \
            and cfg.kernel != lgrngn_mod.kernel_t.undefined.value
        do_sedi = (not spinup) and cfg.sedi_switch
        switches = (do_coal, True, do_sedi, False, False, False, False,
                    False)
        params = jnp.asarray(np.asarray(oi.kernel_parameters, dtype=float))
        w_LS = jnp.asarray(np.asarray(oi.w_LS, dtype=float)
                           if len(oi.w_LS) else np.zeros(max(1, cfg.nz)))
        sgs_mix_len = jnp.asarray(
            np.asarray(oi.SGS_mix_len, dtype=float)
            if len(oi.SGS_mix_len) else np.full(max(1, cfg.nz), cfg.dz))
        gc_x, gc_z, G = self.gc_x, self.gc_z, self.G
        n_iters, fct = self.mpdata_iters, self.fct
        nx, nz = self.nx, self.nz

        def f(carry):
            state, th, rv = carry
            th = mpdata.advect(th, gc_x, gc_z, G, n_iters=n_iters, fct=fct)
            rv = mpdata.advect(rv, gc_x, gc_z, G, n_iters=n_iters, fct=fct)
            state = dataclasses.replace(
                state, th=th.reshape(-1), rv=rv.reshape(-1))
            state = _step_cond_jit(cfg, state, dt, RH_max, False, False, True)
            th, rv = state.th.reshape(nx, nz), state.rv.reshape(nx, nz)
            state = _step_async_jit(cfg, int(oi.sstp_coal), switches,
                                    state, params, w_LS, sgs_mix_len, dt)
            return (state, th, rv)
        return f

    def _lgrngn_step_fn_dense(self, spinup: bool):
        """One fused model step on the dense cell-major layout
        (lgrngn/dense.py) — same pipeline as _lgrngn_step_fn with the SD
        population held as a (n_cell, cap) occupancy matrix, so per-cell
        reductions are row reductions and the coalescence shuffle is a
        cap-wide batched sort."""
        from ..lgrngn import dense as dense_mod
        p = self.prtcls
        cfg = p.cfg
        oi = p.opts_init
        dt = self.setup.dt
        RH_max = 1.01 if spinup else 44.0
        do_coal = (not spinup) and cfg.coal_switch \
            and cfg.kernel != lgrngn_mod.kernel_t.undefined.value
        do_sedi = (not spinup) and cfg.sedi_switch
        params = jnp.asarray(np.asarray(oi.kernel_parameters, dtype=float))
        gc_x, gc_z, G = self.gc_x, self.gc_z, self.G
        n_iters, fct = self.mpdata_iters, self.fct
        nx, nz = self.nx, self.nz

        def f(carry):
            d, th, rv = carry
            th, rv = mpdata.advect2(th, rv, gc_x, gc_z, G,
                                    n_iters=n_iters, fct=fct)
            d, thc, rvc = dense_mod.step_cond(
                cfg, d, th.reshape(-1), rv.reshape(-1), dt, RH_max)
            d = dense_mod.step_async(cfg, d, params, dt, int(oi.sstp_coal),
                                     do_coal, do_sedi)
            return (d, thc.reshape(nx, nz), rvc.reshape(nx, nz))
        return f

    def _lgrngn_runner(self, sp: bool, n: int, engine: str = "flat"):
        """n fused steps: a lax.scan over the step for the flat engine, a
        host-chained python loop over ONE jitted step for the dense engine
        (which then compiles the step once instead of once per (spinup, n)
        scan length).  LIBCLOUD_SCAN=0/1 overrides the choice for A/B."""
        import os
        cache = getattr(self, "_lgrngn_runners", None)
        if cache is None:
            cache = self._lgrngn_runners = {}
        default_scan = "1" if engine == "flat" else "0"
        use_scan = os.environ.get("LIBCLOUD_SCAN", default_scan) == "1"
        step_fn = (self._lgrngn_step_fn_dense if engine == "dense"
                   else self._lgrngn_step_fn)
        if use_scan:
            key = (sp, n, engine, True)
            if key not in cache:
                f = step_fn(sp)
                cache[key] = jax.jit(lambda c: jax.lax.scan(
                    lambda carry, _: (f(carry), None), c, None,
                    length=n)[0])
            return cache[key]
        key = (sp, engine)
        if key not in cache:
            cache[key] = jax.jit(step_fn(sp))
        fj = cache[key]

        def run(c):
            for _ in range(n):
                c = fj(c)
            return c
        return run

    def dense_capacity(self):
        """Row capacity for the dense engine: 2x the densest initial cell,
        rounded up to a multiple of 8 lanes (dense.row_capacity)."""
        from ..lgrngn import dense as dense_mod
        p = self.prtcls
        counts = np.bincount(
            np.asarray(p.state.ijk)[np.asarray(p.state.n) > 0],
            minlength=p.cfg.n_cell)
        return dense_mod.row_capacity(counts.max())

    def run_device_lgrngn(self, nt, spinup=0, engine="flat",
                          repack_every=0, repack_margin=1.25,
                          chunk_log=None):
        """Device-resident lgrngn run: lax.scan over fused model steps; host
        sees th/rv only at the end.  engine="dense" runs the cell-major
        occupancy-matrix backend (lgrngn/dense.py).

        ``repack_every`` > 0 enables the occupancy-aware repack policy for long
        dense runs: every that many steps the max row occupancy is read (one
        host sync) and the population redistributes to the smallest admissible
        capacity >= repack_margin * occupancy — growing BEFORE rows overflow as
        rain concentrates SDs, and shrinking back (with 1.5x hysteresis so a
        hovering occupancy does not oscillate the capacity) so per-lane costs
        track the real population instead of the historical peak.
        ``chunk_log``: optional list; each repack-interval chunk appends
        {steps, occ, cap, seconds} host-side (tools/ bench_sustained.py uses it
        to separate steady-state chunk times from compile-contaminated ones)."""
        if self.relax_th_rv:
            raise NotImplementedError(
                "relax_th_rv is only supported in the stepwise run() path")
        p = self.prtcls
        if engine == "dense":
            from ..lgrngn import dense as dense_mod
            cap = self.dense_capacity()
            flat_state = p.state
            d = jax.jit(
                dense_mod.pack, static_argnums=(0, 2)
            )(p.cfg, flat_state, cap)
            carry = (d, jnp.asarray(self.th), jnp.asarray(self.rv))
        else:
            carry = (p.state, jnp.asarray(self.th), jnp.asarray(self.rv))

        def admissible_cap(occ):
            """Smallest capacity for this occupancy: margin applied,
            8-lane aligned."""
            return max(8, int(-(-int(occ * repack_margin) // 8) * 8))

        repack_jit = None
        if engine == "dense" and repack_every:
            import time as _time
            repack_jit = jax.jit(dense_mod.repack, static_argnums=(0, 2))
            occ_jit = jax.jit(
                lambda n: jnp.max(jnp.sum(jnp.where(n > 0, 1, 0), axis=1)))
        phases = [(min(spinup, nt), True), (max(0, nt - spinup), False)]
        for n, sp in phases:
            done = 0
            redo = 0
            while done < n:
                if repack_jit is not None:
                    t_chunk = _time.perf_counter()
                k = n - done if not repack_jit else min(repack_every,
                                                        n - done)
                prev = carry
                carry = self._lgrngn_runner(sp, k, engine)(carry)
                if repack_jit is not None:
                    # a rain cell can outgrow the 10%-headroom trigger
                    # WITHIN a repack interval; the overflow counter is
                    # loud, so redo the chunk from its start at the next
                    # capacity instead of dropping SDs (correctness) or
                    # carrying a permanent 2x cap (the old 1.25x trigger)
                    ovf = float(carry[0].overflow) - float(
                        prev[0].overflow)
                    if ovf > 0:
                        redo += 1
                        if redo > 3:
                            raise RuntimeError(
                                f"dense engine: row overflow persists "
                                f"after {redo} capacity retargets")
                        d0 = repack_jit(p.cfg, prev[0],
                                        admissible_cap(int(
                                            occ_jit(prev[0].n)) + 16))
                        carry = (d0,) + prev[1:]
                        continue
                    redo = 0
                done += k
                steps_ahead = (n - done) + (nt - spinup if sp else 0)
                if repack_jit is not None and steps_ahead > 0:
                    d0 = carry[0]
                    occ = int(occ_jit(d0.n))
                    new_cap = admissible_cap(occ)
                    # grow only when the CURRENT capacity is actually
                    # tight (<10% headroom): the margin is for choosing
                    # the new capacity, not the grow trigger — occupancy
                    # drifts ~5-10 per repack interval at the GMD rain
                    # peak, and a 1.25x trigger would double every
                    # lane-wise cost for the tail of the run at occ just
                    # past cap/1.25; shrink
                    # only past 1.5x hysteresis so occupancies hovering
                    # at a capacity boundary do not oscillate (each
                    # retarget costs a repack sort + maybe a compile)
                    if (occ * 1.10 > d0.cap and new_cap > d0.cap) or (
                            new_cap < d0.cap and occ * 1.5 <= new_cap):
                        d0 = repack_jit(p.cfg, d0, new_cap)
                        carry = (d0,) + carry[1:]
                    if chunk_log is not None:
                        chunk_log.append(dict(
                            spinup=sp, steps=k, occ=occ,
                            cap=int(carry[0].cap),
                            seconds=_time.perf_counter() - t_chunk))
        state, th, rv = carry
        if engine == "dense":
            dropped = float(state.overflow)
            if dropped:
                # loud failure, like the flat engine's capacity error
                # (parallel/multi.py shard-capacity check): silent mass
                # loss in the fast path is never acceptable
                raise RuntimeError(
                    f"dense engine: {dropped:.0f} SDs dropped on row "
                    f"overflow (capacity {state.cap}) — raise cap")
            state = jax.jit(
                dense_mod.unpack, static_argnums=0
            )(p.cfg, state, flat_state)
        p.state = state
        self.th = np.asarray(th)
        self.rv = np.asarray(rv)
        p._should_now_run_cond = False
        p._should_now_run_async = False
        self.t += nt * self.setup.dt

    # ------------------------------------------- device-resident bulk loop
    def _blk_step_fn(self, spinup: bool):
        """Pure jax step function over the bulk field tuple — the same math
        as step() without host round trips."""
        s = self.setup
        o = self.opts
        rhod = jnp.asarray(self.rhod)
        gc_x, gc_z, G = self.gc_x, self.gc_z, self.G
        dz, dt = self.dz, s.dt
        n_iters, fct = self.mpdata_iters, self.fct
        adv = lambda f: mpdata.advect(f, gc_x, gc_z, G,
                                      n_iters=n_iters, fct=fct)

        if self.micro == "blk_1m":
            if spinup:
                o = dataclasses.replace(o, conv=False)

            def f(fields):
                th, rv, rc, rr, pf = fields
                th, rv, rc, rr = adv(th), adv(rv), adv(rc), adv(rr)
                pz = jnp.zeros_like(th)
                th, rv, rc, rr = blk_1m_mod.adj_cellwise(
                    o, rhod, pz, th, rv, rc, rr, dt)
                zero = jnp.zeros_like(th)
                if o.adj_nwtrph:
                    dth, drv, drc, drr = blk_1m_mod.rhs_cellwise_revap(
                        o, zero, zero, zero, zero,
                        rhod, pz, th, rv, rc, rr, dt)
                else:
                    dth, drv = zero, zero
                    drc, drr = blk_1m_mod.rhs_cellwise(o, zero, zero, rc, rr)
                drr, flux = blk_1m_mod.rhs_columnwise(o, drr, rhod, rr, dz)
                return (th + dt * dth, rv + dt * drv, rc + dt * drc,
                        rr + dt * drr, pf + jnp.sum(flux) * dt)
            return f

        if self.micro == "blk_2m":
            o = dataclasses.replace(
                o, acnv=o.acnv and not spinup,
                RH_max=1.01 if spinup else 44.0)

            def f(fields):
                th, rv, rc, nc, rr, nr, pf = fields
                th, rv, rc, nc, rr, nr = (adv(th), adv(rv), adv(rc),
                                          adv(nc), adv(rr), adv(nr))
                zero = jnp.zeros_like(th)
                dth, drv, drc, dnc, drr, dnr = blk_2m_mod.rhs_cellwise(
                    o, zero, zero, zero, zero, zero, zero,
                    rhod, th, rv, rc, nc, rr, nr, dt)
                drr, dnr, flux = blk_2m_mod.rhs_columnwise(
                    o, drr, dnr, rhod, rr, nr, dt, dz)
                return (th + dt * dth, rv + dt * drv, rc + dt * drc,
                        nc + dt * dnc, rr + dt * drr, nr + dt * dnr,
                        pf + jnp.sum(flux) * dt)
            return f

        raise ValueError(f"run_device: unsupported micro {self.micro}")

    def run_device(self, nt, spinup=0):
        """Device-resident bulk run: one lax.scan per spinup phase, no host
        transfers between steps (the device-resident answer to the
        reference's 9000-step fig_a regressions)."""
        if self.relax_th_rv:
            raise NotImplementedError(
                "relax_th_rv is only supported in the stepwise run() path")
        names = (("th", "rv", "rc", "rr") if self.micro == "blk_1m"
                 else ("th", "rv", "rc", "nc", "rr", "nr"))
        fields = tuple(jnp.asarray(getattr(self, k)) for k in names) \
            + (jnp.asarray(float(self.puddle_flux)),)
        for n, sp in ((min(spinup, nt), True), (max(0, nt - spinup), False)):
            if n == 0:
                continue
            f = self._blk_step_fn(sp)
            runner = jax.jit(lambda c: jax.lax.scan(
                lambda carry, _: (f(carry), None), c, None, length=n)[0])
            fields = runner(fields)
        for k, v in zip(names, fields):
            setattr(self, k, np.asarray(v))
        self.puddle_flux = float(fields[-1])
        self.t += nt * self.setup.dt

    # ---------------------------------------------------------- diagnostics
    def diag_lgrngn(self, what="rc"):
        """Cloud-water mixing ratio (wet mom3 of r in the cloud range) or
        similar, mirroring kin_cloud_2d_lgrngn.hpp:33-95 recording."""
        p = self.prtcls
        if what == "rc":
            p.diag_wet_rng(0.5e-6, 25e-6)
        elif what == "rr":
            p.diag_wet_rng(25e-6, 1.0)
        elif what == "sd_conc":
            p.diag_all()
            p.diag_sd_conc()
            return p.outbuf().reshape(self.nx, self.nz)
        else:
            raise ValueError(what)
        p.diag_wet_mom(3)
        mom3 = p.outbuf().reshape(self.nx, self.nz)
        return 4.0 / 3 * np.pi * c.rho_w * mom3
