"""Single-moment bulk (Kessler) warm-rain and Grabowski-1999 ice formulae.

JAX equivalent of reference include/libcloudph++/blk_1m/formulae.hpp.
All functions are branchless elementwise jnp expressions: the reference's
per-cell early-return guards (``if (x == 0) return 0``) become mask-and-select
with NaN-safe denominators, so a whole grid evaluates in one fused elementwise pass.
"""

import jax.numpy as jnp

from ..common import constants as c
from ..common import vterm as common_vterm

# Kessler collection constant, eq. 5b in Grabowski & Smolarkiewicz 1996
# (reference formulae.hpp:83)
k_2 = 2.2  # [1/s]

# Kessler/Beard rain terminal-velocity constants (formulae.hpp:124-127)
vterm_A = 36.34   # [m/s]
vterm_B = 1e-3    # [m3/kg]

# Marshall-Palmer intercept for rain (formulae.hpp:153) and ice B
# (formulae.hpp:228), graupel density (formulae.hpp:218)
N_0r = 1e7   # [1/m4]
N_0b = 4e6   # [1/m4]
rho_ib = 400.0  # [kg/m3]

_EPS = jnp.finfo(jnp.float64).eps if hasattr(jnp, "float64") else 2.2e-16


def autoconversion_rate(rc, rc_thresh, k_autoconv):
    """Kessler autoconversion, eq. 5a in Grabowski & Smolarkiewicz 1996
    (reference formulae.hpp:72-79)."""
    return k_autoconv * jnp.maximum(0.0, rc - rc_thresh)


def collection_rate(rc, rr):
    """Kessler collection, eq. 5b in G&S 1996 (formulae.hpp:85-91)."""
    return k_2 * rc * jnp.maximum(rr, 0.0) ** 0.875


def evaporation_rate(rv, rvs, rr, rhod, p):
    """Kessler rain evaporation, eq. 5c in G&S 1996 (formulae.hpp:95-120)."""
    rho_rr = jnp.maximum(1e-3 * rhod * rr, 0.0)
    return (
        (1 - rv / rvs) / rhod
        * (1.6 + 124.9 * rho_rr ** 0.2046)   # ventilation factor
        * rho_rr ** 0.525
        / (5.4e2 + 2.55e5 / p / rvs)
    )


def v_term(rr, rhod, rhod_0):
    """Kessler/Beard rain terminal velocity, eq. 5d in G&S 1996
    (formulae.hpp:129-143)."""
    return (
        vterm_A
        * jnp.maximum(rhod * rr * vterm_B, 0.0) ** 0.1346
        * jnp.sqrt(rhod_0 / rhod)
    )


def lambda_rain(rr, rhod_0):
    """Marshall-Palmer slope for rain, eq. A.1 in Grabowski 1999
    (formulae.hpp:147-155).  Safe at rr == 0 (returns a huge finite slope)."""
    denom = jnp.maximum(rhod_0 * rr, 1e-300)
    return (c.pi * c.rho_w * N_0r / denom) ** 0.25


def _iwc_partition(ri, rhod_0):
    """Split ice-A water content into small/large populations
    (shared by mass_a/velocity_iceA; reference formulae.hpp:166-171, 201-205)."""
    IWC = jnp.maximum(1e-9, rhod_0 * ri)
    IWCS = jnp.maximum(
        1e-9, jnp.minimum(jnp.minimum(1e-3, IWC), 2.52e-4 * (IWC / 1e-3) ** 0.837)
    )
    IWCL = jnp.maximum(1e-9, IWC - IWCS)
    return IWCS, IWCL


def mass_a(ria, T, rhod_0):
    """Mean mass of an ice A particle, eq. A.7-A.15a in Grabowski 1999
    (formulae.hpp:158-191)."""
    tempc = T - 273.16
    IWCS, IWCL = _iwc_partition(ria, rhod_0)
    # small ice A
    alpha = jnp.maximum(1e3, 4.99e3 - 4.94e4 * jnp.log10(IWCS / 1e-3))
    m_as = 6.28 * c.rho_i / alpha**3
    # large ice A: lognormal-fit mass from temperature-dependent mu/sigma
    ami = 5.20 + 1.3e-3 * tempc
    bmi = 0.026 - 1.2e-3 * tempc
    asi = 0.47 + 2.1e-3 * tempc
    bsi = 0.018 - 2.1e-4 * tempc
    alorat = jnp.log10(IWCL / 1e-3)
    miu = jnp.clip(ami + bmi * alorat, 4.6, 5.4)
    sig = jnp.clip(asi + bsi * alorat, 0.0, 0.5)
    m_al = 5.24e-19 * c.rho_i * jnp.exp(3.0 * miu + 4.5 * sig**2)
    delta = IWCS / (IWCS + IWCL)
    amass = delta * m_as + (1 - delta) * m_al
    return jnp.maximum(1e-18, amass)


def velocity_iceA(ria, rhod_0):
    """Mean terminal velocity of ice A, eq. A.15b in Grabowski 1999
    (formulae.hpp:195-214)."""
    IWCS, IWCL = _iwc_partition(ria, rhod_0)
    v_as = 0.1
    v_al = 0.9 + 0.1 * jnp.log10(1e3 * IWCL)
    delta = IWCS / (IWCS + IWCL)
    return (delta * v_as + (1 - delta) * v_al) / jnp.sqrt(rhod_0)


def lambda_ice_b(rib, rhod_0):
    """Marshall-Palmer slope for ice B, eq. A.4 in Grabowski 1999
    (formulae.hpp:222-233)."""
    return (c.pi * rho_ib * N_0b / (rhod_0 * rib + _EPS)) ** 0.25


def mass_b(rib, rhod_0):
    """Mean mass of an ice B particle, eq. A.5 in Grabowski 1999
    (formulae.hpp:237-247)."""
    bmass = c.pi * rho_ib / (6.0 * lambda_ice_b(rib, rhod_0) ** 3)
    return jnp.maximum(1e-18, bmass)


def velocity_iceB(rib, rhod_0):
    """Mean terminal velocity of ice B, eq. A.6 in Grabowski 1999
    (formulae.hpp:251-261)."""
    return 31.2 * lambda_ice_b(rib, rhod_0) ** (-0.37) / jnp.sqrt(rhod_0)


# Koenig 1972 table 2 deposition/riming coefficients, tabulated per degC
# from 0 to -31 C (reference formulae.hpp:265-311)
_ALPHA_TABLE = jnp.array([
    0.0, 0.7939e-7, 0.7841e-6, 0.3369e-5, 0.4336e-5, 0.5285e-5,
    0.3728e-5, 0.1852e-5, 0.2991e-6, 0.4248e-6, 0.7434e-6, 0.1812e-5,
    0.4394e-5, 0.9145e-5, 0.1725e-4, 0.3348e-4, 0.1725e-4, 0.9175e-5,
    0.4412e-5, 0.2252e-5, 0.9115e-6, 0.4876e-6, 0.3473e-6, 0.4758e-6,
    0.6306e-6, 0.8573e-6, 0.7868e-6, 0.7192e-6, 0.6515e-6, 0.5956e-6,
    0.533e-6, 0.4834e-6,
])
_BETA_TABLE = jnp.array([
    0.0, 0.4006, 0.4831, 0.5320, 0.5307, 0.5319, 0.5249, 0.4888,
    0.3894, 0.4047, 0.4318, 0.4771, 0.5183, 0.5463, 0.5651, 0.5813,
    0.5655, 0.5478, 0.5203, 0.4906, 0.4447, 0.4126, 0.3960, 0.4149,
    0.4320, 0.4506, 0.4483, 0.4460, 0.4433, 0.4413, 0.4382, 0.4361,
])


def _koenig_interp(table, T):
    """Linear interpolation into a Koenig-1972 per-degree table; gather-based
    (jnp.take) so the whole grid looks up in one vectorized op
    (reference formulae.hpp:279-286)."""
    ttcoe = jnp.clip(T - 273.16, -31.0, 0.0)
    idx = jnp.trunc(-ttcoe).astype(jnp.int32)
    frac = -ttcoe - idx
    lo = jnp.take(table, idx)
    hi = jnp.take(table, jnp.minimum(idx + 1, table.shape[0] - 1))
    return (1.0 - frac) * lo + frac * hi


def coeff_alpha(T):
    return _koenig_interp(_ALPHA_TABLE.astype(jnp.result_type(T)), T)


def coeff_beta(T):
    return _koenig_interp(_BETA_TABLE.astype(jnp.result_type(T)), T)


def hom_A_nucleation_1(rv, rvs, rvsi, T, dt):
    """Homogeneous ice A nucleation from vapour, eq. A.21a in Grabowski 1999
    (formulae.hpp:315-333).  Active only below -40 C."""
    beta = jnp.where(T > 213.16, 0.1 + 0.9 * (T - 213.16) / 20.0, 0.1)
    rv_adj = beta * rvs + (1 - beta) * rvsi
    rate = (1 - jnp.exp(-1.0)) * jnp.maximum(0.0, rv - rv_adj)  # taunuc = dt
    return jnp.where(T < 233.16, rate, 0.0)


def hom_A_nucleation_2(rc, T, dt):
    """Homogeneous ice A nucleation from cloud water, eq. A.21b
    (formulae.hpp:337-348)."""
    rate = (1 - jnp.exp(-1.0)) * rc
    return jnp.where(T < 233.16, rate, 0.0)


def het_A_nucleation(ria, rc, T, rhod_0, dt):
    """Heterogeneous ice A nucleation, eq. A.19 (formulae.hpp:352-375)."""
    m_a = mass_a(ria, T, rhod_0)
    N_in = jnp.minimum(1e5, 1e-2 * jnp.exp(0.6 * (273.16 - T)))
    rate = (1 - jnp.exp(-1.0)) * jnp.minimum(
        rc, jnp.maximum(0.0, N_in * m_a / rhod_0 - ria)
    )
    return jnp.where((rc > 0) & (T <= 273.16), rate, 0.0)


def _rain_iceA_collision_rate(rr, ria, T, rhod_0):
    """Raindrop/ice-A collision rate N_ra [1/kg/s] shared by the two
    het-B nucleation pathways (reference formulae.hpp:392-408, 428-441)."""
    lam_r = lambda_rain(rr, rhod_0)
    v_r = 251.0 / jnp.sqrt(lam_r * rhod_0)
    R_r = 0.5 / lam_r
    m_a = mass_a(ria, T, rhod_0)
    v_a = velocity_iceA(ria, rhod_0)
    return N_0r / lam_r * jnp.abs(v_r - v_a) * c.pi * R_r * R_r * ria / m_a


def _het_B_active(rr, ria, T):
    return (ria > 0) & (rr > 0) & (T <= 273.16)


def het_B_nucleation_1(rr, ria, T, rhod_0):
    """Heterogeneous ice B nucleation rr->rib, eq. A.23 (formulae.hpp:379-411)."""
    lam_r = lambda_rain(rr, rhod_0)
    m_r = c.pi * c.rho_w / (6.0 * lam_r**3)
    rate = _rain_iceA_collision_rate(rr, ria, T, rhod_0) * m_r
    return jnp.where(_het_B_active(rr, ria, T), rate, 0.0)


def het_B_nucleation_2(rr, ria, T, rhod_0):
    """Heterogeneous ice B nucleation ria->rib, eq. A.23
    (formulae.hpp:415-444)."""
    m_a = mass_a(ria, T, rhod_0)
    rate = _rain_iceA_collision_rate(rr, ria, T, rhod_0) * m_a
    return jnp.where(_het_B_active(rr, ria, T), rate, 0.0)


def melting_A(ria, T, rhod_0, dt):
    """Melting of ice A, eq. A.26 (formulae.hpp:448-475)."""
    m_a = mass_a(ria, T, rhod_0)
    D_a = jnp.sqrt(m_a / 0.025)
    v_a = velocity_iceA(ria, rhod_0)
    Re = D_a * v_a * rhod_0 / common_vterm.visc(T)
    F_a = jnp.maximum(1.0, 0.78 + 0.27 * jnp.sqrt(Re))
    dma_dt = 9e-7 * D_a / 2.0 * F_a * jnp.maximum(0.0, T - 273.16)
    rate = jnp.minimum(ria / dt, dma_dt * ria / m_a)
    return jnp.where((ria > 0) & (T >= 273.16), rate, 0.0)


def melting_B(rib, T, rhod_0, dt):
    """Melting of ice B, eq. A.26 (formulae.hpp:479-508)."""
    lam_b = lambda_ice_b(rib, rhod_0)
    m_b = mass_b(rib, rhod_0)
    D_b = 1.0 / lam_b
    v_b = velocity_iceB(rib, rhod_0)
    Re = D_b * v_b * rhod_0 / common_vterm.visc(T)
    F_b = jnp.maximum(1.0, 0.78 + 0.27 * jnp.sqrt(Re))
    dmb_dt = 9e-7 * D_b / 2.0 * F_b * jnp.maximum(0.0, T - 273.16)
    rate = jnp.minimum(rib / dt, dmb_dt * rib / m_b)
    return jnp.where((rib > 0) & (T >= 273.16), rate, 0.0)


def _dep_rate_AE(m, rv, rvs, rvsi, T):
    """Koenig-1976 single-particle depositional growth rate dm/dt [kg/s]
    (regime AE; reference formulae.hpp:530-534)."""
    alpha = coeff_alpha(T)
    beta = coeff_beta(T)
    return 1e-3 * (rv - rvsi) / (rvs - rvsi + _EPS) * alpha * (m * 1e3) ** beta


def deposition_A(ria, rv, rvs, rvsi, T, rhod_0):
    """Depositional growth of ice A, eq. A.24a (formulae.hpp:513-536)."""
    m_a = mass_a(ria, T, rhod_0)
    rate = ria / m_a * _dep_rate_AE(m_a, rv, rvs, rvsi, T)
    return jnp.where((ria > 0) & (T <= 273.16), rate, 0.0)


def deposition_B(rib, rv, rvs, rvsi, T, rhod_0):
    """Depositional growth of ice B, eq. A.24c (formulae.hpp:592-615)."""
    m_b = mass_b(rib, rhod_0)
    rate = rib / m_b * _dep_rate_AE(m_b, rv, rvs, rvsi, T)
    return jnp.where((rib > 0) & (T <= 273.16), rate, 0.0)


def _riming_rate(m, ri, rc, rv, rvs, rvsi, T, rhod_0):
    """Koenig-1976 riming growth (regimes BC/CD minus AE), shared by ice A
    and ice B (reference formulae.hpp:541-588, 620-665)."""
    alpha = coeff_alpha(T)
    beta = coeff_beta(T)
    dm_dt_AE = _dep_rate_AE(m, rv, rvs, rvsi, T)
    rc_safe = jnp.maximum(rc, 1e-300)
    tan_theta = 1.0 + 0.1 * jnp.log(rhod_0 * rc_safe * 1e3)
    gamma = alpha * 5e-8**beta
    dm_dt_BC = 1e-3 * gamma * (m / 5e-11) ** tan_theta
    dzeta = gamma * 2e3**tan_theta
    xi = jnp.log(rc_safe * rhod_0 * 1e9 / dzeta) / jnp.log(1e4)
    dm_dt_CD = 1e-3 * dzeta * (m * 1e7) ** xi
    rim = jnp.where(
        (m > 5e-11) & (m <= 1e-7),
        jnp.maximum(0.0, dm_dt_BC - dm_dt_AE) * ri / m,
        0.0,
    )
    rim += jnp.where(
        m > 1e-7, jnp.maximum(0.0, dm_dt_CD - dm_dt_AE) * ri / m, 0.0
    )
    return rim


def riming_A(ria, rc, rv, rvs, rvsi, T, rhod_0):
    """Riming growth of ice A, eq. A.24b (formulae.hpp:541-588)."""
    m_a = mass_a(ria, T, rhod_0)
    rate = _riming_rate(m_a, ria, rc, rv, rvs, rvsi, T, rhod_0)
    return jnp.where((ria > 0) & (rc > 0) & (T <= 273.16), rate, 0.0)


def riming_B(rib, rc, rv, rvs, rvsi, T, rhod_0):
    """Riming growth of ice B, eq. A.24d (formulae.hpp:619-665)."""
    m_b = mass_b(rib, rhod_0)
    rate = _riming_rate(m_b, rib, rc, rv, rvs, rvsi, T, rhod_0)
    return jnp.where((rib > 0) & (T <= 273.16), rate, 0.0)


def riming_B_1(rib, rc, rr, rv, rvs, rvsi, T, rhod_0):
    """Riming of ice B taking from rc only (formulae.hpp:669-682)."""
    coeff_rc = rc / (rc + rr + 1e-10)
    return coeff_rc * riming_B(rib, rc, rv, rvs, rvsi, T, rhod_0)


def riming_B_2(rib, rc, rr, rv, rvs, rvsi, T, rhod_0):
    """Riming of ice B taking from rr only (formulae.hpp:686-699)."""
    coeff_rc = rc / (rc + rr + 1e-10)
    return (1.0 - coeff_rc) * riming_B(rib, rc, rv, rvs, rvsi, T, rhod_0)
