"""Grabowski & Abade 2017 SGS turbulence formulas.

JAX equivalent of reference
include/libcloudph++/common/GA17_turbulence.hpp and
include/libcloudph++/common/SGS_length_scale.hpp.
"""

import math

import jax.numpy as jnp

C_E = 0.845
C_tau = 1.5
cube_root_of_two_pi = (2 * math.pi) ** (1.0 / 3.0)
a_1 = 3e-4      # [1/m]   (GA17_turbulence.hpp:32)
a_2 = 2.8e-4    # [m2/s]  (GA17_turbulence.hpp:38)


def tke(diss_rate, L):
    """TKE from dissipation rate and length scale
    (reference GA17_turbulence.hpp:60-69)."""
    return jnp.cbrt(L * diss_rate / C_E) ** 2


def tau(tke_, L):
    """Velocity-relaxation timescale (GA17_turbulence.hpp:71-79)."""
    return L / cube_root_of_two_pi * jnp.sqrt(C_tau / tke_)


def update_turb_vel(wp, tau_, dt, tke_, r_normal):
    """Ornstein-Uhlenbeck update of the SGS velocity perturbation
    (GA17_turbulence.hpp:81-95)."""
    e = jnp.exp(-dt / tau_)
    return wp * e + jnp.sqrt((1.0 - e * e) * (2.0 / 3.0) * tke_) * r_normal


def tau_relax(wet_mom_1_over_vol):
    """Supersaturation relaxation timescale (GA17_turbulence.hpp:97-104)."""
    return 1.0 / (a_2 * wet_mom_1_over_vol)


def dot_turb_ss(ssp, wp, tau_rlx):
    """Supersaturation perturbation tendency (GA17_turbulence.hpp:106-114)."""
    return a_1 * wp - ssp / tau_rlx


# --- SGS mixing-length choices (SGS_length_scale.hpp) --------------------

def length_vertical(*deltas):
    """lambda = dz (last dimension spacing), as in SAM/UWLCM."""
    return deltas[-1]


def length_geometric_mean(*deltas):
    """lambda = (dx*dy*dz)^(1/n)."""
    prod = 1.0
    for d in deltas:
        prod = prod * d
    return prod ** (1.0 / len(deltas))


def length_arithmetic_mean(*deltas):
    """lambda = mean(dx, dy, dz)."""
    return sum(deltas) / len(deltas)
