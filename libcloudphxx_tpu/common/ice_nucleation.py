"""Ice nucleation: singular (Shima 2020) and time-dependent (Arabas 2025,
Koop & Murray 2016) freezing.

JAX equivalent of reference
include/libcloudph++/common/ice_nucleation.hpp.
"""

import enum
import math

import jax.numpy as jnp

from . import const_cp


class INP(enum.IntEnum):
    """Ice-nucleating-particle types (reference ice_nucleation.hpp:17)."""
    mineral = 0


T_FREEZE_DEFAULT = 235.15  # homogeneous freezing default, -38 C


def T_freeze_CDF_inv(rd2_insol, rand, inp_type=INP.mineral):
    """Inverse CDF of the singular freezing temperature, Shima et al. 2020 eq. 1
    (reference ice_nucleation.hpp:20-45)."""
    A = 4.0 * math.pi * rd2_insol
    safe_A = jnp.where(A > 1e-20, A, 1.0)
    T_mineral = 273.15 + (8.934 - jnp.log(-jnp.log1p(-rand) / safe_A)) / 0.517
    use = (inp_type == INP.mineral) & (A > 1e-20)
    return jnp.where(use, T_mineral, T_FREEZE_DEFAULT)


def p_freeze(rd2_insol, rw2, T, dt, inp_type=INP.mineral):
    """Probability of freezing within dt: heterogeneous (Arabas et al. 2025)
    when an insoluble core is present, homogeneous (Koop & Murray 2016)
    otherwise (reference ice_nucleation.hpp:67-117)."""
    # heterogeneous branch
    A = 4.0 * math.pi * rd2_insol
    d_aw = 1.0 - const_cp.p_vsi(T) / const_cp.p_vs(T)
    J_het = 10.0 ** (-1.35 + 22.62 * d_aw) * 1e4
    p_het = 1.0 - jnp.exp(-J_het * A * dt)
    p_het = jnp.where(inp_type == INP.mineral, p_het, 0.0)

    # homogeneous branch
    V = (4.0 / 3.0) * math.pi * rw2 ** 1.5
    dT = T - 273.15
    x = (
        -3020.684
        - 425.921 * dT
        - 25.9779 * dT**2
        - 0.868451 * dT**3
        - 0.0166203 * dT**4
        - 0.000171736 * dT**5
        - 0.000000746953 * dT**6
    )
    J_hom = 10.0**x * 1e6
    p_hom = 1.0 - jnp.exp(-J_hom * V * dt)

    return jnp.where(rd2_insol > 0, p_het, p_hom)
