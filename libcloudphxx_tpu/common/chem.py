"""Aqueous-chemistry constants and temperature dependences.

JAX equivalent of reference include/libcloudph++/common/{chem,henry,
dissoc,react,molar_mass}.hpp.  Species indexing mirrors chem.hpp:9-22 so the
per-SD chemistry arrays line up with the reference's strided vector layout.
"""

import enum
import math

import jax.numpy as jnp

from . import constants as c


class chem_species_t(enum.IntEnum):
    """(reference common/chem.hpp:9-22)"""
    HNO3 = 0
    NH3 = 1
    CO2 = 2
    SO2 = 3
    H2O2 = 4
    O3 = 5
    S_VI = 6
    H = 7


chem_gas_n = chem_species_t.O3 + 1
chem_all = chem_species_t.H + 1

# molar masses [kg/mol] (molar_mass.hpp:15-48)
M_SO2 = 64e-3
M_H2O2 = 34e-3
M_O3 = 48e-3
M_NH3 = 17e-3
M_HNO3 = 63e-3
M_CO2 = 44e-3
M_H = 1e-3
M_OH = 17e-3
M_SO2_H2O = 82e-3
M_HSO3 = 81e-3
M_SO3 = 80e-3
M_NH3_H2O = 35e-3
M_NH4 = 18e-3
M_NO3 = 62e-3
M_CO2_H2O = 62e-3
M_HCO3 = 61e-3
M_CO3 = 60e-3
M_H2SO4 = 98e-3
M_HSO4 = 97e-3
M_SO4 = 96e-3

# Henry's-law constants [mol/m3/Pa] @298K (henry.hpp:29-36)
H_SO2 = 1.23e3 / c.p_stp
H_H2O2 = 7.45e4 * 1e3 / c.p_stp
H_O3 = 1.13e-2 * 1e3 / c.p_stp
H_NH3 = 62e3 / c.p_stp
H_HNO3 = 2.1e5 * 1e3 / c.p_stp
H_CO2 = 3.4e-2 * 1e3 / c.p_stp

# Henry temperature dependence [K] (henry.hpp:38-43)
dHR_SO2 = 3150.0
dHR_O3 = 2540.0
dHR_H2O2 = 7300.0
dHR_NH3 = 4100.0
dHR_HNO3 = 8700.0
dHR_CO2 = 2440.0

# gas-phase diffusivities [m2/s] (henry.hpp:45-50)
D_SO2 = 0.1089e-4
D_O3 = 0.1444e-4
D_H2O2 = 0.8700e-4
D_CO2 = 0.1381e-4
D_HNO3 = 0.6525e-4
D_NH3 = 0.1978e-4

# mass accommodation coefficients (henry.hpp:52-57)
ac_SO2 = 0.035
ac_O3 = 0.00053
ac_H2O2 = 0.018
ac_CO2 = 0.05
ac_HNO3 = 0.05
ac_NH3 = 0.05

# dissociation constants [mol/m3] @298K (dissoc.hpp:20-30)
K_H2O = 1e-14 * 1e6   # [mol2/m6]
K_SO2 = 1.3e-2 * 1e3
K_HSO3 = 6.6e-8 * 1e3
K_HSO4 = 1.2e-2 * 1e3
K_CO2 = 4.3e-7 * 1e3
K_HCO3 = 4.68e-11 * 1e3
K_NH3 = 1.7e-5 * 1e3
K_HNO3 = 15.4 * 1e3

# dissociation temperature dependence [K] (dissoc.hpp:32-40)
dKR_CO2 = -1000.0
dKR_HCO3 = -1760.0
dKR_SO2 = 1960.0
dKR_HSO3 = 1500.0
dKR_NH3 = -450.0
dKR_HNO3 = 8700.0
dKR_HSO4 = 2720.0

# oxidation rates (react.hpp:22-38): S(IV)->S(VI) by O3 (per HSO3-path) and
# H2O2 (Seinfeld & Pandis)
R_S_O3_k0 = 2.4e4 * 1e-3      # [m3/mol/s]
R_S_O3_k1 = 3.5e5 * 1e-3
R_S_O3_k2 = 1.5e9 * 1e-3
R_S_H2O2_k = 7.45e7 * 1e-6    # [m6/mol2/s]
R_S_H2O2_K = 13.0 * 1e-3      # [m3/mol]
dER_O3_k0 = 0.0
dER_O3_k1 = -5530.0
dER_O3_k2 = -5280.0
dER_H2O2_k = -4430.0


def henry_temp(T, H, dHR):
    """Henry 'constant' at temperature T (henry.hpp:118-126)."""
    return H * jnp.exp(dHR * (1.0 / T - 1.0 / 298.0))


def dissoc_temp(T, K, dKR):
    """Dissociation constant at temperature T (dissoc.hpp:42-51)."""
    return K * jnp.exp(dKR * (1.0 / T - 1.0 / 298.0))


def react_temp(T, R, dER):
    """Reaction rate at temperature T (react.hpp:44-63)."""
    return R * jnp.exp(dER * (1.0 / T - 1.0 / 298.0))


def molec_vel(T, M):
    """Mean molecular speed [m/s] (henry.hpp:59-83)."""
    return jnp.sqrt(8.0 / c.pi * c.kaBoNA * T / M)


def mass_trans(rw2, D, acc_coeff, T, M):
    """Mass-transfer timescale coefficient [1/s] (henry.hpp:85-105)."""
    rw = jnp.sqrt(jnp.maximum(rw2, 1e-300))
    return 1.0 / (
        rw2 / 3.0 / D + 4.0 / 3.0 / acc_coeff * rw / molec_vel(T, M)
    )
