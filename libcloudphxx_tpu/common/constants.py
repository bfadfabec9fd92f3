"""Physical constants shared by all schemes.

JAX re-derivation of the reference constant set
(reference: include/libcloudph++/common/{moist_air,const_cp,earth,theta_std}.hpp).
Values are plain Python floats (double precision); array functions downstream
cast to the working dtype of their inputs, so the library runs in f32 by
default and in f64 (x64 enabled) for parity tests.
"""

import math

# --- molar masses [kg/mol] (reference: common/molar_mass.hpp, moist_air.hpp:32-34)
M_H = 1e-3
M_OH = 17e-3
M_d = 0.02897               # dry air
M_v = M_H + M_OH            # water vapour = 0.018 kg/mol
eps = M_v / M_d             # ~0.6213

# --- universal gas constant [J/K/mol] (moist_air.hpp:40)
kaBoNA = 8.3144621

# --- gas constants [J/K/kg] (moist_air.hpp:43-44)
R_d = kaBoNA / M_d
R_v = kaBoNA / M_v

# --- specific heat capacities [J/K/kg] (moist_air.hpp:26-29)
c_pd = 1005.0               # dry air
c_pv = 1850.0               # water vapour
c_pw = 4218.0               # liquid water
c_pi = 2114.0               # ice

R_d_over_c_pd = R_d / c_pd

# --- densities [kg/m3] (moist_air.hpp:50-52)
rho_w = 1e3                 # liquid water
rho_i = 910.0               # ice

# --- vapour diffusivity / thermal conductivity of air (moist_air.hpp:91,112)
D_0 = 2.26e-5               # [m2/s]
K_0 = 2.4e-2                # [J/m/s/K]

# --- water triple point (const_cp.hpp:22-26)
p_tri = 611.73              # [Pa]
T_tri = 273.16              # [K]
l_tri = 2.5e6               # latent heat of evaporation [J/kg]
ls_tri = 2.834e6            # latent heat of sublimation [J/kg]
lf_tri = 3.34e5             # latent heat of freezing [J/kg]

# --- earth (earth.hpp:16-22)
g = 9.81                    # [m/s2]
p_stp = 101325.0            # [Pa]
T_stp = 273.15 + 15         # [K]
rho_stp = p_stp / T_stp / R_d

# --- potential-temperature reference pressure (theta_std.hpp:20)
p_1000 = 100000.0           # [Pa]

pi = math.pi
