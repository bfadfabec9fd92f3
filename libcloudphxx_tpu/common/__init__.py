"""Common physics foundation shared by all microphysics schemes.

JAX re-implementation of the reference header library
include/libcloudph++/common/ (see SURVEY.md section 2.5).
"""

from . import (
    const_cp,
    constants,
    hydrostatic,
    ice_nucleation,
    kappa_koehler,
    kelvin,
    lognormal,
    maxwell_mason,
    mean_free_path,
    moist_air,
    tetens,
    theta_dry,
    theta_std,
    transition_regime,
    turbulence,
    ventil,
    vterm,
)

__all__ = [
    "const_cp",
    "constants",
    "hydrostatic",
    "ice_nucleation",
    "kappa_koehler",
    "kelvin",
    "lognormal",
    "maxwell_mason",
    "mean_free_path",
    "moist_air",
    "tetens",
    "theta_dry",
    "theta_std",
    "transition_regime",
    "turbulence",
    "ventil",
    "vterm",
]
