"""blk_2m — double-moment bulk scheme (Morrison & Grabowski 2007).

JAX re-implementation of reference include/libcloudph++/blk_2m/
(see SURVEY.md section 2.4): activation over lognormal aerosol modes,
relaxation condensation/evaporation, KK2000 autoconversion/accretion with
number sinks, and two-moment sedimentation.
"""

from . import formulae
from .options import lognormal_mode_t, opts_t
from .rhs_cellwise import rhs_cellwise
from .rhs_columnwise import rhs_columnwise

__all__ = [
    "formulae",
    "lognormal_mode_t",
    "opts_t",
    "rhs_cellwise",
    "rhs_columnwise",
]
