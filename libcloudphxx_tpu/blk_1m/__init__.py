"""blk_1m — single-moment bulk (Kessler warm rain + Grabowski-1999 ice A/B).

JAX re-implementation of reference include/libcloudph++/blk_1m/
(see SURVEY.md section 2.4).  Public surface mirrors the reference's four free
functions + opts struct, in functional (return-new-arrays) form.
"""

from . import formulae
from .adj_cellwise import adj_cellwise, adj_cellwise_nwtrph, adj_cellwise_rk4
from .options import opts_t
from .rhs_cellwise import rhs_cellwise, rhs_cellwise_ice, rhs_cellwise_revap
from .rhs_columnwise import ice_t, rhs_columnwise, rhs_columnwise_ice

__all__ = [
    "adj_cellwise",
    "adj_cellwise_nwtrph",
    "adj_cellwise_rk4",
    "formulae",
    "ice_t",
    "opts_t",
    "rhs_cellwise",
    "rhs_cellwise_ice",
    "rhs_cellwise_revap",
    "rhs_columnwise",
    "rhs_columnwise_ice",
]
