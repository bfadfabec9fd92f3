"""lgrngn — the Lagrangian Super-Droplet Method engine (Shima et al. 2009).

JAX re-implementation of reference src/ + include/libcloudph++/lgrngn/
(see SURVEY.md sections 2.1-2.3): fixed-capacity particle state pytrees,
segment-reduction moments, whole-population implicit condensation, and (in
later milestones) Monte-Carlo coalescence, transport, and shard_map domain
decomposition.
"""

from .enums import RH_formula_t, as_t, backend_t, kernel_t, src_t, vt_t
from .opts import opts_init_t, opts_t
from .particles import factory, particles_t
from .state import State, StaticConfig

__all__ = [
    "RH_formula_t", "as_t", "backend_t", "kernel_t", "src_t", "vt_t",
    "opts_init_t", "opts_t", "factory", "particles_t",
    "State", "StaticConfig",
]
