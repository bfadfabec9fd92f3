"""Options for the double-moment bulk scheme.

JAX equivalent of reference include/libcloudph++/blk_2m/options.hpp:17-52.
Static frozen dataclass: process switches specialize the compiled program;
the aerosol spectrum is a tuple of lognormal modes unrolled at trace time
(the reference also loops over the mode vector per cell).
"""

from dataclasses import dataclass, field
from typing import Tuple


@dataclass(frozen=True)
class lognormal_mode_t:
    mean_rd: float   # [m]
    sdev_rd: float   # [1]
    N_stp: float     # [m^-3] at STP
    chem_b: float    # [1] solubility parameter


@dataclass(frozen=True)
class opts_t:
    acti: bool = True   # activation
    cond: bool = True   # condensation
    acnv: bool = True   # autoconversion
    accr: bool = True   # accretion
    sedi: bool = True   # sedimentation

    RH_max: float = 44.0  # RH limit for activation

    # Khairoutdinov & Kogan 2000 autoconversion parameters (eq. 29)
    acnv_A: float = 1350.0
    acnv_b: float = 2.47
    acnv_c: float = -1.79

    dry_distros: Tuple[lognormal_mode_t, ...] = field(default_factory=tuple)

    # thermodynamic convention, same contract as blk_1m (options.hpp:49-51)
    th_dry: bool = True
    const_p: bool = False

    def validate_theta_convention(self):
        if self.th_dry == self.const_p:
            raise ValueError(
                "blk_2m: exactly one of opts.th_dry and opts.const_p must be true"
            )
