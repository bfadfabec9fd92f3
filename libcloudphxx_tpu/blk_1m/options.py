"""Options for the single-moment bulk scheme.

JAX equivalent of reference include/libcloudph++/blk_1m/options.hpp:15-46.
The struct is a frozen dataclass of *static* (trace-time) switches: each distinct
combination compiles to its own XLA program with dead branches removed, mirroring
the reference's compile-time inlining of the `if (opts.x)` guards.
"""

from dataclasses import dataclass


@dataclass(frozen=True)
class opts_t:
    # process switches (reference options.hpp:17-33)
    cond: bool = True    # condensation
    cevp: bool = True    # evaporation of cloud
    revp: bool = True    # evaporation of rain
    conv: bool = True    # autoconversion
    accr: bool = True    # accretion
    sedi: bool = True    # sedimentation
    homA1: bool = True   # homogeneous nucleation of ice A from vapour
    homA2: bool = True   # homogeneous nucleation of ice A from cloud droplets
    hetA: bool = True    # heterogeneous nucleation of ice A
    hetB: bool = True    # heterogeneous nucleation of ice B
    depA: bool = True    # depositional growth of ice A
    depB: bool = True    # depositional growth of ice B
    rimA: bool = True    # riming growth of ice A
    rimB: bool = True    # riming growth of ice B
    melA: bool = True    # melting of ice A
    melB: bool = True    # melting of ice B

    # numeric knobs (options.hpp:34-37)
    r_c0: float = 5e-4     # autoconversion threshold
    k_acnv: float = 1e-3   # Kessler autoconversion rate [1/s]
    r_eps: float = 2e-5    # absolute tolerance of saturation adjustment

    # saturation-adjustment algorithm (options.hpp:39-40)
    adj_nwtrph: bool = True   # Newton-Raphson if True, else RK4 path integration
    nwtrph_iters: int = 3

    # thermodynamic convention (options.hpp:42-45); only the two combinations
    # (th_dry=True, const_p=False) and (th_dry=False, const_p=True) are valid
    th_dry: bool = True
    const_p: bool = False

    def validate_theta_convention(self):
        if self.th_dry == self.const_p:
            raise ValueError(
                "blk_1m: exactly one of opts.th_dry and opts.const_p must be true"
            )
