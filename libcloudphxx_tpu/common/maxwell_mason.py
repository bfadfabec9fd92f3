"""Maxwell-Mason diffusional droplet growth rate.

JAX equivalent of reference include/libcloudph++/common/maxwell-mason.hpp.
"""

from . import constants as c
from . import const_cp


def rdrdt(D, K, rho_v, T, p, RH, a_w, klvntrm):
    """r * dr/dt for liquid droplets [m2/s] (reference maxwell-mason.hpp:13-47)."""
    l_v = const_cp.l_v(T)
    return (
        (1.0 - a_w * klvntrm / RH)
        / c.rho_w
        / (1.0 / D / rho_v + l_v / K / RH / T * (l_v / c.R_v / T - 1.0))
    )


def rdrdt_i(D, K, rho_v, T, p, RH_i):
    """r * dr/dt for ice (deposition) [m2/s] (maxwell-mason.hpp:52-83)."""
    l_s = const_cp.l_s(T)
    return (
        (1.0 - 1.0 / RH_i)
        / c.rho_i
        / (1.0 / D / rho_v + l_s / K / RH_i / T * (l_s / c.R_v / T - 1.0))
    )
