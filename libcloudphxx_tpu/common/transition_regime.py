"""Transition-regime correction (Fuchs-Sutugin after Laaksonen et al. 2005).

JAX equivalent of reference
include/libcloudph++/common/transition_regime.hpp.
"""


def beta(Kn):
    """Transition-regime correction factor (reference transition_regime.hpp:13-20)."""
    return (1 + Kn) / (1 + 1.71 * Kn + 1.33 * Kn * Kn)
