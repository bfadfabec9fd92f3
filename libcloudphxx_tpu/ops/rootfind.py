"""Batched bracketed root finding.

The reference relies on a per-element TOMS-748 solver
(reference: include/libcloudph++/common/detail/toms748.hpp) called from
per-droplet device loops.  Here the whole batch is solved at once
with a fixed-iteration, divergence-free bracketing scheme: an
Anderson-Bjoerck-accelerated regula falsi with a bisection safeguard.  All
lanes run the same instruction stream (no data-dependent trip counts), so
the solve vectorises over the population; converged lanes simply keep a
collapsed bracket.

Convergence is superlinear (~order 1.7), so 32 iterations exceed f64
precision for any sane bracket; the reference caps TOMS-748 at 100
iterations with ~quarter-precision tolerance (src/detail/config.hpp:181-205).
"""

from functools import partial

import jax
import jax.numpy as jnp


def solve_bracketed(f, a, b, *, iters=32, unroll=False):
    """Find roots of ``f`` within brackets ``[a, b]`` elementwise.

    ``f`` must be a vectorized callable; ``a``/``b`` arrays of equal shape.
    A sign change inside the bracket is assumed (f(a)*f(b) <= 0); if absent,
    the iteration collapses toward the endpoint with smaller |f| — callers
    that need an explicit-Euler fallback (condensation) must detect the
    missing sign change themselves, as the reference does
    (src/impl/condensation/common/particles_impl_cond_common.ipp:294-315).
    ``unroll`` is passed to the iteration's ``fori_loop``.
    """
    fa = f(a)
    fb = f(b)

    def body(_, st):
        a, b, fa, fb = st
        denom = fb - fa
        mid = 0.5 * (a + b)
        # secant (regula falsi) candidate, bisection fallback when degenerate
        sec = jnp.where(denom != 0, (a * fb - b * fa) / jnp.where(denom == 0, 1, denom), mid)
        lo = jnp.minimum(a, b)
        hi = jnp.maximum(a, b)
        inside = (sec > lo) & (sec < hi)
        x = jnp.where(inside, sec, mid)
        fx = f(x)
        left = fa * fx <= 0  # root now in [a, x]
        # Anderson-Bjoerck scaling of the retained endpoint to avoid stagnation
        m_l = 1 - fx / jnp.where(fb == 0, 1, fb)
        m_r = 1 - fx / jnp.where(fa == 0, 1, fa)
        m_l = jnp.where(m_l > 0, m_l, 0.5)
        m_r = jnp.where(m_r > 0, m_r, 0.5)
        na = jnp.where(left, a, x)
        nfa = jnp.where(left, fa * m_l, fx)
        nb = jnp.where(left, x, b)
        nfb = jnp.where(left, fx, fb * m_r)
        # a lane that has already hit fx == 0 keeps a collapsed bracket
        na = jnp.where(fx == 0, x, na)
        nb = jnp.where(fx == 0, x, nb)
        return na, nb, nfa, nfb

    a, b, fa, fb = jax.lax.fori_loop(0, iters, body, (a, b, fa, fb),
                                     unroll=unroll)
    # return the endpoint with the smaller residual
    return jnp.where(jnp.abs(fa) < jnp.abs(fb), a, b)


def bisect(f, a, b, *, iters=64):
    """Plain fixed-iteration bisection (robust reference implementation)."""
    fa = f(a)

    def body(_, st):
        a, b, fa = st
        m = 0.5 * (a + b)
        fm = f(m)
        left = fa * fm <= 0
        return (
            jnp.where(left, a, m),
            jnp.where(left, m, b),
            jnp.where(left, fa, fm),
        )

    a, b, _ = jax.lax.fori_loop(0, iters, body, (a, b, fa))
    return 0.5 * (a + b)
