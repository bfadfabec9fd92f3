"""Super-droplet recycling: refill dead slots by splitting large SDs.

JAX equivalent of reference src/impl/housekeeping/particles_impl_
rcyc.ipp:44-130: one multiplicity argsort pairs the k-th dead slot with the
k-th largest-multiplicity SD; the donor's attributes are copied into the dead
slot and the multiplicity is halved between them (dead gets ceil(n/2), donor
keeps floor(n/2)).  All conflict-free scatters — a pair never overlaps
another.
"""

import dataclasses

import jax.numpy as jnp

from .state import State, StaticConfig

# attributes copied from donor to recycled slot (the reference copies every
# distmem vector, rcyc.ipp:90-96)
RECYCLED_ATTRS = ("rd3", "rw2", "kpa", "x", "y", "z", "vt",
                  "incloud_time", "up", "vp", "wp", "ssp", "dot_ssp",
                  "ice_a", "ice_c", "ice_rho", "T_freeze", "rd2_insol")


def rcyc(cfg: StaticConfig, state: State) -> State:
    n_sd = cfg.n_sd_max
    order = jnp.argsort(state.n)  # dead (n=0) first, then ascending n
    k = jnp.arange(n_sd)
    dead_slot = order[k]
    donor = order[n_sd - 1 - k]
    n_donor = state.n[donor]
    valid = (
        (state.n[dead_slot] <= 0)    # genuinely dead
        & (n_donor > 1)              # splittable donor
        & (k < n_sd - 1 - k)         # pairs never overlap
    )

    tgt = jnp.where(valid, dead_slot, n_sd)   # OOB drop for invalid lanes
    don = jnp.where(valid, donor, n_sd)

    updates = {}
    for name in RECYCLED_ATTRS + ("ijk",):
        arr = getattr(state, name)
        vals = arr[jnp.minimum(donor, n_sd - 1)]
        updates[name] = arr.at[tgt].set(vals, mode="drop")

    half = jnp.floor(n_donor / 2.0)
    n_new = state.n.at[tgt].set(n_donor - half, mode="drop")
    n_new = n_new.at[don].set(half, mode="drop")
    updates["n"] = n_new
    return dataclasses.replace(state, **updates)
