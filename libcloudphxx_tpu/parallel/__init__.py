"""parallel — multi-chip domain decomposition over jax.sharding meshes.

JAX equivalent of the reference's MPI / multi-GPU distributed-memory
layer (SURVEY section 2.3): 1-D x-slab decomposition (uneven slabs padded to
the widest, reference distmem_opts.hpp) with ring (ppermute) courant halos
and super-droplet migration, plus the multi-device particles_t front-end
(reference src/impl_multi_gpu/particles_multi_gpu_*.ipp).
"""

from .decomp import (
    MIGRATING_ATTRS,
    ShardDomain,
    build_multichip_step,
    device_put_domains,
    local_config,
    make_mesh,
    migrate,
    replicate_state_for_mesh,
    shard_domains,
    sharded_async_step,
    sharded_sync_step,
    slab_widths,
    state_specs,
    xchng_courants,
)
from .multi import particles_multi_t

__all__ = [
    "MIGRATING_ATTRS",
    "ShardDomain",
    "build_multichip_step",
    "device_put_domains",
    "local_config",
    "make_mesh",
    "migrate",
    "particles_multi_t",
    "replicate_state_for_mesh",
    "shard_domains",
    "sharded_async_step",
    "sharded_sync_step",
    "slab_widths",
    "state_specs",
    "xchng_courants",
]
