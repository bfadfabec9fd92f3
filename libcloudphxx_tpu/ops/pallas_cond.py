"""Pallas kernel (Triton route) for the per-droplet implicit condensation
solve.

The per-SD backward-Euler wet-growth root find (reference
src/impl/condensation/common/particles_impl_cond_common.ipp:187-338) runs a
fixed-iteration bracketing solver inside every condensation substep.  As
plain XLA each solver iteration is a separate loop-body kernel that re-reads
every carried and captured per-SD array from device memory.  This kernel
runs the whole solve for a block of SDs in registers: each per-SD array is
read once and the result written once.

Input form: the four per-SD planes (rw2, rd3, kpa, vt) are flat vectors in
row-major (cell, lane) order and the eight ambient quantities (rhod, rv, T,
p, RH, eta, lambda_D, lambda_K) are per-cell vectors; the kernel gathers
them by row = sd_index // cap, so no per-SD broadcast plane is ever
materialised.  ``cap == 1`` is the per-SD form (cell vectors already
gathered per SD, as the flat engine holds them).

The physics is the same jnp code as the plain path — the condensation core
is passed in as ``core_fn`` — so the two paths cannot drift.
"""

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plt

N_CELL_ARRAYS = 8   # rhod, rv, T, p, RH, eta, lambda_D, lambda_K


def _kernel(core_fn, block, cap, n_rows, scal_ref, rw2_ref, rd3_ref,
            kpa_ref, vt_ref, *refs):
    cell_refs, out_ref = refs[:N_CELL_ARRAYS], refs[N_CELL_ARRAYS]
    idx = pl.program_id(0) * block + jax.lax.broadcasted_iota(
        jnp.int32, (block,), 0)
    # padded tail lanes clamp onto the last row (they are dead SDs)
    row = jnp.minimum(idx // cap, n_rows - 1)
    cells = [r[row] for r in cell_refs]
    dt = scal_ref[0]
    rh_max = scal_ref[1]
    out_ref[...] = core_fn(dt, rw2_ref[...], rd3_ref[...], kpa_ref[...],
                           vt_ref[...], *cells, rh_max)


@functools.partial(
    jax.jit,
    static_argnames=("core_fn", "cap", "block", "num_warps", "interpret"))
def advance_rw2_pallas(core_fn, dt, rw2, rd3, kpa, vt, cells, RH_max, *,
                       cap, block=128, num_warps=4, interpret=False):
    """``core_fn(dt, rw2, rd3, kpa, vt, <8 ambient arrays>, RH_max)`` as one
    kernel launch over 1-D blocks of ``block`` SDs.

    ``rw2``/``rd3``/``kpa``/``vt``: flat (N,) per-SD vectors, N a multiple
    of ``cap``; ``cells``: the 8 ambient (N // cap,) vectors.  ``block`` is
    a power of two (a Triton requirement).  Returns the new rw2, (N,)."""
    if block & (block - 1):
        raise ValueError(f"pallas_cond: block {block} is not a power of two")
    n = rw2.shape[0]
    dtype = rw2.dtype
    n_rows = n // cap
    n_blocks = pl.cdiv(max(n, 1), block)
    padded = n_blocks * block

    def prep(x):
        x = jnp.asarray(x, dtype)
        # zero padding == dead SD slots (rw2 <= 0 lanes keep rw2_old)
        return jnp.pad(x, (0, padded - n)) if padded != n else x

    sd = tuple(prep(x) for x in (rw2, rd3, kpa, vt))
    cells = tuple(jnp.asarray(c, dtype) for c in cells)
    if len(cells) != N_CELL_ARRAYS:
        raise ValueError(f"pallas_cond: expected {N_CELL_ARRAYS} ambient "
                         f"arrays, got {len(cells)}")
    scal = jnp.stack([jnp.asarray(dt, dtype), jnp.asarray(RH_max, dtype)])

    # under shard_map the output varies over the mesh axes of its inputs
    vma = frozenset().union(*(jax.typeof(a).vma for a in (scal,) + sd
                              + cells))
    sd_spec = pl.BlockSpec((block,), lambda i: (i,))
    full = lambda shape: pl.BlockSpec(shape, lambda i: (0,))
    out = pl.pallas_call(
        functools.partial(_kernel, core_fn, block, cap, n_rows),
        grid=(n_blocks,),
        out_shape=jax.ShapeDtypeStruct((padded,), dtype, vma=vma),
        in_specs=[full((2,))] + [sd_spec] * 4
        + [full((n_rows,))] * N_CELL_ARRAYS,
        out_specs=sd_spec,
        compiler_params=plt.CompilerParams(num_warps=num_warps,
                                           num_stages=1),
        interpret=interpret,
        backend="triton",
        name="advance_rw2",
    )(scal, *sd, *cells)
    return out[:n]
