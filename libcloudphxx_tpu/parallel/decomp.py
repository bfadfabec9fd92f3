"""Multi-chip domain decomposition of the SDM engine.

JAX equivalent of the reference's distributed-memory layer
(SURVEY section 2.3): the 1-D x-slab MPI/multi-GPU decomposition
(src/impl/distributed_memory/particles_impl_mpi_exchange.ipp,
src/impl_multi_gpu/) becomes a single `shard_map` program over a
`jax.sharding.Mesh` axis "x":

  - Eulerian fields are sharded into x slabs (the flat cell index is
    x-outermost, so axis-0 sharding IS the slab decomposition),
  - slabs may be UNEVEN (reference distmem_opts.hpp distributes the
    remainder; the MPI oracle test uses nx = rank+2): every shard is padded
    to the widest slab, and the live extent rides along as a per-shard
    ShardDomain of dynamic Lagrangian bounds [lo, hi),
  - each shard owns a fixed-capacity slice of the SD population in *local*
    coordinates (the reference also re-bases coordinates on migration,
    pack.ipp:14-27),
  - courant halos are refreshed with a ring `ppermute` each sync
    (reference xchng_courants.ipp:207-320, called from sync_in),
  - SD migration is a fixed-size pack -> `jax.lax.ppermute` -> unpack into
    dead slots, mirroring the preallocated MPI buffers
    (src/detail/config.hpp:191) — ragged counts ride as validity masks,
  - migration-buffer overflow increments a loud counter in the state
    (the reference hard-asserts its buffer sizes),
  - per-shard puddles are reduced host-side at diag time (reference
    particles_multi_gpu_diag.ipp).

Collectives ride the ICI ring; nothing here assumes a host count.
"""

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..lgrngn import coalescence, condensation, hskpng, transport, turbulence
from ..lgrngn import vterm as vterm_mod
from ..lgrngn.state import State, StaticConfig

# SD attributes that migrate between shards — the analog of the
# distmem_real_vctrs registry (particles_impl.ipp:440-494)
MIGRATING_ATTRS = ("n", "rd3", "rw2", "kpa", "x", "y", "z", "vt",
                   "incloud_time", "up", "vp", "wp", "ssp", "dot_ssp",
                   "ice_a", "ice_c", "ice_rho", "T_freeze", "rd2_insol")


def migrating_attrs(cfg: StaticConfig):
    """The migration payload for a config — exact per-particle substepping
    adds the per-SD ambient copies, like the reference's conditional
    distmem_real_vctrs registration (particles_impl.ipp:440-494)."""
    attrs = MIGRATING_ATTRS
    if cfg.exact_sstp_cond:
        # sstp_tmp_p is per-SD-shaped in exact mode even for var-p runs
        # (it just stays zero there), so it always rides along
        attrs = attrs + ("sstp_tmp_th", "sstp_tmp_rv", "sstp_tmp_rh",
                         "sstp_tmp_p")
    return attrs


@jax.tree_util.register_dataclass
@dataclasses.dataclass
class ShardDomain:
    """Per-shard dynamic Lagrangian domain in local coordinates.

    All leaves are (1,)-shaped so the global (n_shards,) arrays shard to one
    scalar per device; the global domain crop (x0 > 0 on the first slab,
    x1 < nx*dx on the last) and uneven slab widths both live here instead of
    in the static config.  ``nxl`` is the live cell count of the slab (the
    padded static nx may be larger)."""
    lo: jax.Array
    hi: jax.Array
    nxl: jax.Array


def slab_widths(nx: int, n_shards: int):
    """Cells per slab, remainder spread from the left
    (reference src/detail/distmem_opts.hpp)."""
    base = nx // n_shards
    rem = nx % n_shards
    return [base + (1 if s < rem else 0) for s in range(n_shards)]


def local_config(cfg: StaticConfig, n_shards: int,
                 widths=None) -> StaticConfig:
    """Per-shard static config: the PADDED x slab in local coordinates.
    All shards share one compiled program; narrower slabs leave their
    rightmost cells dead (no SDs, dv keeps a safe nonzero value)."""
    if cfg.n_sd_max % n_shards != 0:
        raise ValueError("lgrngn: n_sd_max must divide by the shard count")
    widths = widths or slab_widths(cfg.nx, n_shards)
    nx_pad = max(widths)
    return dataclasses.replace(
        cfg,
        nx=nx_pad,
        n_cell=nx_pad * max(1, cfg.ny) * max(1, cfg.nz),
        n_sd_max=cfg.n_sd_max // n_shards,
        x0=0.0,
        x1=nx_pad * cfg.dx,
    )


def shard_domains(cfg: StaticConfig, n_shards: int, widths=None):
    """(lo, hi, widths) per shard as (n_shards,) arrays (local coords)."""
    widths = widths or slab_widths(cfg.nx, n_shards)
    offs = np.concatenate([[0], np.cumsum(widths)])[:-1]
    lo = np.maximum(0.0, cfg.x0 - offs * cfg.dx)
    hi = np.minimum(np.asarray(widths, float) * cfg.dx,
                    cfg.x1 - offs * cfg.dx)
    return np.asarray(lo), np.asarray(hi), np.asarray(widths, np.int32)


def xchng_courants(cfg: StaticConfig, state: State, dom=None,
                   axis_name: str = "x") -> State:
    """Refresh the right courant halo from the right neighbour's first face
    (reference xchng_courants.ipp:207-320; halo_size == 1, i.e. implicit /
    euler SD advection — pred_corr's halo of 2 is not supported sharded).

    Local courant_x holds (nx_l+1)*ny*nz values; faces [0..nx_l-1] are owned,
    face nx_l duplicates the right neighbour's face 0 (with periodic x the
    last shard receives the first shard's face — the ring IS the wrap)."""
    if cfg.n_dims == 0 or state.courant_x.size == 0:
        return state
    n_shards = jax.lax.psum(1, axis_name)
    nyz = max(1, cfg.ny) * max(1, cfg.nz)
    cx = state.courant_x
    first_face = jax.lax.dynamic_slice_in_dim(cx, 0, nyz)
    perm = [(i, (i - 1) % n_shards) for i in range(n_shards)]
    halo = jax.lax.ppermute(first_face, axis_name, perm)
    # the halo face sits after the slab's LIVE faces (uneven slabs are
    # padded to a common static width, so the position is dynamic)
    pos = (dom.nxl[0] if dom is not None else cfg.nx) * nyz
    cx = jax.lax.dynamic_update_slice_in_dim(cx, halo, pos, axis=0)
    return dataclasses.replace(state, courant_x=cx)


def _xchng_courants_pc(cfg: StaticConfig, state: State, dom: ShardDomain,
                       axis_name: str = "x"):
    """Halo-2 courant exchange for pred_corr SD advection (reference
    xchng_courants.ipp:207-320 with halo_size == 2,
    particles_impl.ipp:361-371).

    Returns extended arrays in a +2-shifted x layout:
      cx_ext: x-faces  -2 .. nx_pad+2   ((nx_pad+5)*ny*nz,)
      cy_ext: x-columns -2 .. nx_pad+1  ((nx_pad+4)*(ny+1)*nz,) or None
      cz_ext: x-columns -2 .. nx_pad+1  ((nx_pad+4)*ny*(nz+1),) or None
    Only faces/columns within [-2, nxl+2] / [-2, nxl+1] are meaningful."""
    n_shards = jax.lax.psum(1, axis_name)
    perm_r = [(i, (i + 1) % n_shards) for i in range(n_shards)]
    perm_l = [(i, (i - 1) % n_shards) for i in range(n_shards)]
    ny, nz = max(1, cfg.ny), max(1, cfg.nz)
    nxl = dom.nxl[0]

    def extend(arr, stride, n_send_r):
        """arr has (nx_pad + extra) x-planes of size ``stride``; build the
        ext array with 2 left-halo planes and n_send_r right-halo planes."""
        nplanes = arr.shape[0] // stride
        # to RIGHT neighbour: my last two owned planes (nxl-2, nxl-1)
        send_r = jax.lax.dynamic_slice_in_dim(
            arr, (nxl - 2) * stride, 2 * stride)
        # to LEFT neighbour: my first n_send_r planes
        send_l = jax.lax.dynamic_slice_in_dim(arr, 0, n_send_r * stride)
        from_l = jax.lax.ppermute(send_r, axis_name, perm_r)
        from_r = jax.lax.ppermute(send_l, axis_name, perm_l)
        ext = jnp.zeros(((nplanes + 2 + n_send_r) * stride,), arr.dtype)
        ext = jax.lax.dynamic_update_slice_in_dim(ext, from_l, 0, axis=0)
        ext = jax.lax.dynamic_update_slice_in_dim(
            ext, arr, 2 * stride, axis=0)
        ext = jax.lax.dynamic_update_slice_in_dim(
            ext, from_r, (2 + nxl) * stride, axis=0)
        return ext

    cx_ext = extend(state.courant_x, ny * nz, 3)
    cy_ext = (extend(state.courant_y, (ny + 1) * nz, 2)
              if cfg.n_dims == 3 else None)
    cz_ext = (extend(state.courant_z, ny * (nz + 1), 2)
              if cfg.n_dims > 1 else None)
    return cx_ext, cy_ext, cz_ext


def adve_pred_corr_sharded(cfg: StaticConfig, state: State, dom: ShardDomain,
                           axis_name: str = "x") -> State:
    """Predictor-corrector SD advection on the device mesh (reference
    adve.ipp:168-304 run with halo_size == 2): explicit-Euler predictor with
    the in-slab courants, then the corrector displacement gathered at the
    midpoint from halo-extended courants — midpoints up to two cells outside
    the slab read the neighbours' values, exactly the reference's halo
    coordinate system.  Out-of-slab FINAL positions are handled by the ring
    migration that follows in the async step."""
    from ..lgrngn.transport import _advance_positions, _axis_euler, _wrap
    ny, nz = max(1, cfg.ny), max(1, cfg.nz)
    cx_ext, cy_ext, cz_ext = _xchng_courants_pc(cfg, state, dom, axis_name)

    x_old, y_old, z_old = state.x, state.y, state.z
    # ---- predictor (in-slab gathers; SDs sit in live cells) ----
    x, y, z = _advance_positions(cfg, state, state.ijk, _axis_euler)
    if cfg.n_dims > 1:
        z = jnp.clip(z, cfg.z0 + 1e-8 * cfg.dz, cfg.z1 - 1e-8 * cfg.dz)
    if cfg.n_dims == 3:
        y_wr = _wrap(y, cfg.y0, cfg.y1)
        y_old = y_old + (y_wr - y)
        y = y_wr

    # ---- corrector at the midpoint, halo-extended gathers ----
    # x may sit up to 2 cells outside the slab; indices shift by +2 into the
    # ext layout and clamp to the exchanged extent
    i = jnp.clip(jnp.floor(x / cfg.dx).astype(jnp.int32), -2,
                 dom.nxl[0] + 1)
    j = (jnp.clip(jnp.floor(y / cfg.dy).astype(jnp.int32), 0, ny - 1)
         if cfg.n_dims == 3 else jnp.zeros_like(i))
    k = (jnp.clip(jnp.floor(z / cfg.dz).astype(jnp.int32), 0, nz - 1)
         if cfg.n_dims > 1 else jnp.zeros_like(i))

    lft = ((i + 2) * ny + j) * nz + k
    dx_ = _axis_euler(x, cfg.dx, i, cx_ext[lft], cx_ext[lft + ny * nz],
                      apply=False)
    x = (x + x_old + dx_) / 2.0
    if cfg.n_dims == 3:
        fre = ((i + 2) * (ny + 1) + j) * nz + k
        dy_ = _axis_euler(y, cfg.dy, j, cy_ext[fre], cy_ext[fre + nz],
                          apply=False)
        y = (y + y_old + dy_) / 2.0
    else:
        y = state.y
    if cfg.n_dims > 1:
        blw = ((i + 2) * ny + j) * (nz + 1) + k
        dz_ = _axis_euler(z, cfg.dz, k, cz_ext[blw], cz_ext[blw + 1],
                          apply=False)
        z = (z + z_old + dz_) / 2.0
    else:
        z = state.z
    return dataclasses.replace(state, x=x, y=y, z=z)


def migrate(cfg: StaticConfig, state: State, dom: ShardDomain, buf: int,
            axis_name: str = "x") -> State:
    """Exchange out-of-slab SDs with the two x neighbours
    (reference mpi_exchange.ipp:20-331 / step_async_and_copy.ipp:28-206).

    Runs inside shard_map.  ``buf`` is the static per-direction buffer
    capacity.  Coordinate re-basing follows the reference's
    rmt + x - lcl rule (pack.ipp:14-27) generalised to uneven slabs and the
    periodic wrap at the domain ends: a right mover lands at
    x - hi(sender) + lo(receiver)."""
    n_shards = jax.lax.psum(1, axis_name)
    lo = dom.lo[0]
    hi = dom.hi[0]
    perm_r = [(i, (i + 1) % n_shards) for i in range(n_shards)]
    perm_l = [(i, (i - 1) % n_shards) for i in range(n_shards)]
    # domain handshake (reference xchng_domains.ipp:149-190)
    lo_next = jax.lax.ppermute(dom.lo, axis_name, perm_l)[0]
    hi_prev = jax.lax.ppermute(dom.hi, axis_name, perm_r)[0]

    attrs = migrating_attrs(cfg)

    def pack(mask, shift):
        # movers first (stable sort keeps in-cell order), take buf slots
        order = jnp.argsort(~mask)
        idx = order[:buf]
        valid = mask[idx]
        payload = {}
        for name in attrs:
            v = getattr(state, name)[idx]
            if name == "x":
                v = v + shift
            payload[name] = jnp.where(valid, v, 0.0)
        if cfg.chem_switch:
            # dissolved chemical masses ride the migration too (the
            # reference registers them in distmem_real_vctrs,
            # particles_impl.ipp:440-494)
            payload["chem"] = jnp.where(valid[None, :],
                                        state.chem[:, idx], 0.0)
        overflow = jnp.maximum(jnp.sum(mask) - buf, 0)
        return payload, valid, overflow

    alive = state.n > 0
    go_l = alive & (state.x < lo)
    go_r = alive & (state.x >= hi)
    if cfg.open_side_walls:
        # open x walls: SDs leaving the GLOBAL domain die instead of riding
        # the ring (single-device transport.bcnd kills them; the ring would
        # silently make the boundary periodic)
        idx0 = jax.lax.axis_index(axis_name)
        kill = (go_l & (idx0 == 0)) | (go_r & (idx0 == n_shards - 1))
        state = dataclasses.replace(
            state, n=jnp.where(kill, 0.0, state.n))
        alive = state.n > 0
        go_l = alive & (state.x < lo)
        go_r = alive & (state.x >= hi)
    pay_l, val_l, ovf_l = pack(go_l, hi_prev - lo)
    pay_r, val_r, ovf_r = pack(go_r, lo_next - hi)

    # kill the movers locally (they are flagged n=0 in the reference too)
    n_local = jnp.where(go_l | go_r, 0.0, state.n)
    state = dataclasses.replace(state, n=n_local)

    # ring exchange: right payload to the right neighbour, left to the left
    recv_from_left = jax.tree_util.tree_map(
        lambda a: jax.lax.ppermute(a, axis_name, perm_r), (pay_r, val_r)
    )
    recv_from_right = jax.tree_util.tree_map(
        lambda a: jax.lax.ppermute(a, axis_name, perm_l), (pay_l, val_l)
    )

    def unpack(st, payload, valid):
        # dead slots first; invalid lanes dropped via out-of-bounds index
        dead_order = jnp.argsort(st.n > 0)
        slots = dead_order[jnp.arange(buf)]
        tgt = jnp.where(valid, slots, cfg.n_sd_max)
        updates = {}
        for name in attrs:
            updates[name] = getattr(st, name).at[tgt].set(
                payload[name], mode="drop"
            )
        if cfg.chem_switch:
            updates["chem"] = st.chem.at[:, tgt].set(
                payload["chem"], mode="drop")
        return dataclasses.replace(st, **updates)

    state = unpack(state, *recv_from_left)
    state = unpack(state, *recv_from_right)

    # loud overflow accounting (the reference hard-asserts buffer sizes)
    from ..lgrngn.state import OUT_MIGRATION_OVERFLOW
    puddle = state.puddle.at[OUT_MIGRATION_OVERFLOW].add(
        (ovf_l + ovf_r).astype(state.puddle.dtype))
    state = dataclasses.replace(state, puddle=puddle)

    # re-bin: migrated SDs need local cell ids
    return transport.post_step(cfg, state)


def _bcnd_z_only(cfg: StaticConfig, state: State) -> State:
    """bcnd with the x-direction left to migration (the ring is the wrap);
    y walls are local to every shard (the slab split is x-only)."""
    z, n = state.z, state.n
    puddle = state.puddle
    if cfg.n_dims == 3:
        if cfg.open_side_walls:
            out_y = (state.y >= cfg.y1) | (state.y < cfg.y0)
            n = jnp.where(out_y, 0.0, n)
        else:
            y = cfg.y0 + jnp.remainder(state.y - cfg.y0, cfg.y1 - cfg.y0)
            state = dataclasses.replace(state, y=y)
    if cfg.n_dims > 1:
        from ..common import constants as c
        from ..lgrngn.state import (OUT_DRY_VOL, OUT_LIQ_NUM, OUT_LIQ_VOL,
                                    OUT_PRTCL_NUM)
        if cfg.periodic_topbot_walls:
            z = cfg.z0 + jnp.remainder(z - cfg.z0, cfg.z1 - cfg.z0)
        else:
            n = jnp.where(z >= cfg.z1, 0.0, n)
            fell = (z < cfg.z0) & (n > 0)
            nf = jnp.where(fell, n, 0.0)
            rw2 = state.rw2
            puddle = puddle.at[OUT_LIQ_VOL].add(jnp.sum(
                4.0 / 3 * c.pi * nf * rw2 * jnp.sqrt(jnp.maximum(rw2, 0.0))))
            puddle = puddle.at[OUT_DRY_VOL].add(
                jnp.sum(4.0 / 3 * c.pi * nf * state.rd3))
            puddle = puddle.at[OUT_LIQ_NUM].add(
                jnp.sum(jnp.where(rw2 > 0, nf, 0.0)))
            puddle = puddle.at[OUT_PRTCL_NUM].add(jnp.sum(nf))
            if cfg.ice_switch:
                # frozen SDs reaching the ground (bcnd.ipp:301-327)
                from ..lgrngn import ice as ice_mod
                from ..lgrngn.state import OUT_ICE_MASS, OUT_ICE_NUM
                nfi = jnp.where(state.ice_a > 0, nf, 0.0)
                mass = ice_mod.ice_mass(
                    state.ice_a, state.ice_c, state.ice_rho)
                puddle = puddle.at[OUT_ICE_MASS].add(jnp.sum(nfi * mass))
                puddle = puddle.at[OUT_ICE_NUM].add(jnp.sum(nfi))
            if cfg.chem_switch:
                # dissolved chemical masses rain out (bcnd.ipp:330-340)
                for s in range(8):
                    puddle = puddle.at[s].add(jnp.sum(nf * state.chem[s]))
            n = jnp.where(fell, 0.0, n)
    return dataclasses.replace(state, z=z, n=n, puddle=puddle)


def sharded_sync_step(cfg: StaticConfig, axis_name: str = "x"):
    """Per-shard condensation (+ chemistry) phase: local physics after the
    courant-halo refresh — the hottest kernel needs zero further
    communication (same as the reference, where cond never touches MPI)."""

    def step(state: State, dt, RH_max, dom=None, turb_cond=False):
        state = xchng_courants(cfg, state, dom, axis_name)
        lam = condensation.stale_mfp(state)
        state = hskpng.hskpng_Tpr(cfg, state)
        state = condensation.cond_percell(cfg, state, dt, RH_max,
                                          turb_cond=turb_cond, lam=lam)
        state = condensation.sstp_save(state, exact=cfg.exact_sstp_cond)
        if cfg.chem_switch:
            from ..lgrngn import chemistry
            state = chemistry.sstp_chem_loop(cfg, state, dt,
                                             True, True, True)
        return state

    return step


def sharded_async_step(cfg: StaticConfig, sstp_coal: int, buf: int,
                       switches=(True, True, True, False, False, False,
                                 False, False),
                       axis_name: str = "x"):
    """The per-shard transport phase with neighbour migration — the body to
    run under shard_map: the FULL step_async process set of the reference
    (particles_step.ipp:339-494: coalescence, SGS turbulence, advection,
    turbulent displacement, sedimentation, subsidence, walls, migration).

    ``switches`` mirrors the single-device _step_async_jit tuple:
    (coal, adve, sedi, subs, turb_adve, turb_cond, rcyc, turb_coal)."""
    (do_coal, do_adve, do_sedi, do_subs, do_turb_adve, do_turb_cond,
     do_rcyc, do_turb_coal) = switches

    def step(state: State, dom: ShardDomain, params, w_LS, sgs_mix_len, dt):
        state = hskpng.hskpng_Tpr(cfg, state)
        state = vterm_mod.hskpng_vterm_all(cfg, state)
        if do_coal:
            state = coalescence.coal(cfg, state, params, dt, sstp_coal,
                                     turb_coal=do_turb_coal)
        if do_turb_adve or do_turb_cond:
            state = turbulence.hskpng_tke(cfg, state, sgs_mix_len)
            state = turbulence.hskpng_turb_vel(
                cfg, state, sgs_mix_len, dt,
                only_vertical=not do_turb_adve)
            if do_turb_cond:
                state = turbulence.hskpng_turb_dot_ss(cfg, state)
        if do_adve:
            from ..lgrngn.enums import as_t
            if as_t(cfg.adve_scheme) == as_t.pred_corr:
                state = adve_pred_corr_sharded(cfg, state, dom, axis_name)
            else:
                state = transport.adve(cfg, state)
        if do_turb_adve:
            state = turbulence.turb_adve(cfg, state, dt)
        if do_sedi:
            state = transport.sedi(state, dt)
        if do_subs:
            state = transport.subs(cfg, state, w_LS, dt)
        # z walls + puddle are local; the x wrap happens globally through
        # migration, so open/periodic x is handled by the ring itself
        state = _bcnd_z_only(cfg, state)
        if do_rcyc:
            from ..lgrngn import recycle
            state = recycle.rcyc(cfg, state)
        state = migrate(cfg, state, dom, buf, axis_name)
        return state

    return step


def make_mesh(n_devices=None):
    devs = jax.devices()
    if n_devices is not None:
        devs = devs[:n_devices]
    return Mesh(np.array(devs), axis_names=("x",))


def state_specs():
    """A State-shaped pytree of sharding specs: 1-D leaves shard on axis 0,
    the (species, n) chemistry leaves on axis 1."""
    specs = {f.name: P("x") for f in dataclasses.fields(State)}
    for nm in ("chem", "ambient_chem", "sstp_tmp_chem"):
        specs[nm] = P(None, "x")
    return State(**specs)


def build_multichip_step(mesh: Mesh, cfg: StaticConfig, sstp_coal=1,
                         buf=None, switches=None):
    """Assemble the full jitted multi-chip SDM step: courant halos + sharded
    condensation (local) + full transport with ring migration.  Returns
    (step_fn, cfg_local); ``step_fn(state, dom, params, w_LS, sgs_mix_len,
    dt, RH_max)`` expects a State whose per-SD and per-cell leaves are
    sharded along the mesh "x" axis and ``dom`` built from shard_domains."""
    n_shards = mesh.devices.size
    cfg_l = local_config(cfg, n_shards)
    buf = buf or max(16, cfg_l.n_sd_max // 4)
    if switches is None:
        switches = (cfg.coal_switch, True, cfg.sedi_switch, False, False,
                    False, False, False)

    sync = sharded_sync_step(cfg_l)
    async_ = sharded_async_step(cfg_l, sstp_coal, buf, switches)

    def whole_step(state, dom, params, w_LS, sgs_mix_len, dt, RH_max):
        state = sync(state, dt, RH_max, dom)
        state = async_(state, dom, params, w_LS, sgs_mix_len, dt)
        return state

    spec_state = state_specs()
    dom_spec = ShardDomain(lo=P("x"), hi=P("x"), nxl=P("x"))
    step = jax.jit(
        jax.shard_map(
            whole_step,
            mesh=mesh,
            in_specs=(spec_state, dom_spec, P(), P(), P(), P(), P()),
            out_specs=spec_state,
        )
    )
    return step, cfg_l


def replicate_state_for_mesh(cfg: StaticConfig, mesh: Mesh, state_builder,
                             widths=None):
    """Host-side helper: build each shard's local state with
    ``state_builder(shard_index, cfg_local)`` and concatenate into global
    arrays laid out for axis-0 "x" sharding."""
    n_shards = mesh.devices.size
    cfg_l = local_config(cfg, n_shards, widths)
    locals_ = [state_builder(s, cfg_l) for s in range(n_shards)]

    spec = state_specs()

    def cat(sp, *leaves):
        axis = 1 if (len(sp) > 1 and sp[0] is None) else 0
        return jnp.concatenate([jnp.atleast_1d(l) for l in leaves],
                               axis=axis)

    merged = jax.tree_util.tree_map(cat, spec, *locals_)
    return global_put(
        merged,
        jax.tree_util.tree_map(lambda s: NamedSharding(mesh, s), spec),
    )


def global_put(tree, shardings):
    """device_put a host-value pytree with NamedShardings, working in BOTH
    single-controller and multi-controller (multi-process) runs.

    Multi-controller jax.device_put cannot target shardings that span
    non-addressable devices; there every process holds the SAME full host
    value (the front-end's init/sync are deterministic), so each builds the
    global array from its addressable portion via make_array_from_callback
    (the reference analog: every MPI rank computes its own slab of the same
    global initial condition, mpi_adve_test.cpp:92-110)."""
    import numpy as np
    if jax.process_count() == 1:
        return jax.device_put(tree, shardings)

    def one(x, s):
        if isinstance(x, jax.Array) and not x.is_fully_addressable:
            # already a global array (e.g. untouched state leaves inside a
            # dataclasses.replace): reshard with a compiled identity —
            # multi-controller-legal, unlike host fetching or device_put.
            # Zero-size leaves pass through (XLA normalises them to
            # replicated; any sharding is equivalent).
            if x.size == 0 or x.sharding.is_equivalent_to(s, x.ndim):
                return x
            return jax.jit(lambda a: a, out_shardings=s)(x)
        a = np.asarray(x)
        return jax.make_array_from_callback(a.shape, s,
                                            lambda idx: a[idx])
    return jax.tree_util.tree_map(one, tree, shardings)


def device_put_domains(cfg: StaticConfig, mesh: Mesh, widths=None):
    """ShardDomain for the mesh, device_put with "x" sharding."""
    lo, hi, nxl = shard_domains(cfg, mesh.devices.size, widths)
    dom = ShardDomain(lo=jnp.asarray(lo), hi=jnp.asarray(hi),
                      nxl=jnp.asarray(nxl))
    return global_put(
        dom, jax.tree_util.tree_map(
            lambda _: NamedSharding(mesh, P("x")), dom))
