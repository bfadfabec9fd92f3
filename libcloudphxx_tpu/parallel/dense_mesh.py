"""The dense cell-major engine on the device mesh (x-slab sharding).

The occupancy matrix (n_cell, cap) is row-major in cells with x outermost,
so an x slab is a contiguous row range: each shard owns a padded local
matrix (nx_pad*nz rows, cap) in LOCAL coordinates, exactly mirroring the
flat mesh layout (parallel/decomp.py).  Everything in the dense step is
row-local — condensation, coalescence, advection, sedimentation, z walls —
so the only distributed piece is the post-transport re-binning:

  1. cross-shard movers (x < lo or x >= hi; possible only in the two live
     edge columns under CFL <= 1 + the half-cell domain crop) are extracted
     from the edge-column row blocks into fixed-capacity buffers, re-based
     (the flat migrate()'s rmt + x - lcl rule, reference pack.ipp:14-27),
     and ring-`ppermute`d — the dense analog of the reference's
     MPI/P2P particle exchange (mpi_exchange.ipp:20-331),
  2. the remaining population re-bins with the serial CFL-bounded
     neighbour-row exchange (lgrngn/dense._rebin_neighbor) unchanged,
  3. arrivals scatter into the free lanes of their target rows (a
     buffer-sized scatter, not a population-sized one).

Buffer overflow and row overflow are counted loudly, like the flat mesh.
"""

import dataclasses

import jax
import jax.numpy as jnp

from ..lgrngn import dense, hskpng
from ..lgrngn.dense import _ATTRS, DenseState
from ..lgrngn.state import StaticConfig
from .decomp import ShardDomain


def _edge_rows(mat, nz, nxl, n_edge):
    """Rows of the first ``n_edge`` live columns and the last ``n_edge``
    live columns: (2*n_edge*nz, cap).  nxl is dynamic (uneven slabs); the
    two blocks are kept DISJOINT (narrow slabs would otherwise present the
    same mover twice): for nxl <= 2*n_edge the 'hi' block shifts right
    into padded (SD-free) columns and the 'lo' block alone covers the live
    ones — both mover masks are evaluated on the same concatenated rows,
    so movers in either direction are found wherever they sit."""
    lo_blk = jax.lax.dynamic_slice_in_dim(mat, 0, n_edge * nz, axis=0)
    start = jnp.maximum(n_edge, nxl - n_edge) * nz
    hi_blk = jax.lax.dynamic_slice_in_dim(mat, start, n_edge * nz, axis=0)
    return jnp.concatenate([lo_blk, hi_blk], axis=0)


def rebin_sharded(cfg_l: StaticConfig, d: DenseState, dom: ShardDomain,
                  buf: int, axis_name: str = "x") -> DenseState:
    """Distributed re-binning after transport (see module docstring).

    ``d`` holds post-transport positions in local coordinates, NOT
    x-wrapped (adve_sedi_bcnd must run with x_wrap=False on the mesh).
    ``buf`` is the per-direction mover capacity."""
    nz = cfg_l.nz
    cap = d.cap
    n_cell = cfg_l.n_cell
    n_shards = jax.lax.psum(1, axis_name)
    lo, hi, nxl = dom.lo[0], dom.hi[0], dom.nxl[0]
    perm_r = [(i, (i + 1) % n_shards) for i in range(n_shards)]
    perm_l = [(i, (i - 1) % n_shards) for i in range(n_shards)]
    lo_next = jax.lax.ppermute(dom.lo, axis_name, perm_l)[0]
    hi_prev = jax.lax.ppermute(dom.hi, axis_name, perm_r)[0]

    planes = {a: getattr(d, a) for a in _ATTRS}
    alive = planes["n"] > 0
    go_l = alive & (planes["x"] < lo)
    go_r = alive & (planes["x"] >= hi)
    if cfg_l.open_side_walls:
        # SDs leaving the GLOBAL domain die instead of riding the ring
        idx0 = jax.lax.axis_index(axis_name)
        kill = (go_l & (idx0 == 0)) | (go_r & (idx0 == n_shards - 1))
        planes["n"] = jnp.where(kill, 0.0, planes["n"])
        alive = planes["n"] > 0
        go_l = alive & (planes["x"] < lo)
        go_r = alive & (planes["x"] >= hi)

    # ---- extract movers from the edge-column row blocks (2 live columns
    # per side cover CFL <= 1 plus the half-cell crop; narrow slabs fall
    # back to 1 and any mover outside the blocks is counted loudly in the
    # overflow below)
    n_edge = min(2, cfg_l.nx // 2) or 1
    blk = {a: _edge_rows(planes[a], nz, nxl, n_edge) for a in _ATTRS}
    blk_go_l = _edge_rows(go_l, nz, nxl, n_edge).reshape(-1)
    blk_go_r = _edge_rows(go_r, nz, nxl, n_edge).reshape(-1)

    def pack(mask, shift):
        order = jnp.argsort(~mask)
        idx = order[:buf]
        valid = mask[idx]
        payload = {}
        for a in _ATTRS:
            v = blk[a].reshape(-1)[idx]
            if a == "x":
                v = v + shift
            payload[a] = jnp.where(valid, v, 0.0)
        overflow = jnp.maximum(jnp.sum(mask) - buf, 0)
        return payload, overflow

    pay_l, ovf_l = pack(blk_go_l, hi_prev - lo)
    pay_r, ovf_r = pack(blk_go_r, lo_next - hi)

    # remove ALL movers locally (also any outside the edge blocks — none
    # under CFL, but a long sedimentation jump must not silently stay)
    lost_long = jnp.sum(jnp.where((go_l | go_r), 1, 0)) \
        - jnp.sum(jnp.where(blk_go_l | blk_go_r, 1, 0))
    planes["n"] = jnp.where(go_l | go_r, 0.0, planes["n"])

    # ---- local re-binning of the remaining population (the serial
    # CFL-bounded neighbour exchange, with its global-sort fallback for
    # long in-slab jumps)
    d = dataclasses.replace(d, **planes)
    d = dense.rebin(cfg_l, d)

    # ---- ring exchange + arrival injection
    arr_l = jax.tree_util.tree_map(
        lambda a: jax.lax.ppermute(a, axis_name, perm_r), pay_r)
    arr_r = jax.tree_util.tree_map(
        lambda a: jax.lax.ppermute(a, axis_name, perm_l), pay_l)

    arr = {a: jnp.concatenate([arr_l[a], arr_r[a]]) for a in _ATTRS}
    a_alive = arr["n"] > 0
    row = hskpng.ijk_of_xyz(cfg_l, arr["x"], arr["x"],
                            arr["z"]).astype(jnp.int32)
    row = jnp.where(a_alive, row, n_cell)

    occ = jnp.sum(jnp.where(d.n > 0, 1, 0), axis=1)
    # rank among same-row arrivals (stable): count earlier equal rows
    m = 2 * buf
    same = (row[:, None] == row[None, :]) & (
        jnp.arange(m)[None, :] < jnp.arange(m)[:, None])
    rank = jnp.sum(jnp.where(same, 1, 0), axis=1)
    lane = jnp.where(row < n_cell, occ[jnp.minimum(row, n_cell - 1)], 0) \
        + rank
    flat_idx = jnp.where(a_alive & (lane < cap) & (row < n_cell),
                         row * cap + lane, n_cell * cap)
    inj_ovf = jnp.sum(jnp.where(a_alive & (lane >= cap), 1, 0))

    upd = {}
    for a in _ATTRS:
        upd[a] = getattr(d, a).reshape(-1).at[flat_idx].set(
            arr[a], mode="drop").reshape(n_cell, cap)
    return dataclasses.replace(
        d, overflow=d.overflow + ovf_l + ovf_r + lost_long + inj_ovf, **upd)


def dense_specs():
    """DenseState-shaped pytree of PartitionSpecs for the x-slab mesh."""
    from jax.sharding import PartitionSpec as P
    return DenseState(
        n=P("x", None), rw2=P("x", None), rd3=P("x", None),
        kpa=P("x", None), vt=P("x", None), x=P("x", None), z=P("x", None),
        y=P(),                      # 2-D mesh: empty plane, replicated
        rhod=P("x"), p=P("x"), T=P("x"), RH=P("x"), eta=P("x"), dv=P("x"),
        sstp_tmp_th=P("x"), sstp_tmp_rv=P("x"),
        courant_x=P("x"), courant_y=P(), courant_z=P("x"),
        key=P("x"), puddle=P("x"), overflow=P("x"),
        # exact-substepping planes: a serial-engine feature, empty on the
        # mesh (guarded in dense_step_sharded)
        sd_th=P(), sd_rv=P(), sd_rh=P(), sd_p=P())


def scatter_dense(cfg: StaticConfig, d: DenseState, n_shards: int,
                  widths=None) -> DenseState:
    """Host-side: global-coordinate DenseState -> concatenated padded
    x-slab layout (shard with dense_specs; the inverse of gather_dense).

    Mirrors multi._shard_state for the flat engine: uneven slabs pad to
    the widest, x re-bases to slab-local coordinates, padded columns copy
    the slab's last live column's cell values (safe, SD-free)."""
    import numpy as np
    from .decomp import slab_widths

    nz = max(1, cfg.nz)
    widths = widths or slab_widths(cfg.nx, n_shards)
    nx_pad = max(widths)
    offs = np.concatenate([[0], np.cumsum(widths)])[:-1]
    cap = d.cap

    def rows(mat, fill_like=True):
        mat = np.asarray(mat)
        out = np.zeros((n_shards, nx_pad * nz) + mat.shape[1:], mat.dtype)
        for s, (off, w) in enumerate(zip(offs, widths)):
            out[s, :w * nz] = mat[off * nz:(off + w) * nz]
            if fill_like and w < nx_pad:
                out[s, w * nz:] = np.tile(
                    mat[(off + w - 1) * nz:(off + w) * nz],
                    (nx_pad - w,) + (1,) * (mat.ndim - 1))
        return out.reshape((-1,) + mat.shape[1:])

    upd = {}
    for a in _ATTRS:
        upd[a] = jnp.asarray(rows(getattr(d, a), fill_like=False))
    # slab-local x
    xs = np.asarray(upd["x"]).reshape(n_shards, nx_pad * nz, cap).copy()
    ns = np.asarray(upd["n"]).reshape(n_shards, nx_pad * nz, cap)
    for s, off in enumerate(offs):
        xs[s] = np.where(ns[s] > 0, xs[s] - off * cfg.dx, 0.0)
    upd["x"] = jnp.asarray(xs.reshape(-1, cap))

    for a in ("rhod", "p", "T", "RH", "eta", "dv", "sstp_tmp_th",
              "sstp_tmp_rv"):
        upd[a] = jnp.asarray(rows(getattr(d, a)))

    # staggered courants (multi._pad_courant_{x,z} conventions)
    gx = np.asarray(d.courant_x).reshape(cfg.nx + 1, nz)
    cx = np.zeros((n_shards, nx_pad + 1, nz))
    for s, (off, w) in enumerate(zip(offs, widths)):
        cx[s, :w + 1] = gx[off:off + w + 1]
    gz = np.asarray(d.courant_z).reshape(cfg.nx, nz + 1)
    cz = np.zeros((n_shards, nx_pad, nz + 1))
    for s, (off, w) in enumerate(zip(offs, widths)):
        cz[s, :w] = gz[off:off + w]

    keys = np.stack([np.asarray(jax.random.fold_in(d.key, s))
                     for s in range(n_shards)])
    return DenseState(
        y=jnp.zeros((0, 0), np.asarray(d.x).dtype),
        courant_x=jnp.asarray(cx.reshape(-1)),
        courant_y=jnp.zeros((0,)),
        courant_z=jnp.asarray(cz.reshape(-1)),
        key=jnp.asarray(keys.reshape(-1)),
        puddle=jnp.zeros((n_shards * np.asarray(d.puddle).shape[0],),
                         np.asarray(d.puddle).dtype),
        overflow=jnp.zeros((n_shards,), np.asarray(d.overflow).dtype),
        **upd)


def pad_cell_field(cfg: StaticConfig, arr, n_shards: int, widths=None):
    """Global (n_cell,) cell field -> concatenated padded slab layout
    (n_shards*nx_pad*nz,), padded columns copying the last live column."""
    import numpy as np
    from .decomp import slab_widths
    nz = max(1, cfg.nz)
    widths = widths or slab_widths(cfg.nx, n_shards)
    nx_pad = max(widths)
    offs = np.concatenate([[0], np.cumsum(widths)])[:-1]
    g = np.asarray(arr).reshape(cfg.nx, nz)
    out = np.zeros((n_shards, nx_pad, nz), g.dtype)
    for s, (off, w) in enumerate(zip(offs, widths)):
        out[s, :w] = g[off:off + w]
        out[s, w:] = g[off + w - 1]
    return jnp.asarray(out.reshape(-1))


def unpad_cell_field(cfg: StaticConfig, arr, n_shards: int, widths=None):
    """Inverse of pad_cell_field."""
    import numpy as np
    from .decomp import slab_widths
    nz = max(1, cfg.nz)
    widths = widths or slab_widths(cfg.nx, n_shards)
    nx_pad = max(widths)
    a = np.asarray(arr).reshape(n_shards, nx_pad, nz)
    return np.concatenate(
        [a[s, :w] for s, w in enumerate(widths)], axis=0).reshape(-1)


def gather_dense(cfg: StaticConfig, dm: DenseState, n_shards: int,
                 widths=None):
    """Host-side inverse of scatter_dense: (alive multiset of the global
    population as dict of flat arrays incl. global cell, plus puddle sum
    and total overflow)."""
    import numpy as np
    from .decomp import slab_widths

    nz = max(1, cfg.nz)
    widths = widths or slab_widths(cfg.nx, n_shards)
    nx_pad = max(widths)
    offs = np.concatenate([[0], np.cumsum(widths)])[:-1]
    cap = dm.cap

    out = {a: [] for a in _ATTRS}
    cells = []
    for s, (off, w) in enumerate(zip(offs, widths)):
        sl = slice(s * nx_pad * nz, s * nx_pad * nz + w * nz)
        n = np.asarray(dm.n)[sl]
        alive = n > 0
        rows_l = np.repeat(np.arange(w * nz), cap).reshape(w * nz, cap)
        for a in _ATTRS:
            v = np.asarray(getattr(dm, a))[sl][alive]
            if a == "x":
                v = v + off * cfg.dx
            out[a].append(v)
        cells.append((rows_l + off * nz)[alive])
    res = {a: np.concatenate(v) for a, v in out.items()}
    res["cell"] = np.concatenate(cells)
    n_pud = np.asarray(dm.puddle).size // n_shards
    res["puddle"] = np.asarray(dm.puddle).reshape(n_shards, n_pud).sum(0)
    res["overflow"] = float(np.asarray(dm.overflow).sum())
    return res


def dense_step_sharded(cfg_l: StaticConfig, sstp_coal: int, buf: int,
                       do_coal: bool, do_sedi: bool, RH_max: float,
                       axis_name: str = "x"):
    """One full microphysics step on the sharded dense layout — the body to
    run under shard_map: percell condensation, coalescence, transport
    (x unwrapped), distributed re-binning.

    Returns step(d, th, rv, dom, params, dt) -> (d, th, rv)."""
    if cfg_l.exact_sstp_cond and (cfg_l.sstp_cond > 1
                                  or cfg_l.sstp_cond_act > 1):
        # the sharded migration payload does not carry the per-SD ambient
        # planes yet — refuse rather than migrate SDs with wrong snapshots
        raise NotImplementedError(
            "sharded dense engine: exact substepping not supported "
            "(flat particles_multi_t covers it)")

    def step(d: DenseState, th, rv, dom: ShardDomain, params, dt):
        d, thc, rvc = dense.step_cond(cfg_l, d, th, rv, dt, RH_max)
        row = lambda a: a[:, None]
        from ..lgrngn import vterm as vterm_mod
        vt = vterm_mod.vt_of(cfg_l, d.rw2, row(d.T), row(d.p),
                             row(d.rhod), row(d.eta))
        d = dataclasses.replace(d, vt=vt)
        if do_coal:
            d = dense.coal(cfg_l, d, params, dt, sstp_coal)
        d = dense.adve_sedi_bcnd(cfg_l, d, dt, do_sedi, x_wrap=False)
        d = rebin_sharded(cfg_l, d, dom, buf, axis_name)
        return d, thc, rvc

    return step
