"""particles_multi_t — the multi-device SDM front-end.

JAX equivalent of the reference's multi_CUDA backend
(src/impl_multi_gpu/particles_multi_gpu_impl.ipp:35-227 + the diag
reductions in particles_multi_gpu_diag.ipp): one particles_proto_t that
fans the domain out over a `jax.sharding.Mesh` x axis.  Where the reference
spawns a std::thread + particles_t<CUDA> per GPU and hand-rolls P2P halo
copies, here the whole step is ONE shard_map'd XLA program per phase and the
exchanges are `ppermute` collectives (parallel/decomp.py).

Semantics mirror the reference:
  - construction-time slab split of nx, remainder spread from the left
    (distmem_opts.hpp) — uneven nx is fine,
  - init happens globally (identical SD population to the serial backend),
    then the population is scattered to its slabs in local coordinates,
  - step_sync / step_cond / step_async keep the particles_proto_t contract,
  - diag moments come back as the stitched global field (outbuf), and
    diag_puddle sums the per-shard accumulators
    (particles_multi_gpu_diag.ipp:14-68).

Aerosol source/relaxation run with exact full-domain semantics through a
gather -> serial host phase -> re-scatter cycle (better than the reference
multi_CUDA, which degrades relaxation to per-GPU local means with a warning,
particles_multi_gpu_ctor.ipp:41).  Aqueous chemistry is fully sharded: chem
attrs split on axis 1, trace gases per slab, dissolved masses ride the
migration payload (the reference's MPI backend forbids chemistry,
init_sanity_check.ipp:131 — the mesh does not need to).  pred_corr SD
advection runs sharded through the halo-2 courant exchange
(decomp._xchng_courants_pc, mirroring xchng_courants.ipp:207-320 with
halo_size == 2); it requires every slab to be at least 2 cells wide.
"""

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import NamedSharding, PartitionSpec as P

from ..lgrngn import hskpng
from ..lgrngn.particles import particles_t
from ..lgrngn.state import PUDDLE_KEYS, State, StaticConfig
from ..lgrngn.enums import as_t, backend_t
from . import decomp


class particles_multi_t(particles_t):
    def __init__(self, backend, opts_init, n_devices=None):
        super().__init__(backend, opts_init)
        n_dev = n_devices or int(opts_init.dev_count) or len(jax.devices())
        if n_dev < 2:
            raise ValueError("particles_multi_t: need at least 2 devices")
        if len(jax.devices()) < n_dev:
            raise ValueError(
                f"particles_multi_t: {n_dev} devices requested but only "
                f"{len(jax.devices())} visible")
        if opts_init.nx < n_dev:
            raise ValueError("particles_multi_t: nx smaller than the mesh")
        if self.cfg.adve_scheme == as_t.pred_corr.value:
            # halo-2 exchange needs two live faces per slab
            # (decomp._xchng_courants_pc; reference particles_impl.ipp:
            # 361-371 sizes its halos the same way)
            if min(decomp.slab_widths(self.cfg.nx, n_dev)) < 2:
                raise RuntimeError(
                    "libcloudphxx: pred_corr on a device mesh needs every "
                    "x slab at least 2 cells wide"
                )
        # aqueous chemistry is supported on the mesh (the reference's
        # multi_CUDA supports it too; only the MPI backend forbids it,
        # init_sanity_check.ipp:131) — chem attrs shard on axis 1 and ride
        # the migration payload
        # round the per-shard SD capacity up so n_sd_max shards evenly
        self._cap = math.ceil(self.cfg.n_sd_max / n_dev)
        cfg_pad = dataclasses.replace(self.cfg, n_sd_max=self._cap * n_dev)
        self.cfg_global = cfg_pad
        self.mesh = decomp.make_mesh(n_dev)
        self.n_shards = n_dev
        self.widths = decomp.slab_widths(self.cfg.nx, n_dev)
        self.offs = np.concatenate([[0], np.cumsum(self.widths)])[:-1]
        self.cfg_l = decomp.local_config(cfg_pad, n_dev, self.widths)
        self.nx_pad = self.cfg_l.nx
        self.dom = decomp.device_put_domains(cfg_pad, self.mesh, self.widths)
        self._sharding = jax.tree_util.tree_map(
            lambda s: NamedSharding(self.mesh, s), decomp.state_specs())
        self._shard_jits = {}

    # ------------------------------------------------------------- sharding
    def _pad_cell(self, arr, fill=None):
        """Global (n_cell,) -> padded sharded layout (n_shards*nx_pad*nyz,).
        Padded columns get the slab's last column (a safe, finite value)."""
        nyz = max(1, self.cfg.ny) * max(1, self.cfg.nz)
        g = np.asarray(arr, np.float64).reshape(self.cfg.nx, nyz)
        out = np.empty((self.n_shards, self.nx_pad, nyz))
        for s, (off, w) in enumerate(zip(self.offs, self.widths)):
            out[s, :w] = g[off:off + w]
            out[s, w:] = g[off + w - 1]
        return out.reshape(-1)

    def _unpad_cell(self, arr):
        nyz = max(1, self.cfg.ny) * max(1, self.cfg.nz)
        a = np.asarray(arr).reshape(self.n_shards, self.nx_pad, nyz)
        return np.concatenate(
            [a[s, :w] for s, w in enumerate(self.widths)], axis=0
        ).reshape(-1)

    def _pad_courant_x(self, arr):
        """Global ((nx+1)*nyz,) -> per-shard (nx_pad+1)*nyz with the right
        halo face filled from the neighbour (the host-side equivalent of
        xchng_courants — the device-side ppermute refreshes it each sync)."""
        nyz = max(1, self.cfg.ny) * max(1, self.cfg.nz)
        g = np.asarray(arr, np.float64).reshape(self.cfg.nx + 1, nyz)
        out = np.zeros((self.n_shards, self.nx_pad + 1, nyz))
        for s, (off, w) in enumerate(zip(self.offs, self.widths)):
            out[s, :w + 1] = g[off:off + w + 1]
        return out.reshape(-1)

    def _pad_courant_z(self, arr):
        if self.cfg.n_dims <= 1:
            return np.asarray(arr)
        nyz1 = max(1, self.cfg.ny) * (max(1, self.cfg.nz) + 1)
        g = np.asarray(arr, np.float64).reshape(self.cfg.nx, nyz1)
        out = np.zeros((self.n_shards, self.nx_pad, nyz1))
        for s, (off, w) in enumerate(zip(self.offs, self.widths)):
            out[s, :w] = g[off:off + w]
        return out.reshape(-1)

    def _pad_courant_y(self, arr):
        if self.cfg.n_dims != 3:
            return np.asarray(arr)
        ny1z = (self.cfg.ny + 1) * max(1, self.cfg.nz)
        g = np.asarray(arr, np.float64).reshape(self.cfg.nx, ny1z)
        out = np.zeros((self.n_shards, self.nx_pad, ny1z))
        for s, (off, w) in enumerate(zip(self.offs, self.widths)):
            out[s, :w] = g[off:off + w]
        return out.reshape(-1)

    def _unpad_courant_x(self, arr):
        nyz = max(1, self.cfg.ny) * max(1, self.cfg.nz)
        a = np.asarray(arr).reshape(self.n_shards, self.nx_pad + 1, nyz)
        g = np.zeros((self.cfg.nx + 1, nyz))
        for s, (off, w) in enumerate(zip(self.offs, self.widths)):
            g[off:off + w + 1] = a[s, :w + 1]
        return g.reshape(-1)

    def _unpad_courant_z(self, arr):
        if self.cfg.n_dims <= 1:
            return np.asarray(arr)
        nyz1 = max(1, self.cfg.ny) * (max(1, self.cfg.nz) + 1)
        a = np.asarray(arr).reshape(self.n_shards, self.nx_pad, nyz1)
        return np.concatenate(
            [a[s, :w] for s, w in enumerate(self.widths)], axis=0
        ).reshape(-1)

    def _unpad_courant_y(self, arr):
        if self.cfg.n_dims != 3:
            return np.asarray(arr)
        ny1z = (self.cfg.ny + 1) * max(1, self.cfg.nz)
        a = np.asarray(arr).reshape(self.n_shards, self.nx_pad, ny1z)
        return np.concatenate(
            [a[s, :w] for s, w in enumerate(self.widths)], axis=0
        ).reshape(-1)

    def _gather_state(self) -> State:
        """Sharded local-coordinate state -> one global-coordinate State —
        the inverse of _shard_state.  Used to run the host-RNG phases
        (aerosol source / CCN relaxation) with exact full-domain semantics:
        the reference's multi_CUDA degrades relaxation to per-GPU local
        means with a warning (particles_multi_gpu_ctor.ipp:41); a
        single-process mesh can afford the exact global pass instead."""
        cfg = self.cfg
        nyz = max(1, cfg.ny) * max(1, cfg.nz)
        st = self.state
        per_sd_attrs = decomp.migrating_attrs(cfg) + ("ijk",)
        n2 = np.asarray(st.n).reshape(self.n_shards, self._cap)
        alive = n2 > 0
        out = {}
        for f in dataclasses.fields(State):
            name = f.name
            v = np.asarray(getattr(st, name))
            if name in per_sd_attrs and v.size:
                vv = v.reshape(self.n_shards, self._cap)
                if name == "x":
                    vv = np.where(alive, vv + (self.offs * cfg.dx)[:, None],
                                  0.0)
                elif name == "ijk":
                    vv = np.where(alive, vv + (self.offs * nyz)[:, None], 0)
                out[name] = jnp.asarray(vv.reshape(-1))
            elif name == "chem":
                if cfg.chem_switch and v.size:
                    vv = v.reshape(8, self.n_shards, self._cap)
                    out[name] = jnp.asarray(
                        np.where(alive[None], vv, 0.0).reshape(8, -1))
                else:
                    out[name] = jnp.zeros((8, 0))
            elif name in ("ambient_chem", "sstp_tmp_chem"):
                if cfg.chem_switch and v.size:
                    out[name] = jnp.asarray(np.stack(
                        [self._unpad_cell(row)
                         for row in v.reshape(6, -1)]))
                else:
                    out[name] = jnp.zeros((6, 0))
            elif name == "key":
                out[name] = jnp.asarray(v.reshape(self.n_shards, -1)[0])
            elif name == "puddle":
                out[name] = jnp.asarray(
                    v.reshape(self.n_shards, -1).sum(axis=0))
            elif name == "courant_x":
                out[name] = jnp.asarray(self._unpad_courant_x(v))
            elif name == "courant_y":
                out[name] = (jnp.asarray(self._unpad_courant_y(v))
                             if cfg.n_dims == 3
                             else jnp.zeros((0,)))
            elif name == "courant_z":
                out[name] = (jnp.asarray(self._unpad_courant_z(v))
                             if cfg.n_dims > 1 else jnp.zeros((0,)))
            elif v.size == 0:
                out[name] = jnp.zeros((0,))
            else:  # per-cell arrays
                out[name] = jnp.asarray(self._unpad_cell(v))
        return State(**out)

    def _shard_state(self, g: State) -> State:
        """Scatter a global-coordinate state into the sharded local layout
        (the reference's per-GPU slab scatter, multi_gpu_impl.ipp:35-181)."""
        cfg = self.cfg
        nyz = max(1, cfg.ny) * max(1, cfg.nz)
        n = np.asarray(g.n)
        ijk = np.asarray(g.ijk)
        i_cell = ijk // nyz
        shard = np.searchsorted(np.cumsum(self.widths), i_cell, side="right")
        shard = np.where(n > 0, shard, -1)

        per_sd = {}
        counts = [(shard == s).sum() for s in range(self.n_shards)]
        if max(counts) > self._cap:
            raise RuntimeError(
                f"libcloudphxx: shard SD count {max(counts)} exceeds the "
                f"per-device capacity {self._cap}; raise n_sd_max"
            )
        sel = [np.nonzero(shard == s)[0] for s in range(self.n_shards)]
        per_sd_attrs = decomp.migrating_attrs(self.cfg) + ("ijk",)
        for f in dataclasses.fields(State):
            name = f.name
            v = np.asarray(getattr(g, name))
            if v.size == 0:
                per_sd[name] = jnp.asarray(v)
            elif name in per_sd_attrs:
                out = np.zeros((self.n_shards, self._cap), v.dtype)
                for s in range(self.n_shards):
                    vv = v[sel[s]]
                    if name == "x":
                        vv = vv - self.offs[s] * cfg.dx
                    elif name == "ijk":
                        # local ravel keeps the i-stride (ny*nz), so the
                        # slab shift is a plain offset (i outermost)
                        vv = vv - self.offs[s] * nyz
                    out[s, :counts[s]] = vv
                per_sd[name] = jnp.asarray(out.reshape(-1))
            elif name == "chem":
                if cfg.chem_switch and v.size:
                    out = np.zeros((8, self.n_shards, self._cap), v.dtype)
                    for s in range(self.n_shards):
                        out[:, s, :counts[s]] = v[:, sel[s]]
                    per_sd[name] = jnp.asarray(out.reshape(8, -1))
                else:
                    per_sd[name] = jnp.zeros((8, 0))
            elif name == "key":
                keys = np.stack([
                    np.asarray(jax.random.fold_in(g.key, s))
                    for s in range(self.n_shards)])
                per_sd[name] = jnp.asarray(keys.reshape(-1))
            elif name == "puddle":
                per_sd[name] = jnp.zeros(
                    (self.n_shards * np.asarray(g.puddle).shape[0],))
            elif name == "courant_x":
                per_sd[name] = jnp.asarray(self._pad_courant_x(v))
            elif name == "courant_y":
                per_sd[name] = (jnp.asarray(self._pad_courant_y(v))
                                if self.cfg.n_dims == 3
                                else jnp.asarray(np.zeros((0,))))
            elif name == "courant_z":
                per_sd[name] = jnp.asarray(self._pad_courant_z(v))
            elif name in ("ambient_chem", "sstp_tmp_chem"):
                if cfg.chem_switch and v.size:
                    per_sd[name] = jnp.asarray(np.stack(
                        [self._pad_cell(row) for row in v.reshape(6, -1)]))
                else:
                    per_sd[name] = jnp.zeros((6, 0))
            elif name == "sstp_tmp_p" and v.size == 0:
                per_sd[name] = jnp.zeros((0,))
            else:  # per-cell arrays
                per_sd[name] = jnp.asarray(self._pad_cell(v))
        merged = State(**per_sd)
        return decomp.global_put(merged, self._sharding)

    # ------------------------------------------------------------------ init
    def init(self, th, rv, rhod, p=None, courant_x=None, courant_y=None,
             courant_z=None, ambient_chem=None, Cx=None, Cy=None, Cz=None):
        super().init(th, rv, rhod, p=p, courant_x=courant_x,
                     courant_y=courant_y, courant_z=courant_z,
                     ambient_chem=ambient_chem, Cx=Cx, Cy=Cy, Cz=Cz)
        # scatter the global population to its slabs (each shard holds a
        # fixed capacity of self._cap slots)
        self.state = self._shard_state(self.state)

    # ------------------------------------------------ sharded device hooks
    def _shmap(self, name, fn, n_extra, cell_out=False):
        """Cache a shard_map'd jit of fn(state, *extras)."""
        key = name
        if key not in self._shard_jits:
            spec = decomp.state_specs()
            out_spec = P("x") if cell_out else spec
            wrapped = jax.jit(jax.shard_map(
                fn, mesh=self.mesh,
                in_specs=(spec,) + (P(),) * n_extra,
                out_specs=out_spec,
            ))
            self._shard_jits[key] = wrapped
        return self._shard_jits[key]

    def _step_cond_impl(self, state, dt, RH_max, turb_cond, ice_nucl,
                        do_cond, var_rho=False):
        from ..lgrngn.particles import step_cond_body
        cfg_l = self._cfg_for_dt(self.cfg_l, dt)

        def fn(st, dom_, dt_, rhmax):
            # courant-halo refresh (sync_in's xchng_courants), then the
            # SAME condensation body the serial backend runs — features
            # added to step_cond_body automatically reach the mesh
            st = decomp.xchng_courants(cfg_l, st, dom_)
            return step_cond_body(cfg_l, st, dt_, rhmax, turb_cond,
                                  ice_nucl, do_cond, var_rho)

        key = ("cond", turb_cond, ice_nucl, do_cond, var_rho,
               cfg_l.sstp_cond, cfg_l.sstp_cond_act)
        if key not in self._shard_jits:
            spec = decomp.state_specs()
            dom_spec = decomp.ShardDomain(lo=P("x"), hi=P("x"), nxl=P("x"))
            self._shard_jits[key] = jax.jit(jax.shard_map(
                fn, mesh=self.mesh,
                in_specs=(spec, dom_spec, P(), P()),
                out_specs=spec))
        return self._shard_jits[key](state, self.dom, dt, RH_max)

    def _step_chem_impl(self, state, dt, do_dsl, do_dsc, do_rct):
        from ..lgrngn import chemistry
        cfg_l = self._cfg_for_dt(self.cfg_l, dt)

        def fn(st, dt_):
            st = hskpng.hskpng_Tpr(cfg_l, st)
            return chemistry.sstp_chem_loop(cfg_l, st, dt_, do_dsl, do_dsc,
                                            do_rct)

        key = ("chem", do_dsl, do_dsc, do_rct, cfg_l.sstp_chem)
        if key not in self._shard_jits:
            spec = decomp.state_specs()
            self._shard_jits[key] = jax.jit(jax.shard_map(
                fn, mesh=self.mesh, in_specs=(spec, P()), out_specs=spec))
        return self._shard_jits[key](state, dt)

    def _chem_sync_out(self, ambient_chem):
        if not ambient_chem:
            return
        dev = np.asarray(self.state.ambient_chem)
        for key, arr in ambient_chem.items():
            np.asarray(arr).reshape(-1)[:] = self._unpad_cell(dev[int(key)])

    def _step_async_impl(self, sstp_coal, switches, state, params, w_LS,
                         sgs_mix_len, dt):
        cfg_l = self.cfg_l
        buf = max(16, self._cap // 4)
        step = decomp.sharded_async_step(cfg_l, sstp_coal, buf, switches)

        def fn(st, dom, params_, w_LS_, sgs_, dt_):
            return step(st, dom, params_, w_LS_, sgs_, dt_)

        key = ("async", sstp_coal, switches)
        if key not in self._shard_jits:
            spec = decomp.state_specs()
            dom_spec = decomp.ShardDomain(lo=P("x"), hi=P("x"), nxl=P("x"))
            self._shard_jits[key] = jax.jit(jax.shard_map(
                fn, mesh=self.mesh,
                in_specs=(spec, dom_spec, P(), P(), P(), P()),
                out_specs=spec,
            ))
        return self._shard_jits[key](state, self.dom, params, w_LS,
                                     sgs_mix_len, dt)

    def _tpr_impl(self):
        cfg_l = self.cfg_l
        return self._shmap(
            "tpr", lambda st: hskpng.hskpng_Tpr(cfg_l, st), 0)(self.state)

    def _moms_calc_impl(self, power, n_filtered, attr):
        cfg_l = self.cfg_l
        power = float(power)

        def fn(st, nf, at):
            return hskpng.segment_moment(
                cfg_l, nf, at, power, st.ijk,
                dv=st.dv, rhod=st.rhod, specific=True)

        key = ("moms", power)
        if key not in self._shard_jits:
            spec = decomp.state_specs()
            self._shard_jits[key] = jax.jit(jax.shard_map(
                fn, mesh=self.mesh,
                in_specs=(spec, P("x"), P("x")),
                out_specs=P("x")))
        return self._shard_jits[key](self.state, n_filtered, attr)

    def _sd_count_impl(self, n_filtered):
        cfg_l = self.cfg_l

        def fn(st, nf):
            return hskpng.sd_count_per_cell(cfg_l, nf, st.ijk)

        key = "sd_count"
        if key not in self._shard_jits:
            spec = decomp.state_specs()
            self._shard_jits[key] = jax.jit(jax.shard_map(
                fn, mesh=self.mesh, in_specs=(spec, P("x")),
                out_specs=P("x")))
        return self._shard_jits[key](self.state, n_filtered)

    def _segment_max_impl(self, vals):
        cfg_l = self.cfg_l

        def fn(st, v):
            mx = jax.ops.segment_max(v, st.ijk,
                                     num_segments=cfg_l.n_cell)
            return jnp.maximum(mx, 0.0)

        key = "segmax"
        if key not in self._shard_jits:
            spec = decomp.state_specs()
            self._shard_jits[key] = jax.jit(jax.shard_map(
                fn, mesh=self.mesh, in_specs=(spec, P("x")),
                out_specs=P("x")))
        return self._shard_jits[key](self.state, vals)

    def _mass_dens_impl(self, n_filtered, rad, sig0):
        from ..lgrngn.particles import _mass_dens_jit
        cfg_l = self.cfg_l

        def fn(st, nf, rad_, sig_):
            return _mass_dens_jit(cfg_l, st, nf, rad_, sig_)

        key = "mass_dens"
        if key not in self._shard_jits:
            spec = decomp.state_specs()
            self._shard_jits[key] = jax.jit(jax.shard_map(
                fn, mesh=self.mesh, in_specs=(spec, P("x"), P(), P()),
                out_specs=P("x")))
        return self._shard_jits[key](self.state, n_filtered,
                                     jnp.asarray(rad), jnp.asarray(sig0))

    def _precip_rate_impl(self, ice: bool):
        from ..lgrngn import vterm as vterm_mod
        cfg_l = self.cfg_l

        def fn(st, nf):
            st = hskpng.hskpng_Tpr(cfg_l, st)
            st = vterm_mod.hskpng_vterm_all(cfg_l, st)
            if ice:
                from ..lgrngn import ice as ice_mod
                vals = ice_mod.ice_mass(st.ice_a, st.ice_c, st.ice_rho)
            else:
                vals = st.rw2 ** 1.5
            return jax.ops.segment_sum(nf * vals * st.vt, st.ijk,
                                       num_segments=cfg_l.n_cell)

        key = ("precip", ice)
        if key not in self._shard_jits:
            spec = decomp.state_specs()
            self._shard_jits[key] = jax.jit(jax.shard_map(
                fn, mesh=self.mesh, in_specs=(spec, P("x")),
                out_specs=P("x")))
        return self._shard_jits[key](self.state, self._n_filtered)

    # ----------------------------------------------------- host data paths
    def sync_in(self, th=None, rv=None, rhod=None, courant_x=None,
                courant_y=None, courant_z=None, ambient_chem=None,
                diss_rate=None):
        if not self._init_called:
            raise RuntimeError(
                "libcloudphxx: please call init() before calling step_sync()"
            )
        if self._should_now_run_async:
            raise RuntimeError(
                "libcloudphxx: please call step_async() before calling "
                "step_sync() again"
            )
        n_cell = self.cfg.n_cell
        updates = {}
        from ..lgrngn.particles import _as_flat
        for name, arr in (("th", th), ("rv", rv), ("rhod", rhod),
                          ("diss_rate", diss_rate)):
            a = _as_flat(arr, n_cell, name)
            if a is not None:
                updates[name] = jnp.asarray(self._pad_cell(a))
        if courant_x is not None:
            updates["courant_x"] = jnp.asarray(self._pad_courant_x(
                np.asarray(courant_x, np.float64).reshape(-1)))
        if courant_y is not None:
            updates["courant_y"] = jnp.asarray(self._pad_courant_y(
                np.asarray(courant_y, np.float64).reshape(-1)))
        if courant_z is not None:
            updates["courant_z"] = jnp.asarray(self._pad_courant_z(
                np.asarray(courant_z, np.float64).reshape(-1)))
        if self.cfg.chem_switch or ambient_chem:
            gases = self._chem_updates(ambient_chem)
            if gases is not None:
                updates["ambient_chem"] = jnp.asarray(np.stack(
                    [self._pad_cell(row) for row in np.asarray(gases)]))
        if updates:
            self.state = decomp.global_put(
                dataclasses.replace(self.state, **updates), self._sharding)
        self._should_now_run_cond = True

    # ------------------------------------------ sharded source/relaxation
    # The reference multi_CUDA runs relaxation per-GPU on LOCAL means with a
    # warning (particles_multi_gpu_ctor.ipp:41) and windows the source per
    # domain (particles_step.ipp:452).  The mesh keeps the serial run's
    # exact GLOBAL semantics without gathering the population: cell fields
    # are stitched (small), population statistics are sharded device
    # reductions (integer-valued f64 sums — bit-identical to the host
    # bincount), and the host-RNG candidate stream is byte-identical to the
    # serial backend's, so serial and mesh create the same SDs.
    def _src_engine(self):
        self.state = self._tpr_impl()
        return MeshSrcEngine(self)

    def _rlx_counts_sharded(self, kappa_rng, rd3_edges):
        cfg_l = self.cfg_l
        nz = max(1, cfg_l.nz)
        nb = len(rd3_edges) - 1
        klo, khi = float(kappa_rng[0]), float(kappa_rng[1])
        key = ("rlx_counts", nb, klo, khi)
        if key not in self._shard_jits:
            spec = decomp.state_specs()

            def fn(st, edges):
                k = st.ijk % nz
                alive = st.n > 0
                in_k = alive & (st.kpa >= klo) & (st.kpa < khi)
                b = jnp.searchsorted(edges, st.rd3, side="right") - 1
                ok = in_k & (b >= 0) & (b < nb)
                idx = jnp.where(ok, b * nz + k, nb * nz)
                cnt = jax.ops.segment_sum(
                    jnp.where(ok, st.n, 0.0), idx,
                    num_segments=nb * nz + 1)[: nb * nz]
                return jax.lax.psum(cnt, "x")

            self._shard_jits[key] = jax.jit(jax.shard_map(
                fn, mesh=self.mesh, in_specs=(spec, P()), out_specs=P()))
        out = self._shard_jits[key](self.state, jnp.asarray(rd3_edges))
        return np.asarray(out).reshape(nb, nz)

    def _alive_counts(self):
        """Per-shard live-SD counts (S,) — cheap device reduction."""
        if "alive_counts" not in self._shard_jits:
            spec = decomp.state_specs()
            self._shard_jits["alive_counts"] = jax.jit(jax.shard_map(
                lambda st: jnp.sum(st.n > 0)[None],
                mesh=self.mesh, in_specs=(spec,), out_specs=P("x")))
        return np.asarray(self._shard_jits["alive_counts"](self.state))

    def _inject_sharded(self, new):
        """Scatter host candidate SDs (global coordinates) into their owner
        shards' dead slots — the mesh twin of source._inject."""
        from ..lgrngn.source import _fresh_attr_names
        n_new = int(np.asarray(new["n"]).size)
        if n_new == 0:
            return 0
        cfg = self.cfg
        nyz = max(1, cfg.ny) * max(1, cfg.nz)
        S = self.n_shards
        cells = np.asarray(new["ijk"], np.int64)
        shard = np.searchsorted(np.cumsum(self.widths), cells // nyz,
                                side="right")
        counts = np.bincount(shard, minlength=S)
        dead = self._cap - self._alive_counts()
        if (counts > dead).any():
            s = int(np.argmax(counts - dead))
            raise RuntimeError(
                f"lgrngn source: shard {s} needs {counts[s]} free slots "
                f"but has {dead[s]} (n_sd_max too small)")
        buf = int(max(1, counts.max()))
        attrs = tuple(a for a in _fresh_attr_names(self.cfg_l)
                      if getattr(self.state, a).size)
        payload = {a: np.zeros((S, buf)) for a in attrs}
        valid = np.zeros((S, buf), bool)
        fill = np.zeros(S, np.int64)
        for idx in np.argsort(shard, kind="stable"):
            s = shard[idx]
            l = fill[s]
            fill[s] += 1
            valid[s, l] = True
            for a in attrs:
                if a in new:
                    v = new[a][idx]
                    if a == "x":
                        v = v - self.offs[s] * cfg.dx
                    elif a == "ijk":
                        v = v - self.offs[s] * nyz
                    payload[a][s, l] = v

        jkey = ("inject", buf, attrs)
        if jkey not in self._shard_jits:
            spec = decomp.state_specs()
            n_sd_l = self.cfg_l.n_sd_max
            chem_on = self.cfg_l.chem_switch and self.state.chem.size

            def fn(st, valid_, *vals):
                dead_order = jnp.argsort(st.n > 0)  # dead slots first
                tgt = jnp.where(valid_, dead_order[:buf], n_sd_l)
                upd = {}
                for a, v in zip(attrs, vals):
                    arr = getattr(st, a)
                    upd[a] = arr.at[tgt].set(v.astype(arr.dtype),
                                             mode="drop")
                if chem_on:
                    upd["chem"] = st.chem.at[:, tgt].set(0.0, mode="drop")
                return dataclasses.replace(st, **upd)

            self._shard_jits[jkey] = jax.jit(jax.shard_map(
                fn, mesh=self.mesh,
                in_specs=(spec,) + (P("x"),) * (1 + len(attrs)),
                out_specs=spec))
        sh = NamedSharding(self.mesh, P("x"))
        dev_valid = decomp.global_put(jnp.asarray(valid.reshape(-1)), sh)
        dev_vals = [decomp.global_put(jnp.asarray(payload[a].reshape(-1)),
                                      sh)
                    for a in attrs]
        self.state = self._shard_jits[jkey](self.state, dev_valid,
                                            *dev_vals)
        return n_new

    def _put_state(self, state):
        return decomp.global_put(state, self._sharding)

    # ---------------------------------------------------------- diag output
    def _cell_to_host(self, arr):
        return self._unpad_cell(arr)

    def _cell_out(self, arr):
        return jnp.asarray(self._unpad_cell(arr))

    def _set_outbuf(self, per_cell):
        self._outbuf = self._unpad_cell(per_cell)

    def diag_puddle(self):
        self._require_init()
        vals = np.asarray(self.state.puddle).reshape(self.n_shards, -1)
        return dict(zip(PUDDLE_KEYS, vals.sum(axis=0).tolist()))

    def migration_overflow(self):
        """Total migration-buffer overflow count across shards (a loud
        health check; the reference hard-asserts its buffer capacity)."""
        from ..lgrngn.state import OUT_MIGRATION_OVERFLOW
        vals = np.asarray(self.state.puddle).reshape(self.n_shards, -1)
        return float(vals[:, OUT_MIGRATION_OVERFLOW].sum())

    def get_attr(self, name):
        self._require_init()
        v = super().get_attr(name)
        if name == "x":
            v = v.reshape(self.n_shards, self._cap) \
                + (self.offs * self.cfg.dx)[:, None]
            n = np.asarray(self.state.n).reshape(self.n_shards, self._cap)
            v = np.where(n > 0, v, 0.0).reshape(-1)
        return v


class MeshSrcEngine:
    """Sharded backend adapter for source/relaxation (see
    lgrngn.source.StateEngine for the contract): per-cell fields are
    stitched host arrays (n_cell-sized, cheap), population statistics are
    device psum reductions, and injection scatters candidates into their
    owner shards — the step path never gathers the O(n_sd_max) population
    (the reference keeps src/rlx distributed too,
    rlx_dry_distros.ipp:314)."""

    def __init__(self, prt):
        self.prt = prt
        self._cells = {}

    @property
    def state(self):
        return self.prt.state

    def cell(self, name):
        if name not in self._cells:
            self._cells[name] = self.prt._unpad_cell(
                np.asarray(getattr(self.prt.state, name)))
        return self._cells[name]

    def inject(self, new):
        from ..lgrngn.source import StateEngine
        new = StateEngine._augment_fresh(self, self.prt.cfg, new)
        return self.prt._inject_sharded(new)

    def rlx_counts(self, kappa_rng, rd3_edges):
        return self.prt._rlx_counts_sharded(kappa_rng, rd3_edges)

    def percell_population(self):
        """(n, rd3, kpa, ijk_global) in the flattened sharded layout (the
        matching source needs per-SD views; 4 arrays, not the full state)."""
        prt = self.prt
        nyz = max(1, prt.cfg.ny) * max(1, prt.cfg.nz)
        ijk = np.asarray(prt.state.ijk).reshape(prt.n_shards, prt._cap) \
            + (prt.offs * nyz)[:, None]
        return (np.asarray(prt.state.n), np.asarray(prt.state.rd3),
                np.asarray(prt.state.kpa),
                ijk.reshape(-1).astype(np.int64))

    def add_multiplicity(self, updates):
        prt = self.prt
        sh = NamedSharding(prt.mesh, P("x"))
        prt.state = dataclasses.replace(
            prt.state,
            n=prt.state.n + decomp.global_put(
                jnp.asarray(updates, np.asarray(prt.state.n).dtype), sh))
