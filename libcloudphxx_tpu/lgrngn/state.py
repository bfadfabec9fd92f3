"""SDM state containers — pytrees of fixed-capacity arrays.

JAX redesign of the reference's per-SD/per-cell device vectors
(reference src/impl/particles_impl.ipp:66-146).  Instead of resizable thrust
vectors with remove_if compaction, state lives in fixed-capacity (n_sd_max,)
arrays where multiplicity n == 0 marks a dead slot (the reference's
n==0-then-remove dance, hskpng_remove.ipp:20-80, becomes masking).  Everything
is a pytree, so the whole engine state jits, shards, and checkpoints as one
object.
"""

from dataclasses import dataclass, field, fields

import jax
import jax.numpy as jnp


@jax.tree_util.register_dataclass
@dataclass
class StaticConfig:
    """Hashable snapshot of the opts_init fields that shape the compiled
    program (grid geometry, substep counts, formula selections).  Passed as a
    static argument to every jitted kernel."""

    n_dims: int = field(metadata=dict(static=True))
    nx: int = field(metadata=dict(static=True))
    ny: int = field(metadata=dict(static=True))
    nz: int = field(metadata=dict(static=True))
    n_cell: int = field(metadata=dict(static=True))
    n_sd_max: int = field(metadata=dict(static=True))
    dx: float = field(metadata=dict(static=True))
    dy: float = field(metadata=dict(static=True))
    dz: float = field(metadata=dict(static=True))
    x0: float = field(metadata=dict(static=True))
    x1: float = field(metadata=dict(static=True))
    y0: float = field(metadata=dict(static=True))
    y1: float = field(metadata=dict(static=True))
    z0: float = field(metadata=dict(static=True))
    z1: float = field(metadata=dict(static=True))
    dt: float = field(metadata=dict(static=True))
    sstp_cond: int = field(metadata=dict(static=True))
    sstp_coal: int = field(metadata=dict(static=True))
    th_dry: bool = field(metadata=dict(static=True))
    const_p: bool = field(metadata=dict(static=True))
    RH_formula: int = field(metadata=dict(static=True))
    adve_scheme: int = field(metadata=dict(static=True))
    terminal_velocity: int = field(metadata=dict(static=True))
    kernel: int = field(metadata=dict(static=True))
    exact_sstp_cond: bool = field(metadata=dict(static=True))
    variable_dt: bool = field(metadata=dict(static=True))
    sedi_switch: bool = field(metadata=dict(static=True))
    coal_switch: bool = field(metadata=dict(static=True))
    turb_cond_switch: bool = field(metadata=dict(static=True))
    open_side_walls: bool = field(metadata=dict(static=True))
    periodic_topbot_walls: bool = field(metadata=dict(static=True))
    diag_incloud_time: bool = field(metadata=dict(static=True), default=False)
    rc2_T: float = field(metadata=dict(static=True), default=10.0)
    ice_switch: bool = field(metadata=dict(static=True), default=False)
    time_dep_ice_nucl: bool = field(metadata=dict(static=True), default=False)
    # aqueous chemistry (reference opts_init.hpp chem_switch/sstp_chem/
    # chem_rho; src/impl/chemistry/)
    chem_switch: bool = field(metadata=dict(static=True), default=False)
    sstp_chem: int = field(metadata=dict(static=True), default=1)
    chem_rho: float = field(metadata=dict(static=True), default=0.0)
    # adaptive per-SD condensation substepping
    # (reference opts_init.hpp adaptive_sstp_cond/sstp_cond_act/
    # sstp_cond_adapt_drw2_{eps,max};
    # src/impl/condensation/perparticle/
    # perparticle_nomixing_adaptive_sstp_cond.ipp)
    adaptive_sstp_cond: bool = field(metadata=dict(static=True),
                                     default=False)
    sstp_cond_act: int = field(metadata=dict(static=True), default=1)
    sstp_cond_adapt_drw2_eps: float = field(metadata=dict(static=True),
                                            default=1e-4)
    sstp_cond_adapt_drw2_max: float = field(metadata=dict(static=True),
                                            default=4.0)
    # per-substep in-cell mixing in exact per-particle condensation
    # (reference opts_init.hpp sstp_cond_mix; can only be off with
    # exact_sstp_cond)
    sstp_cond_mix: bool = field(metadata=dict(static=True), default=True)
    # collision probability can exceed one only when multiplicities are not
    # sd_conc-balanced (reference particles_impl.ipp:384); gates the
    # increase_sstp_coal adaptive substep growth (coal.ipp:224-227)
    pure_const_multi: bool = field(metadata=dict(static=True), default=False)

    def __hash__(self):
        return hash(tuple(getattr(self, f.name) for f in fields(self)))

    def __eq__(self, other):
        return isinstance(other, StaticConfig) and all(
            getattr(self, f.name) == getattr(other, f.name) for f in fields(self)
        )

    @classmethod
    def from_opts_init(cls, oi):
        return cls(
            n_dims=oi.n_dims,
            nx=max(1, oi.nx), ny=max(1, oi.ny), nz=max(1, oi.nz),
            n_cell=oi.n_cell,
            n_sd_max=int(oi.n_sd_max),
            dx=float(oi.dx), dy=float(oi.dy), dz=float(oi.dz),
            x0=float(oi.x0), x1=float(oi.x1),
            y0=float(oi.y0), y1=float(oi.y1),
            z0=float(oi.z0), z1=float(oi.z1),
            dt=float(oi.dt),
            sstp_cond=int(oi.sstp_cond),
            sstp_coal=int(oi.sstp_coal),
            th_dry=bool(oi.th_dry),
            const_p=bool(oi.const_p),
            RH_formula=oi.RH_formula.value,
            adve_scheme=oi.adve_scheme.value,
            terminal_velocity=oi.terminal_velocity.value,
            kernel=oi.kernel.value,
            exact_sstp_cond=bool(oi.exact_sstp_cond),
            variable_dt=bool(oi.variable_dt_switch),
            sedi_switch=bool(oi.sedi_switch),
            coal_switch=bool(oi.coal_switch),
            turb_cond_switch=bool(oi.turb_cond_switch),
            open_side_walls=bool(oi.open_side_walls),
            periodic_topbot_walls=bool(oi.periodic_topbot_walls),
            diag_incloud_time=bool(oi.diag_incloud_time),
            rc2_T=float(oi.rc2_T),
            ice_switch=bool(oi.ice_switch),
            time_dep_ice_nucl=bool(oi.time_dep_ice_nucl),
            chem_switch=bool(getattr(oi, "chem_switch", False)),
            sstp_chem=int(getattr(oi, "sstp_chem", 1)),
            chem_rho=float(getattr(oi, "chem_rho", 0.0)),
            adaptive_sstp_cond=bool(getattr(oi, "adaptive_sstp_cond", False)),
            sstp_cond_act=int(getattr(oi, "sstp_cond_act", 1)),
            sstp_cond_adapt_drw2_eps=float(
                getattr(oi, "sstp_cond_adapt_drw2_eps", 1e-4)),
            sstp_cond_adapt_drw2_max=float(
                getattr(oi, "sstp_cond_adapt_drw2_max", 4.0)),
            sstp_cond_mix=bool(getattr(oi, "sstp_cond_mix", True)),
            pure_const_multi=bool(
                getattr(oi, "sd_conc", 0) == 0
                and (getattr(oi, "sd_const_multi", 0) > 0
                     or len(getattr(oi, "dry_sizes", {})) > 0)),
        )


@jax.tree_util.register_dataclass
@dataclass
class State:
    """The full engine state: per-SD attributes, Eulerian cell mirrors,
    diagnosed cell fields, substepping state and the RNG key.

    Per-SD arrays have shape (n_sd_max,); cell arrays (n_cell,).
    Mirrors reference src/impl/particles_impl.ipp:66-146.
    """

    # --- per-SD attributes (particles_impl.ipp:66-99)
    n: jax.Array       # multiplicity; 0 == dead slot (f64 holds exact ints)
    rd3: jax.Array     # dry radius cubed [m3]
    rw2: jax.Array     # wet radius squared [m2]
    kpa: jax.Array     # kappa hygroscopicity
    x: jax.Array
    y: jax.Array
    z: jax.Array
    vt: jax.Array      # terminal velocity [m/s]
    incloud_time: jax.Array   # time spent activated [s] (diag_incloud_time)
    # SGS turbulence perturbations (particles_impl.ipp:80-84)
    up: jax.Array
    vp: jax.Array
    wp: jax.Array
    ssp: jax.Array       # supersaturation perturbation
    dot_ssp: jax.Array   # its tendency
    # ice attributes (particles_impl.ipp:93-99): spheroid semi-axes,
    # apparent density, singular freezing temperature, insoluble-core radius^2
    ice_a: jax.Array
    ice_c: jax.Array
    ice_rho: jax.Array
    T_freeze: jax.Array
    rd2_insol: jax.Array
    ijk: jax.Array     # linear cell index (i32); dead slots point at cell 0

    # --- Eulerian mirrors (particles_impl.ipp:122-146)
    th: jax.Array
    rv: jax.Array
    rhod: jax.Array
    p: jax.Array
    courant_x: jax.Array   # (nx+1)*ny*nz when present, else shape (0,)
    courant_y: jax.Array
    courant_z: jax.Array

    # --- diagnosed cell fields
    T: jax.Array
    RH: jax.Array
    eta: jax.Array
    dv: jax.Array      # cell volume [m3] (parcel: 1/rhod, i.e. 1 kg of air)
    diss_rate: jax.Array   # TKE dissipation rate [m2/s3] (turbulent kernels)

    # --- condensation substepping state (sstp_save semantics); per-cell
    # arrays normally, per-SD in exact_sstp_cond mode (sstp_save.ipp:13-34)
    sstp_tmp_th: jax.Array
    sstp_tmp_rv: jax.Array
    sstp_tmp_rh: jax.Array
    sstp_tmp_p: jax.Array   # only used in exact const_p mode

    # --- aqueous chemistry (reference particles_impl.ipp chem vectors +
    # ambient_chem[6]); zero-width when chem_switch is off so non-chem runs
    # carry no cost
    chem: jax.Array           # (8, n_sd_max) per-SD aqueous masses [kg]
    ambient_chem: jax.Array   # (6, n_cell) trace-gas mixing ratios
    sstp_tmp_chem: jax.Array  # (6, n_cell) chem substepping snapshot

    # --- bookkeeping
    key: jax.Array          # jax.random key (run sequence)
    puddle: jax.Array       # (15,) accumulators keyed by common.output_t

    @property
    def n_sd_max(self):
        return self.n.shape[0]

    @property
    def n_cell(self):
        return self.th.shape[0]


# puddle accumulator slots, mirroring common/output.hpp:8-42 output_t
# (chem species first, exactly as the reference's output_t enum; the final
# internal slot counts multi-chip migration-buffer overflows and is not part
# of the public diag_puddle surface)
PUDDLE_KEYS = (
    "HNO3", "NH3", "CO2", "SO2", "H2O2", "O3", "S_VI", "H",
    "liquid_volume", "dry_volume", "particle_number", "ice_mass",
    "liquid_number", "ice_number",
)
OUT_LIQ_VOL = PUDDLE_KEYS.index("liquid_volume")
OUT_DRY_VOL = PUDDLE_KEYS.index("dry_volume")
OUT_PRTCL_NUM = PUDDLE_KEYS.index("particle_number")
OUT_ICE_MASS = PUDDLE_KEYS.index("ice_mass")
OUT_LIQ_NUM = PUDDLE_KEYS.index("liquid_number")
OUT_ICE_NUM = PUDDLE_KEYS.index("ice_number")
OUT_MIGRATION_OVERFLOW = len(PUDDLE_KEYS)  # internal, multi-chip only
# internal flag slot: a const-multi pair saw floor(prob) >= 1 this step,
# requesting adaptive sstp_coal growth (reference coal.ipp:224-227)
OUT_COAL_OVERFLOW = len(PUDDLE_KEYS) + 1
N_PUDDLE = len(PUDDLE_KEYS) + 2


def empty_state(cfg: StaticConfig, dtype=None) -> State:
    """Allocate an all-dead-slot state for a given static config.
    Default dtype follows the x64 setting: f64 for parity runs, f32
    otherwise (the reference's real_t template parameter,
    particles.hpp:137)."""
    if dtype is None:
        dtype = jnp.result_type(float)
    n_sd = cfg.n_sd_max
    n_cell = cfg.n_cell
    zsd = jnp.zeros((n_sd,), dtype)
    zc = jnp.zeros((n_cell,), dtype)
    # staggered courant fields allocated for each present dimension
    ncx = (cfg.nx + 1) * cfg.ny * cfg.nz if cfg.n_dims >= 1 else 0
    ncy = cfg.nx * (cfg.ny + 1) * cfg.nz if cfg.n_dims == 3 else 0
    ncz = cfg.nx * cfg.ny * (cfg.nz + 1) if cfg.n_dims >= 2 else 0
    return State(
        n=zsd, rd3=zsd, rw2=zsd, kpa=zsd,
        x=zsd, y=zsd, z=zsd, vt=zsd, incloud_time=zsd,
        up=zsd, vp=zsd, wp=zsd, ssp=zsd, dot_ssp=zsd,
        ice_a=zsd, ice_c=zsd, ice_rho=zsd, T_freeze=zsd, rd2_insol=zsd,
        ijk=jnp.zeros((n_sd,), jnp.int32),
        th=zc, rv=zc, rhod=zc, p=zc,
        courant_x=jnp.zeros((ncx,), dtype),
        courant_y=jnp.zeros((ncy,), dtype),
        courant_z=jnp.zeros((ncz,), dtype),
        T=zc, RH=zc, eta=zc, dv=jnp.ones((n_cell,), dtype),
        diss_rate=zc,
        sstp_tmp_th=(zsd if cfg.exact_sstp_cond else zc),
        sstp_tmp_rv=(zsd if cfg.exact_sstp_cond else zc),
        sstp_tmp_rh=(zsd if cfg.exact_sstp_cond else zc),
        sstp_tmp_p=(zsd if cfg.exact_sstp_cond else jnp.zeros((0,), dtype)),
        chem=jnp.zeros((8, n_sd if cfg.chem_switch else 0), dtype),
        ambient_chem=jnp.zeros((6, n_cell if cfg.chem_switch else 0), dtype),
        sstp_tmp_chem=jnp.zeros((6, n_cell if cfg.chem_switch else 0), dtype),
        key=jax.random.PRNGKey(44),
        puddle=jnp.zeros((N_PUDDLE, ), dtype),
    )
