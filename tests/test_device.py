"""Device-dependent choices: the one capability query (utils.device), the
factory's engine choice, the dense row capacity, the compilation cache
location, the MPDATA plain path on grids that are not powers of two, and
chip_smoke.py — refusing the host CPU, and its phases at a tiny size."""

import os
import shutil
import subprocess
import sys
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from libcloudphxx_tpu import lgrngn
from libcloudphxx_tpu.lgrngn import dense, dense_front, particles
from libcloudphxx_tpu.utils import device

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


# ------------------------------------------------------ capability query
@pytest.mark.parametrize("backend,want", [("cpu", False), ("gpu", True)])
def test_on_accelerator(monkeypatch, backend, want):
    monkeypatch.setattr(device.jax, "default_backend", lambda: backend)
    assert device.on_accelerator() is want


def test_on_accelerator_here():
    # the test run is pinned to the host CPU (conftest)
    assert device.on_accelerator() is False


# ------------------------------------------------- factory engine choice
def _opts(variant):
    def lognormal(lnr):
        return (60e6 * np.exp(-(lnr - np.log(0.02e-6)) ** 2
                              / 2 / np.log(1.4) ** 2)
                / np.log(1.4) / np.sqrt(2 * np.pi))
    oi = lgrngn.opts_init_t()
    oi.dry_distros = {(0.61, 0.0): lognormal}
    oi.nx, oi.nz = 4, 4
    oi.dx = oi.dz = 100.0
    oi.x1, oi.z1 = 400.0, 400.0
    oi.dt = 1.0
    oi.sd_conc = 4
    oi.n_sd_max = 4 * 4 * 4 * 4
    if variant == "ice":
        oi.ice_switch = True
    elif variant == "chem":
        oi.chem_switch = True
    elif variant == "sgs":
        oi.turb_cond_switch = True
    elif variant == "exact":
        oi.exact_sstp_cond = True
        oi.sstp_cond = 2
    elif variant == "3d":
        oi.ny = 4
        oi.dy = 100.0
        oi.y1 = 400.0
        oi.n_sd_max *= 4
    return oi


@pytest.mark.parametrize("variant,capable", [
    ("2d", True), ("exact", True), ("3d", True),
    ("ice", False), ("chem", False), ("sgs", False),
])
def test_factory_engine_on_accelerator(monkeypatch, variant, capable):
    """On an accelerator the factory gives every dense-capable
    configuration the dense engine and every other one the flat engine."""
    monkeypatch.setattr(particles, "on_accelerator", lambda: True)
    monkeypatch.delenv("LIBCLOUD_ENGINE", raising=False)
    p = lgrngn.factory(lgrngn.backend_t.CUDA, _opts(variant))
    assert dense_front.dense_capable(p.cfg) is capable
    assert p.engine == (particles.auto_engine() if capable else "flat")
    assert particles.auto_engine() == "dense"


@pytest.mark.parametrize("variant", ["2d", "3d"])
def test_factory_engine_on_cpu(monkeypatch, variant):
    monkeypatch.delenv("LIBCLOUD_ENGINE", raising=False)
    p = lgrngn.factory(lgrngn.backend_t.serial, _opts(variant))
    assert particles.auto_engine() == "flat"
    assert p.engine == "flat"


def test_kinematic_default_backend_is_cuda():
    from libcloudphxx_tpu.models import Kinematic2D
    m = Kinematic2D(nx=4, nz=4, micro="lgrngn", sd_conc=4)
    assert m.prtcls.backend == lgrngn.backend_t.CUDA
    assert not hasattr(lgrngn.backend_t, "tpu")


# --------------------------------------------------------- row capacity
@pytest.mark.parametrize("occ,cap", [
    (0, 8), (1, 8), (4, 8), (5, 16), (64, 128), (65, 136), (100, 200),
])
def test_row_capacity_8_lane_aligned(occ, cap):
    """2x the densest cell, rounded up to 8 lanes — no power-of-two
    rounding (65 -> 136, not 256)."""
    assert dense.row_capacity(occ) == cap


def test_dense_front_and_model_share_capacity(monkeypatch):
    from libcloudphxx_tpu.models import Kinematic2D
    monkeypatch.setenv("LIBCLOUD_ENGINE", "dense")
    m = Kinematic2D(nx=6, nz=5, micro="lgrngn", sd_conc=12)
    assert m.prtcls.engine == "dense"
    counts = np.bincount(np.asarray(m.prtcls.state.ijk)[
        np.asarray(m.prtcls.state.n) > 0], minlength=30)
    assert m.dense_capacity() == m.prtcls._cap \
        == dense.row_capacity(counts.max())
    assert m.dense_capacity() % 8 == 0


# ---------------------------------------------------- compilation cache
def test_cache_follows_env(monkeypatch, tmp_path):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    calls = []
    monkeypatch.setattr(device.jax.config, "update",
                        lambda *a: calls.append(a))
    assert device.enable_compilation_cache() == str(tmp_path)
    assert calls == []          # JAX reads the variable itself


def test_cache_default_in_checkout(monkeypatch):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    calls = []
    monkeypatch.setattr(device.jax.config, "update",
                        lambda *a: calls.append(a))
    path = device.enable_compilation_cache()
    assert path == os.path.join(REPO, ".jax_cache")
    assert calls == [("jax_compilation_cache_dir", path)]
    with open(os.path.join(REPO, ".gitignore")) as f:
        assert ".jax_cache/" in f.read().split()


# ------------------------------------------- MPDATA on non-pow2 grids
@pytest.mark.parametrize("nx,nz", [(7, 5), (19, 13), (76, 76)])
def test_mpdata_plain_path_grids(nx, nz):
    """The plain XLA MPDATA on grid sizes that are not powers of two:
    mass conserved, positivity kept, advect2 == two advect calls."""
    from libcloudphxx_tpu.models import Kinematic2D, mpdata
    m = Kinematic2D(nx=nx, nz=nz, micro="blk_1m")
    rng = np.random.default_rng(nx)
    a = jnp.asarray(rng.uniform(0.0, 1.0, (nx, nz)))
    b = jnp.asarray(rng.uniform(280.0, 300.0, (nx, nz)))
    mass = float(jnp.sum(a * m.G))
    a1 = mpdata.advect(a, m.gc_x, m.gc_z, m.G, fct=True)
    b1 = mpdata.advect(b, m.gc_x, m.gc_z, m.G, fct=True)
    a2, b2 = mpdata.advect2(a, b, m.gc_x, m.gc_z, m.G, fct=True)
    np.testing.assert_array_equal(np.asarray(a2), np.asarray(a1))
    np.testing.assert_array_equal(np.asarray(b2), np.asarray(b1))
    assert float(jnp.sum(a1 * m.G)) == pytest.approx(mass, rel=1e-12)
    assert float(jnp.min(a1)) >= -1e-12


# ------------------------------------------------------------ chip_smoke
def _run_script(cwd, script):
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("JAX_", "XLA_"))}
    env["JAX_PLATFORMS"] = "cpu"
    env.pop("PYTHONPATH", None)
    return subprocess.run([sys.executable, script], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


def test_chip_smoke_refuses_cpu():
    r = _run_script(REPO, "chip_smoke.py")
    assert r.returncode != 0
    assert '"ok"' not in r.stdout
    assert "no GPU" in r.stderr


def test_chip_smoke_alone_fails(tmp_path):
    """Outside the repo (the script alone) it fails and prints no result."""
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    r = _run_script(str(tmp_path), "chip_smoke.py")
    assert r.returncode != 0
    assert '"ok"' not in r.stdout


@pytest.fixture
def tiny_smoke(monkeypatch):
    """chip_smoke's phases at a tiny size on the CPU, the kernel in
    interpret mode."""
    monkeypatch.syspath_prepend(REPO)
    import bench
    import chip_smoke
    from libcloudphxx_tpu.ops import pallas_cond
    monkeypatch.setattr(bench, "NX", 8)
    monkeypatch.setattr(bench, "NZ", 8)
    monkeypatch.setattr(bench, "SD_CONC", 8)
    monkeypatch.setattr(bench, "peak_bytes", lambda: -1)
    monkeypatch.setattr(chip_smoke, "timed_ms", lambda fn, args: 0.0)
    monkeypatch.setattr(pallas_cond, "advance_rw2_pallas",
                        partial(pallas_cond.advance_rw2_pallas,
                                interpret=True))
    return chip_smoke


def test_smoke_phase_kernels(tiny_smoke):
    out = tiny_smoke.phase_kernels("cpu")
    assert set(out) == {"cond_kernel_ms", "cond_plain_ms"}


def test_smoke_phase_lgrngn_and_public(tiny_smoke):
    import bench
    m = bench.canonical_model()
    out = tiny_smoke.phase_lgrngn("cpu", n_steps=2, model=m)
    assert set(out) == {"dense", "flat"}
    pub = tiny_smoke.phase_public("cpu", n_steps=2, model=m)
    assert pub["engine"] == "flat"


def test_smoke_phase_f64_parity(tiny_smoke):
    out = tiny_smoke.phase_f64_parity("cpu", nx=8, nz=8, sd_conc=8,
                                      n_steps=3)
    assert out["th_rel"] <= tiny_smoke.PARITY_TH_RTOL


def test_smoke_phase_bulk_and_cli(tiny_smoke):
    assert set(tiny_smoke.phase_bulk("cpu", nx=8, nz=8, n_steps=20)) \
        == {"blk_1m", "blk_2m"}
    tiny_smoke.phase_cli("cpu", nx=8, nz=8, nt=20, spinup=10)


def test_smoke_phase_multi(tiny_smoke):
    """The --multi phases on 4 of the virtual CPU devices, uneven slabs."""
    tiny_smoke.phase_multi_factory("cpu", 4, nx=10, nz=6, sd_conc=6,
                                   n_steps=2)
    tiny_smoke.phase_multi_dense("cpu", 4, nx=10, nz=6, sd_conc=6,
                                 n_steps=2, widths=[3, 3, 2, 2])


@pytest.fixture
def gpu_card():
    """Skip unless the machine has an NVIDIA GPU (asked of nvidia-smi: this
    process is pinned to the CPU by conftest, the card is used by a child
    process)."""
    smi = shutil.which("nvidia-smi")
    if smi is None or subprocess.run([smi, "-L"], capture_output=True,
                                     timeout=60).returncode != 0:
        pytest.skip("needs an NVIDIA GPU")


@pytest.mark.chip
def test_chip_smoke_on_gpu(gpu_card):
    """chip_smoke.py end to end on the card, in its own process."""
    import json
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("JAX_PLATFORMS", "XLA_FLAGS"))}
    r = subprocess.run([sys.executable, "chip_smoke.py"], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=1200)
    assert r.returncode == 0, r.stderr[-4000:]
    last = json.loads(r.stdout.strip().splitlines()[-1])
    assert last["ok"] is True and last["device"]["platform"] == "gpu"
