"""The condensation kernel (ops/pallas_cond, Triton route) == the plain XLA
form, in interpret mode on CPU, plus the dispatch that chooses between them.

The kernel runs the very same `_advance_rw2_core` jnp code, so any
difference would come from the plumbing — 1-D blocking, tail padding, the
row gather of the per-cell ambient vectors — which is what these tests pin
down, on physically representative droplet populations (reference physics:
cond_common.ipp:187-338)."""

from functools import partial

import jax.numpy as jnp
import numpy as np
import pytest

from libcloudphxx_tpu.common import vterm as common_vterm
from libcloudphxx_tpu.lgrngn import condensation as cond
from libcloudphxx_tpu.lgrngn.condensation import _advance_rw2_core
from libcloudphxx_tpu.ops import pallas_cond
from libcloudphxx_tpu.ops.pallas_cond import advance_rw2_pallas

CELL_NAMES = ("rhod", "rv", "T", "p", "RH", "eta", "lam_D", "lam_K")


def _cells(rng, n):
    T = rng.uniform(270.0, 300.0, n)
    return dict(
        rhod=rng.uniform(0.9, 1.2, n),
        rv=rng.uniform(5e-3, 1.5e-2, n),
        T=T,
        p=rng.uniform(7e4, 1.02e5, n),
        RH=rng.uniform(0.7, 1.05, n),
        eta=np.asarray(common_vterm.visc(jnp.asarray(T))),
        lam_D=rng.uniform(5e-8, 2e-7, n),
        lam_K=rng.uniform(5e-8, 2e-7, n),
    )


def _sd(rng, n):
    rd = rng.uniform(0.01e-6, 0.5e-6, n)  # dry radii
    rw = rd * rng.uniform(1.1, 30.0, n)   # wet radii across haze..droplet
    rw2 = rw ** 2
    # a few dead slots (rw2 = 0) exercise the masking
    rw2[:: max(n // 7, 1)] = 0.0
    return dict(rw2=rw2, rd3=rd ** 3, kpa=rng.uniform(0.1, 1.2, n),
                vt=rng.uniform(0.0, 2.0, n))


def _population(n, seed=0, dtype=jnp.float32):
    """Per-SD form: every input is an (n,) vector."""
    rng = np.random.default_rng(seed)
    sd, cells = _sd(rng, n), _cells(rng, n)
    f = lambda d: {k: jnp.asarray(v, dtype) for k, v in d.items()}
    return f(sd), f(cells)


def _rows(n_cell, cap, seed=0, dtype=jnp.float32):
    """Dense form: (n_cell, cap) SD planes + (n_cell,) cell vectors."""
    rng = np.random.default_rng(seed)
    sd = {k: v.reshape(n_cell, cap) for k, v in
          _sd(rng, n_cell * cap).items()}
    cells = _cells(rng, n_cell)
    f = lambda d: {k: jnp.asarray(v, dtype) for k, v in d.items()}
    return f(sd), f(cells)


def _cells_tuple(cells):
    return tuple(cells[k] for k in CELL_NAMES)


def _assert_f32_close(out, ref):
    """Kernel vs plain XLA at f32: fusion order differs, so lanes agree to
    the root find's converged noise floor (~4e-5, condensation._root_iters)
    and a lane near its bracket test may differ by a few of those; the
    reference's own f32 tolerance (2^-7, config.hpp:181-205) bounds all.
    The same criterion as chip_smoke.py's kernel phase."""
    out, ref = np.asarray(out), np.asarray(ref)
    assert out.shape == ref.shape and out.dtype == ref.dtype
    live = ref > 0
    np.testing.assert_array_equal(out[~live], ref[~live])
    rel = np.abs(out - ref)[live] / ref[live]
    assert np.quantile(rel, 0.999) <= 1e-4, np.quantile(rel, 0.999)
    assert rel.max() <= 2.0 ** -7, rel.max()


@pytest.mark.parametrize("n,block", [(100, 128), (1024, 256), (5000, 512)])
def test_per_sd_form_matches_xla(n, block):
    """cap=1 (the flat engine's per-SD form), sizes on and off the block
    multiple."""
    sd, cells = _population(n)
    dt = 0.1
    ref = _advance_rw2_core(dt, *sd.values(), *_cells_tuple(cells), 44.0)
    out = advance_rw2_pallas(_advance_rw2_core, dt, *sd.values(),
                             _cells_tuple(cells), 44.0, cap=1, block=block,
                             interpret=True)
    _assert_f32_close(out, ref)


@pytest.mark.parametrize("n_cell,cap,block", [
    (37, 24, 128),    # rows straddle blocks, N not a block multiple
    (16, 128, 256),   # the bench lane width
    (5, 8, 128),      # one partial block
    (9, 136, 1024),   # cap not a power of two, block > N
])
def test_cell_vector_form_matches_xla(n_cell, cap, block):
    """The dense form: the kernel gathers the per-cell ambient values by
    row = sd_index // cap; the reference broadcasts them."""
    sd, cells = _rows(n_cell, cap, seed=n_cell)
    dt = 0.1
    ref = _advance_rw2_core(dt, *sd.values(),
                            *(c[:, None] for c in _cells_tuple(cells)),
                            44.0)
    out = advance_rw2_pallas(
        _advance_rw2_core, dt, *(v.ravel() for v in sd.values()),
        _cells_tuple(cells), 44.0, cap=cap, block=block, interpret=True)
    _assert_f32_close(np.asarray(out).reshape(n_cell, cap), ref)


def test_dead_lanes_unchanged():
    """Dead slots (rw2 == 0, rd3 == 0 — the padding of a dense row) come
    back as exact zeros, whole dead rows included."""
    sd, cells = _rows(6, 16, seed=4)
    sd = dict(sd)
    dead = np.zeros((6, 16), bool)
    dead[2] = True                # a whole empty row
    dead[:, 11:] = True           # row tails
    for k in ("rw2", "rd3"):
        sd[k] = jnp.where(jnp.asarray(dead), 0.0, sd[k])
    out = advance_rw2_pallas(
        _advance_rw2_core, 0.5, *(v.ravel() for v in sd.values()),
        _cells_tuple(cells), 44.0, cap=16, block=128, interpret=True)
    out = np.asarray(out).reshape(6, 16)
    assert (out[dead] == 0.0).all()
    assert np.isfinite(out).all()


def test_f64_interpret():
    # interpret mode agrees to f64 precision (same jnp ops)
    sd, cells = _population(513, seed=3, dtype=jnp.float64)
    ref = _advance_rw2_core(1.0, *sd.values(), *_cells_tuple(cells), 44.0)
    out = advance_rw2_pallas(_advance_rw2_core, 1.0, *sd.values(),
                             _cells_tuple(cells), 44.0, cap=1, block=128,
                             interpret=True)
    np.testing.assert_allclose(np.asarray(out), np.asarray(ref),
                               rtol=1e-12, atol=0.0)


def test_block_must_be_power_of_two():
    sd, cells = _population(64)
    with pytest.raises(ValueError, match="power of two"):
        advance_rw2_pallas(_advance_rw2_core, 0.1, *sd.values(),
                           _cells_tuple(cells), 44.0, cap=1, block=96,
                           interpret=True)


@pytest.mark.parametrize("accel,dtype,want", [
    (True, jnp.float32, True),
    (True, jnp.float64, False),    # the f64 parity path stays plain XLA
    (False, jnp.float32, False),   # the host CPU stays plain XLA
])
def test_kernel_dispatch(monkeypatch, accel, dtype, want):
    monkeypatch.setattr(cond, "on_accelerator", lambda: accel)
    assert cond._kernel_wanted(jnp.ones((10,), dtype)) is want


@pytest.fixture
def kernel_on_cpu(monkeypatch):
    """Route the dispatch to the kernel as on an accelerator, with the
    kernel in interpret mode (the Triton lowering needs a GPU)."""
    monkeypatch.setattr(cond, "on_accelerator", lambda: True)
    monkeypatch.setattr(pallas_cond, "advance_rw2_pallas",
                        partial(advance_rw2_pallas, interpret=True))


def test_advance_rw2_rows_dispatch(kernel_on_cpu):
    """advance_rw2_rows: kernel path == plain path on the dense form."""
    sd, cells = _rows(12, 24, seed=7)
    args = (0.2, *sd.values(), _cells_tuple(cells), 44.0)
    out = cond.advance_rw2_rows(*args)
    ref = _advance_rw2_core(0.2, *sd.values(),
                            *(c[:, None] for c in _cells_tuple(cells)),
                            44.0)
    _assert_f32_close(out, ref)


def test_advance_rw2_per_sd_dispatch(kernel_on_cpu):
    """advance_rw2 takes the kernel for all-vector inputs and falls back to
    plain XLA when an ambient input is a scalar (kernel not applicable)."""
    sd, cells = _population(300, seed=5)
    c = _cells_tuple(cells)
    out = cond.advance_rw2(0.2, *sd.values(), *c, 44.0)
    ref = _advance_rw2_core(0.2, *sd.values(), *c, 44.0)
    _assert_f32_close(out, ref)
    scal = c[:5] + (jnp.float32(1.8e-5),) + c[6:]
    out2 = cond.advance_rw2(0.2, *sd.values(), *scal, 44.0)
    ref2 = _advance_rw2_core(0.2, *sd.values(), *scal, 44.0)
    np.testing.assert_array_equal(np.asarray(out2), np.asarray(ref2))


def test_plain_rows_form_on_cpu():
    """On the host CPU advance_rw2_rows is the plain form, bit for bit."""
    sd, cells = _rows(8, 16, seed=9, dtype=jnp.float64)
    out = cond.advance_rw2_rows(0.3, *sd.values(), _cells_tuple(cells), 1.01)
    ref = _advance_rw2_core(0.3, *sd.values(),
                            *(c[:, None] for c in _cells_tuple(cells)), 1.01)
    np.testing.assert_array_equal(np.asarray(out), np.asarray(ref))
