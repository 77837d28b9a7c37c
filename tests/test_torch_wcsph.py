"""Port parity: the WCSPH generator (``lagrangebench_torch.data_gen.wcsph``)
against the JAX package's on the CPU.

The initial states are numpy and bit-equal from the same seed. One solver
substep in float64 matches JAX's cell-list substep within rtol 1e-9 / atol
1e-12 for the five case families, on the port's kernel backend (``"auto"``:
K1 and K2's plain versions on the CPU) and on its cell list: the two
packages sum each particle's neighbors in other orders, nothing else
differs. 15 substeps with a Verlet skin match JAX's within 1e-8; the
neighbor list rebuilds ``ceil(steps / nl_every)`` times per ``advance``;
an overflowing list raises as JAX's does; and the JAX tests' physical
checks hold for the port.
"""

import math

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from lagrangebench_tpu.data_gen import wcsph as jw
from lagrangebench_torch.data_gen import wcsph as tw

RTOL, ATOL = 1e-9, 1e-12


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread: the tensors are small, and under the suite's
    parallel workers more threads oversubscribe the cores (each of the
    solver's many small ops then waits on its thread pool)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


@pytest.fixture
def jax_float32():
    """JAX's generator runs in float32, as on its TPU: its scan carries
    float32 state, which x64 (on in the tests) would promote."""
    import jax

    jax.config.update("jax_enable_x64", False)
    try:
        yield
    finally:
        jax.config.update("jax_enable_x64", True)


def _states(rng_seed=0):
    """(name, make_sph kwargs, r, v) of the five case families, small."""
    r2, v2 = jw.tgv_initial_state(12, np.random.default_rng(rng_seed))
    r3, v3 = jw.tgv_initial_state(10, np.random.default_rng(rng_seed), dim=3)
    rd, vd, _, box_d, wall_d = jw.dam_initial_state(
        0.05, np.random.default_rng(3), tank=(1.0, 1.0), column=(1.0, 0.5), jitter=0.01)
    rr, vr, _ = jw.rpf_initial_state(1 / 16, np.random.default_rng(rng_seed), box=[1.0, 2.0])
    rl, vl, _, box_l, wall_l = jw.ldc_initial_state(1 / 16, np.random.default_rng(rng_seed))
    return {
        "tgv2d": (dict(dx=1 / 12, box=[1.0, 1.0]), r2, v2),
        "tgv3d": (dict(dx=1 / 10, box=[1.0] * 3), r3, v3),
        "dam": (dict(dx=0.05, box=box_d, visc=0.05, c0=15.0, pbc=[False, False],
                     g_ext=[0.0, -1.0], wall_mask=wall_d, free_surface=True), rd, vd),
        "rpf": (dict(dx=1 / 16, box=[1.0, 2.0], visc=0.1, pbc=[True, True],
                     force_fn="rpf"), rr, vr),
        "ldc": (dict(dx=1 / 16, box=box_l, visc=0.05, pbc=[False, False], wall_mask=wall_l,
                     free_surface=True), rl, vl),
    }


def _jax_run(kw, r, v, steps, **extra):
    kw = dict(kw, **extra)
    if kw.get("force_fn") == "rpf":
        kw["force_fn"] = jw.rpf_force_fn
    kw.setdefault("backend", "celllist")
    nl, adv, dt = jw.make_sph(**kw)
    rj, vj = jnp.asarray(r, jnp.float64), jnp.asarray(v, jnp.float64)
    r1, v1, nbrs = adv(rj, vj, nl.allocate(rj), steps)
    assert not bool(nbrs.did_buffer_overflow)
    return np.asarray(r1), np.asarray(v1), dt


def _torch_make(kw, backend, **extra):
    kw = dict(kw, **extra)
    if kw.get("force_fn") == "rpf":
        kw["force_fn"] = tw.rpf_force_fn
    return tw.make_sph(**kw, backend=backend, device="cpu", dtype=torch.float64)


def _torch_run(kw, r, v, steps, backend, **extra):
    nl, adv, dt = _torch_make(kw, backend, **extra)
    rt = torch.as_tensor(r, dtype=torch.float64)
    r1, v1, nbrs = adv(rt, torch.as_tensor(v), nl.allocate(rt), steps)
    assert not bool(nbrs.did_buffer_overflow)
    return r1.numpy(), v1.numpy(), dt


@pytest.mark.parametrize("case", ["tgv2d", "tgv3d", "dam", "rpf", "ldc"])
def test_initial_states_bit_equal(case):
    rng = lambda: np.random.default_rng(7)  # noqa: E731
    if case == "tgv2d":
        got, want = tw.tgv_initial_state(9, rng()), jw.tgv_initial_state(9, rng())
    elif case == "tgv3d":
        got, want = (tw.tgv_initial_state(6, rng(), dim=3),
                     jw.tgv_initial_state(6, rng(), dim=3))
    elif case == "dam":
        got, want = tw.dam_initial_state(0.1, rng()), jw.dam_initial_state(0.1, rng())
    elif case == "rpf":
        got, want = tw.rpf_initial_state(0.1, rng()), jw.rpf_initial_state(0.1, rng())
    else:
        got, want = tw.ldc_initial_state(0.1, rng()), jw.ldc_initial_state(0.1, rng())
    assert len(got) == len(want)
    for g, w in zip(got, want):
        if isinstance(w, np.ndarray):
            assert g.dtype == w.dtype and g.shape == w.shape
            np.testing.assert_array_equal(g, w)
        else:
            assert g == w


@pytest.mark.parametrize("backend", ["auto", "celllist"])
@pytest.mark.parametrize("case", ["tgv2d", "tgv3d", "dam", "rpf", "ldc"])
def test_one_substep_matches_jax(case, backend):
    kw, r, v = _states()[case]
    rj, vj, dtj = _jax_run(kw, r, v, 1)
    rt, vt, dtt = _torch_run(kw, r, v, 1, backend)
    assert dtt == dtj
    np.testing.assert_allclose(vt, vj, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(rt, rj, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("backend", ["auto", "celllist"])
def test_verlet_skin_run_matches_jax(backend):
    """15 substeps with a skin of 0.25 h (a rebuild every few substeps):
    the port's skin run against JAX's, and against its own rebuild-every-
    substep run, within 1e-8."""
    rng = np.random.default_rng(3)
    r, v = jw.tgv_initial_state(8, rng, dim=2)
    kw = dict(dx=1 / 8, box=[1.0, 1.0])
    skin = dict(nl_skin_h=0.25, capacity_multiplier=1.5)
    rj, vj, _ = _jax_run(kw, r, v, 15, **skin)
    rt, vt, _ = _torch_run(kw, r, v, 15, backend, **skin)
    r0, v0, _ = _torch_run(kw, r, v, 15, backend)
    np.testing.assert_allclose(rt, rj, atol=1e-8)
    np.testing.assert_allclose(vt, vj, atol=1e-8)
    np.testing.assert_allclose(rt, r0, atol=1e-8)
    np.testing.assert_allclose(vt, v0, atol=1e-8)


@pytest.mark.parametrize("steps,nl_every", [(15, 3), (16, 3), (7, 1), (1, 4)])
def test_rebuilds_once_per_period(steps, nl_every):
    """``advance`` rebuilds on ``k % nl_every == 0``, k from 0 at each call:
    ``ceil(steps / nl_every)`` updates."""
    r, v = tw.tgv_initial_state(8, np.random.default_rng(0))
    nl, adv, _ = tw.make_sph(1 / 8, [1.0, 1.0], nl_skin_h=0.25, nl_every=nl_every,
                             device="cpu", dtype=torch.float64)
    nbrs = nl.allocate(torch.as_tensor(r))
    calls = []
    real = nbrs.update_fn

    def counted(*a, **k):
        calls.append(1)
        out = real(*a, **k)
        out.update_fn = counted
        return out

    nbrs.update_fn = counted
    for _ in range(2):
        calls.clear()
        _, _, nbrs = adv(r, v, nbrs, steps)
        assert len(calls) == math.ceil(steps / nl_every)


@pytest.mark.parametrize("backend", ["auto", "celllist"])
def test_overflow_raises_as_jax(tmp_path, backend, jax_float32):
    """A list below its neighbor count overflows; the trajectory raises
    once, after its frames, in both packages."""
    r, v = jw.tgv_initial_state(8, np.random.default_rng(0))
    tag = np.zeros(len(r), np.int32)
    nl_j, adv_j, _ = jw.make_sph(1 / 8, [1.0, 1.0], capacity_multiplier=0.3,
                                 backend="celllist")
    nl_t, adv_t, _ = tw.make_sph(1 / 8, [1.0, 1.0], capacity_multiplier=0.3, backend=backend,
                                 device="cpu")
    (tmp_path / "j").mkdir()
    (tmp_path / "t").mkdir()
    with pytest.raises(RuntimeError, match="neighbor-list overflow") as want:
        jw._simulate_trajectory(str(tmp_path / "j"), r, v, tag, nl_j, adv_j, 2, 2)
    with pytest.raises(RuntimeError, match="neighbor-list overflow") as got:
        tw._simulate_trajectory(str(tmp_path / "t"), r, v, tag, nl_t, adv_t, 2, 2,
                                device="cpu")
    assert str(got.value).replace("/t;", "/j;") == str(want.value)
    # the in-memory run raises the same way, naming its label
    with pytest.raises(RuntimeError, match="overflow in tgv"):
        tw.simulate_frames(r, v, nl_t, adv_t, 2, 2, device="cpu", label="tgv")


def test_float32_frames_match_jax(tmp_path, jax_float32):
    """The generator's float32 trajectory, frame by frame, against JAX's
    written frames: float32 summation order only (1e-5)."""
    import h5py

    r, v = jw.tgv_initial_state(10, np.random.default_rng(1))
    tag = np.zeros(len(r), np.int32)
    nl_j, adv_j, _ = jw.make_sph(0.1, [1.0, 1.0], backend="celllist")
    jw._simulate_trajectory(str(tmp_path), r, v, tag, nl_j, adv_j, 4, 5)
    nl_t, adv_t, _ = tw.make_sph(0.1, [1.0, 1.0], device="cpu")
    frames, _, _ = tw.simulate_frames(r, v, nl_t, adv_t, 4, 5, device="cpu")
    assert frames.dtype == np.float32 and frames.shape == (4, 100, 2)
    for k in range(4):
        with h5py.File(tmp_path / f"traj_{k:04d}.h5") as f:
            np.testing.assert_allclose(frames[k], f["r"][:], atol=1e-5)


# -- the JAX tests' physical checks, on the port ------------------------------


def _run(kw, r, v, steps, backend="auto"):
    nl, adv, dt = tw.make_sph(**kw, backend=backend, device="cpu", dtype=torch.float64)
    rt = torch.as_tensor(r, dtype=torch.float64)
    r1, v1, nbrs = adv(rt, torch.as_tensor(v), nl.allocate(rt), steps)
    assert not bool(nbrs.did_buffer_overflow)
    return r1.numpy(), v1.numpy()


def test_tgv_run_is_physical():
    r, v = tw.tgv_initial_state(16, np.random.default_rng(1))
    ke0, mom0 = 0.5 * np.mean(np.sum(v**2, -1)), v.sum(0)
    r2, v2 = _run(dict(dx=1 / 16, box=[1.0, 1.0]), r, v, 200)
    ke = 0.5 * np.mean(np.sum(v2**2, -1))
    assert 0.0 < ke < ke0
    np.testing.assert_allclose(v2.sum(0), mom0, atol=1e-8)
    assert np.all(r2 >= 0) and np.all(r2 < 1.0)


def test_hydrostatic_tank_stays_put():
    dx = 0.05
    r, v, _, box, wall = tw.dam_initial_state(dx, np.random.default_rng(3), tank=(1.0, 1.0),
                                              column=(1.0, 0.5), jitter=0.01)
    r2, v2 = _run(dict(dx=dx, box=box, visc=0.05, c0=15.0, pbc=[False, False],
                       g_ext=[0.0, -1.0], wall_mask=wall, free_surface=True), r, v, 400)
    vf, rf = v2[~wall], r2[~wall]
    assert np.abs(vf).max() < 0.25
    assert rf[:, 0].min() > 2 * dx and rf[:, 0].max() < box[0] - 2 * dx
    assert rf[:, 1].min() > 2 * dx
    np.testing.assert_allclose(r2[wall], r[wall], atol=1e-12)


def test_rpf_force_accelerates_bands():
    r, v, _ = tw.rpf_initial_state(1 / 16, np.random.default_rng(0), box=[1.0, 2.0])
    r2, v2 = _run(dict(dx=1 / 16, box=[1.0, 2.0], visc=0.1, pbc=[True, True],
                       force_fn=tw.rpf_force_fn), r, v, 100)
    lower = r2[:, 1] < 1.0
    assert v2[lower, 0].mean() > 0.01
    assert v2[~lower, 0].mean() < -0.01


def test_ldc_lid_drags_fluid():
    dx = 1 / 16
    r, v, tag, box, wall = tw.ldc_initial_state(dx, np.random.default_rng(0), u_lid=1.0)
    r2, v2 = _run(dict(dx=dx, box=box, visc=0.05, pbc=[False, False], wall_mask=wall,
                       free_surface=True), r, v, 300)
    np.testing.assert_allclose(v2[tag == 2, 0], 1.0, atol=1e-12)
    np.testing.assert_allclose(r2[wall], r[wall], atol=1e-12)
    top = (tag == 0) & (r[:, 1] > box[1] - 6 * dx)
    assert v2[top, 0].mean() > 0.02


def test_rpf_force_fn_matches_jax():
    """The torch force, per particle, equals JAX's, in float64."""
    import jax

    r = np.random.default_rng(0).uniform(0, 2, size=(50, 2))
    want = np.asarray(jax.vmap(jw.rpf_force_fn)(jnp.asarray(r)))
    got = torch.func.vmap(tw.rpf_force_fn)(torch.as_tensor(r)).numpy()
    np.testing.assert_array_equal(got, want)
