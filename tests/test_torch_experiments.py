"""The experiments path (E1 row gather, E2 windowed select) against the JAX
probes in ``scripts/experiments/``.

``window_select.py`` is loaded as a copy through importlib with its module
constants set to a reduced size (1,000 particles, cutoff 0.145, F = 16);
its Pallas window kernel runs in interpret mode with eager DMAs (the
default mode reads the scratch of the probe's one shared DMA semaphore
before its copies land). ``gather_variants.py`` runs every variant when
imported, so it is not imported: its kernels compute ``h[idx]`` (each
variant checked itself against ``h[idx]``), and the port's plain version is
held to ``jnp.take`` in every index form and dtype, and to a float32 loop of
the same additions for the repeated form. ``compaction``'s three designs of
the cell list's candidate selection build equal lists on the CPU.
"""

import importlib.util
import math
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from lagrangebench_torch.experiments import compaction, gather_variants, mp_times, window_select
from lagrangebench_torch.ops import fused_mp, row_gather
from lagrangebench_tpu.ops import fused_mp as jfused_mp

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_SMALL, CUTOFF_SMALL, F_SMALL = 1000, 1.45 * 0.1, 16


@pytest.fixture(scope="module")
def script():
    """A copy of the JAX probe with its constants at the reduced size."""
    path = os.path.join(REPO, "scripts", "experiments", "window_select.py")
    spec = importlib.util.spec_from_file_location("window_select_reduced", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    mod.N, mod.CUTOFF, mod.F = N_SMALL, CUTOFF_SMALL, F_SMALL
    mod.NCX = math.floor(1.0 / CUTOFF_SMALL)
    mod.YF = 4 * mod.NCX
    assert (mod.NCX, mod.YF) == (6, 24)
    return mod


@pytest.fixture(scope="module")
def structure(script):
    """(the script's outputs, the port's outputs) at seed 0."""
    return (script.build_structure(0),
            window_select.build_structure(N_SMALL, 3, 24, CUTOFF_SMALL, 128, 32, seed=0))


def _script_decode(script, n_rows, n_ext, ext_idx, cand, w0s_rows, wsub):
    """The probe's decode of cand for the gather path
    (``window_select.py:330-342``, its ``main``)."""
    t, sub = script.T, script.SUB
    senders_abs = np.full((n_rows, script.K), n_rows, np.int32)
    for ti in range(n_rows // t):
        for u in range(t // sub):
            rows = slice(ti * t + u * sub, ti * t + (u + 1) * sub)
            c = cand[rows]
            valid = c < 3 * wsub
            sx = np.clip(c // wsub, 0, 2)
            extrow = w0s_rows[ti, u][sx] + c % wsub
            senders_abs[rows] = np.where(valid, ext_idx[np.clip(extrow, 0, n_ext - 1)], n_rows)
    return senders_abs


@pytest.mark.parametrize("seed", [0, 3])
def test_build_structure_equals_the_script(script, structure, seed):
    """The port's copy gives the script's arrays, equal: n_rows, n_ext,
    ext_idx, cand (the stencil order of the candidates), w0s (both units)
    and WSUB."""
    if seed == 0:
        want, got = structure
    else:
        want = script.build_structure(seed)
        got = window_select.build_structure(N_SMALL, 3, 24, CUTOFF_SMALL, 128, 32, seed=seed)
    names = ("n_rows", "n_ext", "ext_idx", "cand", "w0s", "w0s_rows", "WSUB")
    for name, a, b in zip(names, want, got):
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape, name
        assert np.array_equal(a, b), name
    assert got[0] % 128 == 0 and got[3].shape == (got[0], 24)


def test_window_sender_rows_equal_the_script_decode(script, structure):
    """window_sender_rows names the ext row whose compact row is the
    script's decoded sender (n_rows on padded slots); decode_senders is
    that decode."""
    n_rows, n_ext, ext_idx, cand, w0s, w0s_rows, wsub = structure[0]
    want = _script_decode(script, n_rows, n_ext, ext_idx, cand, w0s_rows, wsub)
    rows, mask = fused_mp.window_sender_rows(torch.as_tensor(cand), torch.as_tensor(w0s),
                                             int(wsub))
    got = torch.where(mask, torch.as_tensor(ext_idx)[rows], n_rows).numpy()
    assert np.array_equal(got, want)
    assert np.array_equal(mask.numpy(), cand < 3 * wsub)
    assert np.array_equal(window_select.decode_senders(cand, w0s_rows, ext_idx, wsub), want)


def _window_inputs(structure, dtype):
    n_rows, n_ext, ext_idx, cand, w0s, w0s_rows, wsub = structure
    rng = np.random.default_rng(1)
    e = rng.normal(size=(n_rows, 24, F_SMALL)).astype(np.float32)
    h, hr, hs = (rng.normal(size=(n_rows, F_SMALL)).astype(np.float32) for _ in range(3))
    p = {k: np.array(v, np.float32)
         for k, v in jfused_mp.init_step_params(jax.random.PRNGKey(0), F_SMALL).items()}
    return e, h, hr, hs, p


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-5), ("bfloat16", 0.125)])
def test_window_step_plain_matches_the_jax_kernel(script, structure, dtype, tol):
    """gns_mp_step_window_plain vs the probe's Pallas window kernel (eager
    interpret mode) on the same numpy inputs and weights, and the kernel vs
    ``gns_mp_step_reference`` on the decoded gather: within 1e-5 in float32;
    0.125 in bf16 (outputs of a few units, one bf16 ulp 1/64..1/32: the two
    sum their products in other orders before the same roundings)."""
    n_rows, n_ext, ext_idx, cand, w0s, w0s_rows, wsub = structure[0]
    e, h, hr, hs, p = _window_inputs(structure[0], dtype)
    T, K, F = script.T, script.K, F_SMALL
    cdt = jnp.dtype(dtype)

    # the JAX kernel, launched as the probe's main launches it
    kernel = script.make_window_kernel(n_rows, wsub, n_rows // T, T // script.SUB)
    params = jfused_mp._row_params({k: jnp.asarray(v) for k, v in p.items()},
                                   jfused_mp._MP_KERNEL_PARAMS, F, cdt)
    tile3 = pl.BlockSpec((T, K, F), lambda t, a: (t, 0, 0), memory_space=pltpu.VMEM)
    tile2 = pl.BlockSpec((T, F), lambda t, a: (t, 0), memory_space=pltpu.VMEM)
    candsp = pl.BlockSpec((T * K, 1), lambda t, a: (t, 0), memory_space=pltpu.VMEM)
    masksp = pl.BlockSpec((T, K), lambda t, a: (t, 0), memory_space=pltpu.VMEM)

    def full_spec(arr):
        return pl.BlockSpec(arr.shape, lambda t, a: (0,) * arr.ndim, memory_space=pltpu.VMEM)

    grid_spec = pltpu.PrefetchScalarGridSpec(
        num_scalar_prefetch=1, grid=(n_rows // T,),
        in_specs=[tile3, candsp, masksp, tile2, tile2, pl.BlockSpec(memory_space=pl.ANY)]
        + [full_spec(q) for q in params],
        out_specs=[tile3, tile2],
        scratch_shapes=[pltpu.VMEM((T // script.SUB * 3 * wsub, F), cdt),
                        pltpu.SemaphoreType.DMA],
    )
    hs_j = jnp.asarray(hs, cdt)
    j_e, j_h = pl.pallas_call(
        kernel, grid_spec=grid_spec,
        out_shape=[jax.ShapeDtypeStruct((n_rows, K, F), cdt),
                   jax.ShapeDtypeStruct((n_rows, F), cdt)],
        interpret=pltpu.InterpretParams(dma_execution_mode="eager",
                                        uninitialized_memory="zero"),
    )(jnp.asarray(w0s, jnp.int32), jnp.asarray(e, cdt),
      jnp.asarray(cand, jnp.int32).reshape(n_rows * K, 1),
      jnp.asarray((cand < 3 * wsub).astype(np.float32)), jnp.asarray(hr, cdt),
      jnp.asarray(h, cdt), hs_j[jnp.asarray(ext_idx)], *params)

    # the port's plain version on the same inputs and weights
    tdt = getattr(torch, dtype)
    tp = fused_mp.kernel_params({k: torch.as_tensor(v) for k, v in p.items()}, tdt)
    hs_t = torch.as_tensor(hs).to(tdt)
    t_e, t_h = fused_mp.gns_mp_step_window_plain(
        torch.as_tensor(e).to(tdt), torch.as_tensor(cand), torch.as_tensor(w0s), int(wsub),
        hs_t[torch.as_tensor(ext_idx)], torch.as_tensor(hr).to(tdt),
        torch.as_tensor(h).to(tdt), tp)
    assert t_e.dtype == tdt and t_h.dtype == tdt

    def diff(a, b):
        return float(np.max(np.abs(np.asarray(a, np.float32) - np.asarray(b, np.float32))))

    assert diff(t_e.float().numpy(), j_e) <= tol
    assert diff(t_h.float().numpy(), j_h) <= tol

    # the JAX kernel vs the reference step on the decoded, masked gather
    senders = _script_decode(script, n_rows, n_ext, ext_idx, cand, w0s_rows, wsub)
    mask = jnp.asarray((senders < n_rows).astype(np.float32))
    hs_g = hs_j[jnp.minimum(jnp.asarray(senders), n_rows - 1)] * mask[..., None].astype(cdt)
    r_e, r_h = jfused_mp.gns_mp_step_reference(
        jnp.asarray(e, cdt), hs_g, jnp.asarray(hr, cdt), jnp.asarray(h, cdt), mask,
        {k: jnp.asarray(v) for k, v in p.items()})
    assert diff(j_e, r_e) <= tol and diff(j_h, r_h) <= tol


@pytest.mark.parametrize("reps", [1, 24])
@pytest.mark.parametrize("form", ["rk", "kr", "flat"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_row_gather_plain_matches_jnp_take(dtype, form, reps):
    """row_gather_plain in every E1 form equals jnp.take (reps = 1) or a
    float32 loop of the same additions of jnp.take (E1g), rounded once."""
    rng = np.random.default_rng(reps)
    h = rng.normal(size=(50, 16)).astype(np.float32)
    idx = rng.integers(0, 50, size=(40,) if form == "flat" else (40, 6)).astype(np.int32)
    hj = jnp.asarray(h, jnp.dtype(dtype))
    want = jnp.take(hj, jnp.asarray(idx), axis=0)
    if reps > 1:
        acc = jnp.zeros(want.shape, jnp.float32)
        for _ in range(reps):
            acc = acc + want.astype(jnp.float32)
        want = acc.astype(hj.dtype)
    ht = torch.as_tensor(h).to(getattr(torch, dtype))
    it = torch.as_tensor(idx.T.copy() if form == "kr" else idx)
    before = row_gather.ROW_GATHER.launches
    got = row_gather.row_gather(ht, it, transposed=form == "kr", reps=reps)
    assert row_gather.ROW_GATHER.launches == before  # CPU tensors: the plain version
    assert got.dtype == ht.dtype and tuple(got.shape) == want.shape
    assert np.array_equal(got.float().numpy(), np.asarray(want, np.float32))


@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_window_select_main_on_cpu(no_cuda, monkeypatch):
    """main runs on the CPU only when asked, at a reduced size; E2's plain
    version equals the gather path's plain step on the decoded gather."""
    for name, value in (("N", N_SMALL), ("CUTOFF", CUTOFF_SMALL), ("F", F_SMALL),
                        ("STEPS", 2), ("REPEATS", 1), ("DTYPE", torch.float32)):
        monkeypatch.setattr(window_select, name, value)
    with pytest.raises(RuntimeError, match="CUDA"):
        window_select.main([])
    out = window_select.main(["--device", "cpu"])
    assert out["loops"] == 2 and out["steps"] == 2 and out["check_launches"] == 1
    assert out["max_abs_err"] == 0.0 and out["vs_gather"] == 0.0
    assert out["window_ms"] > 0 and out["gather_ms"] > 0 and out["n_rows"] % 128 == 0


def test_gather_variants_main_on_cpu(no_cuda, monkeypatch):
    """main runs on the CPU only when asked, every variant at a tiny size,
    every kernel form checked equal to h[idx]."""
    for name, value in (("N", 64), ("K", 4), ("SWEEP", (8, 16)), ("N_REAL", 125),
                        ("ITERS", 2)):
        monkeypatch.setattr(gather_variants, name, value)
    with pytest.raises(RuntimeError, match="CUDA"):
        gather_variants.main(["1"])
    out = gather_variants.main(["--device", "cpu"])
    assert sorted(out) == [1, 2, 3, 4, 5, 6]
    assert "row_gather" in out[1] and "loop_24x_gather_N8" in out[5]
    assert "row_gather_real_bf16" in out[6] and "index_select_sorted_f32" in out[6]
    assert all(ms > 0 for times in out.values() for ms in times.values())


def test_mp_times_needs_a_card(no_cuda):
    with pytest.raises(RuntimeError, match="CUDA"):
        mp_times.main([])


def test_mp_times_inputs(monkeypatch):
    """The timed inputs, at a reduced size on the CPU: bf16 edge and node
    tensors, a float32 0/1 mask, the step's and the encoder's parameters in
    the kernel layout; the same seed gives the same inputs."""
    monkeypatch.setattr(mp_times, "N", 5)
    monkeypatch.setattr(mp_times, "K", 3)
    t, p, enc = mp_times._inputs(fused_mp, torch, torch.device("cpu"))
    f = fused_mp.LATENT
    for name in ("e", "hs", "ge"):
        assert t[name].shape == (5, 3, f) and t[name].dtype == torch.bfloat16
    for name in ("hr", "h", "gh"):
        assert t[name].shape == (5, f) and t[name].dtype == torch.bfloat16
    assert t["raw"].shape == (5, 3, 4) and t["mask"].dtype == torch.float32
    assert set(t["mask"].unique().tolist()) <= {0.0, 1.0}
    assert set(p) == set(fused_mp.PARAM_NAMES) and p["w_e"].dtype == torch.bfloat16
    assert p["b1"].dtype == torch.float32 and enc["enc_w1"].shape == (4, f)
    again = mp_times._inputs(fused_mp, torch, torch.device("cpu"))[0]
    assert all(torch.equal(t[name], again[name]) for name in t)


def test_mp_times_segnn_on_the_cpu(monkeypatch):
    """The SEGNN group at 512 particles on the CPU (the card's timers and
    memory counters stubbed): a finite rollout time per run and one timed
    forward and backward."""
    from lagrangebench_torch import profiling

    monkeypatch.setattr(mp_times, "N_SAMPLE", 512)
    for name in ("synchronize", "reset_peak_memory_stats"):
        monkeypatch.setattr(torch.cuda, name, lambda *a: None)
    monkeypatch.setattr(torch.cuda, "max_memory_allocated", lambda *a: 2**30)
    calls = []
    monkeypatch.setattr(profiling, "device_ms", lambda fn, **kw: (calls.append(fn()), 1.0)[1])
    monkeypatch.setattr(mp_times, "_device_events", lambda torch, fn: [])
    out = {}
    mp_times._time_segnn(torch, torch.device("cpu"), out, steps=2, runs=1)
    assert len(out["segnn_rollout_b2_ms_per_step"]) == 1
    assert out["segnn_rollout_b2_ms_per_step"][0] > 0
    assert out["segnn_fwd_bwd_b1_ms"] == 1.0 and out["segnn_fwd_bwd_b1_peak_gib"] == 1.0
    assert len(calls) == 1 and out["segnn_fwd_bwd_b1_top_kernels_ms"] == {}


def test_compaction_designs_agree_on_the_cpu():
    """The three selections of the cell list's candidates build the same
    dense and sparse lists (343 particles, the plain ops on the CPU)."""
    out = compaction.main(["--device", "cpu"], n_particles=343)
    for fmt in ("dense", "sparse"):
        for name in compaction.DESIGNS:
            assert out[f"{fmt} {name}"]["equal"] and len(out[f"{fmt} {name}"]["ms"]) == 2
