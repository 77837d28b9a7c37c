"""Weakly-compressible SPH solver on the port's own neighbor search.

Counterpart of ``lagrangebench_tpu/data_gen/wcsph.py``, the dataset
generator: the same scheme, initial states, cases and output layout, with
torch tensors in the solver's loop and the port's ``ops.neighbor_list`` in
the dense ``(N, K)`` layout (fill N) as its neighbor search, so on the card
each neighbor rebuild is K1 (the column table) + K2 (the stencil scan).

Scheme (textbook WCSPH, cf. Monaghan 2005; Adami et al. 2012 for walls):

* density by kernel summation (cubic spline), the self-edge once,
* linear equation of state ``p = c0^2 (rho - rho0)``,
* symmetric pressure gradient ``-m (p_i/rho_i^2 + p_j/rho_j^2) grad W``,
* Morris viscosity,
* static wall particles with Adami-style pressure extrapolation from
  their fluid neighbors (incl. the hydrostatic correction under gravity)
  and prescribed wall velocities in the viscous term (no-slip / moving
  lid),
* optional free-surface treatment (pressure clamped >= 0),
* constant gravity and/or a per-particle body-force field (the RPF
  band-reversal force), applied per particle as a dataset's force is
  (``data.force.apply_force``),

advanced by semi-implicit Euler, a Python loop of substeps: about a
hundred small device kernels per 2D substep, the rebuild included.

Cases (the reference's four dataset families): ``generate_tgv_ensemble``
(2D/3D Taylor-Green vortex, periodic), ``generate_dam_ensemble`` (2D dam
break: free surface, gravity, static walls), ``generate_rpf_trajectory``
(2D reverse Poiseuille flow: periodic, band-reversal force; the dataset
directory also needs ``RPF_FORCE_PY`` as its ``force.py``) and
``generate_ldc_trajectory`` (2D lid-driven cavity: walls and a moving lid).
Each writes the jax-sph per-frame layout that ``jax_sph_converter``
consumes: ``<root>/<case>_<seed>/traj_NNNN.h5`` with ``r`` and ``tag``
datasets plus a ``config.yaml`` per trajectory. :func:`simulate_frames`
is the in-memory part, for a program without h5py.

The generators' neighbor backend defaults to ``"auto"``, K1 + K2 on the
card (their plain PyTorch versions on the CPU), where the JAX package's
pin ``"celllist"``: two TPU limits chose that there (the Pallas scan's
shape envelope, and a failed ~40 s compile at the 3D TGV's 3 dx cutoff),
and neither applies to K2, which takes columns of up to ~14k staged slots.
The port's cell list is ~55 PyTorch kernels per update. Given
``"celllist"``, a generator behaves as the JAX package's does.
"""

from __future__ import annotations

import os
from typing import Callable, List, Optional, Sequence

import numpy as np
import torch

from ..data.force import apply_force
from ..defaults import resolve_backend
from ..ops import neighbor_list
from ..utils import resolve_device

FLUID_TAG = 0
WALL_TAG = 1  # NodeType.SOLID_WALL
MOVING_WALL_TAG = 2  # NodeType.MOVING_WALL


def make_sph(
    dx: float,
    box: Sequence[float],
    rho0: float = 1.0,
    c0: float = 10.0,
    visc: float = 0.01,
    capacity_multiplier: float = 2.0,
    backend: str = "auto",
    pbc: Optional[Sequence[bool]] = None,
    g_ext: Optional[Sequence[float]] = None,
    force_fn: Optional[Callable] = None,
    wall_mask: Optional[np.ndarray] = None,
    free_surface: bool = False,
    nl_skin_h: float = 0.0,
    nl_every: Optional[int] = None,
    device="cuda",
    dtype: torch.dtype = torch.float32,
):
    """Build a WCSPH stepper.

    Returns ``(nl_fns, advance, dt)`` where ``advance(r, v, nbrs, steps)``
    runs ``steps`` solver substeps (a Python loop; inputs are taken to
    ``device`` and ``dtype``) and returns ``(r, v, nbrs)``, and ``dt`` is
    the (CFL-limited) substep size ``min(0.2 h / c0, 0.25 sqrt(h/|g|))``.
    ``advance.nl_every`` is the rebuild period.

    Each substep, in the order of the JAX package's: the neighbor rebuild
    when ``k % nl_every == 0`` (``k`` counts from 0 at each ``advance``, so
    its first substep always rebuilds), density by summation, the EOS with
    the free-surface clamp, the Adami wall pressure, the pressure gradient
    and Morris viscosity, gravity and the body force, semi-implicit Euler,
    and walls reset to their ``r`` and ``v``. The neighbor list's overflow
    flag stays on the device, sticky; ``advance`` never reads it.

    Args:
        dx: particle spacing (smoothing length h = 1.5 dx, cutoff 2h).
        box: box side lengths; positions are expected in [0, box) for
            periodic dims and may slightly exceed the box in free dims.
        capacity_multiplier: headroom of the neighbor list's capacities.
        backend: neighbor backend: ``"auto"`` (K1 + K2), ``"celllist"`` or
            ``"allpairs"`` (and the reference's names).
        pbc: per-dim periodic flags; default all-periodic. Non-periodic
            dims skip the min-image fold and the shift does not wrap.
        g_ext: constant body acceleration (e.g. ``[0, -1]`` gravity).
        force_fn: per-particle body acceleration ``r (dim,) -> (dim,)`` at
            the current positions, the signature of a dataset
            ``force.py``'s ``force_fn``.
        wall_mask: static (N,) bool marking wall particles. Walls never
            integrate; their pressure/density is extrapolated from fluid
            neighbors and their velocity entries in ``v`` act as the
            prescribed wall velocity in the viscous term.
        free_surface: clamp fluid pressure to >= 0.
        nl_skin_h: Verlet-skin width as a multiple of h: the list is built
            with cutoff ``2h + skin`` and rebuilt every ``nl_every``
            substeps (every pair term vanishes for q >= 2, so the skin's
            extra neighbors add exactly zero). 0 rebuilds every substep.
        nl_every: rebuild period in substeps; default the largest safe
            period ``floor(skin / (2 u_max dt))`` with ``u_max = c0/5``.
        device: where the solver runs (CUDA unless ``"cpu"``).
        dtype: the solver's float dtype.
    """
    device = resolve_device(device)
    dim = len(box)
    h = 1.5 * dx
    m = rho0 * dx**dim
    dt = 0.2 * h / c0
    if g_ext is not None:
        g_norm = float(np.linalg.norm(np.asarray(g_ext, np.float64)))
        if g_norm > 0:
            dt = min(dt, 0.25 * float(np.sqrt(h / g_norm)))
    if pbc is None:
        pbc = [True] * dim
    pbc = [bool(p) for p in pbc]
    skin = float(nl_skin_h) * h
    if skin > 0 and nl_every is None:
        u_max = c0 / 5.0
        nl_every = max(1, int(skin / (2.0 * u_max * dt)))
    elif nl_every is None:
        nl_every = 1
    nl_fns = neighbor_list(
        None,  # the minimum image of box when periodic, else the plain difference
        box,
        2.0 * h + skin,
        backend=resolve_backend(backend),
        capacity_multiplier=capacity_multiplier,
        format="dense",
        pbc=pbc,
    )
    if dim == 2:
        sigma = 10.0 / (7.0 * np.pi * h * h)  # cubic spline, 2D
    elif dim == 3:
        sigma = 1.0 / (np.pi * h**3)  # cubic spline, 3D
    else:
        raise ValueError(f"dim must be 2 or 3, got {dim}")

    def kernel_w(q):
        return sigma * torch.where(
            q < 1,
            1 - 1.5 * q**2 + 0.75 * q**3,
            torch.where(q < 2, 0.25 * (2 - q) ** 3, 0.0),
        )

    def kernel_dw(q):
        return sigma * torch.where(
            q < 1, -3 * q + 2.25 * q**2, torch.where(q < 2, -0.75 * (2 - q) ** 2, 0.0)
        )

    def const(x, dt_=dtype):
        return torch.as_tensor(np.asarray(x), dtype=dt_, device=device)

    # the min-image fold on any periodic axis, the wrapping shift only in
    # an all-periodic box, as in the JAX package
    periodic, wrap = any(pbc), all(pbc)
    box_t = const(box)
    pbc_t = const(pbc)  # min-image only on periodic dims
    wall = None if wall_mask is None else const(wall_mask, torch.bool)
    g_vec = None if g_ext is None else const(g_ext)

    def pad_gather(a, idx):
        """Rows of ``a`` by the (N, K) dense index, fill -> 0."""
        return torch.cat([a, a.new_zeros((1,) + a.shape[1:])])[idx]

    def step(r, v, nbrs, k):
        if k % nl_every == 0:
            nbrs = nbrs.update(r)
        idx = nbrs.idx.long()  # (N, K) senders per receiver, fill = N
        n = r.shape[0]
        mask = idx < n
        r_nb = pad_gather(r, idx)
        v_nb = pad_gather(v, idx)
        dr = r[:, None, :] - r_nb
        if periodic:
            dr = dr - box_t * torch.round(dr / box_t) * pbc_t  # min-image
        d = torch.sqrt(torch.sum(dr**2, -1) + 1e-16)
        q = d / h
        w = torch.where(mask, kernel_w(q), 0.0)
        gradw = torch.where(mask, kernel_dw(q) / (h * d), 0.0)[..., None] * dr
        rho_sum = m * torch.sum(w, dim=1)  # (N,) self-edge included once

        if wall is None:
            rho = rho_sum
            p = c0**2 * (rho - rho0)  # linear EOS
            if free_surface:
                p = torch.clamp(p, min=0.0)
        else:
            p_f = c0**2 * (rho_sum - rho0)
            if free_surface:
                p_f = torch.clamp(p_f, min=0.0)
            # Adami wall BC: wall pressure from FLUID neighbors only,
            # p_w = (sum_f p_f W + g . sum_f rho_f r_wf W) / sum_f W,
            # with r_wf = r_f - r_w = -dr; density from the inverted EOS.
            fluid_nb = mask & ~pad_gather(wall, idx)
            wf = torch.where(fluid_nb, kernel_w(q), 0.0)
            sw = torch.sum(wf, dim=1)
            p_num = torch.sum(pad_gather(torch.where(wall, 0.0, p_f), idx) * wf, dim=1)
            if g_vec is not None:
                rho_f_nb = pad_gather(torch.where(wall, 0.0, rho_sum), idx)
                p_num = p_num + torch.sum(
                    rho_f_nb * wf * torch.sum((-dr) * g_vec, -1), dim=1
                )
            p_w = torch.where(sw > 1e-12, p_num / torch.clamp(sw, min=1e-12), 0.0)
            p = torch.where(wall, p_w, p_f)
            rho = torch.where(wall, p_w / c0**2 + rho0, rho_sum)
            if free_surface:
                # keep the p/rho^2 division well-behaved for surface
                # particles whose summation density is deficient
                rho = torch.clamp(rho, min=0.5 * rho0)

        pr = p / rho**2  # (N,)
        pij = pr[:, None] + pad_gather(pr, idx)  # (N, K)
        acc = -m * torch.sum(pij[..., None] * gradw, dim=1)
        vij = v[:, None, :] - v_nb  # Morris viscosity
        lam = (2 * visc * m / rho0) * torch.sum(dr * gradw, -1) / (d**2 + 0.01 * h * h)
        lam = torch.where(mask, lam, 0.0)
        acc = acc + torch.sum(lam[..., None] * vij / rho0, dim=1)
        if g_vec is not None:
            acc = acc + g_vec
        if force_fn is not None:
            acc = acc + apply_force(force_fn, r)
        v2 = v + dt * acc
        r2 = r + dt * v2
        if wrap:
            r2 = torch.remainder(r2, box_t)
        if wall is not None:
            v2 = torch.where(wall[:, None], v, v2)  # prescribed wall velocity
            r2 = torch.where(wall[:, None], r, r2)  # walls never move
        return r2, v2, nbrs

    @torch.no_grad()
    def advance(r, v, nbrs, steps: int):
        r = torch.as_tensor(r, dtype=dtype, device=device)
        v = torch.as_tensor(v, dtype=dtype, device=device)
        # k restarts at each call: the first substep of every advance()
        # rebuilds, so staleness never crosses a frame boundary
        for k in range(int(steps)):
            r, v, nbrs = step(r, v, nbrs, k)
        return r, v, nbrs

    advance.nl_every = nl_every
    return nl_fns, advance, dt


# -- initial states ----------------------------------------------------------


def tgv_initial_state(
    n_side: int, rng: np.ndarray, jitter: float = 0.1, u0: float = 1.0, dim: int = 2
):
    """Jittered particle lattice with the analytic Taylor-Green field.

    2D: the classic vortex array; 3D: ``u = sin x cos y cos z, v = -cos x
    sin y cos z, w = 0`` (divergence free) mapped onto the unit box. A
    different seed gives a different jitter realization.
    """
    dx = 1.0 / n_side
    xs = (np.arange(n_side) + 0.5) * dx
    grids = np.meshgrid(*([xs] * dim), indexing="ij")
    r = np.stack([g.ravel() for g in grids], 1)
    r = np.mod(r + rng.normal(0, jitter * dx, r.shape), 1.0)
    t = 2 * np.pi * r
    if dim == 2:
        v = u0 * np.stack(
            [
                np.sin(t[:, 0]) * np.cos(t[:, 1]),
                -np.cos(t[:, 0]) * np.sin(t[:, 1]),
            ],
            1,
        )
    else:
        v = u0 * np.stack(
            [
                np.sin(t[:, 0]) * np.cos(t[:, 1]) * np.cos(t[:, 2]),
                -np.cos(t[:, 0]) * np.sin(t[:, 1]) * np.cos(t[:, 2]),
                np.zeros(len(r)),
            ],
            1,
        )
    return r, v


def _lattice(lo, hi, dx):
    """Centered lattice covering [lo, hi) per dim at spacing dx."""
    axes = [np.arange(lo_d + 0.5 * dx, hi_d, dx) for lo_d, hi_d in zip(lo, hi)]
    grids = np.meshgrid(*axes, indexing="ij")
    return np.stack([g.ravel() for g in grids], 1)


def dam_initial_state(
    dx: float,
    rng,
    tank: Sequence[float] = (5.366, 2.0),
    column: Sequence[float] = (2.0, 1.0),
    n_layers: int = 3,
    jitter: float = 0.08,
):
    """2D dam break: water column against the left wall of a walled tank.

    The reference's DAM 2D geometry (tank 5.366 x 2.0): a ``column``-sized
    water block in the lower-left corner, ``n_layers`` static wall layers
    on the bottom and both sides, open top; shifted so wall particles sit
    at positive coordinates, in the box ``[L + 2 o, H + o]`` with
    ``o = n_layers * dx``.

    Returns ``(r, v, tag, box, wall_mask)``.
    """
    L, H = float(tank[0]), float(tank[1])
    W, Hc = float(column[0]), float(column[1])
    o = n_layers * dx
    fluid = _lattice([o, o], [o + W, o + Hc], dx)
    fluid = fluid + rng.normal(0, jitter * dx, fluid.shape)
    bottom = _lattice([0.0, 0.0], [L + 2 * o, o], dx)
    left = _lattice([0.0, o], [o, H + o], dx)
    right = _lattice([L + o, o], [L + 2 * o, H + o], dx)
    walls = np.concatenate([bottom, left, right])
    r = np.concatenate([fluid, walls]).astype(np.float64)
    v = np.zeros_like(r)
    tag = np.concatenate(
        [
            np.full(len(fluid), FLUID_TAG, np.int32),
            np.full(len(walls), WALL_TAG, np.int32),
        ]
    )
    box = [L + 2 * o, H + o]
    return r, v, tag, box, tag != FLUID_TAG


def rpf_initial_state(
    dx: float, rng, box: Sequence[float] = (1.0, 2.0), jitter: float = 0.1
):
    """2D reverse Poiseuille flow: jittered lattice at rest, periodic box,
    driven by the band-reversal body force (``rpf_force_fn``)."""
    r = _lattice([0.0, 0.0], list(box), dx)
    r = np.mod(r + rng.normal(0, jitter * dx, r.shape), np.asarray(box))
    v = np.zeros_like(r)
    tag = np.full(len(r), FLUID_TAG, np.int32)
    return r, v, tag


def rpf_force_fn(r: torch.Tensor) -> torch.Tensor:
    """Band-reversal body force of one particle: +x below mid-channel, -x
    above (the JAX package's ``rpf_force_fn``, in torch)."""
    sign = 1.0 - 2.0 * (r[1] > 1.0).to(r.dtype)
    return torch.stack([sign, torch.zeros_like(sign)])


# the JAX package's text, unchanged: a dataset written by either package
# loads in both (in the port through data.force's jax.numpy namespace)
RPF_FORCE_PY = '''"""External force for the reverse Poiseuille flow dataset."""

import jax.numpy as jnp


def force_fn(r):
    """Band-reversal body force: +x below mid-channel, -x above."""
    return jnp.where(r[1] > 1.0, -1.0, 1.0) * jnp.array([1.0, 0.0])
'''


def ldc_initial_state(
    dx: float,
    rng,
    cavity: Sequence[float] = (1.0, 1.0),
    n_layers: int = 3,
    u_lid: float = 1.0,
    jitter: float = 0.05,
):
    """2D lid-driven cavity: walled unit box, moving lid on top.

    The lid is a MOVING_WALL (tag 2) layer with prescribed velocity
    ``(u_lid, 0)`` entering the viscous interaction (lid particles never
    move but drag the fluid).

    Returns ``(r, v, tag, box, wall_mask)``.
    """
    Lx, Ly = float(cavity[0]), float(cavity[1])
    o = n_layers * dx
    fluid = _lattice([o, o], [o + Lx, o + Ly], dx)
    fluid = fluid + rng.normal(0, jitter * dx, fluid.shape)
    bottom = _lattice([0.0, 0.0], [Lx + 2 * o, o], dx)
    left = _lattice([0.0, o], [o, Ly + o], dx)
    right = _lattice([Lx + o, o], [Lx + 2 * o, Ly + o], dx)
    lid = _lattice([0.0, Ly + o], [Lx + 2 * o, Ly + 2 * o], dx)
    r = np.concatenate([fluid, bottom, left, right, lid]).astype(np.float64)
    v = np.zeros_like(r)
    v[-len(lid):, 0] = u_lid
    tag = np.concatenate(
        [
            np.full(len(fluid), FLUID_TAG, np.int32),
            np.full(len(bottom) + len(left) + len(right), WALL_TAG, np.int32),
            np.full(len(lid), MOVING_WALL_TAG, np.int32),
        ]
    )
    box = [Lx + 2 * o, Ly + 2 * o]
    return r, v, tag, box, tag != FLUID_TAG


# -- trajectories ------------------------------------------------------------


def traj_config(name: str, dx: float, dim: int, bounds, pbc, visc: float, dt: float,
                c0: float, write_every: int) -> dict:
    """The jax-sph ``config.yaml`` dict of one trajectory."""
    return {
        "case": {
            "name": name,
            "dx": dx,
            "dim": dim,
            "bounds": [[0.0, float(b)] for b in bounds],
            "pbc": [bool(p) for p in pbc],
            "viscosity": visc,
        },
        "solver": {"name": "WCSPH", "dt": float(dt), "c0": c0},
        "io": {"write_every": write_every},
    }


def _write_traj_config(d: str, name: str, dx: float, dim: int, bounds, pbc, visc: float,
                       dt: float, c0: float, write_every: int):
    import yaml

    with open(os.path.join(d, "config.yaml"), "w") as f:
        yaml.safe_dump(traj_config(name, dx, dim, bounds, pbc, visc, dt, c0, write_every), f)


def simulate_frames(r, v, nl_fns, advance, n_frames: int, write_every: int,
                    warmup_steps: int = 0, device="cuda", dtype=torch.float32,
                    label: str = "trajectory"):
    """Run one trajectory in memory.

    ``warmup_steps`` substeps, then ``n_frames`` frames ``write_every``
    substeps apart (frame 0 is the state after the warmup). The frames
    stay on the device until the end; the overflow flag is read once, after
    the last frame, and raises RuntimeError naming ``label``.

    Returns ``(frames (n_frames, N, dim) float32 numpy, r, v)``, the last
    two the final state as tensors.
    """
    r = torch.as_tensor(np.asarray(r), dtype=dtype, device=device)
    v = torch.as_tensor(np.asarray(v), dtype=dtype, device=device)
    nbrs = nl_fns.allocate(r)
    if warmup_steps:
        r, v, nbrs = advance(r, v, nbrs, warmup_steps)
    frames = torch.empty((n_frames,) + tuple(r.shape), dtype=torch.float32, device=r.device)
    for k in range(n_frames):
        if k:
            r, v, nbrs = advance(r, v, nbrs, write_every)
        frames[k] = r
    if bool(nbrs.did_buffer_overflow):
        raise RuntimeError(f"neighbor-list overflow in {label}; raise capacity_multiplier")
    return frames.cpu().numpy(), r, v


def _write_frames(d: str, frames: np.ndarray, tag: np.ndarray, first_frame_index: int = 0):
    """One ``traj_NNNN.h5`` per frame, with ``r`` and ``tag``."""
    import h5py

    for k, frame in enumerate(frames):
        with h5py.File(os.path.join(d, f"traj_{first_frame_index + k:04d}.h5"), "w") as f:
            f.create_dataset("r", data=frame)
            f.create_dataset("tag", data=tag)


def _simulate_trajectory(
    d: str,
    r,
    v,
    tag: np.ndarray,
    nl_fns,
    advance,
    n_frames: int,
    write_every: int,
    warmup_steps: int = 0,
    first_frame_index: int = 0,
    device="cuda",
):
    """Run one trajectory in float32, writing per-frame h5 files into ``d``."""
    frames, r, v = simulate_frames(r, v, nl_fns, advance, n_frames, write_every,
                                   warmup_steps, device=device, label=d)
    _write_frames(d, frames, tag, first_frame_index)
    return r, v


# -- ensemble generators -----------------------------------------------------


def generate_tgv_ensemble(
    root: str,
    n_side: int = 50,
    n_trajs: int = 70,
    n_frames: int = 126,
    write_every: int = 40,
    seed0: int = 100,
    rng_seed: int = 0,
    visc: float = 0.01,
    c0: float = 10.0,
    dim: int = 2,
    n_frames_last: Optional[int] = None,
    n_last: int = 0,
    nl_skin_h: float = 0.0,
    capacity_multiplier: float = 2.0,
    backend: str = "auto",
    verbose: bool = True,
    device="cuda",
) -> List[str]:
    """Simulate a Taylor-Green vortex ensemble to jax-sph layout.

    2D defaults give ``n_side**2 = 2500`` particles (the reference 2D TGV
    scale, ``2D_TGV_2500_10kevery100``) over ``n_frames`` frames
    ``write_every`` substeps apart; ``dim=3`` with ``n_side=20`` gives the
    reference 3D TGV scale (8000 particles). The LAST ``n_last``
    trajectories get ``n_frames_last`` frames instead (the converter puts
    trailing seeds in the test split: long test trajectories).

    ``backend`` defaults to ``"auto"`` (K1 + K2; the JAX package pins
    ``"celllist"``, see the module docstring). Returns the list of
    trajectory directories written.
    """
    device = resolve_device(device)
    dx, box = 1.0 / n_side, [1.0] * dim
    rng = np.random.default_rng(rng_seed)
    nl_fns, advance, dt = make_sph(
        dx, box, visc=visc, c0=c0, nl_skin_h=nl_skin_h,
        capacity_multiplier=capacity_multiplier, backend=backend, device=device,
    )
    case_name = f"{dim}D_TGV_{n_side ** dim}"

    dirs = []
    for i in range(n_trajs):
        d = os.path.join(root, f"{case_name}_{seed0 + i}")
        os.makedirs(d, exist_ok=True)
        dirs.append(d)
        frames = (
            n_frames_last
            if (n_last and i >= n_trajs - n_last and n_frames_last)
            else n_frames
        )
        _write_traj_config(d, "TGV", dx, dim, box, [True] * dim, visc, dt, c0, write_every)
        r, v = tgv_initial_state(n_side, rng, dim=dim)
        tag = np.zeros(len(r), dtype=np.int32)  # all fluid
        r, v = _simulate_trajectory(d, r, v, tag, nl_fns, advance, frames, write_every,
                                    device=device)
        if verbose:
            ke = float(0.5 * torch.mean(torch.sum(v**2, -1)))
            print(
                f"[wcsph] traj {i + 1}/{n_trajs}: {frames} frames, "
                f"final mean KE {ke:.4e}",
                flush=True,
            )
    return dirs


def generate_dam_ensemble(
    root: str,
    dx: float = 0.025,
    n_trajs: int = 40,
    n_frames: int = 126,
    write_every: int = 50,
    seed0: int = 100,
    rng_seed: int = 0,
    visc: float = 0.01,
    c0: float = 15.0,
    g: float = 1.0,
    backend: str = "auto",
    verbose: bool = True,
    device="cuda",
) -> List[str]:
    """Simulate a 2D dam-break ensemble to jax-sph layout.

    Scaled units: water column 2 x 1, tank 5.366 x 2 (the reference DAM 2D
    geometry), gravity 1 downward, c0 ~ 10x the surge speed
    ``sqrt(2 g H_c)``. Trajectories differ by the fluid lattice jitter;
    walls are identical, so every trajectory has the same particle count.
    ``backend`` defaults to ``"auto"`` (K1 + K2).
    """
    device = resolve_device(device)
    rng_master = np.random.default_rng(rng_seed)
    # geometry is seed-independent: build once to create the stepper
    r0, v0, tag, box, wall_mask = dam_initial_state(dx, np.random.default_rng(0))
    nl_fns, advance, dt = make_sph(
        dx,
        box,
        visc=visc,
        c0=c0,
        pbc=[False, False],
        g_ext=[0.0, -g],
        wall_mask=wall_mask,
        free_surface=True,
        backend=backend,
        device=device,
    )
    case_name = f"2D_DAM_{len(r0)}"

    dirs = []
    for i in range(n_trajs):
        d = os.path.join(root, f"{case_name}_{seed0 + i}")
        os.makedirs(d, exist_ok=True)
        dirs.append(d)
        _write_traj_config(d, "DAM", dx, 2, box, [False, False], visc, dt, c0, write_every)
        r, v, tag, _, _ = dam_initial_state(
            dx, np.random.default_rng(rng_master.integers(2**31))
        )
        r, v = _simulate_trajectory(d, r, v, tag, nl_fns, advance, n_frames, write_every,
                                    device=device)
        if verbose:
            vf = v.cpu().numpy()[~wall_mask]
            print(
                f"[wcsph] dam traj {i + 1}/{n_trajs}: {n_frames} frames, "
                f"final max |v| {np.abs(vf).max():.3f}",
                flush=True,
            )
    return dirs


def generate_rpf_trajectory(
    root: str,
    dx: float = 0.025,
    n_frames: int = 1260,
    write_every: int = 40,
    warmup_steps: int = 12000,
    seed: int = 100,
    rng_seed: int = 0,
    visc: float = 0.1,
    c0: float = 15.0,
    backend: str = "auto",
    verbose: bool = True,
    device="cuda",
) -> List[str]:
    """Simulate one long 2D reverse-Poiseuille trajectory to jax-sph layout.

    RPF is statistically stationary, so the dataset is one long trajectory
    that the converter time-splits; ``warmup_steps`` substeps bring the flow
    from rest to the steady band profile before frame 0. Defaults give 3200
    particles in the [1, 2] box (the reference RPF 2D scale). ``backend``
    defaults to ``"auto"`` (K1 + K2).
    """
    device = resolve_device(device)
    box = [1.0, 2.0]
    rng = np.random.default_rng(rng_seed)
    r, v, tag = rpf_initial_state(dx, rng, box=box)
    nl_fns, advance, dt = make_sph(
        dx, box, visc=visc, c0=c0, pbc=[True, True], force_fn=rpf_force_fn,
        backend=backend, device=device,
    )
    case_name = f"2D_RPF_{len(r)}"
    d = os.path.join(root, f"{case_name}_{seed}")
    os.makedirs(d, exist_ok=True)
    _write_traj_config(d, "RPF", dx, 2, box, [True, True], visc, dt, c0, write_every)
    r, v = _simulate_trajectory(d, r, v, tag, nl_fns, advance, n_frames, write_every,
                                warmup_steps=warmup_steps, device=device)
    if verbose:
        print(
            f"[wcsph] rpf: {n_frames} frames after {warmup_steps} warmup "
            f"substeps, final max |v| {float(torch.abs(v).max()):.3f}",
            flush=True,
        )
    return [d]


def generate_ldc_trajectory(
    root: str,
    dx: float = 1.0 / 46.0,
    n_frames: int = 1260,
    write_every: int = 40,
    warmup_steps: int = 12000,
    seed: int = 100,
    rng_seed: int = 0,
    visc: float = 0.01,
    c0: float = 10.0,
    u_lid: float = 1.0,
    backend: str = "auto",
    verbose: bool = True,
    device="cuda",
) -> List[str]:
    """Simulate one long 2D lid-driven-cavity trajectory to jax-sph layout.

    Like RPF, LDC is statistically stationary; one long trajectory is
    time-split. Defaults give a unit cavity at Re = u_lid / visc = 100 with
    ~2116 fluid particles (the reference LDC 2D scale). ``backend``
    defaults to ``"auto"`` (K1 + K2).
    """
    device = resolve_device(device)
    rng = np.random.default_rng(rng_seed)
    r, v, tag, box, wall_mask = ldc_initial_state(dx, rng, u_lid=u_lid)
    nl_fns, advance, dt = make_sph(
        dx,
        box,
        visc=visc,
        c0=c0,
        pbc=[False, False],
        wall_mask=wall_mask,
        free_surface=True,
        backend=backend,
        device=device,
    )
    case_name = f"2D_LDC_{len(r)}"
    d = os.path.join(root, f"{case_name}_{seed}")
    os.makedirs(d, exist_ok=True)
    _write_traj_config(d, "LDC", dx, 2, box, [False, False], visc, dt, c0, write_every)
    r, v = _simulate_trajectory(d, r, v, tag, nl_fns, advance, n_frames, write_every,
                                warmup_steps=warmup_steps, device=device)
    if verbose:
        vf = v.cpu().numpy()[~wall_mask]
        print(
            f"[wcsph] ldc: {n_frames} frames after {warmup_steps} warmup "
            f"substeps, final max fluid |v| {np.abs(vf).max():.3f}",
            flush=True,
        )
    return [d]
