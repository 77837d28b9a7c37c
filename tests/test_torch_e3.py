"""Port parity: the steerable engine (``lagrangebench_torch.models.e3``)
against the JAX package's (``lagrangebench_tpu.models.e3``).

* ``Irreps``: parsing, dims, ``simplify``, ``sort``, the selection rule
  and ``weight_balanced_irreps``: equal to JAX's.
* ``clebsch_gordan`` for every triple up to l = 3 and ``wigner_d`` up to
  l = 3: equal to JAX's arrays within 1e-12.
* ``spherical_harmonics_fn`` up to lmax 3, zero vectors included: 1e-12
  (float64).
* ``from_mul_major`` and the m-major ``.array`` boundary: exact.
* ``O3TensorProduct`` / ``O3TensorProductGate`` from one parameter tree,
  both at ``compute_dtype="float64"``, for ``mul_y = 1`` (lmax 1 and 2
  attributes), the general ``mul_y > 1`` branch, ``y=None`` and an
  unreachable output: values within atol and rtol 1e-9; the gradients in
  x, y and every weight against ``jax.grad`` within 1e-6 of the largest
  |gradient|. JAX's float64 product is a float64 dot rounded to float32
  (``preferred_element_type=float32``), and XLA lowers that dot's
  transpose to float32 dots (it converts the float64 operand to float32),
  so its gradients are float32 sums, where the port's are float64 (up to
  2.8e-7 apart measured).
  The general branch's float64 values likewise (JAX's three-operand
  einsum rounds its intermediate to float32): 1e-6 of the largest value.
  The shipped float32 setting: 1e-5 of the largest output.
* The equivariance checks of ``tests/test_e3.py`` on the port (float32,
  the same tolerances).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lagrangebench_tpu.models import e3 as je3
from lagrangebench_tpu.models import segnn as jsegnn
from lagrangebench_torch.models import e3
from lagrangebench_torch.models import segnn

IRREPS = ["2x1o + 1x0e", "1x0e+1x1o+1x2e", "3x1o + 2x0e + 1x1o + 4x0e + 0x2e",
          "5x1o+2x1o+1x1o+5x0e+9x0e",
          "1x3o + 2x2e + 1x0o"]


@pytest.mark.parametrize("text", IRREPS)
def test_irreps_match_jax(text):
    got, want = e3.Irreps(text), je3.Irreps(text)
    assert repr(got) == repr(want)
    assert (got.dim, got.num_irreps, got.lmax) == (want.dim, want.num_irreps, want.lmax)
    assert repr(got.simplify()) == repr(want.simplify())
    assert repr(got.sort()) == repr(want.sort())
    assert repr(got.regroup()) == repr(want.regroup())
    assert repr(got * 3) == repr(want * 3)
    assert got.slices() == want.slices()
    for ir in ("0e", "1o", "2e"):
        assert got.count(ir) == want.count(ir)
    for a in got:
        for b in got:
            assert [tuple(x) for x in a.ir * b.ir] == [tuple(x) for x in
                                                       je3.Irrep(*a.ir) * je3.Irrep(*b.ir)]


@pytest.mark.parametrize("lmax", [0, 1, 2, 3])
def test_spherical_harmonics_irreps(lmax):
    assert repr(e3.Irreps.spherical_harmonics(lmax)) == repr(je3.Irreps.spherical_harmonics(lmax))


@pytest.mark.parametrize("units,lmax_attr,lmax_hidden", [(64, 1, 1), (64, 2, 2), (128, 1, 1),
                                                         (16, 1, 2), (8, 2, 1)])
def test_weight_balanced_irreps_match_jax(units, lmax_attr, lmax_hidden):
    got = segnn.weight_balanced_irreps(units, e3.Irreps.spherical_harmonics(lmax_attr),
                                       lmax_hidden)
    want = jsegnn.weight_balanced_irreps(units, je3.Irreps.spherical_harmonics(lmax_attr),
                                         lmax_hidden)
    assert repr(got) == repr(want)
    if (units, lmax_attr, lmax_hidden) == (64, 1, 1):
        assert repr(got) == "32x0e+32x1o"


TRIPLES = [(l1, l2, l3) for l1 in range(4) for l2 in range(4)
           for l3 in range(abs(l1 - l2), min(l1 + l2, 3) + 1)]


@pytest.mark.parametrize("l1,l2,l3", TRIPLES)
def test_clebsch_gordan_matches_jax(l1, l2, l3):
    got, want = e3.clebsch_gordan(l1, l2, l3), je3.clebsch_gordan(l1, l2, l3)
    assert got.shape == want.shape == (2 * l1 + 1, 2 * l2 + 1, 2 * l3 + 1)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)
    np.testing.assert_allclose(np.sum(got**2), 2 * l3 + 1, rtol=1e-12)


def random_rotation(seed=0):
    rng = np.random.default_rng(seed)
    q, r = np.linalg.qr(rng.normal(size=(3, 3)))
    q = q * np.sign(np.diag(r))
    if np.linalg.det(q) < 0:
        q[:, 0] = -q[:, 0]
    return q


@pytest.mark.parametrize("l", [0, 1, 2, 3])
def test_wigner_d_matches_jax(l):
    R = random_rotation(l)
    np.testing.assert_allclose(e3.wigner_d(l, R), je3.wigner_d(l, R), rtol=0, atol=1e-12)


@pytest.mark.parametrize("lmax", [0, 1, 2, 3])
def test_spherical_harmonics_match_jax(lmax):
    """(..., 3) inputs with zero vectors among them (padded edge slots)."""
    v = np.random.default_rng(lmax).normal(size=(5, 7, 3))
    v[0, :3] = 0.0
    v[2, 4] = 0.0
    got = e3.spherical_harmonics_fn(lmax)(torch.as_tensor(v)).numpy()
    want = np.asarray(je3.spherical_harmonics_fn(lmax)(jnp.asarray(v)))
    assert got.shape == want.shape == (5, 7, (lmax + 1) ** 2)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)
    # no direction, no l > 0 component
    np.testing.assert_array_equal(got[0, :3, 1:], 0.0)


def test_spherical_harmonics_gradient_matches_jax():
    v = np.random.default_rng(3).normal(size=(9, 3))
    cot = np.random.default_rng(4).normal(size=(9, 16))
    want = jax.grad(lambda x: jnp.sum(je3.spherical_harmonics_fn(3)(x) * cot))(jnp.asarray(v))
    x = torch.as_tensor(v).requires_grad_()
    (e3.spherical_harmonics_fn(3)(x) * torch.as_tensor(cot)).sum().backward()
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(want), rtol=1e-12, atol=1e-12)


def test_mul_major_boundary_matches_jax():
    irreps = "3x1o + 2x0e + 1x1o + 2x2e"
    a = np.random.default_rng(0).normal(size=(4, 5, e3.Irreps(irreps).dim))
    got = e3.from_mul_major(irreps, torch.as_tensor(a))
    want = je3.from_mul_major(irreps, jnp.asarray(a))
    np.testing.assert_array_equal(got.array.numpy(), np.asarray(want.array))
    for c, w in zip(got.chunks(), want.chunks()):
        np.testing.assert_array_equal(c.numpy(), np.asarray(w))
    cat = e3.concatenate([got, e3.IrrepsArray("1x0e", torch.ones(4, 5, 1, dtype=torch.float64))])
    assert repr(cat.irreps) == irreps.replace(" ", "") + "+1x0e"
    np.testing.assert_array_equal(cat.array[..., :-1].numpy(), np.asarray(want.array))


# (irreps_x, irreps_y or None, output irreps, gated)
TP_CASES = {
    "attrs_lmax1": ("2x0e + 2x1o + 1x1o + 1x0e", "1x0e + 1x1o", "3x0e + 2x1o", False),
    "gate_attrs_lmax1": ("2x0e + 2x1o + 1x1o + 1x0e", "1x0e + 1x1o", "3x0e + 2x1o", True),
    "gate_attrs_lmax2": ("3x0e + 2x1o + 2x2e", "1x0e + 1x1o + 1x2e", "2x0e + 2x1o + 1x2e", True),
    "general_y": ("2x0e + 2x1o + 1x2e", "2x0e + 2x1o", "2x0e + 2x1o + 1x2e", False),
    "linear": ("2x0e + 1x1o", None, "3x0e + 2x1o", False),
    "unreachable": ("2x0e", "1x0e", "2x0e + 1x1o", False),
}


def _tp_setup(case, cdt, dtype=np.float64, seed=0):
    ix, iy, io, gated = TP_CASES[case]
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(6, e3.Irreps(ix).dim)).astype(dtype)
    y = None if iy is None else rng.normal(size=(6, e3.Irreps(iy).dim)).astype(dtype)
    jcls = je3.O3TensorProductGate if gated else je3.O3TensorProduct
    jmod = jcls(je3.Irreps(io), compute_dtype=cdt)
    jargs = [je3.IrrepsArray(ix, jnp.asarray(x))] + (
        [] if y is None else [je3.IrrepsArray(iy, jnp.asarray(y))])
    params = jax.device_get(jmod.init(jax.random.PRNGKey(seed), *jargs)["params"])
    params = jax.tree.map(
        lambda p: (p + 0.1 * rng.normal(size=p.shape)).astype(np.float32), params)
    cls = e3.O3TensorProductGate if gated else e3.O3TensorProduct
    port = cls(ix, iy, io, compute_dtype=cdt)
    flat = {"/".join(str(k.key) for k in path): leaf
            for path, leaf in jax.tree_util.tree_flatten_with_path(params)[0]}
    leaves = port.named_leaves("")
    assert sorted(p.lstrip("/") for p, _, _ in leaves) == sorted(flat)
    with torch.no_grad():
        for path, p, _ in leaves:
            p.copy_(torch.as_tensor(flat[path.lstrip("/")]))
    return jmod, params, port, leaves, x, y, (ix, iy, io)


def _port_out(port, irreps, x, y):
    ix, iy, _ = irreps
    args = [e3.IrrepsArray(ix, x)] + ([] if y is None else [e3.IrrepsArray(iy, y)])
    return port(*args).array


def _close_to_max(got, want, tol, what):
    err = float(np.abs(np.asarray(got) - np.asarray(want)).max() / np.abs(want).max())
    assert err <= tol, f"{what}: {err:.3g} of the largest > {tol}"


@pytest.mark.parametrize("case", list(TP_CASES))
def test_tensor_product_matches_jax_float64(case):
    """Values (1e-9; the general branch 1e-6 of the largest) and the
    gradients in x, y and every parameter (1e-6 of the largest), float64
    compute on both sides."""
    jmod, params, port, leaves, x, y, irreps = _tp_setup(case, "float64")
    ix, iy, io = irreps
    cot = np.random.default_rng(9).normal(size=(6, e3.Irreps(io).dim))

    def loss(p, xa, ya):
        args = [je3.IrrepsArray(ix, xa)] + ([] if ya is None else [je3.IrrepsArray(iy, ya)])
        out = jmod.apply({"params": p}, *args).array
        return jnp.sum(out * cot), out

    wide = jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), params)
    argnums = (0, 1) if y is None else (0, 1, 2)
    (_, want), grads = jax.value_and_grad(loss, argnums=argnums, has_aux=True)(
        wide, jnp.asarray(x), None if y is None else jnp.asarray(y))

    port = port.double()
    xt = torch.as_tensor(x).requires_grad_()
    yt = None if y is None else torch.as_tensor(y).requires_grad_()
    got = _port_out(port, irreps, xt, yt)
    if case == "general_y":
        _close_to_max(got.detach().numpy(), want, 1e-6, "values")
    else:
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=1e-9, atol=1e-9)
    (got * torch.as_tensor(cot)).sum().backward()
    _close_to_max(xt.grad.numpy(), grads[1], 1e-6, "d/dx")
    if y is not None:
        _close_to_max(yt.grad.numpy(), grads[2], 1e-6, "d/dy")
    gflat = {"/".join(str(k.key) for k in path): leaf
             for path, leaf in jax.tree_util.tree_flatten_with_path(grads[0])[0]}
    for path, p, _ in leaves:
        _close_to_max(p.grad.numpy(), gflat[path.lstrip("/")], 1e-6, path)
    if case == "unreachable":
        np.testing.assert_array_equal(got[:, 2:].detach().numpy(), 0.0)


@pytest.mark.parametrize("case", ["gate_attrs_lmax1", "general_y", "linear"])
def test_tensor_product_matches_jax_float32(case):
    """The shipped setting (float32 inputs and compute): 1e-5 of the
    largest output."""
    jmod, params, port, _, x, y, irreps = _tp_setup(case, "float32", dtype=np.float32)
    ix, iy, _ = irreps
    args = [je3.IrrepsArray(ix, jnp.asarray(x))] + (
        [] if y is None else [je3.IrrepsArray(iy, jnp.asarray(y))])
    want = np.asarray(jmod.apply({"params": params}, *args).array)
    with torch.no_grad():
        got = _port_out(port, irreps, torch.as_tensor(x),
                        None if y is None else torch.as_tensor(y)).numpy()
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * np.abs(want).max())


def _rotate(irreps, x, R):
    """Rotate an irreps array in the m-major layout (rotation only)."""
    irreps = e3.Irreps(irreps)
    out = np.array(x)
    for g, sl in zip(irreps, irreps.slices()):
        D = e3.wigner_d(g.ir.l, R)
        chunk = x[..., sl].reshape(x.shape[:-1] + (g.ir.dim, g.mul))
        out[..., sl] = np.einsum("pq,...qu->...pu", D, chunk).reshape(x.shape[:-1] + (g.dim,))
    return out


@pytest.mark.parametrize("l1,l2,l3", [(1, 1, 2), (1, 2, 1), (2, 2, 2), (1, 2, 3)])
def test_cg_equivariance(l1, l2, l3):
    C = e3.clebsch_gordan(l1, l2, l3)
    R = random_rotation(5)
    D1, D2, D3 = (e3.wigner_d(l, R) for l in (l1, l2, l3))
    lhs = np.einsum("pa,qb,pqc->abc", D1, D2, C)
    rhs = np.einsum("cd,abd->abc", D3, C)
    np.testing.assert_allclose(lhs, rhs, atol=1e-8)


def test_spherical_harmonics_equivariance():
    sh = e3.spherical_harmonics_fn(2)
    R = random_rotation(1)
    v = np.random.default_rng(2).normal(size=(10, 3)).astype(np.float32)
    y1 = sh(torch.as_tensor(v @ R.T.astype(np.float32))).numpy()
    y0 = sh(torch.as_tensor(v)).numpy()
    for l in (0, 1, 2):
        sl = slice(l * l, (l + 1) * (l + 1))
        np.testing.assert_allclose(y1[:, sl], y0[:, sl] @ e3.wigner_d(l, R).T, atol=1e-6)


EQUIVARIANCE = {
    # (irreps_x, irreps_y, output irreps, gated, atol), as tests/test_e3.py
    "tp": ("2x0e + 2x1o", "1x0e + 1x1o", "3x0e + 2x1o", False, 2e-5),
    "gate": ("2x0e + 2x1o", "1x0e + 1x1o", "3x0e + 2x1o", True, 2e-5),
    "general_y": ("2x0e + 2x1o + 1x2e", "2x0e + 2x1o", "2x0e + 2x1o + 1x2e", False, 3e-5),
    "attrs_lmax2": ("3x0e + 2x1o + 2x2e", "1x0e + 1x1o + 1x2e", "2x0e + 2x1o + 1x2e", False,
                    3e-5),
    "attrs_lmax3": ("2x0e + 2x1o + 1x2e + 1x3o", "1x0e + 1x1o + 1x2e + 1x3o",
                    "2x0e + 2x1o + 1x2e + 1x3o", False, 5e-5),
}


@pytest.mark.parametrize("case", list(EQUIVARIANCE))
def test_tensor_product_equivariance(case):
    """Rotating the inputs rotates the output (float32)."""
    ix, iy, io, gated, atol = EQUIVARIANCE[case]
    cls = e3.O3TensorProductGate if gated else e3.O3TensorProduct
    mod = cls(ix, iy, io, generator=torch.Generator().manual_seed(0))
    rng = np.random.default_rng(3)
    x = rng.normal(size=(5, e3.Irreps(ix).dim)).astype(np.float32)
    y = rng.normal(size=(5, e3.Irreps(iy).dim)).astype(np.float32)

    def apply(xa, ya):
        with torch.no_grad():
            return mod(e3.IrrepsArray(ix, torch.as_tensor(xa, dtype=torch.float32)),
                       e3.IrrepsArray(iy, torch.as_tensor(ya, dtype=torch.float32))).array.numpy()

    R = random_rotation(4)
    out_then_rot = _rotate(io, apply(x, y), R)
    rot_then_out = apply(_rotate(ix, x, R), _rotate(iy, y, R))
    np.testing.assert_allclose(rot_then_out, out_then_rot, atol=atol)


def test_layout_experiment_orders_agree_on_the_cpu():
    """``experiments/e3_layout.py`` at 500 edges on the CPU: the engine
    (weights first), the contraction-first order and the per-m parts give
    the same gated product (float32, outputs of order 1: 1e-4 absolute)."""
    from lagrangebench_torch.experiments import e3_layout

    out = e3_layout.main(["--edges", "500", "--device", "cpu"])
    assert list(out) == ["stacked", "paths_first", "per_m"]
    for row in out.values():
        assert row["edges"] == 500 and row["fwd_ms"] > 0 and row["fwd_bwd_ms"] > 0
        assert row["max_abs_diff"] <= 1e-4
