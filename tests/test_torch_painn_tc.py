"""K5's tensor-core design (H > 256 or R > 64) on the CPU.

On the card these widths run ``csrc/painn_layer.cu`` painn_edge_tc and
painn_node_tc: the filters and the three node products on the tensor cores
(mma.sync; in float32 as three TF32 products, 3xTF32), the weights staged
by the wrapper transposed and zero-padded (``painn_msg.tc_weights``), the
intermediates in device memory (``tc_buffers``). The kernels cannot run
here; these tests hold what surrounds them and the arithmetic they repeat:

* what the wrapper decides at every H from 257 to 1,088 (past the old
  limit of 1,024) and at R past 64 (to 264, past the old 256), in 2D and 3D, float32 and bf16: the routing, the padded widths
  (``tc_widths``), the staged weights' shapes, the intermediates' bytes;
* an emulation of the design in torch on the staged layouts, float64,
  against the float64 plain version (1e-10 of the largest magnitude) at
  padded widths: it takes the same padding, transposes and sum chunks as
  the kernels;
* the wrapper's split of the float32 node weights into (hi, lo) TF32
  pairs (``tf32_pairs``), against the rounding below;
* the same emulation with the float32 split (TF32 by rounding the mantissa
  to 10 bits, ties away, as cvt.rna does; products lo x hi + hi x lo + hi x
  hi, each exact in float32, summed in float32 over chunks of 64 k) at
  PaiNN-5-512's H = 512, R = 20, within the float32 gate's 1e-4 of the
  float64 plain version's largest magnitude, and single-pass TF32 outside
  it.
"""

import numpy as np
import pytest
import torch

from lagrangebench_torch.ops import painn_msg

KC = 64  # k elements per sum chunk of the node products (csrc/painn_layer.cu TC_KC)


@pytest.mark.parametrize("dim", [2, 3])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_tc_plan_fits_every_width(dtype, dim):
    """What the wrapper decides for the tensor-core design at every H in
    257..1,088 and R in {1, 20, 64, 65, 264}, and at R in {65, 96, 256, 264}
    for narrow H: the routing, HP and RK (the padding the C entry checks; the
    launches' grids and shared memory are the kernel source's, held there
    by static_asserts), the staged weights' shapes and the intermediates'
    bytes at 16,000 receivers."""
    n = 16000
    cases = [(h, r) for h in range(257, 1089) for r in (1, 20, 64, 65, 264)]
    cases += [(h, r) for h in (1, 64, 128, 256) for r in (65, 96, 256, 264)]
    step = 16 if dtype == torch.bfloat16 else 8
    esize = 2 if dtype == torch.bfloat16 else 4
    for h, r in cases:
        assert painn_msg.is_tensor_core(h, r)
        hp, rk = painn_msg.tc_widths(h, r, dtype)
        assert hp % 64 == 0 and h <= hp < h + 64
        assert rk % step == 0 and r <= rk < r + step
    for h, r in ((512, 20), (257, 65), (1024, 256), (128, 96)):
        hp, rk = painn_msg.tc_widths(h, r, dtype)
        kp = {"filt_w": torch.empty(r, 3 * h, device="meta"), "filt_b": torch.empty(3 * h),
              "vmix_w": torch.empty(h, 2 * h, device="meta"),
              "mix_w1": torch.empty(2 * h, h, device="meta"), "mix_b1": torch.empty(h),
              "mix_w2": torch.empty(h, 3 * h, device="meta"), "mix_b2": torch.empty(3 * h)}
        shapes = [tuple(w.shape) for w in painn_msg.tc_weights(kp, h, r, hp, rk)]
        assert shapes == [(3, hp, rk), (3, hp), (2, hp, hp), (hp, 2, hp), (hp,), (3, hp, hp),
                          (3, hp)]
        bufs = painn_msg.tc_buffers(n, hp, dim, dtype, "meta")
        assert [tuple(b.shape) for b in bufs] == [(n, dim, hp), (n, 2, hp), (n, hp),
                                                  (n, dim, hp), (n, hp)]
        assert sum(b.numel() * b.element_size() for b in bufs) == n * hp * (
            (dim + 3) * esize + (dim + 1) * 4)
    # PaiNN-5-512's shape: no padding of H; R = 20 to 24 (float32), 32 (bf16)
    assert painn_msg.tc_widths(512, 20, dtype) == (512, 24 if step == 8 else 32)


def test_tc_plan_splits_wide_bases_at_use():
    """The routing at the narrow instances' edges (tensor cores from H = 257
    or R = 65 on) and the filter rows of a wide or one-wide basis staged
    whole, zero past R: RK words a row at R = 256 and 1 in float32, 96 in
    bf16 (the edge kernel stages them raw and splits them at each use)."""
    assert not painn_msg.is_tensor_core(256, 64) and painn_msg.is_tensor_core(128, 65)
    assert painn_msg.is_tensor_core(257, 1)
    for h, r, dtype in ((64, 256, torch.float32), (64, 96, torch.bfloat16),
                        (320, 1, torch.float32)):
        hp, rk = painn_msg.tc_widths(h, r, dtype)
        kp = painn_msg.layer_kernel_params(_case(h, r, 3, n=2, k=1)[-1], dtype)
        filt_t = painn_msg.tc_weights(kp, h, r, hp, rk)[0]
        step = 16 if dtype == torch.bfloat16 else 8
        assert filt_t.shape == (3, hp, rk) and rk == r + (-r) % step
        assert torch.equal(filt_t[:, :h, :r], kp["filt_w"].reshape(r, 3, h).permute(1, 2, 0))
        assert not filt_t[:, h:].any() and not filt_t[..., r:].any()


def _tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 rounded to TF32 (10 mantissa bits), to nearest with ties
    away from zero: cvt.rna.tf32.f32."""
    i = x.to(torch.float32).contiguous().view(torch.int32)
    return ((i + 0x1000) & -0x2000).view(torch.float32)


def test_tf32_pairs_split_float32():
    """The wrapper's split of the node weights: hi and lo TF32 values (the
    low 13 bits zero), hi the round to nearest of w, hi + lo equal to w
    within 2^-21 of |w| (lo keeps w - hi to TF32 precision)."""
    w = torch.as_tensor(np.random.default_rng(3).normal(size=(64, 48)), dtype=torch.float32)
    w[0, :4] = torch.tensor([1.0, -3.0, 1e-30, 0.0])
    pairs = painn_msg.tf32_pairs(w)
    assert pairs.shape == (64, 48, 2) and pairs.dtype == torch.int32
    assert int((pairs & 0x1FFF).abs().max()) == 0
    hi, lo = pairs[..., 0].view(torch.float32), pairs[..., 1].view(torch.float32)
    assert torch.equal(hi, _tf32(w)) and torch.equal(lo, _tf32(w - hi))
    assert float(((hi.double() + lo.double()) - w.double()).abs().max()) <= 2.0**-21 * float(
        w.abs().max())
    assert float((hi - w).abs().div(w.abs().clamp_min(1e-30)).max()) <= 2.0**-11


def _prod(a: torch.Tensor, bt: torch.Tensor, mode: str) -> torch.Tensor:
    """a @ bt^T as one tile's products: float64, 3xTF32 or single TF32."""
    if mode == "float64":
        return a.double() @ bt.double().T
    if mode == "tf32":
        return _tf32(a) @ _tf32(bt).T
    ah, bh = _tf32(a), _tf32(bt)
    al, bl = _tf32(a - ah), _tf32(bt - bh)
    return al @ bh.T + ah @ bl.T + ah @ bh.T


def _mm(a: torch.Tensor, bt: torch.Tensor, mode: str, chunk: int) -> torch.Tensor:
    """a (..., K) @ bt (N, K)^T over k chunks, each chunk's sum from 0 and
    then added to the running sums, as the node kernels sum."""
    total = None
    for k0 in range(0, a.shape[-1], chunk):
        part = _prod(a[..., k0:k0 + chunk], bt[:, k0:k0 + chunk], mode)
        total = part if total is None else total + part
    return total


def tc_emulated(packed, sidx, phi, nd, s, v, p, mode):
    """The tensor-core design's arithmetic in torch on its staged layouts
    (``tc_weights``): the filters over the padded basis (one running sum,
    as the edge kernel), the messages and K-sums, v1 @ vmix_t, ts @ mix1_t
    and z @ mix2_t over chunks of ``TC_KC``, padded channels zero. float64
    in ``mode="float64"``, else float32 with the products of ``_prod``."""
    acc = torch.float64 if mode == "float64" else torch.float32
    n, k, _ = phi.shape
    h, dim, r = s.shape[-1], nd.shape[-1], phi.shape[-1] - 1
    kp = painn_msg.layer_kernel_params(p, acc)
    hp, rk = painn_msg.tc_widths(h, r, torch.float32)
    filt_t, filt_b, vmix_t, mix1_t, mix_b1, mix2_t, mix_b2 = painn_msg.tc_weights(kp, h, r, hp, rk)
    basis = phi.new_zeros(n, k, rk, dtype=acc)
    basis[..., :r] = phi[..., :r]
    w = _mm(basis, filt_t.reshape(3 * hp, rk), mode, rk).to(acc)
    w = (w + filt_b.reshape(3 * hp)) * phi[..., r:].to(acc)
    rows = sidx.long().clamp(0, packed.shape[0] - 1)
    g = packed.new_zeros(n, k, 2 + dim, hp, dtype=acc)
    g[..., :h] = packed[rows].reshape(n, k, 2 + dim, h)
    ds = torch.sum(w[..., :hp] * g[:, :, 0], dim=1)
    msg1 = w[..., hp:2 * hp] * g[:, :, 1]
    s1 = s.new_zeros(n, hp, dtype=acc)
    s1[:, :h] = s.to(acc) + painn_msg._clip(ds[:, :h])
    v1 = v.new_zeros(n, dim, hp, dtype=acc)
    for d in range(dim):
        dv = torch.sum(nd[..., d:d + 1].to(acc) * msg1 + w[..., 2 * hp:] * g[:, :, 2 + d], dim=1)
        v1[:, d, :h] = v.reshape(n, dim, h)[:, d].to(acc) + painn_msg._clip(dv[:, :h])
    vm = _mm(v1, vmix_t.reshape(2 * hp, hp), mode, KC).to(acc)
    vl, vr = vm[..., :hp], vm[..., hp:]
    dot = torch.sum(vr * vl, dim=1)
    ts = torch.cat([s1, torch.sqrt(torch.sum(vr * vr, dim=1) + 1e-8)], dim=-1)
    z = _mm(ts, mix1_t.reshape(hp, 2 * hp), mode, KC).to(acc) + mix_b1
    z = z * torch.sigmoid(z)
    m = _mm(z, mix2_t.reshape(3 * hp, hp), mode, KC).to(acc) + mix_b2.reshape(-1)
    s_out = s1 + painn_msg._clip(m[:, :hp] + m[:, 2 * hp:] * dot)
    v_out = v1 + painn_msg._clip(vl * m[:, None, hp:2 * hp])
    return s_out[:, :h], v_out[..., :h].reshape(n, dim * h)


def _case(h, r, dim, n=24, k=13, m=None, seed=0):
    """Seeded float64 inputs (numpy): packed (m >= n rows), senders with
    padded slots (fill m, scale 0), basis, directions, state, parameters."""
    rng = np.random.default_rng(seed)
    m = m or n
    senders = rng.integers(0, m, size=(n, k))
    senders[rng.uniform(size=(n, k)) < 0.25] = m
    scale = rng.uniform(size=(n, k, 1)) * (senders < m)[..., None]
    t = {"packed": rng.normal(size=(m, (2 + dim) * h)),
         "phi": np.concatenate([rng.uniform(size=(n, k, r)), scale], axis=-1),
         "nd": rng.normal(size=(n, k, dim)), "s": rng.normal(size=(n, h)),
         "v": rng.normal(size=(n, dim * h))}
    p = {"filt_w": rng.normal(size=(r, 3 * h)) / np.sqrt(r),
         "filt_b": rng.normal(size=(3 * h,)) * 0.1,
         "vmix_w": rng.normal(size=(h, 2 * h)) / np.sqrt(h),
         "mix_w1": rng.normal(size=(2 * h, h)) / np.sqrt(2 * h),
         "mix_b1": rng.normal(size=(h,)) * 0.1,
         "mix_w2": rng.normal(size=(h, 3 * h)) / np.sqrt(h),
         "mix_b2": rng.normal(size=(3 * h,)) * 0.1}
    sidx = painn_msg.sender_index(torch.as_tensor(senders), m)
    t = {name: torch.as_tensor(x) for name, x in t.items()}
    p = {name: torch.as_tensor(x) for name, x in p.items()}
    return (t["packed"], sidx, t["phi"], t["nd"], t["s"], t["v"], p)


def _rel(got, want):
    return float((got - want).abs().max() / want.abs().max())


@pytest.mark.parametrize("h,r,dim,m", [(300, 20, 3, None), (300, 65, 2, None), (128, 96, 3, None),
                                       (257, 20, 2, 72)])
def test_tc_layouts_match_plain_float64(h, r, dim, m):
    """The design's arithmetic on the staged layouts (transposed, padded to
    HP and RK, the node sums in chunks) equals the plain version in float64
    within 1e-10 of the largest magnitude, at padded H and R and with a
    source table of M = 3N rows."""
    args = _case(h, r, dim, m=m)
    want = painn_msg.painn_layer_plain(*args)
    got = tc_emulated(*args, mode="float64")
    for a, b in zip(got, want):
        assert a.shape == b.shape and _rel(a, b) <= 1e-10


def test_tc_float32_split_holds_the_gate():
    """PaiNN-5-512's H = 512, R = 20 in 3D: the 3xTF32 split in the kernels'
    sum order within the float32 gate (1e-4 of the largest magnitude) of
    the float64 plain version; single-pass TF32 outside it."""
    args = _case(512, 20, 3, n=48, k=16, seed=5)
    want = painn_msg.painn_layer_plain(*args)
    f32 = tuple(a.float() if a.is_floating_point() else a for a in args[:6])
    f32 += ({name: x.float() for name, x in args[6].items()},)
    split = max(_rel(a.double(), b) for a, b in zip(tc_emulated(*f32, mode="3xtf32"), want))
    single = max(_rel(a.double(), b) for a, b in zip(tc_emulated(*f32, mode="tf32"), want))
    assert split <= 1e-5 < 1e-4 < single
