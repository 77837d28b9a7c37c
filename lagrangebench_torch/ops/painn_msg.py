"""PaiNN message block (K6) and fused PaiNN layer (K5), dense (N, K) layout.

Counterpart of ``lagrangebench_tpu/ops/painn_msg.py``.

K6, ``painn_message``, per receiver over its K slots:

    msg  = wij * g[..., :3H]          (filters pre-masked: padded slots 0)
    ds   = sum_K msg[:H]
    dv_d = sum_K (nd_d * msg[H:2H] + g[..., (3+d)H:(4+d)H] * msg[2H:3H])

with g the packed sender gather [x (3H), v (dim*H)] and nd the
receiver->sender direction; ds (N, H) and dv (N, dim*H) come out in float32.

K5, ``painn_layer``, runs everything of a PaiNN layer after the interaction
context net in one call: the sender gather ``g = packed[sidx]`` of the rows
[x1, x2, u_d = v_d * x3] ((2 + dim) * H wide), the filters ``W =
(phi[:R] @ filt_w + filt_b) * phi[R]`` from the raw radial basis (the
per-edge scale, cutoff x padding mask, in the last column), the edge
message and its K-sum, the clipped residuals, the per-axis ``v1_d @
vmix_w``, the norm gate, the mixing net ``silu(ts @ mix_w1 + mix_b1) @
mix_w2 + mix_b2`` and the updates; outputs are in the compute dtype of
``s``. The kernel reads each sender row itself, so the (N, K, (2 + dim) *
H) gathered tensor that the TPU kernel takes (``painn_layer_gathered_plain``
computes from it) is never made on the forward.

Products and sums run in float32 (float64 when the inputs are float64,
which only the CPU takes). The plain versions round to the compute dtype
where the JAX package does: s1 and v1_d before their products, ts and the
silu output before theirs, and the outputs.

``painn_message`` and ``painn_layer`` are ``torch.autograd.Function``s.
Their forward runs the CUDA kernel on CUDA tensors (``csrc/painn_msg.cu``,
``csrc/painn_layer.cu``) and the plain version on CPU tensors. Their
backward recomputes the plain version under ``torch.enable_grad()`` and
returns ``torch.autograd.grad`` of it: the reference's own design
(``_painn_message_vjp_bwd`` and ``_painn_layer_vjp_bwd`` rematerialize
through the pure-JAX mirror), not a fallback; K5's carries the gradient of
``packed`` through the gather with ``models.utils.gather_rows`` (a float32
``index_add_``). Neither TPU kernel has a backward kernel.

On the card K6 takes any channel width H and K5 any H and radial-basis
width R (device memory is the one limit): its
instances of one thread per channel up to H = 256 and R = 64
(``NARROW_HIDDEN``, ``NARROW_RBF``), and past either the tensor-core design
(``csrc/painn_layer.cu`` painn_edge_tc, painn_node_tc: mma.sync products,
3xTF32 in float32, four launches whose intermediates go through device
memory; H and R padded to :func:`tc_widths`, the weights staged by
:func:`tc_weights` and, in float32, split by :func:`tf32_pairs`;
:func:`tc_buffers`; where the edge kernel's filter rows do not fit a
block, past R = 298 in float32 and 596 in bf16, it streams them from
device memory). The plain versions, and so the CPU path, take any width.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Sequence, Tuple

import torch

from .build import Kernel

NARROW_HIDDEN, NARROW_RBF = 256, 64  # K5's thread-per-channel instances; tensor cores past

LAYER_PARAM_NAMES = ("filt_w", "filt_b", "vmix_w", "mix_w1", "mix_b1",
                     "mix_w2", "mix_b2")
_LAYER_MATRICES = ("filt_w", "vmix_w", "mix_w1", "mix_w2")

PAINN_MSG = Kernel(
    "painn_msg", "painn_msg", "lbt_painn_msg",
    [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [ctypes.c_void_p],
    replaces="lagrangebench_tpu/ops/painn_msg.py:57",
)
PAINN_LAYER = Kernel(
    "painn_layer", "painn_layer", "lbt_painn_layer",
    [ctypes.c_void_p] + [ctypes.c_int] * 9 + [ctypes.c_void_p],
    replaces="lagrangebench_tpu/ops/painn_msg.py:252",
)


def _acc_dtype(dtype: torch.dtype) -> torch.dtype:
    return torch.float64 if dtype == torch.float64 else torch.float32


def _dot(a: torch.Tensor, w: torch.Tensor, cdt: torch.dtype) -> torch.Tensor:
    """a @ w with operands rounded to ``cdt`` and the sum in float32/64."""
    acc = _acc_dtype(cdt)
    return a.to(cdt).to(acc) @ w.to(cdt).to(acc)


def _clip(x: torch.Tensor) -> torch.Tensor:
    return torch.clamp(x, -1e2, 1e2)


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------

def painn_message_plain(g: torch.Tensor, wij: torch.Tensor, neg_dir: torch.Tensor,
                        h: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of K6.

    g (N, K, 3H + dim*H) packed gather [x, v]; wij (N, K, 3H) pre-masked
    filters; neg_dir (N, K, dim). Returns (ds (N, H), dv (N, dim*H)) in
    float32 (float64 for float64 inputs).
    """
    acc = _acc_dtype(g.dtype)
    dim = neg_dir.shape[-1]
    msg = wij.to(acc) * g[..., : 3 * h].to(acc)
    ds = torch.sum(msg[..., :h], dim=1)
    msg1 = msg[..., h: 2 * h]
    msg2 = msg[..., 2 * h: 3 * h]
    dvs = []
    for d in range(dim):
        vg = g[..., (3 + d) * h: (4 + d) * h].to(acc)
        nd = neg_dir[..., d: d + 1].to(acc)
        dvs.append(torch.sum(nd * msg1 + vg * msg2, dim=1))
    return ds, torch.cat(dvs, dim=-1)


def painn_layer_gathered_plain(g: torch.Tensor, phi: torch.Tensor, neg_dir: torch.Tensor,
                               s: torch.Tensor, v_flat: torch.Tensor,
                               p: Dict[str, torch.Tensor],
                               eps: float = 1e-8) -> Tuple[torch.Tensor, torch.Tensor]:
    """The fused PaiNN layer on gathered sender rows (what the TPU kernel
    takes; ``painn_layer_reference`` of the JAX package).

    g (N, K, (2 + dim) * H) the gathered rows [x1, x2, u]; phi (N, K, R + 1)
    radial basis with the per-edge scale last; neg_dir (N, K, dim); s
    (N, H) and v_flat (N, dim*H) the node state in the compute dtype; ``p``
    the ``LAYER_PARAM_NAMES`` arrays ((in, out) matrices). Returns (s_out,
    v_out) in the compute dtype.
    """
    cdt = s.dtype
    acc = _acc_dtype(cdt)
    h = s.shape[-1]
    dim = neg_dir.shape[-1]
    r = phi.shape[-1] - 1

    wij = _dot(phi[..., :r], p["filt_w"], cdt)
    wij = (wij + p["filt_b"].to(acc)) * phi[..., r:].to(acc)

    ds = torch.sum(wij[..., :h] * g[..., :h].to(acc), dim=1)
    msg1 = wij[..., h: 2 * h] * g[..., h: 2 * h].to(acc)
    w3 = wij[..., 2 * h:]
    s1 = (s.to(acc) + _clip(ds)).to(cdt)

    vls, vrs, v1s = [], [], []
    for d in range(dim):
        u_d = g[..., (2 + d) * h: (3 + d) * h].to(acc)
        nd = neg_dir[..., d: d + 1].to(acc)
        dv_d = torch.sum(nd * msg1 + w3 * u_d, dim=1)
        v1_d = (v_flat[..., d * h: (d + 1) * h].to(acc) + _clip(dv_d)).to(cdt)
        v1s.append(v1_d)
        vm = _dot(v1_d, p["vmix_w"], cdt)
        vls.append(vm[..., :h])
        vrs.append(vm[..., h:])

    v_norm = torch.sqrt(sum(vr * vr for vr in vrs) + eps)
    ts = torch.cat([s1.to(acc), v_norm], dim=-1).to(cdt)
    z = _dot(ts, p["mix_w1"], cdt) + p["mix_b1"].to(acc)
    z = (z * torch.sigmoid(z)).to(cdt)
    m = _dot(z, p["mix_w2"], cdt) + p["mix_b2"].to(acc)
    ds2 = m[..., :h]
    dv2 = m[..., h: 2 * h]
    dsv = m[..., 2 * h:] * sum(vr * vl for vr, vl in zip(vrs, vls))
    s_out = (s1.to(acc) + _clip(ds2 + dsv)).to(cdt)
    v_out = torch.cat(
        [(v1s[d].to(acc) + _clip(vls[d] * dv2)).to(cdt) for d in range(dim)], dim=-1
    )
    return s_out, v_out


def painn_layer_plain(packed: torch.Tensor, sidx: torch.Tensor, phi: torch.Tensor,
                      neg_dir: torch.Tensor, s: torch.Tensor, v_flat: torch.Tensor,
                      p: Dict[str, torch.Tensor]) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of K5: :func:`painn_layer_gathered_plain` of
    ``packed[sidx]``, the source rows (M, (2 + dim) * H) gathered by the
    (N, K) sender index, clamped to [0, M) as a JAX gather clamps. M >= N:
    the nodes' own rows (M = N), or under spatial sharding the slab's rows
    with its two halo slabs behind them (M = 3 N_loc)."""
    rows = _sender_rows(sidx, packed.shape[0])
    return painn_layer_gathered_plain(packed[rows], phi, neg_dir, s, v_flat, p)


def _sender_rows(sidx: torch.Tensor, n: int) -> torch.Tensor:
    return sidx.long().clamp(0, n - 1)


# ---------------------------------------------------------------------------
# kernel launches (CUDA tensors only)
# ---------------------------------------------------------------------------

def _check(name: str, t: torch.Tensor, dtype: torch.dtype, shape: Sequence[int],
           vec: int = 1) -> torch.Tensor:
    """Raise unless ``t`` is a contiguous CUDA tensor of this dtype and shape
    whose start is aligned for loads of ``vec`` elements at once."""
    if t.dtype != dtype or tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: {tuple(t.shape)} {t.dtype}, expected {tuple(shape)} {dtype}")
    align = vec * t.element_size()
    if not t.is_cuda or not t.is_contiguous() or t.data_ptr() % align:
        raise ValueError(f"{name}: must be a contiguous, {align}-byte aligned CUDA tensor")
    return t


def _cuda_dtype(cdt: torch.dtype, kernel: str) -> torch.dtype:
    if cdt not in (torch.bfloat16, torch.float32):
        raise ValueError(f"{kernel} kernel: compute dtype {cdt} not supported")
    return cdt


def message_vector(h: int) -> int:
    """The channels a lane of K6 loads at once at width ``h``: 4 where h %
    4 == 0, else 2 where h is even, else 1 (so that every row segment is
    aligned for the load)."""
    return 4 if h % 4 == 0 else 2 if h % 2 == 0 else 1


def painn_message_kernel(g: torch.Tensor, wij: torch.Tensor, neg_dir: torch.Tensor,
                         h: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch K6 on CUDA tensors (no autograd); see :func:`painn_message_plain`.

    g, wij and neg_dir share the compute dtype (bfloat16 or float32); H is
    any width >= 1 and dim 2 or 3; g and wij start aligned for loads of
    ``message_vector(h)`` elements.
    """
    cdt = _cuda_dtype(g.dtype, "painn_msg")
    n, k, gw = g.shape
    dim = neg_dir.shape[-1]
    if h < 1 or dim not in (2, 3):
        raise ValueError(f"painn_msg kernel: H {h} (needs >= 1), dim {dim} (needs 2 or 3)")
    vec = message_vector(h)
    _check("painn_msg g", g, cdt, (n, k, (3 + dim) * h), vec=vec)
    _check("painn_msg wij", wij, cdt, (n, k, 3 * h), vec=vec)
    _check("painn_msg neg_dir", neg_dir, cdt, (n, k, dim))
    ds = torch.empty((n, h), dtype=torch.float32, device=g.device)
    dv = torch.empty((n, dim * h), dtype=torch.float32, device=g.device)
    PAINN_MSG(*(ctypes.c_void_p(t.data_ptr()) for t in (g, wij, neg_dir, ds, dv)),
              n, k, h, dim, int(cdt == torch.bfloat16), device=g.device)
    return ds, dv


def layer_kernel_params(p: Dict[str, torch.Tensor], cdt: torch.dtype) -> Dict[str, torch.Tensor]:
    """The layer's parameters as K5 takes them: matrices in the compute
    dtype, vectors in float32 (float64 for a float64 compute dtype)."""
    acc = _acc_dtype(cdt)
    return {name: p[name].detach().to(cdt if name in _LAYER_MATRICES else acc).contiguous()
            for name in LAYER_PARAM_NAMES}


def painn_layer_kernel(packed: torch.Tensor, sidx: torch.Tensor, phi: torch.Tensor,
                       neg_dir: torch.Tensor, s: torch.Tensor, v_flat: torch.Tensor,
                       p: Dict[str, torch.Tensor]) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch K5 on CUDA tensors (no autograd); see :func:`painn_layer_plain`.

    All activations share the compute dtype of ``s`` (bfloat16 or float32),
    ``sidx`` is int32 (:func:`sender_index`); H and R (the basis width,
    ``phi``'s last axis minus one) are at least 1 and dim is 2 or 3. ``packed`` has M >= N
    rows, N the receivers of ``phi``. ``p`` is in any dtype and is
    converted with :func:`layer_kernel_params`.
    """
    cdt = _cuda_dtype(s.dtype, "painn_layer")
    n, k, _ = phi.shape
    m = packed.shape[0]
    h = s.shape[-1]
    dim = neg_dir.shape[-1]
    r = phi.shape[-1] - 1
    if h < 1 or r < 1 or dim not in (2, 3):
        raise ValueError(f"painn_layer kernel: H {h} (needs at least 1), R {r} (needs at "
                         f"least 1), dim {dim} (needs 2 or 3)")
    if m < n:
        raise ValueError(f"painn_layer kernel: packed has {m} rows, fewer than the {n} receivers")
    _check("painn_layer packed", packed, cdt, (m, (2 + dim) * h))
    _check("painn_layer sidx", sidx, torch.int32, (n, k))
    _check("painn_layer phi", phi, cdt, (n, k, r + 1))
    _check("painn_layer neg_dir", neg_dir, cdt, (n, k, dim))
    _check("painn_layer s", s, cdt, (n, h))
    _check("painn_layer v", v_flat, cdt, (n, dim * h))
    kp = layer_kernel_params(p, cdt)
    acc = _acc_dtype(cdt)
    shapes = {"filt_w": (r, 3 * h), "filt_b": (3 * h,), "vmix_w": (h, 2 * h),
              "mix_w1": (2 * h, h), "mix_b1": (h,), "mix_w2": (h, 3 * h), "mix_b2": (3 * h,)}
    for name in LAYER_PARAM_NAMES:
        _check(f"painn_layer {name}", kp[name], cdt if name in _LAYER_MATRICES else acc,
               shapes[name])
    s_out = torch.empty_like(s)
    v_out = torch.empty_like(v_flat)
    tensors = [packed, sidx, phi, neg_dir, s, v_flat] + [kp[name] for name in LAYER_PARAM_NAMES]
    tensors += [s_out, v_out]
    hp = rk = 0  # the narrow instances
    if is_tensor_core(h, r):
        hp, rk = tc_widths(h, r, cdt)
        w = list(tc_weights(kp, h, r, hp, rk))
        if cdt == torch.float32:  # vmix_t, mix1_t, mix2_t
            w[2], w[3], w[5] = (tf32_pairs(w[i]) for i in (2, 3, 5))
        tensors += [*w, *tc_buffers(n, hp, dim, cdt, s.device)]
    ptrs = [t.data_ptr() for t in tensors]
    arr = (ctypes.c_void_p * len(ptrs))(*ptrs)
    PAINN_LAYER(ctypes.cast(arr, ctypes.c_void_p), n, k, m, h, r, dim,
                int(cdt == torch.bfloat16), hp, rk, device=s_out.device)
    return s_out, v_out


def is_tensor_core(h: int, r: int) -> bool:
    """Whether K5 runs its tensor-core design at H = h, R = r (past the
    thread-per-channel instances' H = 256 or R = 64)."""
    return h > NARROW_HIDDEN or r > NARROW_RBF


def tc_widths(h: int, r: int, dtype: torch.dtype) -> Tuple[int, int]:
    """The widths the tensor-core design pads H and R to, as the C entry
    takes them: HP = 64 ceil(H / 64) (whole node tiles and k chunks), RK = R
    to a whole k-step of the filter product (8 in float32, 16 in bf16)."""
    step = 16 if dtype == torch.bfloat16 else 8
    return -(-h // 64) * 64, -(-r // step) * step


def tc_weights(kp: Dict[str, torch.Tensor], h: int, r: int, hp: int,
               rk: int) -> Tuple[torch.Tensor, ...]:
    """The layer's parameters as the tensor-core design reads them, from
    :func:`layer_kernel_params`: each matrix transposed to K-major rows and
    zero-padded (H to hp, R to rk), each bias zero-padded, in the C entry's
    order: filt_t (3, hp, rk), filt_b (3, hp), vmix_t (2, hp, hp) [section,
    column, k], mix1_t (hp, 2, hp) [column, half, k], mix_b1 (hp), mix2_t
    (3, hp, hp), mix_b2 (3, hp)."""
    w, b = kp["filt_w"], kp["filt_b"]
    filt_t = w.new_zeros(3, hp, rk)
    filt_t[:, :h, :r] = w.reshape(r, 3, h).permute(1, 2, 0)
    vmix_t = w.new_zeros(2, hp, hp)
    vmix_t[:, :h, :h] = kp["vmix_w"].reshape(h, 2, h).permute(1, 2, 0)
    mix1_t = w.new_zeros(hp, 2, hp)
    mix1_t[:h, :, :h] = kp["mix_w1"].reshape(2, h, h).permute(2, 0, 1)
    mix2_t = w.new_zeros(3, hp, hp)
    mix2_t[:, :h, :h] = kp["mix_w2"].reshape(h, 3, h).permute(1, 2, 0)
    filt_b, mix_b1, mix_b2 = b.new_zeros(3, hp), b.new_zeros(hp), b.new_zeros(3, hp)
    filt_b[:, :h] = b.reshape(3, h)
    mix_b1[:h] = kp["mix_b1"]
    mix_b2[:, :h] = kp["mix_b2"].reshape(3, h)
    return filt_t, filt_b, vmix_t, mix1_t, mix_b1, mix2_t, mix_b2


def tf32_pairs(w: torch.Tensor) -> torch.Tensor:
    """float32 ``w`` as its 3xTF32 split, the bits of (hi, lo) pairs on a
    new last axis (int32): hi is w rounded to TF32 (10 mantissa bits, to
    nearest, ties away from zero, as cvt.rna.tf32.f32 rounds), lo the rest
    w - hi rounded the same. The node products read their weights so."""
    def tf32(x):
        return (x.contiguous().view(torch.int32) + 0x1000) & -0x2000

    hi = tf32(w)
    lo = tf32(w - hi.view(torch.float32))
    return torch.stack([hi, lo], dim=-1).contiguous()


def tc_buffers(n: int, hp: int, dim: int, cdt: torch.dtype,
               device) -> Tuple[torch.Tensor, ...]:
    """The tensor-core design's intermediates, in the C entry's order: v1
    (n, dim, hp) and ts = [s1, |vr|] (n, 2, hp) and z (n, hp) in the compute
    dtype, vl (n, dim, hp) and sum_d vr_d vl_d (n, hp) in float32."""
    return (torch.empty((n, dim, hp), dtype=cdt, device=device),
            torch.empty((n, 2, hp), dtype=cdt, device=device),
            torch.empty((n, hp), dtype=cdt, device=device),
            torch.empty((n, dim, hp), dtype=torch.float32, device=device),
            torch.empty((n, hp), dtype=torch.float32, device=device))


def sender_index(senders: torch.Tensor, n: int) -> torch.Tensor:
    """The (N, K) sender rows as K5 takes them: int32, contiguous, padded
    slots (fill ``n``, the row count of ``packed``) clamped to row n - 1, as
    a JAX gather clamps."""
    return torch.clamp(senders, max=n - 1).to(torch.int32).contiguous()


# ---------------------------------------------------------------------------
# autograd Functions: kernel (or plain) forward, rematerialized plain backward
# ---------------------------------------------------------------------------

def _plain_vjp(fn, inputs, needs, cotangents):
    """Gradients of ``fn(*inputs)`` for the inputs flagged in ``needs``,
    rematerialized through ``fn`` (None for the others)."""
    with torch.enable_grad():
        leaves = [x.detach().requires_grad_(bool(need)) for x, need in zip(inputs, needs)]
        outs = fn(*leaves)
        wrt = [x for x in leaves if x.requires_grad]
        grads = iter(torch.autograd.grad(outs, wrt, cotangents, allow_unused=True)) if wrt else None
    return [next(grads) if need else None for need in needs]


class _MessageFunction(torch.autograd.Function):
    @staticmethod
    def forward(ctx, g, wij, neg_dir, h):
        ctx.h = h
        ctx.save_for_backward(g, wij, neg_dir)
        if g.is_cuda:
            return painn_message_kernel(g, wij, neg_dir, h)
        return painn_message_plain(g, wij, neg_dir, h)

    @staticmethod
    def backward(ctx, gds, gdv):
        h = ctx.h
        grads = _plain_vjp(lambda *xs: painn_message_plain(*xs, h), ctx.saved_tensors,
                           ctx.needs_input_grad[:3], (gds, gdv))
        return (*grads, None)


class _LayerFunction(torch.autograd.Function):
    @staticmethod
    def forward(ctx, packed, sidx, phi, neg_dir, s, v_flat, *params):
        ctx.save_for_backward(packed, sidx, phi, neg_dir, s, v_flat, *params)
        p = dict(zip(LAYER_PARAM_NAMES, params))
        if s.is_cuda:
            return painn_layer_kernel(packed, sidx, phi, neg_dir, s, v_flat, p)
        return painn_layer_plain(packed, sidx, phi, neg_dir, s, v_flat, p)

    @staticmethod
    def backward(ctx, gs, gv):
        from ..models.utils import gather_rows  # here: models imports this module

        packed, sidx, *rest = ctx.saved_tensors
        rows = _sender_rows(sidx, packed.shape[0])

        def plain(packed, phi, neg_dir, s, v_flat, *params):
            return painn_layer_gathered_plain(gather_rows(packed, rows), phi, neg_dir, s, v_flat,
                                              dict(zip(LAYER_PARAM_NAMES, params)))

        needs = ctx.needs_input_grad
        grads = _plain_vjp(plain, [packed, *rest], (needs[0],) + needs[2:], (gs, gv))
        return (grads[0], None, *grads[1:])


def painn_message(g: torch.Tensor, wij: torch.Tensor, neg_dir: torch.Tensor,
                  h: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """K6, differentiable: the CUDA kernel forward on CUDA tensors (the
    plain version on CPU tensors), the backward rematerialized through
    :func:`painn_message_plain`. Counts a launch only where the kernel
    runs (``PAINN_MSG.launches``)."""
    return _MessageFunction.apply(g, wij, neg_dir, h)


def painn_layer(packed: torch.Tensor, sidx: torch.Tensor, phi: torch.Tensor,
                neg_dir: torch.Tensor, s: torch.Tensor, v_flat: torch.Tensor,
                p: Dict[str, torch.Tensor]) -> Tuple[torch.Tensor, torch.Tensor]:
    """K5, differentiable: the CUDA kernel forward on CUDA tensors (the
    plain version on CPU tensors), the backward rematerialized through
    :func:`painn_layer_plain`. ``packed`` (M, (2 + dim) * H) holds the
    source rows [x1, x2, u] (M >= N: every node's own, or a slab's with its
    halo), ``sidx`` (N, K) the sender rows (int32 on the card,
    :func:`sender_index`); the gradient of ``packed`` comes back in all M
    rows. ``p`` holds the parameters as stored, and their gradients come
    back in their own dtype. Counts a launch only where the kernel runs
    (``PAINN_LAYER.launches``)."""
    return _LayerFunction.apply(packed, sidx, phi, neg_dir, s, v_flat,
                                *(p[name] for name in LAYER_PARAM_NAMES))
