"""Fused GNS message-passing step (K3), dense (N, K) layout.

Counterpart of ``lagrangebench_tpu/ops/fused_mp.py`` (forward). One call
computes, per receiver,

    first    = e @ W_e + hs_gath + hr_proj (broadcast over K) + b1
    messages = LayerNorm(relu(first) @ W2 + b2)
    e'       = e + messages
    agg      = sum_K messages * mask
    h'       = h + LayerNorm(relu(h @ W_nh + agg @ W_na + bn1) @ W_n2 + bn2)

and on the first step (``enc``) the edge encoder
``e = LayerNorm(relu(raw @ enc_w1 + enc_b1) @ enc_w2 + enc_b2)`` runs
first, on the raw (N, K, dim+1) edge features. The sender projection
``hs_gath = hs_proj[senders]`` is gathered outside, as in the JAX model.

``gns_mp_step`` launches the CUDA kernel (``csrc/fused_mp.cu``) for CUDA
tensors and runs ``gns_mp_step_plain`` for CPU tensors. The plain version
keeps the kernel's casts: products of compute-dtype operands accumulate in
float32 (float64 when the compute dtype is float64), relu(first) and agg
are cast to the compute dtype before their products, LayerNorm runs in the
accumulation dtype with eps 1e-5.

Weights are (in, out) matrices, as in the JAX parameter tree.

Training goes through ``gns_mp_step_autograd``: a ``torch.autograd.Function``
whose forward is K3 and whose backward is K4 (``csrc/fused_mp_bwd.cu``,
``gns_mp_step_bwd``; ``gns_mp_step_bwd_plain`` on CPU tensors), with the
forward rematerialized from the saved inputs, as the JAX package's
``_gns_mp_step_vjp``.

The same kernel, in other instances, reads each edge's sender row itself:
K8 (``gns_mp_step_slot``) through the slot layout's stencil table, and E2
(``gns_mp_step_window``, the probe of ``scripts/experiments/
window_select.py``) through three windows per 32-row sub-tile of compact,
cell-sorted rows.

On the card the kernels take any latent width F from 1 on (device memory
is the one limit). Up to 256 each is compiled at the instance widths of
``INSTANCES`` (64, 128, 192, 256; in bf16 the warp design at ``LATENTS``,
64 and 128, the stream design above; in float32 the tile design); above
256 the wide path serves every width (``csrc/mp_wide.cuh``: a hand-written
GEMM per product with its epilogue, then LayerNorm / residual / K-sum row
kernels; its launch plan is ``wide_plan``), except that in bf16 up to
``WGMMA_MAX`` (512) the edge side of a step is one kernel, the wgmma design
(``csrc/mp_wgmma.cuh``: TMA-fed wgmma products with T(relu(first)) and the
pre-LayerNorm x1 kept on chip, agg summed through per-tile partials), and
so is the edge side of K4's backward, its weight gradients dW_e and dW2 a
wgmma product kernel of their own (``csrc/mp_wgmma_bwd.cuh``); the node
side stays on the wide path's launches. Past 1,024 the wide path's row
kernels walk each row in 1,024-column chunks. Width F runs at
``kernel_width(F)`` = 64 ceil(F / 64), with the tensors and weights
zero-padded past F (LayerNorm scale and bias included, ``pad_params``)
and the true F passed to the kernel, which
takes every LayerNorm's statistics over the first F channels; the padded
channels come out 0. On CUDA tensors a wrapper takes its tensors at the
instance width, with ``latent`` the true width (the GNS model carries its
latents padded through the processor); ``at_true_width`` pads tensors at
the true width and slices the outputs. A width below 1 raises
``ValueError`` on a CUDA tensor. The plain versions take the same
``latent`` argument (the padded form, on the CPU) and any width.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Dict, Optional, Tuple

import torch

from .build import Kernel

PARAM_NAMES = (
    "w_s", "w_r",  # node-level sender/receiver projections (applied outside)
    "w_e", "b1", "w2", "b2", "ln1_scale", "ln1_bias",
    "w_nh", "w_na", "bn1", "wn2", "bn2", "ln2_scale", "ln2_bias",
)
ENC_PARAM_NAMES = (
    "enc_w1", "enc_b1", "enc_w2", "enc_b2", "enc_ln_scale", "enc_ln_bias",
)
_KERNEL_WEIGHTS = ("w_e", "w2", "w_nh", "w_na", "wn2")
_KERNEL_VECTORS = ("b1", "b2", "ln1_scale", "ln1_bias", "bn1", "bn2",
                   "ln2_scale", "ln2_bias")
LATENTS = (64, 128)  # the bf16 warp design's instances (GNS-5-64, GNS-10-128)
INSTANCES = (64, 128, 192, 256)  # every instance width (bf16 stream design above 128)
WGMMA_MAX = 512  # the bf16 wgmma design (csrc/mp_wgmma.cuh) in (INSTANCES[-1], WGMMA_MAX]


def kernel_width(f: int, kernel: str = "fused_mp") -> int:
    """The width that runs latent width ``f`` on the card, 64 ceil(f / 64)
    (an instance up to 256, the wide path above, any width); ``ValueError``
    for f below 1 (on the card there is no fallback to the plain version).
    A width too large for the card's memory fails where its tensors are
    allocated (torch.cuda.OutOfMemoryError)."""
    if f < 1:
        raise ValueError(f"{kernel} kernel: latent width {f} not supported on CUDA; "
                         f"the kernels take widths from 1 on")
    return -(-f // 64) * 64


def check_latent(f: int, kernel: str) -> None:
    """Raise ``ValueError`` unless the kernels take latent width ``f``."""
    kernel_width(f, kernel)


def _instance_width(width: int, latent: int, kernel: str) -> int:
    """The instance width of a wrapper's call on CUDA tensors ``width``
    wide for latent width ``latent``; ``ValueError`` unless they are that
    wide (``at_true_width`` pads tensors at the true width)."""
    f = kernel_width(latent, kernel)
    if width != f:
        raise ValueError(f"{kernel} kernel: tensors {width} wide, expected the instance width "
                         f"{f} of latent width {latent} (at_true_width pads them)")
    return f


def pad_last(x: torch.Tensor, width: int) -> torch.Tensor:
    """``x`` zero-padded along its last axis to ``width`` (``x`` itself
    when it is that wide); differentiable."""
    extra = width - x.shape[-1]
    return x if extra == 0 else torch.nn.functional.pad(x, (0, extra))


def pad_params(p: Dict[str, torch.Tensor], width: int) -> Dict[str, torch.Tensor]:
    """Step or encoder parameters zero-padded to latent width ``width``:
    (F, F) matrices in both axes, ``enc_w1`` (fe, F) in its columns, the
    (F,) vectors, LayerNorm scales and biases included, so that the padded
    channels stay 0 through the step; differentiable."""
    out = {}
    for name, v in p.items():
        if v.dim() == 2:
            rows = v.shape[0] if name == "enc_w1" else width
            out[name] = v if v.shape == (rows, width) else torch.nn.functional.pad(
                v, (0, width - v.shape[1], 0, rows - v.shape[0]))
        else:
            out[name] = pad_last(v, width)
    return out


# each step wrapper's arguments at the latent width, by position (e without
# the encoder), and the position of its encoder argument
_WIDE_ARGS = {"gns_mp_step": ((0, 1, 2, 3), 6), "gns_mp_step_bwd": ((0, 1, 2, 3, 6, 7), None),
              "gns_mp_step_slot": ((0, 3, 4, 5), 7), "gns_mp_step_window": ((0, 4, 5, 6), None)}


def at_true_width(name: str, *args, latent: int):
    """The step wrapper ``name`` (``gns_mp_step``, ``gns_mp_step_bwd``,
    ``gns_mp_step_slot`` or ``gns_mp_step_window``) on its arguments at the
    true latent width ``latent``: the tensors of that width zero-padded to
    ``kernel_width(latent)``, the one width the wrappers take on CUDA
    tensors, the parameters with them (``pad_params``), and the outputs
    cut back to ``latent`` (K4's parameter gradients in every axis). The
    model carries its latents padded instead (``models.gns``); the kernel
    checks and probes call this. On CPU tensors the wrapper runs its plain
    version, which takes any width, on the arguments as they are."""
    f = kernel_width(latent, name)
    wide, enc = _WIDE_ARGS[name]
    if not args[wide[1]].is_cuda:
        return globals()[name](*args, latent=latent)
    raw = enc is not None and len(args) > enc and args[enc] is not None
    args = [pad_last(a, f) if i in wide and not (i == 0 and raw)
            else pad_params(a, f) if isinstance(a, dict) else a for i, a in enumerate(args)]
    out = globals()[name](*args, latent=latent)
    return tuple(o[..., :latent].contiguous() if isinstance(o, torch.Tensor)
                 else {k: v[(slice(0, latent),) * v.dim()] for k, v in o.items()} for o in out)


def _design(cdt: torch.dtype, width: int) -> str:
    """The kernel design of the instance at ``width`` in compute dtype
    ``cdt``: "warp" (bf16 at F <= 128: weights resident in shared memory,
    A operands in registers), "stream" (bf16 above: weights streamed
    through a ring of slabs, A operands in shared memory, K4's weight
    gradients in a product kernel of their own) or "tile" (float32). Both
    bf16 designs run an edge and a node kernel with an agg scratch. Above
    ``INSTANCES[-1]``: "wgmma" in bf16 up to ``WGMMA_MAX`` (the edge side of
    a step in one kernel, ``csrc/mp_wgmma.cuh``, and of K4's backward in
    one kernel with dW_e and dW2 in a wgmma product kernel,
    ``csrc/mp_wgmma_bwd.cuh``; the node side on the wide path's launches),
    else "wide" (``csrc/mp_wide.cuh``: float32 at every wide width, bf16
    above ``WGMMA_MAX``)."""
    if width > INSTANCES[-1]:
        return "wgmma" if cdt == torch.bfloat16 and width <= WGMMA_MAX else "wide"
    if cdt != torch.bfloat16:
        return "tile"
    return "warp" if width <= LATENTS[-1] else "stream"


_ARGTYPES = [ctypes.c_void_p] + [ctypes.c_int] * 6 + [ctypes.c_void_p] * 2
FUSED_MP = Kernel(
    "fused_mp", "fused_mp", "lbt_fused_mp", _ARGTYPES,
    replaces="lagrangebench_tpu/ops/fused_mp.py:177",
)
FUSED_MP_ENC = Kernel(
    "fused_mp_enc", "fused_mp", "lbt_fused_mp", _ARGTYPES,
    replaces="lagrangebench_tpu/ops/fused_mp.py:177",
)


# the bf16 kernels: warps per block, rows per warp slice, nodes per block of
# the backward's node kernel (warp design), rows per chunk of the weight-
# gradient product kernel (stream design)
_WARPS, _SLICE, _NODE_BWD_ROWS, _TN_CHUNK = 8, 16, 64, 32
_N_PTRS = 38  # the forward entries' pointer array (csrc/fused_mp.cu)
# the wide path (csrc/mp_wide.cuh): output tile and k-slab of its bf16
# products, their cp.async ring stages, the float32 products' tile and
# k-slab, warps (rows) per block of its row kernels
WIDE_TILE, _WIDE_KS, _WIDE_STAGES, _WIDE_TILE_F32, _WIDE_KS_F32 = 128, 32, 3, 64, 16
_WIDE_ROW_WARPS = 8
# the wgmma design (csrc/mp_wgmma.cuh): edge rows per tile, k rows per weight
# slab, blocks per cluster (sharing each slab by TMA multicast), the most
# stages of its ring
_WGMMA_ROWS, _WGMMA_KS, _WGMMA_CLUSTER, _WGMMA_MAX_STAGES = 64, 32, 2, 6
# its K4 weight-gradient kernel (csrc/mp_wgmma_bwd.cuh fused_mp_bwd_tn_wgmma):
# the output tile's side, edge rows per stage (and per chunk of its row
# ranges), stages, and the waves of blocks its ranges aim at
WGMMA_TN_TILE, _WGMMA_TN_ROWS, _WGMMA_TN_STAGES, _WGMMA_TN_WAVES = 128, 64, 4, 4
SMEM_LIMIT = 232448  # a block's shared memory on an H100 (227 KB)


def mp_grids(n: int, k: int, sms: int) -> Tuple[int, int]:
    """(edge, node) grids of the bf16 kernels for n receivers of k edge rows
    on a card of ``sms`` SMs: the persistent edge kernel takes one block per
    SM, fewer when its 8 warps would not get a 16-row slice each; the node
    kernel one block per 8 slices of 16 nodes, at most one per SM."""
    edge = -(-n * k // (_SLICE * _WARPS))
    node = -(-n // (_SLICE * _WARPS))
    return max(1, min(sms, edge)), max(1, min(sms, node))


def bwd_stream_plan(n: int, k: int, sms: int) -> Tuple[int, int, int, int]:
    """The bf16 stream design's K4 launch plan for n receivers of k edge rows
    on a card of ``sms`` SMs: (edge grid, node grid, r_e, r_n), the grids of
    ``mp_grids`` and the row ranges into which the weight-gradient product
    kernel splits each edge gradient's n k rows (dW_e, dW2) and each node
    gradient's n rows (dW_nh, dW_na, dW_n2). Each range is summed by two
    blocks (the two halves of the output rows); the ranges take whole
    32-row chunks, about equally many each over all five gradients, and
    their 2 (2 r_e + 3 r_n) blocks fit one wave of the SMs where the card
    has 12 or more."""
    edge, node = mp_grids(n, k, sms)
    ce, cn = -(-n * k // _TN_CHUNK), -(-n // _TN_CHUNK)
    slots = max(1, sms // 2 - 5)  # the rounding up below adds at most 5 ranges
    per = max(1, -(-(2 * ce + 3 * cn) // slots))
    return edge, node, -(-ce // per), -(-cn // per)


def wgmma_stages(f: int) -> int:
    """The ring stages of the wgmma edge kernel at width ``f``: as many
    32-deep weight slabs as fit beside the E and R tiles, the LayerNorm
    exchange and the barriers, at most ``_WGMMA_MAX_STAGES``
    (``csrc/mp_wgmma.cuh`` GSmem)."""
    tile, stage = _WGMMA_ROWS * f * 2, _WGMMA_KS * f * 2
    fit = (SMEM_LIMIT - 1024 - 2 * tile - 1024 - (2 * _WGMMA_MAX_STAGES + 4) * 8) // stage
    return min(fit, _WGMMA_MAX_STAGES)


def wgmma_smem_bytes(f: int) -> int:
    """Shared memory of the wgmma edge kernel at width ``f``: the E and R
    tiles (64 x f bf16 each), ``wgmma_stages(f)`` weight slabs (32 x f
    bf16), the LayerNorm exchange (2 passes x 2 warpgroups x 64 float32
    row sums), 2 stages + 4 mbarriers and 1,024 bytes to align the tiles."""
    stages = wgmma_stages(f)
    return (2 * _WGMMA_ROWS * f * 2 + stages * _WGMMA_KS * f * 2 + 1024
            + (2 * stages + 4) * 8 + 1024)


def wgmma_bwd_stages(f: int) -> int:
    """The ring stages of K4's wgmma edge-backward kernel at width ``f``:
    its block is the edge kernel's (``wgmma_smem_bytes``) plus the consumer
    warps' running vector sums (8 warps x 3 x f / 2 float32), as many 32 x
    f weight slabs as then fit, at most ``_WGMMA_MAX_STAGES``
    (``csrc/mp_wgmma_bwd.cuh`` GBSmem)."""
    tile, stage, vec = _WGMMA_ROWS * f * 2, _WGMMA_KS * f * 2, 8 * 3 * (f // 2) * 4
    fit = (SMEM_LIMIT - 1024 - 2 * tile - 1024 - vec - (2 * _WGMMA_MAX_STAGES + 4) * 8) // stage
    return min(fit, _WGMMA_MAX_STAGES)


def wgmma_bwd_smem_bytes(f: int) -> int:
    """Shared memory of K4's wgmma edge-backward kernel at width ``f``: the
    E and R tiles, ``wgmma_bwd_stages(f)`` weight slabs, the LayerNorm
    exchange, the warps' running vector sums, the barriers and 1,024 bytes
    to align the tiles."""
    stages = wgmma_bwd_stages(f)
    return (2 * _WGMMA_ROWS * f * 2 + stages * _WGMMA_KS * f * 2 + 1024 + 8 * 3 * (f // 2) * 4
            + (2 * stages + 4) * 8 + 1024)


def wgmma_tn_smem_bytes() -> int:
    """Shared memory of the wgmma design's K4 weight-gradient kernel: its
    stages of a 64-row A and B slab (128 columns each, bf16), their full and
    empty mbarriers and 1,024 bytes to align the swizzled panels."""
    stage = 2 * _WGMMA_TN_ROWS * WGMMA_TN_TILE * 2
    return _WGMMA_TN_STAGES * stage + 2 * _WGMMA_TN_STAGES * 8 + 1024


def wgmma_tn_ranges(rows: int, f: int, sms: int) -> int:
    """The row ranges of the wgmma design's dW_e and dW2 (each gradient one
    float32 f x f partial per range): whole 64-row chunks, enough that the
    kernel's (ceil(f / 128)^2 tiles x ranges x 2 gradients) blocks fill
    about ``_WGMMA_TN_WAVES`` waves of the SMs, at most one per chunk."""
    side = -(-f // WGMMA_TN_TILE)
    chunks = -(-rows // _WGMMA_TN_ROWS)
    return max(1, min(chunks, -(-_WGMMA_TN_WAVES * sms // (2 * side * side))))


def wgmma_tn_rows(rows: int, ranges: int, r: int) -> Tuple[int, int]:
    """The rows [lo, hi) of range r of the wgmma design's weight-gradient
    kernel: ``rows`` split into ``ranges`` runs of whole 64-row chunks
    (``csrc/mp_wgmma_bwd.cuh`` tn_range)."""
    chunks = -(-rows // _WGMMA_TN_ROWS)
    c0, c1 = chunks * r // ranges, chunks * (r + 1) // ranges
    return c0 * _WGMMA_TN_ROWS, min(c1 * _WGMMA_TN_ROWS, rows)


def wgmma_slots(k: int) -> int:
    """The agg partials per tile of the wgmma design: the receivers of k
    edge rows that 64 consecutive rows can touch, floor(63 / k) + 2, at most
    64."""
    return min(63 // k + 2, _WGMMA_ROWS)


def wide_smem_bytes(cdt: torch.dtype, f: Optional[int] = None) -> int:
    """Shared memory of the wide path's largest block: with the wgmma
    design at width ``f`` (bf16, f <= ``WGMMA_MAX``) its edge kernel's
    (``wgmma_smem_bytes``); else at any width in bf16 the product kernel's
    ring of ``_WIDE_STAGES`` stages, each a 128 x 32 A tile and a 32-deep B
    tile in the layout the operand lies in (rows padded by 8 bf16), the
    largest over its three layouts (A @ W, A @ W^T, A^T B); in float32 its
    two 16 x 64 tiles (rows padded by 4); the row kernels use none."""
    if f is not None and _design(cdt, f) == "wgmma":
        return max(wgmma_smem_bytes(f), wide_smem_bytes(cdt))
    if cdt != torch.bfloat16:
        return 2 * _WIDE_KS_F32 * (_WIDE_TILE_F32 + 4) * 4
    a_rows, a_t = WIDE_TILE * (_WIDE_KS + 8), _WIDE_KS * (WIDE_TILE + 8)
    layouts = ((a_rows, _WIDE_KS * (WIDE_TILE + 8)), (a_rows, WIDE_TILE * (_WIDE_KS + 8)),
               (a_t, _WIDE_KS * (WIDE_TILE + 8)))
    return _WIDE_STAGES * max(a + b for a, b in layouts) * 2


def wide_plan(n: int, k: int, f: int, sms: int, cdt: torch.dtype = torch.bfloat16) -> Dict:
    """The wide path's launch plan for n receivers of k edge rows at width
    ``f`` (> 256, a multiple of 64) on a card of ``sms`` SMs:

    - ``edge_grid``, ``node_grid``: the product grids over the n k edge rows
      and the n node rows (output tiles of ``WIDE_TILE``, 64 in float32);
    - ``r_e``, ``r_n``: the row ranges of the edge (dW_e, dW2) and node
      (dW_nh, dW_na, dW_n2) weight gradients, whole 32-row chunks (``tn_rows``),
      enough that each gradient's launch fills about two waves of the SMs;
      ``tn_grid`` each gradient's grid;
    - ``p_e``, ``p_n``: the warps of K4's edge and node row kernels (one row
      or receiver per warp at a time, a fixed stride), each writing its own
      vector partials; ``row_warps`` per block (``rows_per_block`` rows at a
      time);
    - ``stages`` of the bf16 product ring and ``smem_bytes``, the largest
      block's shared memory (``wide_smem_bytes``);
    - ``design`` (``_design``) and, for the wgmma design, its edge kernel's
      ``tiles`` of 64 edge rows, ``slots`` (``wgmma_slots``) and
      ``partials`` (float32 agg partials, tiles x slots x f), its persistent
      grid ``edge_ctas`` (whole clusters of ``cluster`` blocks, at most one
      block per SM and one cluster per two tiles) and ring ``edge_stages``
      (K4's edge-backward kernel runs the same grid and ring); K4's
      ``r_e`` is then its weight-gradient kernel's ranges
      (``wgmma_tn_ranges``, ``tn_grid[0]`` its grid: output tiles, ranges,
      2 gradients; ``tn_smem`` its shared memory), ``p_e`` its
      edge-backward kernel's vector rows, 4 per block, and that kernel's
      ``bwd_stages`` and ``bwd_smem``."""
    tile = WIDE_TILE if cdt == torch.bfloat16 else _WIDE_TILE_F32
    side = -(-f // tile)

    def ranges(rows):
        return max(1, min(-(-rows // _TN_CHUNK), -(-2 * sms // (side * side))))

    warps = _WIDE_ROW_WARPS * max(1, min(-(-n // _WIDE_ROW_WARPS), 2 * sms))
    r_e, r_n = ranges(n * k), ranges(n)
    plan = {"edge_grid": (-(-n * k // tile), side), "node_grid": (-(-n // tile), side),
            "r_e": r_e, "r_n": r_n, "tn_grid": ((side, side, r_e), (side, side, r_n)),
            "p_e": warps, "p_n": warps, "row_warps": _WIDE_ROW_WARPS,
            "rows_per_block": _WIDE_ROW_WARPS, "stages": _WIDE_STAGES,
            "smem_bytes": wide_smem_bytes(cdt, f), "design": _design(cdt, f)}
    if plan["design"] == "wgmma":
        tiles, cl = -(-n * k // _WGMMA_ROWS), _WGMMA_CLUSTER
        ctas = min(-(-tiles // cl), sms // cl) * cl
        tn_side = -(-f // WGMMA_TN_TILE)
        r_e = wgmma_tn_ranges(n * k, f, sms)
        plan.update(tiles=tiles, slots=wgmma_slots(k), cluster=cl,
                    partials=tiles * wgmma_slots(k) * f, edge_ctas=ctas,
                    edge_stages=wgmma_stages(f), r_e=r_e, p_e=4 * ctas,
                    tn_grid=((tn_side * tn_side, r_e, 2), (side, side, r_n)),
                    tn_smem=wgmma_tn_smem_bytes(), bwd_stages=wgmma_bwd_stages(f),
                    bwd_smem=wgmma_bwd_smem_bytes(f))
    return plan


def _wide_plan_ints(plan: Dict) -> Tuple[int, int, int, int]:
    """The (r_e, r_n, p_e, p_n) that the wide backward and its reduction take."""
    return plan["r_e"], plan["r_n"], plan["p_e"], plan["p_n"]


def _wide_buffers(n: int, k: int, f: int, cdt: torch.dtype, device, backward: bool = False,
                  enc: bool = False, senders: bool = False):
    """The wide path's device buffers (rows = n k), in the order of its entry
    points' pointers (csrc/fused_mp.cu 29-37, csrc/fused_mp_bwd.cu 28-38);
    None where a forward needs none. Forward: sender rows (int32, K8 and E2),
    the encoded e (with the encoder), x (float32), T(relu(first)), T(agg),
    agg (float32; not kept), T(relu(node_first)), y (float32), and the
    wgmma design's agg partials (float32, ``wgmma_slots(k)`` rows of f per
    64-row tile), which keeps e, x and T(relu(first)) on chip: it takes
    none of them. Backward: T(relu(first)), x1 (float32, then dfirst; None
    for the wgmma design, which keeps it on chip), T(agg),
    T(relu(node_first)), y1, T(dy1), dnf, T(dnf), dagg (float32 where not
    T), T(dx1) and the wgmma design's agg partials (then its per-receiver
    dfirst partials); the wrapper adds the wgmma design's W_e^T and W2^T."""
    rows, f32 = n * k, torch.float32
    wgmma = _design(cdt, f) == "wgmma"
    part = torch.empty((-(-rows // _WGMMA_ROWS) * wgmma_slots(k) * f,), dtype=f32,
                       device=device) if wgmma else None

    def buf(r, dt):
        return torch.empty((r, f), dtype=dt, device=device)

    if backward:
        return [buf(rows, cdt), None if wgmma else buf(rows, f32), buf(n, cdt), buf(n, cdt),
                buf(n, f32), buf(n, cdt), buf(n, f32), buf(n, cdt), buf(n, f32), buf(rows, cdt),
                part]
    sender_rows = torch.empty((rows,), dtype=torch.int32, device=device) if senders else None
    if wgmma:
        return [sender_rows, None, None, None, buf(n, cdt), None, buf(n, cdt), buf(n, f32), part]
    return [sender_rows, buf(rows, cdt) if enc else None, buf(rows, f32), buf(rows, cdt),
            buf(n, cdt), None, buf(n, cdt), buf(n, f32), None]


def _ptrs(tensors) -> list:
    return [0 if t is None else t.data_ptr() for t in tensors]


def tn_rows(rows: int, ranges: int, r: int) -> Tuple[int, int]:
    """The rows [lo, hi) of range r of ``rows`` rows split into ``ranges``
    runs of whole 32-row chunks (the weight-gradient product kernel's
    fixed partition; ``csrc/fused_mp_bwd.cu`` fused_mp_bwd_tn)."""
    chunks = -(-rows // _TN_CHUNK)
    c0, c1 = chunks * r // ranges, chunks * (r + 1) // ranges
    return c0 * _TN_CHUNK, min(c1 * _TN_CHUNK, rows)


def bwd_partials_floats(n: int, grid: int, bf16: bool, f: int,
                        plan: Optional[Tuple[int, int, int, int]] = None) -> int:
    """Floats of K4's per-block partials at instance width ``f``: the
    float32 tile design, ``grid`` blocks of the 13 gradients; the bf16 warp
    design, the node kernel's blocks (64 nodes each) of the three node
    matrices and four node vectors, then ``grid`` blocks of dW2 and the four
    edge vectors, then ``grid`` blocks of dW_e; the bf16 stream design (f >
    128, ``plan`` from ``bwd_stream_plan``), each row range's F x F partial
    (2 r_e + 3 r_n of them), then the edge and the node kernel's blocks of
    their four vectors; the wide path (f > 256, either dtype, ``plan`` the
    (r_e, r_n, p_e, p_n) of ``wide_plan``), each row range's F x F partial,
    then the edge and the node row kernels' warps of their four vectors
    (the wgmma design: its edge-backward kernel's vector rows, then the
    node row kernels' warps)."""
    if f > INSTANCES[-1]:
        r_e, r_n, p_e, p_n = plan
        return (2 * r_e + 3 * r_n) * f * f + (p_e + p_n) * 4 * f
    if not bf16:
        return grid * (5 * f * f + 8 * f)
    if f > LATENTS[-1]:
        edge, node, r_e, r_n = plan
        return (2 * r_e + 3 * r_n) * f * f + (edge + node) * 4 * f
    return -(-n // _NODE_BWD_ROWS) * (3 * f * f + 4 * f) + grid * (2 * f * f + 4 * f)


@functools.lru_cache(maxsize=None)
def _sms_of(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _sms(device: torch.device) -> int:
    return _sms_of(torch.cuda.current_device() if device.index is None else device.index)


def _grid_array(device: torch.device, n: int, k: int):
    return (ctypes.c_int * 2)(*mp_grids(n, k, _sms(device)))


def _acc_dtype(cdt: torch.dtype) -> torch.dtype:
    return torch.float64 if cdt == torch.float64 else torch.float32


def _normalize(x: torch.Tensor, n: Optional[int] = None, eps: float = 1e-5):
    """(xhat, inv): LayerNorm's normalized ``x`` and inverse deviation over
    the first ``n`` channels (all by default); xhat is 0 past n."""
    w = x.shape[-1]
    n = w if n is None else n
    xt = x if n == w else x[..., :n]
    mean = xt.mean(dim=-1, keepdim=True)
    inv = torch.rsqrt(((xt - mean) ** 2).mean(dim=-1, keepdim=True) + eps)
    return pad_last((xt - mean) * inv, w), inv


def _layernorm(x: torch.Tensor, scale, bias, n: Optional[int] = None) -> torch.Tensor:
    """LayerNorm over the first ``n`` channels; past n the zero-padded scale
    and bias give 0."""
    return _normalize(x, n)[0] * scale.to(x.dtype) + bias.to(x.dtype)


def _dot(a: torch.Tensor, w: torch.Tensor, cdt: torch.dtype) -> torch.Tensor:
    """a @ w with operands rounded to ``cdt`` and the sum in float32/64."""
    acc = _acc_dtype(cdt)
    return a.to(cdt).to(acc) @ w.to(cdt).to(acc)


def encode_edges_plain(raw: torch.Tensor, enc: Dict[str, torch.Tensor],
                       cdt: torch.dtype, latent: Optional[int] = None) -> torch.Tensor:
    """Edge-encoder MLP on raw edge features: LN(relu(raw@W1+b1)@W2+b2),
    the LayerNorm over the first ``latent`` channels (all by default)."""
    acc = _acc_dtype(cdt)
    x = _dot(raw, enc["enc_w1"], cdt) + enc["enc_b1"].to(acc)
    x = torch.relu(x)
    x = _dot(x, enc["enc_w2"], cdt) + enc["enc_b2"].to(acc)
    return _layernorm(x, enc["enc_ln_scale"], enc["enc_ln_bias"], latent).to(cdt)


def gns_mp_step_plain(
    e: torch.Tensor,
    hs_gath: torch.Tensor,
    hr_proj: torch.Tensor,
    h: torch.Tensor,
    mask: torch.Tensor,
    p: Dict[str, torch.Tensor],
    enc: Optional[Dict[str, torch.Tensor]] = None,
    latent: Optional[int] = None,
):
    """Plain PyTorch version of the fused step (same math, same casts).

    e (N, K, F) edge latents, or raw (N, K, Fe) features with ``enc``;
    hs_gath (N, K, F); hr_proj (N, F); h (N, F); mask (N, K).
    Returns (e' (N, K, F), h' (N, F)) in the compute dtype of hs_gath / h.
    With ``latent`` < F (the padded form the kernels take) every LayerNorm
    runs over the first ``latent`` channels and the parameters are
    zero-padded past it (``pad_params``), so the padded channels stay 0.
    """
    cdt = hs_gath.dtype
    acc = _acc_dtype(cdt)
    if enc is not None:
        e = encode_edges_plain(e, enc, cdt, latent)
    e = e.to(cdt)
    first = _dot(e, p["w_e"], cdt) + hs_gath.to(acc)
    first = first + hr_proj.to(acc)[:, None, :] + p["b1"].to(acc)
    x = _dot(torch.relu(first), p["w2"], cdt) + p["b2"].to(acc)
    messages = _layernorm(x, p["ln1_scale"], p["ln1_bias"], latent)
    e_out = (e.to(acc) + messages).to(cdt)

    agg = torch.sum(messages * mask[..., None].to(acc), dim=1)
    node_first = _dot(h, p["w_nh"], cdt) + _dot(agg, p["w_na"], cdt)
    y = _dot(torch.relu(node_first + p["bn1"].to(acc)), p["wn2"], cdt)
    y = y + p["bn2"].to(acc)
    h_out = h.to(acc) + _layernorm(y, p["ln2_scale"], p["ln2_bias"], latent)
    return e_out, h_out.to(h.dtype)


def gns_mp_step(
    e: torch.Tensor,
    hs_gath: torch.Tensor,
    hr_proj: torch.Tensor,
    h: torch.Tensor,
    mask: torch.Tensor,
    p: Dict[str, torch.Tensor],
    enc: Optional[Dict[str, torch.Tensor]] = None,
    latent: Optional[int] = None,
    first_out: Optional[torch.Tensor] = None,
    agg_out: Optional[torch.Tensor] = None,
):
    """K3: the fused step; the CUDA kernel on CUDA tensors, else the plain
    version. See :func:`gns_mp_step_plain` for shapes and ``latent`` (the
    true width; the tensors' width F by default). For checks, the wgmma
    design only (the plain version leaves them): ``first_out``, an (N, K, F)
    tensor of the compute dtype, receives T(relu(first)) and ``agg_out``, a
    float32 (N, F) one, the step's agg, as the kernel computed them.

    On CUDA the compute dtype (of hs_gath, hr_proj, h, and e unless
    ``enc``) is bfloat16 or float32, weights are (in, out) in the compute
    dtype and vectors float32 (``kernel_params`` converts a parameter dict
    once), and ``latent`` is at least 1. The tensors are
    ``kernel_width(latent)`` wide, zero past ``latent``, and so are the
    outputs; the parameters may be at either width (``at_true_width``
    takes tensors at the true width).
    """
    width = hs_gath.shape[-1]
    latent = width if latent is None else latent
    if not hs_gath.is_cuda:
        return gns_mp_step_plain(e, hs_gath, hr_proj, h, mask, p, enc, latent)
    cdt = hs_gath.dtype
    if cdt not in (torch.bfloat16, torch.float32):
        raise ValueError(f"fused_mp kernel: compute dtype {cdt} not supported")
    f = _instance_width(width, latent, "fused_mp")
    p = pad_params(p, f)
    enc = pad_params(enc, f) if enc is not None else None
    n, k, _ = hs_gath.shape
    if hr_proj.shape != (n, f) or h.shape != (n, f) or mask.shape != (n, k):
        raise ValueError("fused_mp kernel: inconsistent shapes")
    if hr_proj.dtype != cdt or h.dtype != cdt:
        raise ValueError("fused_mp kernel: hs_gath, hr_proj and h must share a dtype")
    if enc is None:
        if e.shape != (n, k, f) or e.dtype != cdt:
            raise ValueError("fused_mp kernel: e must be (N, K, F) in the compute dtype")
    elif e.shape[:2] != (n, k) or e.dtype != torch.float32:
        raise ValueError("fused_mp kernel: raw edge features must be (N, K, Fe) float32")
    mask = mask if mask.dtype == torch.float32 else mask.to(torch.float32)
    tensors = [e, hs_gath, hr_proj, h, mask]
    if any(not t.is_cuda or not t.is_contiguous() for t in tensors):
        raise ValueError("fused_mp kernel: inputs must be contiguous CUDA tensors")

    e_out = torch.empty((n, k, f), dtype=cdt, device=h.device)
    h_out = torch.empty_like(h)
    params, fe = _step_pointers(p, enc, cdt, f, e)
    agg = _agg_scratch(n, f, cdt, h.device)
    ptrs = [t.data_ptr() for t in tensors + [e_out, h_out] + params]
    ptrs += [0] * (28 - len(ptrs)) + [agg.data_ptr() if agg is not None else 0]
    bufs = (_wide_buffers(n, k, f, cdt, h.device, enc=enc is not None)
            if f > INSTANCES[-1] else [None] * 9)
    if first_out is not None or agg_out is not None:
        if _design(cdt, f) != "wgmma":
            raise ValueError("fused_mp kernel: first_out and agg_out are the wgmma design's "
                             f"(bf16, F in ({INSTANCES[-1]}, {WGMMA_MAX}])")
        if first_out is not None:
            bufs[3] = _checked(first_out, cdt, (n, k, f))
        if agg_out is not None:
            bufs[5] = _checked(agg_out, torch.float32, (n, f))
    ptrs += _ptrs(bufs)
    arr = (ctypes.c_void_p * _N_PTRS)(*ptrs)
    kernel = FUSED_MP_ENC if enc is not None else FUSED_MP
    kernel(ctypes.cast(arr, ctypes.c_void_p), n, k, fe, latent, int(cdt == torch.bfloat16),
           int(enc is not None), _grid_array(h.device, n, k), device=h.device)
    return e_out, h_out


def _step_pointers(p, enc, cdt, f, e):
    """The checked kernel-layout parameters of a forward entry, in its
    pointer order (the five matrices, the eight vectors, then the encoder's
    six with ``enc``), and the raw edge width fe (0 without ``enc``)."""
    params = [_checked(p[name], cdt, (f, f)) for name in _KERNEL_WEIGHTS]
    params += [_checked(p[name], torch.float32, (f,)) for name in _KERNEL_VECTORS]
    if enc is None:
        return params, 0
    fe = e.shape[-1]
    params += [
        _checked(enc["enc_w1"], cdt, (fe, f)),
        _checked(enc["enc_w2"], cdt, (f, f)),
    ] + [
        _checked(enc[name], torch.float32, (f,))
        for name in ("enc_b1", "enc_b2", "enc_ln_scale", "enc_ln_bias")
    ]
    return params, fe


def _agg_scratch(n: int, f: int, cdt: torch.dtype, device) -> Optional[torch.Tensor]:
    """The bf16 designs' float32 (n, f) agg, handed from the edge kernel to
    the node kernel; the float32 tile design and the wide path need none."""
    if cdt != torch.bfloat16 or f > INSTANCES[-1]:
        return None
    return torch.empty((n, f), dtype=torch.float32, device=device)


def _checked(t: torch.Tensor, dtype: torch.dtype, shape) -> torch.Tensor:
    if t.dtype != dtype or tuple(t.shape) != tuple(shape) or not t.is_contiguous():
        raise ValueError(
            f"fused_mp kernel: parameter {tuple(t.shape)} {t.dtype}, "
            f"expected contiguous {tuple(shape)} {dtype}"
        )
    if not t.is_cuda:
        raise ValueError("fused_mp kernel: parameters must be CUDA tensors")
    return t


def kernel_params(p: Dict[str, torch.Tensor], cdt: torch.dtype,
                  width: Optional[int] = None) -> Dict[str, torch.Tensor]:
    """A parameter dict in the layout the kernel takes: matrices in the
    compute dtype, vectors in float32 (float64 when the compute dtype is
    float64), all contiguous, zero-padded to latent width ``width`` when
    given (``pad_params``)."""
    acc = _acc_dtype(cdt)
    out = {
        name: (v.to(cdt) if v.dim() == 2 else v.to(acc)).detach().contiguous()
        for name, v in p.items()
    }
    return out if width is None else pad_params(out, width)


# ---------------------------------------------------------------------------
# backward (K4) and the autograd Function
# ---------------------------------------------------------------------------

# weight-gradient order of the backward kernel, as the JAX package's
# _BWD_PARAM_ORDER; also the order of the Function's parameter inputs
BWD_PARAM_ORDER = (
    "w_e", "b1", "w2", "b2", "ln1_scale", "ln1_bias",
    "w_nh", "w_na", "bn1", "wn2", "bn2", "ln2_scale", "ln2_bias",
)
_BWD_GRAD_SLOTS = _KERNEL_WEIGHTS + _KERNEL_VECTORS  # the kernel's output layout

_BWD_ARGTYPES = [ctypes.c_void_p] + [ctypes.c_int] * 5 + [ctypes.c_void_p] * 2
FUSED_MP_BWD = Kernel(
    "fused_mp_bwd", "fused_mp_bwd", "lbt_fused_mp_bwd", _BWD_ARGTYPES,
    replaces="lagrangebench_tpu/ops/fused_mp.py:443",
)
_BWD_REDUCE = Kernel(
    "fused_mp_bwd_reduce", "fused_mp_bwd", "lbt_fused_mp_bwd_reduce",
    [ctypes.c_void_p, ctypes.c_void_p] + [ctypes.c_int] * 4 + [ctypes.c_void_p] * 2,
    replaces="lagrangebench_tpu/ops/fused_mp.py:443",
)
_BWD_TILE = 16  # receivers per tile of the float32 backward kernel


def _ln_bwd(dy, xhat, inv, scale, n=None):
    """LayerNorm input gradient from the normalized activations, over the
    first ``n`` channels (all by default; 0 past n)."""
    dxhat = dy * scale
    w = dy.shape[-1]
    n = w if n is None else n
    if n == w:
        mean1 = dxhat.mean(dim=-1, keepdim=True)
        mean2 = (dxhat * xhat).mean(dim=-1, keepdim=True)
        return inv * (dxhat - mean1 - xhat * mean2)
    dxhat, xhat = dxhat[..., :n], xhat[..., :n]
    mean1 = dxhat.mean(dim=-1, keepdim=True)
    mean2 = (dxhat * xhat).mean(dim=-1, keepdim=True)
    return pad_last(inv * (dxhat - mean1 - xhat * mean2), w)


def _dot_t(a, w, acc):
    """a @ w.T of compute-dtype operands, summed in ``acc``."""
    return a.to(acc) @ w.to(acc).t()


def _dot_g(a, b, acc):
    """a.T @ b over the rows (a weight gradient), summed in ``acc``."""
    a2, b2 = a.reshape(-1, a.shape[-1]), b.reshape(-1, b.shape[-1])
    return a2.to(acc).t() @ b2.to(acc)


def gns_mp_step_bwd_plain(
    e: torch.Tensor,
    hs_gath: torch.Tensor,
    hr_proj: torch.Tensor,
    h: torch.Tensor,
    mask: torch.Tensor,
    p: Dict[str, torch.Tensor],
    ge: torch.Tensor,
    gh: torch.Tensor,
    latent: Optional[int] = None,
    aggc: Optional[torch.Tensor] = None,
    relu_masks: Optional[Tuple[Optional[torch.Tensor], Optional[torch.Tensor]]] = None,
):
    """Plain PyTorch version of K4: the backward of one (non-encoder) step.

    Rematerializes the forward from the inputs, then runs the node-path
    backward and the edge-path backward with the casts of the JAX
    package's ``_fused_bwd_kernel``: relu(first), relu(node_first), agg,
    dy1, dnf, dx1 and dfirst are rounded to the compute dtype before their
    products, which sum in float32 (float64 for a float64 compute dtype);
    LayerNorm and its backward run in that accumulation dtype.

    ``ge`` (N, K, F) and ``gh`` (N, F) are the cotangents of e' and h'.
    Returns (de, dhs, dhr, dh, dp): de and dhs (N, K, F), dhr and dh (N, F)
    in the compute dtype, and ``dp`` the 13 parameter gradients of
    ``BWD_PARAM_ORDER`` in the accumulation dtype. ``latent`` as in
    :func:`gns_mp_step_plain`.

    For checks that resolve ties as the kernel resolved them: ``aggc``
    (N, F) is the rounded agg to use in place of this version's own
    rounding of its sum (the kernel's ``agg_out``, rounded), and
    ``relu_masks`` the derivatives (first > 0, node_first > 0), (N, K, F)
    and (N, F) bool, to use in place of this version's (None: its own).
    """
    cdt = e.dtype
    acc = _acc_dtype(cdt)

    def vec(name):
        return p[name].to(acc)

    # forward rematerialization
    first = _dot(e, p["w_e"], cdt) + hs_gath.to(acc)
    first = first + hr_proj.to(acc)[:, None, :] + vec("b1")
    r1 = torch.relu(first)
    r1c = r1.to(cdt)
    x1 = _dot(r1c, p["w2"], cdt) + vec("b2")
    xhat1, inv1 = _normalize(x1, latent)
    m = xhat1 * vec("ln1_scale") + vec("ln1_bias")
    maskf = mask.to(acc)[..., None]
    aggc = torch.sum(m * maskf, dim=1).to(cdt) if aggc is None else aggc.to(cdt)

    nf = _dot(h, p["w_nh"], cdt) + _dot(aggc, p["w_na"], cdt) + vec("bn1")
    r2 = torch.relu(nf)
    r2c = r2.to(cdt)
    y1 = _dot(r2c, p["wn2"], cdt) + vec("bn2")
    xhat2, inv2 = _normalize(y1, latent)

    dp = {}
    # node-path backward
    ghf = gh.to(acc)
    dp["ln2_scale"] = torch.sum(ghf * xhat2, dim=0)
    dp["ln2_bias"] = torch.sum(ghf, dim=0)
    dy1 = _ln_bwd(ghf, xhat2, inv2, vec("ln2_scale"), latent)
    dy1c = dy1.to(cdt)
    dp["wn2"] = _dot_g(r2c, dy1c, acc)
    dp["bn2"] = torch.sum(dy1, dim=0)
    r1_on, r2_on = relu_masks or (None, None)
    r1_on, r2_on = (r1 > 0 if r1_on is None else r1_on), (r2 > 0 if r2_on is None else r2_on)
    dnf = _dot_t(dy1c, p["wn2"].to(cdt), acc) * r2_on
    dnfc = dnf.to(cdt)
    dp["w_nh"] = _dot_g(h.to(cdt), dnfc, acc)
    dp["w_na"] = _dot_g(aggc, dnfc, acc)
    dp["bn1"] = torch.sum(dnf, dim=0)
    dh = (ghf + _dot_t(dnfc, p["w_nh"].to(cdt), acc)).to(h.dtype)
    dagg = _dot_t(dnfc, p["w_na"].to(cdt), acc)

    # edge-path backward
    dm = ge.to(acc) + dagg[:, None, :] * maskf
    dp["ln1_scale"] = torch.sum(dm * xhat1, dim=(0, 1))
    dp["ln1_bias"] = torch.sum(dm, dim=(0, 1))
    dx1 = _ln_bwd(dm, xhat1, inv1, vec("ln1_scale"), latent)
    dx1c = dx1.to(cdt)
    dp["w2"] = _dot_g(r1c, dx1c, acc)
    dp["b2"] = torch.sum(dx1, dim=(0, 1))
    dfirst = _dot_t(dx1c, p["w2"].to(cdt), acc) * r1_on
    dfirstc = dfirst.to(cdt)
    dp["w_e"] = _dot_g(e, dfirstc, acc)
    dp["b1"] = torch.sum(dfirst, dim=(0, 1))
    de = (ge.to(acc) + _dot_t(dfirstc, p["w_e"].to(cdt), acc)).to(cdt)
    dhr = torch.sum(dfirst, dim=1).to(hr_proj.dtype)
    return de, dfirstc.to(hs_gath.dtype), dhr, dh, dp


def gns_mp_step_bwd(
    e: torch.Tensor,
    hs_gath: torch.Tensor,
    hr_proj: torch.Tensor,
    h: torch.Tensor,
    mask: torch.Tensor,
    p: Dict[str, torch.Tensor],
    ge: torch.Tensor,
    gh: torch.Tensor,
    latent: Optional[int] = None,
    agg_out: Optional[torch.Tensor] = None,
    relu_out: Optional[torch.Tensor] = None,
    first_out: Optional[torch.Tensor] = None,
):
    """K4: the backward kernel on CUDA tensors, else the plain version. See
    :func:`gns_mp_step_bwd_plain` for shapes and returns. For checks (the
    plain version leaves them): ``agg_out``, a float32 (N, F) CUDA tensor
    at the tensors' width, receives the step's agg as the kernel summed it;
    ``relu_out``, an (N, F) tensor of the compute dtype, and ``first_out``,
    an (N, K, F) one (both past F = 256 only), receive T(relu(node_first))
    and T(relu(first)) as the kernel rematerialized them.

    On CUDA the compute dtype (of e, hs_gath, hr_proj, h, ge, gh) is
    bfloat16 or float32, ``p`` is in the kernel's layout (``kernel_params``)
    at the true or the instance width, and the tensors are at the instance
    width, as :func:`gns_mp_step` takes them; the parameter gradients come
    back at the width of ``p``. The weight gradients are summed without
    atomics: each block (in bf16 at F > 128, each row range of the weight-
    gradient product kernel) adds its rows into its own float32 partials,
    once per launch, and a last launch sums the partials in block order, so
    two calls on the same inputs give the same bits.
    """
    width = e.shape[-1]
    latent = width if latent is None else latent
    if not e.is_cuda:
        return gns_mp_step_bwd_plain(e, hs_gath, hr_proj, h, mask, p, ge, gh, latent)
    cdt = e.dtype
    if cdt not in (torch.bfloat16, torch.float32):
        raise ValueError(f"fused_mp_bwd kernel: compute dtype {cdt} not supported")
    f = _instance_width(width, latent, "fused_mp_bwd")
    given = p["w_e"].shape[0]
    p = pad_params(p, f)
    n, k, _ = e.shape
    if hs_gath.shape != (n, k, f) or ge.shape != (n, k, f) or mask.shape != (n, k):
        raise ValueError("fused_mp_bwd kernel: inconsistent edge shapes")
    if hr_proj.shape != (n, f) or h.shape != (n, f) or gh.shape != (n, f):
        raise ValueError("fused_mp_bwd kernel: inconsistent node shapes")
    mask = mask if mask.dtype == torch.float32 else mask.to(torch.float32)
    tensors = [e, hs_gath, hr_proj, h, mask, ge, gh]
    if any(t.dtype != cdt for t in tensors if t is not mask):
        raise ValueError("fused_mp_bwd kernel: e, hs, hr, h, ge, gh must share a dtype")
    if any(not t.is_cuda or not t.is_contiguous() for t in tensors):
        raise ValueError("fused_mp_bwd kernel: inputs must be contiguous CUDA tensors")

    de = torch.empty_like(e)
    dhs = torch.empty_like(e)
    dhr = torch.empty_like(hr_proj)
    dh = torch.empty_like(h)
    params = [_checked(p[name], cdt, (f, f)) for name in _KERNEL_WEIGHTS]
    params += [_checked(p[name], torch.float32, (f,)) for name in _KERNEL_VECTORS]
    bf16 = cdt == torch.bfloat16
    design = _design(cdt, f)
    stream, wide = design == "stream", design in ("wide", "wgmma")
    sms = _sms(e.device)
    grid = mp_grids(n, k, sms)[0] if bf16 else min(-(-n // _BWD_TILE), sms)
    plan = (bwd_stream_plan(n, k, sms) if stream else
            _wide_plan_ints(wide_plan(n, k, f, sms, cdt)) if wide else None)
    per_block = len(_KERNEL_WEIGHTS) * f * f + len(_KERNEL_VECTORS) * f
    partials = torch.empty((bwd_partials_floats(n, grid, bf16, f, plan),), dtype=torch.float32,
                           device=e.device)
    scratch = torch.empty((2 * n if bf16 and not wide else 1, f), dtype=torch.float32,
                          device=e.device)
    # the stream design's bf16 operands of the weight gradients (Ops)
    ops = torch.empty(((2 * k + 4) * n if stream else 1, f), dtype=cdt, device=e.device)
    grads = torch.empty((per_block,), dtype=torch.float32, device=e.device)
    if agg_out is not None:
        _checked(agg_out, torch.float32, (n, f))
    if relu_out is not None:
        if not wide:
            raise ValueError("fused_mp_bwd kernel: relu_out is the wide path's (F > "
                             f"{INSTANCES[-1]})")
        _checked(relu_out, cdt, (n, f))
    if first_out is not None:
        if not wide:
            raise ValueError("fused_mp_bwd kernel: first_out is the wide path's (F > "
                             f"{INSTANCES[-1]})")
        _checked(first_out, cdt, (n, k, f))
    ptrs = [t.data_ptr() for t in tensors + [de, dhs, dhr, dh] + params + [partials, scratch]]
    ptrs.append(agg_out.data_ptr() if agg_out is not None and (wide or not bf16) else 0)
    ptrs.append(ops.data_ptr())
    if wide:
        bufs = _wide_buffers(n, k, f, cdt, e.device, backward=True)
        bufs[0] = bufs[0] if first_out is None else first_out  # T(relu(first))
        bufs[3] = bufs[3] if relu_out is None else relu_out  # T(relu(node_first))
        if design == "wgmma":  # the weights its de and dfirst products read
            bufs += [p["w_e"].t().contiguous(), p["w2"].t().contiguous()]
        ptrs += _ptrs(bufs)
    arr = (ctypes.c_void_p * len(ptrs))(*ptrs)
    plan_arr = (ctypes.c_int * 4)(*plan) if plan else None
    FUSED_MP_BWD(ctypes.cast(arr, ctypes.c_void_p), n, k, latent, int(bf16), grid, plan_arr,
                 device=e.device)
    if agg_out is not None and bf16 and not wide:  # the bf16 designs' agg scratch
        agg_out.copy_(scratch[:n])
    _BWD_REDUCE(ctypes.c_void_p(partials.data_ptr()), ctypes.c_void_p(grads.data_ptr()),
                n, latent, int(bf16), grid, plan_arr, device=e.device)
    dp, at = {}, 0
    for name in _BWD_GRAD_SLOTS:
        if name in _KERNEL_WEIGHTS:
            dp[name] = grads[at:at + f * f].view(f, f)[:given, :given]
            at += f * f
        else:
            dp[name] = grads[at:at + f][:given]
            at += f
    return de, dhs, dhr, dh, dp


class _MPStepFunction(torch.autograd.Function):
    """K3 forward and K4 backward of one step, as the JAX package's
    ``_gns_mp_step_vjp``.

    Inputs: ``has_enc``, ``latent`` (the true width), e (or raw edge
    features with the encoder), hs_gath, hr_proj, h, mask, then the 13
    parameters of ``BWD_PARAM_ORDER`` (and the 6 of ``ENC_PARAM_NAMES``
    with the encoder) as stored, e.g. float32, at the true width. They are
    cast to the kernel's layout and zero-padded to the tensors' width here,
    inside the Function, so their gradients come back in their own dtype
    and shape without passing through the compute dtype. The residuals are
    the inputs; the backward rematerializes the forward. The mask gets no
    gradient.
    """

    @staticmethod
    def forward(ctx, has_enc, latent, e, hs_gath, hr_proj, h, mask, *params):
        cdt, width = hs_gath.dtype, hs_gath.shape[-1]
        p = kernel_params(dict(zip(BWD_PARAM_ORDER, params)), cdt, width)
        enc = (kernel_params(dict(zip(ENC_PARAM_NAMES, params[13:])), cdt, width)
               if has_enc else None)
        ctx.has_enc, ctx.latent = has_enc, latent
        ctx.save_for_backward(e, hs_gath, hr_proj, h, mask, *params)
        return gns_mp_step(e, hs_gath, hr_proj, h, mask, p, enc, latent=latent)

    @staticmethod
    def backward(ctx, ge, gh):
        e, hs_gath, hr_proj, h, mask, *params = ctx.saved_tensors
        cdt, width, latent = hs_gath.dtype, hs_gath.shape[-1], ctx.latent
        p = kernel_params(dict(zip(BWD_PARAM_ORDER, params)), cdt, width)
        ge, gh = ge.contiguous(), gh.contiguous()
        enc_grads = []
        if ctx.has_enc:
            # the encoder backprops through its plain version, rerun here to
            # rematerialize the encoded edges (JAX: jax.vjp of the mirror)
            with torch.enable_grad():
                leaves = [t.detach().requires_grad_() for t in params[13:]]
                raw = e.detach().requires_grad_(ctx.needs_input_grad[2])
                e_enc = encode_edges_plain(raw, dict(zip(ENC_PARAM_NAMES, leaves)), cdt)
            de, dhs, dhr, dh, dp = gns_mp_step_bwd(
                pad_last(e_enc.detach(), width).contiguous(), hs_gath, hr_proj, h, mask, p,
                ge, gh, latent=latent
            )
            inputs = leaves + ([raw] if raw.requires_grad else [])
            grads = torch.autograd.grad(e_enc, inputs,
                                        de[..., :e_enc.shape[-1]].to(e_enc.dtype))
            enc_grads = list(grads[:len(leaves)])
            de = grads[len(leaves)] if raw.requires_grad else None
        else:
            de, dhs, dhr, dh, dp = gns_mp_step_bwd(e, hs_gath, hr_proj, h, mask, p, ge, gh,
                                                   latent=latent)
        pgrads = [_sliced(dp[name], t.shape).to(t.dtype)
                  for name, t in zip(BWD_PARAM_ORDER, params)]
        return (None, None, de, dhs, dhr, dh, None, *pgrads, *enc_grads)


def _sliced(g: torch.Tensor, shape) -> torch.Tensor:
    """A padded parameter's gradient cut back to the parameter's shape."""
    return g[tuple(slice(0, d) for d in shape)]


def gns_mp_step_autograd(
    e: torch.Tensor,
    hs_gath: torch.Tensor,
    hr_proj: torch.Tensor,
    h: torch.Tensor,
    mask: torch.Tensor,
    p: Dict[str, torch.Tensor],
    enc: Optional[Dict[str, torch.Tensor]] = None,
    latent: Optional[int] = None,
):
    """The fused step, differentiable: K3 forward, K4 backward (the plain
    versions on CPU tensors). ``p`` and ``enc`` hold the parameters as
    stored (any of ``PARAM_NAMES``; ``w_s``/``w_r`` are applied outside and
    ignored here) at the true width ``latent`` (the tensors' width by
    default), the tensors zero-padded to the instance width
    ``kernel_width(latent)`` (on the CPU also at the true width). Returns
    (e', h') as :func:`gns_mp_step` does."""
    params = [p[name] for name in BWD_PARAM_ORDER]
    if enc is not None:
        params += [enc[name] for name in ENC_PARAM_NAMES]
    mask = mask if mask.dtype == torch.float32 else mask.to(torch.float32)
    latent = hs_gath.shape[-1] if latent is None else latent
    return _MPStepFunction.apply(enc is not None, latent, e, hs_gath, hr_proj, h, mask, *params)


# ---------------------------------------------------------------------------
# K8: the fused step in column-slot order
# ---------------------------------------------------------------------------

_SLOT_ARGTYPES = [ctypes.c_void_p] + [ctypes.c_int] * 8 + [ctypes.c_void_p] * 2
FUSED_MP_SLOT = Kernel(
    "fused_mp_slot", "fused_mp", "lbt_fused_mp_slot", _SLOT_ARGTYPES,
    replaces="lagrangebench_tpu/ops/fused_mp.py:708",
)
FUSED_MP_SLOT_ENC = Kernel(
    "fused_mp_slot_enc", "fused_mp", "lbt_fused_mp_slot", _SLOT_ARGTYPES,
    replaces="lagrangebench_tpu/ops/fused_mp.py:708",
)


def _bases_ext(bases: torch.Tensor) -> torch.Tensor:
    """The stencil table with a row for the sentinel column's tile, which
    points at that column itself (its candidates are all fill, so no row
    is read through it)."""
    n_cols, s = bases.shape
    return torch.cat([bases, bases.new_full((1, s), n_cols)])


def slot_sender_rows(cand: torch.Tensor, bases: torch.Tensor):
    """The sender slot of every slot-layout edge -> (rows (n_ext, K) int64,
    mask (n_ext, K) bool).

    Receiver row r lies in column t = r // C; its candidate c < S*C is the
    sender in slot ``bases[t, c // C] * C + c % C``. A padded slot
    (c == S*C) gets row 0 and mask False.
    """
    n_cols, s = bases.shape
    n_ext, k = cand.shape
    c = n_ext // (n_cols + 1)
    cand = cand.long()
    mask = cand < s * c
    bases_ext = _bases_ext(bases).long()
    t = torch.arange(n_ext, device=cand.device)[:, None] // c
    safe = torch.where(mask, cand, 0)
    rows = bases_ext[t, safe // c] * c + safe % c
    return torch.where(mask, rows, 0), mask


def slot_gather_plain(hs_ext: torch.Tensor, cand: torch.Tensor, bases: torch.Tensor):
    """The gathered (n_ext, K, F) sender rows of the slot layout, zeros on
    padded slots: what K8 reads in-kernel (``slot_gather_reference``)."""
    rows, mask = slot_sender_rows(cand, bases)
    return torch.where(mask[..., None], hs_ext[rows], 0).to(hs_ext.dtype)


def gns_mp_step_slot_plain(e, cand, bases, hs_ext, hr, h, p, enc=None, latent=None):
    """Plain PyTorch version of K8: the fused step with the sender rows
    selected through the stencil table and the mask ``cand < S*C``
    (``gns_mp_step_slot_reference``); ``latent`` as in
    :func:`gns_mp_step_plain`."""
    mask = slot_sender_rows(cand, bases)[1]
    return gns_mp_step_plain(e, slot_gather_plain(hs_ext, cand, bases), hr, h, mask, p, enc,
                             latent)


def gns_mp_step_slot(
    e: torch.Tensor,
    cand: torch.Tensor,
    bases: torch.Tensor,
    hs_ext: torch.Tensor,
    hr: torch.Tensor,
    h: torch.Tensor,
    p: Dict[str, torch.Tensor],
    enc: Optional[Dict[str, torch.Tensor]] = None,
    latent: Optional[int] = None,
):
    """K8: the fused step in column-slot order; the CUDA kernel on CUDA
    tensors, else the plain version.

    e (n_ext, K, F) edge latents (raw (n_ext, K, Fe) float32 with ``enc``),
    cand (n_ext, K) int32 stencil-candidate ids (fill S*C), bases (n_cols,
    S) int32, hs_ext / hr / h (n_ext, F) with n_ext = (n_cols+1)*C. The
    kernel reads each edge's sender row of ``hs_ext`` itself: no (n_ext, K,
    F) gathered tensor exists. On CUDA the dtypes, parameters and widths
    are those of :func:`gns_mp_step`.
    """
    width = hs_ext.shape[-1]
    latent = width if latent is None else latent
    if not hs_ext.is_cuda:
        return gns_mp_step_slot_plain(e, cand, bases, hs_ext, hr, h, p, enc, latent)
    cdt = hs_ext.dtype
    if cdt not in (torch.bfloat16, torch.float32):
        raise ValueError(f"fused_mp_slot kernel: compute dtype {cdt} not supported")
    f = _instance_width(width, latent, "fused_mp_slot")
    p = pad_params(p, f)
    enc = pad_params(enc, f) if enc is not None else None
    n = hs_ext.shape[0]
    k = cand.shape[-1]
    n_cols, s = bases.shape
    if n % (n_cols + 1) or cand.shape != (n, k) or hr.shape != (n, f) or h.shape != (n, f):
        raise ValueError("fused_mp_slot kernel: inconsistent shapes")
    if cand.dtype != torch.int32 or bases.dtype != torch.int32:
        raise ValueError("fused_mp_slot kernel: cand and bases must be int32")
    if hr.dtype != cdt or h.dtype != cdt:
        raise ValueError("fused_mp_slot kernel: hs_ext, hr and h must share a dtype")
    if enc is None:
        if e.shape != (n, k, f) or e.dtype != cdt:
            raise ValueError("fused_mp_slot kernel: e must be (n_ext, K, F) in the compute dtype")
    elif e.shape[:2] != (n, k) or e.dtype != torch.float32:
        raise ValueError("fused_mp_slot kernel: raw edge features must be (n_ext, K, Fe) float32")
    c = n // (n_cols + 1)
    bases_ext = _bases_ext(bases)
    tensors = [e, hs_ext, hr, h, cand, bases_ext]
    if any(not t.is_cuda or not t.is_contiguous() for t in tensors):
        raise ValueError("fused_mp_slot kernel: inputs must be contiguous CUDA tensors")

    e_out = torch.empty((n, k, f), dtype=cdt, device=h.device)
    h_out = torch.empty_like(h)
    params, fe = _step_pointers(p, enc, cdt, f, e)
    ptrs = [t.data_ptr() for t in (e, hs_ext, hr, h)] + [0]  # slot 4 (mask) unused
    ptrs += [e_out.data_ptr(), h_out.data_ptr()] + [t.data_ptr() for t in params]
    agg = _agg_scratch(n, f, cdt, h.device)
    ptrs += [0] * (26 - len(ptrs)) + [cand.data_ptr(), bases_ext.data_ptr()]
    ptrs += [agg.data_ptr() if agg is not None else 0]
    ptrs += _ptrs(_wide_buffers(n, k, f, cdt, h.device, enc=enc is not None, senders=True)
                  if f > INSTANCES[-1] else [None] * 9)
    arr = (ctypes.c_void_p * _N_PTRS)(*ptrs)
    kernel = FUSED_MP_SLOT_ENC if enc is not None else FUSED_MP_SLOT
    kernel(ctypes.cast(arr, ctypes.c_void_p), n, k, fe, latent, int(cdt == torch.bfloat16),
           int(enc is not None), c, s, _grid_array(h.device, n, k), device=h.device)
    return e_out, h_out


class _SlotStepFunction(torch.autograd.Function):
    """K8 forward; the backward differentiates the plain version,
    rematerialized from the saved inputs, as the JAX package's
    ``_gns_mp_slot_vjp`` differentiates ``gns_mp_step_slot_reference`` (no
    backward kernel: the JAX package has none for this step).

    Inputs: ``has_enc``, ``latent``, e (or raw edge features), cand, bases,
    hs_ext, hr, h, then the parameters as in ``_MPStepFunction``, cast to
    the kernel's layout and padded to the tensors' width inside. In the
    backward the products sum in float32 (float64 in float64), and the
    sender rows' gradient is summed in float32 by
    ``models.utils.gather_rows`` (PyTorch's bf16 ``index_put_`` backward is
    orders of magnitude slower on CUDA).
    """

    @staticmethod
    def forward(ctx, has_enc, latent, e, cand, bases, hs_ext, hr, h, *params):
        cdt, width = hs_ext.dtype, hs_ext.shape[-1]
        p = kernel_params(dict(zip(BWD_PARAM_ORDER, params)), cdt, width)
        enc = (kernel_params(dict(zip(ENC_PARAM_NAMES, params[13:])), cdt, width)
               if has_enc else None)
        ctx.has_enc, ctx.latent = has_enc, latent
        ctx.save_for_backward(e, cand, bases, hs_ext, hr, h, *params)
        return gns_mp_step_slot(e, cand, bases, hs_ext, hr, h, p, enc, latent=latent)

    @staticmethod
    def backward(ctx, ge, gh):
        from ..models.utils import gather_rows

        e, cand, bases, hs_ext, hr, h, *params = ctx.saved_tensors
        cdt, width = hs_ext.dtype, hs_ext.shape[-1]
        acc = _acc_dtype(cdt)
        needs = ctx.needs_input_grad
        with torch.enable_grad():
            e_, hs_, hr_, h_ = (t.detach().requires_grad_(needs[i])
                                for i, t in ((2, e), (5, hs_ext), (6, hr), (7, h)))
            leaves = [t.detach().requires_grad_() for t in params]
            cast = [v.to(cdt) if v.dim() == 2 else v.to(acc) for v in leaves]
            p = pad_params(dict(zip(BWD_PARAM_ORDER, cast)), width)
            enc = (pad_params(dict(zip(ENC_PARAM_NAMES, cast[13:])), width)
                   if ctx.has_enc else None)
            rows, mask = slot_sender_rows(cand, bases)
            hs_gath = torch.where(mask[..., None], gather_rows(hs_, rows), 0).to(cdt)
            outs = gns_mp_step_plain(e_, hs_gath, hr_, h_, mask, p, enc, ctx.latent)
            inputs = [t for t in (e_, hs_, hr_, h_) if t.requires_grad] + leaves
            grads = list(torch.autograd.grad(outs, inputs, (ge, gh), allow_unused=True))
        node = [grads.pop(0) if t.requires_grad else None for t in (e_, hs_, hr_, h_)]
        pgrads = [torch.zeros_like(t) if g is None else g.to(t.dtype)
                  for g, t in zip(grads, params)]
        return (None, None, node[0], None, None, node[1], node[2], node[3], *pgrads)


def gns_mp_step_slot_autograd(e, cand, bases, hs_ext, hr, h, p, enc=None, latent=None):
    """K8, differentiable (the backward through the plain version); ``p``,
    ``enc`` and ``latent`` as :func:`gns_mp_step_autograd` takes them.
    Returns (e', h') as :func:`gns_mp_step_slot` does."""
    params = [p[name] for name in BWD_PARAM_ORDER]
    if enc is not None:
        params += [enc[name] for name in ENC_PARAM_NAMES]
    latent = hs_ext.shape[-1] if latent is None else latent
    return _SlotStepFunction.apply(enc is not None, latent, e, cand, bases, hs_ext, hr, h,
                                   *params)


# ---------------------------------------------------------------------------
# E2: the fused step with windowed sender selects
# ---------------------------------------------------------------------------

WINDOW_TILE, WINDOW_SUB = 128, 32  # receiver rows per tile and per sub-tile
_WINDOW_ARGTYPES = [ctypes.c_void_p] + [ctypes.c_int] * 7 + [ctypes.c_void_p] * 2
FUSED_MP_WINDOW = Kernel(
    "fused_mp_window", "fused_mp", "lbt_fused_mp_window", _WINDOW_ARGTYPES,
    replaces="scripts/experiments/window_select.py:221",
)


def window_sender_rows(cand: torch.Tensor, w0s: torch.Tensor, wsub: int,
                       t: int = WINDOW_TILE, sub: int = WINDOW_SUB):
    """The ``hs_ext`` row of every edge of the windowed layout -> (rows
    (n_rows, K) int64, mask (n_rows, K) bool).

    Receiver row i lies in tile i // t and sub-tile (i % t) // sub; its
    candidate c < 3 wsub is row ``w0s[tile, sub-tile, c // wsub] * 8 + c %
    wsub`` (``w0s`` in 8-row units). A padded slot (c == 3 wsub) gets row 0
    and mask False.
    """
    n_rows, _ = cand.shape
    cand = cand.long()
    mask = cand < 3 * wsub
    i = torch.arange(n_rows, device=cand.device)[:, None]
    safe = torch.where(mask, cand, 0)
    rows = w0s.long()[i // t, (i % t) // sub, safe // wsub] * 8 + safe % wsub
    return torch.where(mask, rows, 0), mask


def gns_mp_step_window_plain(e, cand, w0s, wsub, hs_ext, hr, h, p, latent=None):
    """Plain PyTorch version of E2: the sender rows of ``hs_ext`` decoded
    through the windows (zeros on padded slots), then the fused step with
    the mask ``cand < 3 wsub``; ``latent`` as in :func:`gns_mp_step_plain`."""
    rows, mask = window_sender_rows(cand, w0s, wsub)
    hs_gath = torch.where(mask[..., None], hs_ext[rows], 0).to(hs_ext.dtype)
    return gns_mp_step_plain(e, hs_gath, hr, h, mask, p, latent=latent)


def gns_mp_step_window(
    e: torch.Tensor,
    cand: torch.Tensor,
    w0s: torch.Tensor,
    wsub: int,
    hs_ext: torch.Tensor,
    hr: torch.Tensor,
    h: torch.Tensor,
    p: Dict[str, torch.Tensor],
    latent: Optional[int] = None,
):
    """E2: the fused step with each edge's sender row selected through the
    sub-tile windows; the CUDA kernel on CUDA tensors, else the plain
    version.

    e (n_rows, K, F) edge latents, cand (n_rows, K) int32 window-candidate
    ids (fill 3 wsub), w0s (n_rows // 128, 4, 3) int32 window starts in
    8-row units of the 32-row sub-tiles of 128-row tiles, hs_ext (n_ext, F) the ghost-extended sender projection, hr
    and h (n_rows, F). The kernel reads each edge's sender row of
    ``hs_ext`` itself. On CUDA the dtypes, parameters and widths are those
    of :func:`gns_mp_step`; there is no encoder-folded instance.
    """
    width = hs_ext.shape[-1]
    latent = width if latent is None else latent
    if not hs_ext.is_cuda:
        return gns_mp_step_window_plain(e, cand, w0s, wsub, hs_ext, hr, h, p, latent)
    cdt = hs_ext.dtype
    if cdt not in (torch.bfloat16, torch.float32):
        raise ValueError(f"fused_mp_window kernel: compute dtype {cdt} not supported")
    f = _instance_width(width, latent, "fused_mp_window")
    p = pad_params(p, f)
    n, k = cand.shape
    t, sub = WINDOW_TILE, WINDOW_SUB
    if n % t or w0s.shape != (n // t, t // sub, 3):
        raise ValueError("fused_mp_window kernel: inconsistent tiles or window table")
    if e.shape != (n, k, f) or hr.shape != (n, f) or h.shape != (n, f):
        raise ValueError("fused_mp_window kernel: inconsistent shapes")
    if cand.dtype != torch.int32 or w0s.dtype != torch.int32:
        raise ValueError("fused_mp_window kernel: cand and w0s must be int32")
    if e.dtype != cdt or hr.dtype != cdt or h.dtype != cdt:
        raise ValueError("fused_mp_window kernel: e, hs_ext, hr and h must share a dtype")
    tensors = [e, hs_ext, hr, h, cand, w0s]
    if any(not x.is_cuda or not x.is_contiguous() for x in tensors):
        raise ValueError("fused_mp_window kernel: inputs must be contiguous CUDA tensors")

    e_out = torch.empty_like(e)
    h_out = torch.empty_like(h)
    params = [_checked(p[name], cdt, (f, f)) for name in _KERNEL_WEIGHTS]
    params += [_checked(p[name], torch.float32, (f,)) for name in _KERNEL_VECTORS]
    ptrs = [x.data_ptr() for x in (e, hs_ext, hr, h)] + [0]  # slot 4 (mask) unused
    ptrs += [e_out.data_ptr(), h_out.data_ptr()] + [x.data_ptr() for x in params]
    agg = _agg_scratch(n, f, cdt, h.device)
    ptrs += [0] * (26 - len(ptrs)) + [cand.data_ptr(), w0s.data_ptr()]
    ptrs += [agg.data_ptr() if agg is not None else 0]
    ptrs += _ptrs(_wide_buffers(n, k, f, cdt, h.device, senders=True)
                  if f > INSTANCES[-1] else [None] * 9)
    arr = (ctypes.c_void_p * _N_PTRS)(*ptrs)
    FUSED_MP_WINDOW(ctypes.cast(arr, ctypes.c_void_p), n, k, latent,
                    int(cdt == torch.bfloat16), t, sub, int(wsub), _grid_array(h.device, n, k),
                    device=h.device)
    return e_out, h_out
