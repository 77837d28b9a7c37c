"""PaiNN, the polarizable interaction network, on the dense (N, K) and
sparse (2, E) layouts.

Counterpart of ``lagrangebench_tpu/models/painn.py``:
vector channels start from the velocity history (plus force and wall
distances), filters come from a trainable Gaussian radial basis of the edge
lengths with a cosine cutoff, and the gated readout emits one vector channel
used as the predicted acceleration.

Per layer, the interaction context net ``x = LinearXav_1(silu(LinearXav_0(s)))``
(N, 3H) runs at node level; then

* standard layout: the packed sender gather [x, v] goes through K6
  (``ops.painn_msg.painn_message``) with the layer's filters
  ``filter_net_i(phi) * cutoff * mask``, followed by the clipped residuals,
  the vector mix (``LinearXav_2``) and the mixing net (``LinearXav_3/4``) as
  PyTorch ops;
* fused layout (``fused_processor``): the node rows [x1, x2, v_d * x3] and
  the sender index go to K5 (``ops.painn_msg.painn_layer``), which gathers
  the sender rows itself, computes the filters from the raw basis and runs
  the rest of the layer in one launch, with the flat per-layer parameters
  ``filt_w`` ... ``mix_b2``;
* sparse layout (standard layer only; the fused one raises ValueError, as
  the JAX package asserts): the reference's path, gathering [x, v] from the
  receivers and summing the messages into the senders (``segment_sum``,
  a padded edge's sender N dropped), then the same node-level ops.

Parameters keep the JAX tree's names; ``nn.Linear`` weights are stored
(out, in) against Flax's (in, out) kernels. ``load_jax_params`` takes a tree
in either layout and converts it to the module's; ``jax_params`` gives the
module's tree back; ``jax_leaves`` lists every parameter in the order JAX
flattens that tree (``AdamW`` state in ``opt_state.npz``).
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch
from torch import nn

from ..ops import painn_msg
from ..ops.scatter import segment_sum
from .base import JaxTree, sorted_leaves
from .utils import LinearXav, dense_leaves, gather_rows, silu

EPS = 1e-8  # in the edge norms, directions and vector norms, as the JAX model


class GaussianRBF(nn.Module):
    """Gaussian radial basis with trainable widths and centers."""

    def __init__(self, n_rbf: int, cutoff: float):
        super().__init__()
        self.offset = nn.Parameter(torch.linspace(0.0, cutoff, n_rbf))
        self.widths = nn.Parameter(torch.full((n_rbf,), cutoff / n_rbf))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        coeff = -0.5 / self.widths**2
        diff = x[..., None] - self.offset
        return torch.exp(coeff * diff**2)


def cosine_cutoff(x: torch.Tensor, cutoff: float) -> torch.Tensor:
    """Behler's cosine cutoff: 0.5 (cos(pi x / cutoff) + 1) below the cutoff."""
    return 0.5 * (torch.cos(x * math.pi / cutoff) + 1.0) * (x < cutoff)


class GatedEquivariantBlock(nn.Module):
    """Gated equivariant block: mixes scalar (N, C) and vector (N, dim, C)
    channels into ``scalar_out`` and ``vector_out`` channels."""

    def __init__(self, scalar_in: int, vector_in: int, hidden_size: int, scalar_out: int,
                 vector_out: int, generator=None):
        super().__init__()
        self.scalar_out = scalar_out
        self.mix = LinearXav(vector_in, 2 * vector_out, use_bias=False, generator=generator)
        self.gate1 = LinearXav(scalar_in + vector_out, hidden_size, generator=generator)
        self.gate2 = LinearXav(hidden_size, scalar_out + vector_out, generator=generator)

    def forward(self, s, v, cdt):
        v_l, v_r = torch.chunk(self.mix(v, cdt), 2, dim=-1)
        v_r_norm = torch.sqrt(torch.sum(v_r**2, dim=-2) + EPS)
        gating = self.gate2(silu(self.gate1(torch.cat([s, v_r_norm], dim=-1), cdt)), cdt)
        v_gate = gating[..., self.scalar_out:]
        return gating[..., : self.scalar_out], v_l * v_gate[:, None]

    def named_leaves(self, prefix: str):
        return [(f"{prefix}/LinearXav_{i}", lin) for i, lin in
                enumerate((self.mix, self.gate1, self.gate2))]


class PaiNNLayer(nn.Module):
    """PaiNN interaction and mixing block, standard or fused layout."""

    def __init__(self, hidden_size: int, n_rbf: int, fused: bool, generator=None):
        super().__init__()
        h = hidden_size
        self.hidden_size = h
        self.fused = fused
        self.ctx1 = LinearXav(h, h, generator=generator)
        self.ctx2 = LinearXav(h, 3 * h, generator=generator)
        if fused:
            shapes = {"filt_w": (n_rbf, 3 * h), "vmix_w": (h, 2 * h), "mix_w1": (2 * h, h),
                      "mix_w2": (h, 3 * h)}
            params = {}
            for name in painn_msg.LAYER_PARAM_NAMES:
                if name in shapes:
                    w = torch.empty(*reversed(shapes[name]))  # (out, in) for the fans
                    nn.init.xavier_uniform_(w, generator=generator)
                    params[name] = w.t().contiguous()
                else:
                    width = h if name == "mix_b1" else 3 * h
                    params[name] = torch.zeros(width)
            self.p = nn.ParameterDict({k: nn.Parameter(v) for k, v in params.items()})
        else:
            self.vmix = LinearXav(h, 2 * h, use_bias=False, generator=generator)
            self.mix1 = LinearXav(2 * h, h, generator=generator)
            self.mix2 = LinearXav(h, 3 * h, generator=generator)

    def context(self, s, cdt):
        return self.ctx2(silu(self.ctx1(s, cdt)), cdt)

    def forward(self, s, v, dir_ij, wij, sidx, mask, cdt, scatter_to=None, extend=None):
        """s (N, H); v (N, dim, H), flat (N, dim*H) when fused; dir_ij
        (N, K, dim) in cdt; wij the layer's (N, K, 3H) filters, or the
        (N, K, R+1) basis with the scale column when fused; sidx (N, K)
        clamped sender rows (int64, or K5's int32 when fused); mask (N, K)
        in cdt. Sparse edges: dir_ij (E, dim), wij (E, 3H), sidx the (E,)
        clamped receiver rows, ``scatter_to`` the (E,) senders, mask
        None. Fused only: with ``extend``, K5 gathers from
        ``extend(packed)``, rows beyond the N nodes' own (spatial
        sharding's halo)."""
        h = self.hidden_size
        n = s.shape[0]
        x = self.context(s, cdt)  # (N, 3H)
        if self.fused:
            dim = dir_ij.shape[-1]
            x3 = x[..., 2 * h:]
            packed = torch.cat(
                [x[..., :h], x[..., h: 2 * h]] + [v[..., d * h: (d + 1) * h] * x3 for d in range(dim)],
                dim=-1,
            )
            if extend is not None:
                packed = extend(packed)
            # K5 gathers the sender rows; padded slots carry scale 0
            return painn_msg.painn_layer(packed, sidx, wij, (-dir_ij).to(x.dtype), s, v,
                                         dict(self.p))

        dim = v.shape[1]
        packed = torch.cat([x, v.reshape(n, dim * h)], dim=-1)
        g = gather_rows(packed, sidx)  # (N, K, 3H + dim H); padded rows masked
        if scatter_to is not None:
            # sparse: gathered from the receivers, summed into the senders
            # (the reference's direction: dir_ij as stored, not flipped)
            ds, dv1, dv2 = torch.split(wij * g[..., :3 * h], h, dim=-1)
            dv = (dir_ij[..., :, None] * dv1[..., None, :]
                  + g[..., 3 * h:].reshape(-1, dim, h) * dv2[..., None, :])
            ds, dv = segment_sum(ds, scatter_to, n), segment_sum(dv, scatter_to, n)
        else:
            ds, dv = painn_msg.painn_message(
                g, (wij * mask[..., None]).contiguous(), (-dir_ij).to(wij.dtype), h
            )
        s = s + torch.clamp(ds.to(s.dtype), -1e2, 1e2)
        v = v + torch.clamp(dv.reshape(n, dim, h).to(v.dtype), -1e2, 1e2)

        v_l, v_r = torch.chunk(self.vmix(v, cdt), 2, dim=-1)
        v_norm = torch.sqrt(torch.sum(v_r**2, dim=-2) + EPS)
        ds, dv, dsv = torch.chunk(self.mix2(silu(self.mix1(torch.cat([s, v_norm], -1), cdt)),
                                            cdt), 3, dim=-1)
        dv = v_l * dv[:, None, :]
        dsv = dsv * torch.sum(v_r * v_l, dim=-2)
        s = s + torch.clamp(ds + dsv, -1e2, 1e2)
        v = v + torch.clamp(dv, -1e2, 1e2)
        return s, v


class PaiNN(JaxTree, nn.Module):
    """PaiNN over the LagrangeBench feature contract (dense layout).

    Args:
        hidden_size: channel width H (any, on CUDA for K6 and for K5 in
            the fused layout).
        num_mp_steps: number of PaiNN layers.
        n_rbf: radial basis functions (any; ``build_painn`` sets 20).
        radius: basis and cutoff radius (1.5 x the connectivity radius).
        n_vels: velocities in the history (input_seq_length - 1).
        n_vector_extra: extra vector channels (1 for a force, 2 for the
            wall distances without periodic boundaries).
        fused: K5 per layer (``fused_processor``) instead of K6 plus the
            node-level ops.
        compute_dtype: "float32", "bfloat16" or "float64" (CPU only).
        seed: seed of the initial weights (Flax's initializers).
        device: "cuda" (default) or "cpu".
    """

    def __init__(self, hidden_size: int, num_mp_steps: int, n_rbf: int, radius: float,
                 n_vels: int, n_vector_extra: int = 0, fused: bool = False,
                 compute_dtype: str = "float32", seed: int = 0, device="cuda"):
        from ..utils import resolve_device

        super().__init__()
        device = resolve_device(device)
        h = hidden_size
        self.hidden_size = h
        self.num_mp_steps = num_mp_steps
        self.radius = radius
        self.n_vels = n_vels
        self.fused = fused
        self.compute_dtype = getattr(torch, compute_dtype)
        gen = torch.Generator().manual_seed(seed)

        self.rbf = GaussianRBF(n_rbf, radius)
        self.embed_s = LinearXav(n_vels, h, generator=gen)  # the velocity magnitudes
        self.embed_v = LinearXav(n_vels + n_vector_extra, h, use_bias=False, generator=gen)
        if not fused:
            self.filter_nets = nn.ModuleList(LinearXav(n_rbf, 3 * h, generator=gen)
                                             for _ in range(num_mp_steps))
        self.layers = nn.ModuleList(PaiNNLayer(h, n_rbf, fused, generator=gen)
                                    for _ in range(num_mp_steps))
        width = h // 2
        self.readout = nn.ModuleList([
            GatedEquivariantBlock(h, h, 2 * width, width, width, generator=gen),
            GatedEquivariantBlock(width, width, width, 1, 1, generator=gen),
        ])
        self.to(device)

    def forward(self, features: Dict[str, torch.Tensor],
                particle_type: torch.Tensor) -> Dict[str, torch.Tensor]:
        cdt = self.compute_dtype
        n = particle_type.shape[0]
        vecs = [features["vel_hist"].reshape(n, self.n_vels, -1).transpose(1, 2)]
        if "force" in features:
            vecs.append(features["force"][..., None])
        if "bound" in features:
            vecs.append(features["bound"].reshape(n, 2, -1).transpose(1, 2))
        v0 = torch.cat(vecs, dim=-1)  # (N, dim, C)

        senders = features["senders"]
        sparse = senders.dim() == 1
        if sparse and self.fused:
            raise ValueError("the fused PaiNN layer needs the dense edge layout; sparse edges "
                             "take the standard layer (fused_processor=false)")
        rel_disp = features["rel_disp"]
        norm_ij = torch.sqrt(torch.sum(rel_disp**2, dim=-1) + EPS)
        dir_ij = rel_disp / (norm_ij[..., None] + EPS)
        phi = self.rbf(norm_ij).to(cdt)  # (N, K, R)
        cut = cosine_cutoff(norm_ij, self.radius)[..., None].to(cdt)
        mask = (senders < n).to(cdt)
        # padded slots (fill n) gather the last row, as a JAX gather clamps;
        # their filters are zero, so that row gets no gradient from them
        scatter_to = None
        if self.fused:
            sidx = painn_msg.sender_index(senders, n)  # K5's int32, once per forward
        elif sparse:  # gather from the receivers, sum into the senders
            sidx = torch.clamp(features["receivers"], max=n - 1).long()
            scatter_to, mask = senders, None
        else:
            sidx = torch.clamp(senders, max=n - 1).long()
        dir_c = dir_ij.to(cdt)

        s, v = self.embed(features["vel_mag"], v0)
        if self.fused:
            phi_ext = torch.cat([phi, cut * mask[..., None]], dim=-1).contiguous()
            v = v.reshape(n, -1)
            for layer in self.layers:
                s, v = layer(s, v, dir_c, phi_ext, sidx, mask, cdt)
            v = v.reshape(n, -1, self.hidden_size)
        else:
            for layer, filt in zip(self.layers, self.filter_nets):
                s, v = layer(s, v, dir_c, filt(phi, cdt) * cut, sidx, mask, cdt, scatter_to)
        return {"acc": self.read_out(s, v).to(torch.float32)}

    def embed(self, vel_mag: torch.Tensor, v0: torch.Tensor):
        """Scalar and vector channels from the velocity magnitudes (N,
        n_vels) and the vector features (N, dim, C): s (N, H), v (N, dim,
        H) in the compute dtype."""
        return self.embed_s(vel_mag, self.compute_dtype), self.embed_v(v0, self.compute_dtype)

    def read_out(self, s: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
        """The gated readout: the (N, dim) acceleration in the compute dtype."""
        for block in self.readout:
            s, v = block(s, v, self.compute_dtype)
        return v.squeeze(-1)

    # -- weights carried across from / to the JAX parameter tree -----------

    def load_jax_params(self, params: Dict) -> None:
        """Load a JAX PaiNN tree (numpy leaves), fused or standard layout."""
        fused_tree = "filt_w" in params.get("PaiNNLayer_0", {})
        if fused_tree and not self.fused:
            params = painn_standard_params_from_fused(params, self.num_mp_steps)
        elif self.fused and not fused_tree:
            params = painn_fused_params_from_standard(params, self.num_mp_steps)
        super().load_jax_params(params)

    def jax_leaves(self) -> List[Tuple[str, nn.Parameter, bool]]:
        """The tree's leaves in the module's layout (see ``base.JaxTree``)."""
        linears = [("LinearXav_0", self.embed_s), ("LinearXav_1", self.embed_v)]
        out = [("GaussianRBF_0/offset", self.rbf.offset, False),
               ("GaussianRBF_0/widths", self.rbf.widths, False)]
        for i, block in enumerate(self.readout):
            linears += block.named_leaves(f"GatedEquivariantBlock_{i}")
        for i, layer in enumerate(self.layers):
            prefix = f"PaiNNLayer_{i}"
            linears += [(f"{prefix}/LinearXav_0", layer.ctx1), (f"{prefix}/LinearXav_1", layer.ctx2)]
            if layer.fused:
                out += [(f"{prefix}/{name}", p, False) for name, p in layer.p.items()]
            else:
                linears += [(f"{prefix}/LinearXav_{j}", lin)
                            for j, lin in ((2, layer.vmix), (3, layer.mix1), (4, layer.mix2))]
                linears.append((f"filter_net_{i}", self.filter_nets[i]))
        for prefix, lin in linears:
            out += dense_leaves(f"{prefix}/Dense_0", lin)
        return sorted_leaves(out)


def painn_fused_params_from_standard(params: Dict, num_mp_steps: int) -> Dict:
    """Re-layout a standard PaiNN tree for the fused layer: each layer's
    filter net, vector mix (LinearXav_2) and mixing net (LinearXav_3/4)
    become the flat arrays K5 consumes; a rename and split."""
    out = {k: v for k, v in params.items() if not k.startswith(("PaiNNLayer", "filter_net"))}
    for i in range(num_mp_steps):
        lyr = dict(params[f"PaiNNLayer_{i}"])
        filt = params[f"filter_net_{i}"]["Dense_0"]
        vmix = lyr.pop("LinearXav_2")["Dense_0"]
        m1 = lyr.pop("LinearXav_3")["Dense_0"]
        m2 = lyr.pop("LinearXav_4")["Dense_0"]
        lyr.update({"filt_w": filt["kernel"], "filt_b": filt["bias"], "vmix_w": vmix["kernel"],
                    "mix_w1": m1["kernel"], "mix_b1": m1["bias"], "mix_w2": m2["kernel"],
                    "mix_b2": m2["bias"]})
        out[f"PaiNNLayer_{i}"] = lyr
    return out


def painn_standard_params_from_fused(fp: Dict, num_mp_steps: int) -> Dict:
    """The exact inverse of :func:`painn_fused_params_from_standard`."""
    out = {k: v for k, v in fp.items() if not k.startswith("PaiNNLayer")}
    for i in range(num_mp_steps):
        lyr = dict(fp[f"PaiNNLayer_{i}"])
        out[f"filter_net_{i}"] = {"Dense_0": {"kernel": lyr.pop("filt_w"),
                                              "bias": lyr.pop("filt_b")}}
        lyr["LinearXav_2"] = {"Dense_0": {"kernel": lyr.pop("vmix_w")}}
        lyr["LinearXav_3"] = {"Dense_0": {"kernel": lyr.pop("mix_w1"), "bias": lyr.pop("mix_b1")}}
        lyr["LinearXav_4"] = {"Dense_0": {"kernel": lyr.pop("mix_w2"), "bias": lyr.pop("mix_b2")}}
        out[f"PaiNNLayer_{i}"] = lyr
    return out


def build_painn(cfg_model, metadata: Dict, has_external_force: bool = False, seed: int = 0,
                device="cuda") -> PaiNN:
    """A PaiNN from a model config section and dataset metadata: 20
    trainable radial basis functions over 1.5 x the connectivity radius,
    homogeneous particles (the JAX package's ``build_painn``)."""
    if not cfg_model.magnitude_features:
        raise ValueError("PaiNN requires model.magnitude_features")
    pbc = metadata["periodic_boundary_conditions"]
    return PaiNN(
        hidden_size=int(cfg_model.latent_dim),
        num_mp_steps=int(cfg_model.num_mp_steps),
        n_rbf=20,
        radius=float(metadata["default_connectivity_radius"]) * 1.5,
        n_vels=int(cfg_model.input_seq_length) - 1,
        n_vector_extra=int(has_external_force) + (0 if any(pbc) else 2),
        fused=bool(cfg_model.get("fused_processor", False)),
        compute_dtype=cfg_model.get("compute_dtype", "float32"),
        seed=seed,
        device=device,
    )
