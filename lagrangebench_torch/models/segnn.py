"""Steerable E(3)-equivariant GNN (SEGNN, Brandstetter et al. 2022), dense
and sparse layouts.

Counterpart of ``lagrangebench_tpu/models/segnn.py`` on the port's
steerable engine (``models/e3``):

    attributes: edge  Y(rel_disp)                       (N, K, (lmax+1)^2)
                node  Y(velocity) + mean of the edge Y over valid slots,
                      component 0 set to 1
    h   = TP(node features, node attributes)             (embedding)
    per layer:
        msg = [h[senders], h (broadcast over K), rel_disp, rel_dist]
        msg = gated TP(msg, edge attributes)  x blocks_per_step
        agg = sum of msg over the valid slots of each receiver
        x   = gated TP([h, agg], node attributes)  x (blocks_per_step - 1)
        h   = h + TP(x, node attributes)  (then instance norm, optionally)
    acc = TP(gated TPs(h), node attributes) -> 1x1o, cut to 2D in 2D

Node features are the velocity history, the wall distances and the
external force as vectors, then the velocity magnitudes and, for more
than one particle type, a ``NodeType.SIZE`` one-hot as scalars (the JAX
package's order; its docstring records how that departs from the
reference). 2D features are lifted to 3D by zero-padding. Padded slots
(sender N) gather row N-1, as a JAX gather clamps, and drop out of the
sums. On sparse (2, E) edges the receiver rows are gathered
(``h[receivers]``) and the sums run by receiver id (a padded edge's
receiver N drops). ``segnn_norm: batch`` is accepted and applies no norm,
as in the JAX package, which implements only ``instance``.

Parameters keep the JAX tree's auto names: ``O3TensorProduct_0`` (the
embedding), ``SEGNNLayer_i/O3TensorProductGate_j/O3TensorProduct_0`` and
``SEGNNLayer_i/O3TensorProduct_0`` per layer, ``O3TensorProductGate_j``
(decoder) and ``O3TensorProduct_1`` (output).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch
from torch import nn

from ..ops.scatter import aggregate_mean_to_receivers, aggregate_to_receivers
from ..utils import NodeType
from .base import JaxTree, sorted_leaves
from .e3 import (
    Irreps,
    IrrepsArray,
    O3TensorProduct,
    O3TensorProductGate,
    concatenate,
    from_mul_major,
    spherical_harmonics_fn,
)
from .utils import features_2d_to_3d, gather_rows

EDGE_IRREPS = Irreps("1x1o + 1x0e")


def weight_balanced_irreps(scalar_units: int, irreps_right: Irreps, lmax: int) -> Irreps:
    """Left irreps with enough tensor-product paths to match a
    scalar_units^2 dense layer (reference segnn.py:365-400)."""
    linear_weights = scalar_units**2
    n = 0
    while True:
        n += 1
        irreps_left = (Irreps.spherical_harmonics(lmax) * n).sort().simplify()
        tp_weights = sum(gl.mul**2 * gr.mul for gl in irreps_left for gr in irreps_right
                         for g_out in irreps_left if g_out.ir in gl.ir * gr.ir)
        if tp_weights >= linear_weights:
            return irreps_left


def node_feature_irreps(metadata: Dict, input_seq_length: int, has_external_force: bool,
                        has_magnitudes: bool, homogeneous_particles: bool) -> Irreps:
    """Irreps of the (3D-lifted) node features, in concatenation order."""
    parts = [f"{input_seq_length - 1}x1o"]
    if not any(metadata["periodic_boundary_conditions"]):
        parts.append("2x1o")
    if has_external_force:
        parts.append("1x1o")
    if has_magnitudes:
        parts.append(f"{input_seq_length - 1}x0e")
    if not homogeneous_particles:
        parts.append(f"{NodeType.SIZE}x0e")
    return Irreps("+".join(parts))


class SEGNNLayer(nn.Module):
    """One steerable message-passing step."""

    def __init__(self, hidden: Irreps, attributes: Irreps, n_blocks: int = 2,
                 norm: Optional[str] = None, compute_dtype: str = "float32", generator=None):
        super().__init__()
        kw = dict(compute_dtype=compute_dtype, generator=generator)
        msg_in = hidden + hidden + EDGE_IRREPS
        self.message = nn.ModuleList(
            O3TensorProductGate(msg_in if b == 0 else hidden, attributes, hidden, **kw)
            for b in range(n_blocks))
        self.update = nn.ModuleList(
            O3TensorProductGate(hidden + hidden if b == 0 else hidden, attributes, hidden, **kw)
            for b in range(n_blocks - 1))
        self.update_out = O3TensorProduct(hidden + hidden if n_blocks == 1 else hidden,
                                          attributes, hidden, **kw)
        self.norm = norm

    def forward(self, nodes: IrrepsArray, node_attributes: IrrepsArray,
                edge_attributes: IrrepsArray, edge_feats: IrrepsArray, senders: torch.Tensor,
                sidx: torch.Tensor, receivers: torch.Tensor,
                sender_nodes: Optional[IrrepsArray] = None,
                edge_mask: Optional[torch.Tensor] = None) -> IrrepsArray:
        """``sender_nodes`` and ``edge_mask`` serve the spatially sharded
        path (``parallel/spatial.py``): the senders index halo-extended node
        rows, and an explicit (N, K) mask says which slots are edges."""
        h = nodes.array
        n = h.shape[0]
        if senders.dim() == 2:  # row i is receiver i: a broadcast
            recv = h[:, None, :].expand(n, senders.shape[1], h.shape[-1])
        else:
            recv = gather_rows(h, torch.clamp(receivers, max=n - 1).long())
        src = h if sender_nodes is None else sender_nodes.array
        msg = concatenate([IrrepsArray(nodes.irreps, gather_rows(src, sidx)),
                           IrrepsArray(nodes.irreps, recv), edge_feats])
        for block in self.message:
            msg = block(msg, edge_attributes)
        agg = msg.map_chunks(lambda c: aggregate_to_receivers(c, receivers, senders, n,
                                                              mask=edge_mask))

        x = concatenate([nodes, agg])
        for block in self.update:
            x = block(x, node_attributes)
        out = nodes + self.update_out(x, node_attributes)
        return _instance_norm(out) if self.norm == "instance" else out

    def named_leaves(self, prefix: str):
        out = []
        for j, block in enumerate(list(self.message) + list(self.update)):
            out += block.named_leaves(f"{prefix}/O3TensorProductGate_{j}")
        return out + self.update_out.named_leaves(f"{prefix}/O3TensorProduct_0")


def _instance_norm(z: IrrepsArray, eps: float = 1e-6) -> IrrepsArray:
    """RMS-normalize each irrep channel over the node axis."""

    def norm(c):  # (N, 2l+1, mul): mean over N of each m, summed over m
        norm2 = (c**2).mean(dim=0, keepdim=True).sum(dim=-2, keepdim=True)
        return c * (1.0 / torch.sqrt(norm2 + eps))

    return z.map_chunks(norm)


class SEGNN(JaxTree, nn.Module):
    """SEGNN over the LagrangeBench feature contract.

    Args:
        node_features_irreps: irreps of the 3D-lifted node features.
        scalar_units: the width a scalar MLP would have (``latent_dim``);
            the hidden irreps are weight-balanced against it.
        lmax_hidden, lmax_attributes: degrees of hidden features and of
            the spherical-harmonic attributes.
        num_mp_steps: message-passing layers.
        n_vels: velocities in the history (input_seq_length - 1).
        velocity_aggregate: "avg" or "last" (the velocity of the node
            attributes).
        homogeneous_particles: False adds the particle-type one-hot.
        norm: None or "instance".
        blocks_per_step: gated tensor products per message (and decoder).
        compute_dtype: dtype of the weight contractions ("float32",
            "bfloat16" or "float64").
        seed: seed of the initial weights (standard normal, zero biases).
        device: "cuda" (default) or "cpu".
    """

    def __init__(self, node_features_irreps, scalar_units: int, lmax_hidden: int,
                 lmax_attributes: int, num_mp_steps: int, n_vels: int,
                 velocity_aggregate: str = "avg", homogeneous_particles: bool = True,
                 norm: Optional[str] = None, blocks_per_step: int = 2,
                 compute_dtype: str = "float32", seed: int = 0, device="cuda"):
        from ..utils import resolve_device

        super().__init__()
        device = resolve_device(device)
        gen = torch.Generator().manual_seed(seed)
        kw = dict(compute_dtype=compute_dtype, generator=gen)
        self.n_vels = n_vels
        self.compute_dtype = getattr(torch, compute_dtype)
        self.velocity_aggregate = velocity_aggregate
        self.homogeneous_particles = homogeneous_particles
        self.node_features_irreps = Irreps(node_features_irreps)
        self.attribute_irreps = Irreps.spherical_harmonics(lmax_attributes)
        self.sh = spherical_harmonics_fn(lmax_attributes)
        attr = self.attribute_irreps
        hidden = weight_balanced_irreps(scalar_units, attr, lmax_hidden)
        self.hidden_irreps = hidden
        self.embed = O3TensorProduct(self.node_features_irreps, attr, hidden, **kw)
        self.layers = nn.ModuleList(
            SEGNNLayer(hidden, attr, blocks_per_step, norm, **kw) for _ in range(num_mp_steps))
        self.decoder = nn.ModuleList(
            O3TensorProductGate(hidden, attr, hidden, **kw) for _ in range(blocks_per_step))
        self.out = O3TensorProduct(hidden, attr, Irreps("1x1o"), **kw)
        self.to(device)

    def _attributes(self, features: Dict[str, torch.Tensor],
                    n: int) -> Tuple[IrrepsArray, IrrepsArray]:
        """Steerable node and edge attributes from geometry and velocity."""
        vel_hist = features["vel_hist"].reshape(n, self.n_vels, 3)
        if self.n_vels == 1:
            vel = vel_hist[:, 0]
        elif self.velocity_aggregate == "avg":
            vel = vel_hist.mean(dim=1)
        else:  # "last"
            vel = vel_hist[:, -1]
        edge_attr = self.sh(features["rel_disp"])  # (N, K, attr)
        scattered = aggregate_mean_to_receivers(edge_attr, features["receivers"],
                                                features["senders"], n)
        node_attr = self.sh(vel) + scattered
        node_attr = torch.cat([torch.ones_like(node_attr[:, :1]), node_attr[:, 1:]], dim=-1)
        return (IrrepsArray(self.attribute_irreps, node_attr),
                IrrepsArray(self.attribute_irreps, edge_attr))

    def forward(self, features: Dict[str, torch.Tensor],
                particle_type: torch.Tensor) -> Dict[str, torch.Tensor]:
        n = features["vel_hist"].shape[0]
        dim = features["vel_hist"].shape[1] // self.n_vels
        assert dim in (2, 3)
        if dim == 2:
            features = features_2d_to_3d(features)
        node_attributes, edge_attributes = self._attributes(features, n)

        # node features in irreps order: vectors first, then scalars
        feats: List[torch.Tensor] = [features[key] for key in
                                     ("vel_hist", "bound", "force", "vel_mag") if key in features]
        if not self.homogeneous_particles:
            types = torch.arange(NodeType.SIZE, device=particle_type.device)
            feats.append((particle_type[:, None] == types).to(features["vel_hist"].dtype))
        nodes = from_mul_major(self.node_features_irreps, torch.cat(feats, dim=-1))
        edge_feats = IrrepsArray(EDGE_IRREPS,
                                 torch.cat([features["rel_disp"], features["rel_dist"]], dim=-1))

        nodes = self.embed(nodes, node_attributes)
        senders, receivers = features["senders"], features["receivers"]
        sidx = torch.clamp(senders, max=n - 1).long()
        for layer in self.layers:
            nodes = layer(nodes, node_attributes, edge_attributes, edge_feats, senders, sidx,
                          receivers)
        x = nodes
        for block in self.decoder:
            x = block(x, node_attributes)
        acc = self.out(x, node_attributes).array
        return {"acc": acc[:, :2] if dim == 2 else acc}

    def jax_leaves(self):
        out = self.embed.named_leaves("O3TensorProduct_0")
        for i, layer in enumerate(self.layers):
            out += layer.named_leaves(f"SEGNNLayer_{i}")
        for j, block in enumerate(self.decoder):
            out += block.named_leaves(f"O3TensorProductGate_{j}")
        out += self.out.named_leaves("O3TensorProduct_1")
        return sorted_leaves(out)


def build_segnn(cfg_model, metadata: Dict, has_external_force: bool = False,
                homogeneous_particles: bool = True, seed: int = 0, device="cuda") -> SEGNN:
    """A SEGNN from a model config section and dataset metadata (the JAX
    package's ``build_segnn``)."""
    node_irreps = node_feature_irreps(metadata, int(cfg_model.input_seq_length),
                                      has_external_force, bool(cfg_model.magnitude_features),
                                      homogeneous_particles)
    norm = cfg_model.segnn_norm
    return SEGNN(
        node_features_irreps=node_irreps,
        scalar_units=int(cfg_model.latent_dim),
        lmax_hidden=int(cfg_model.lmax_hidden),
        lmax_attributes=int(cfg_model.lmax_attributes),
        num_mp_steps=int(cfg_model.num_mp_steps),
        n_vels=int(cfg_model.input_seq_length) - 1,
        velocity_aggregate=cfg_model.velocity_aggregate,
        homogeneous_particles=homogeneous_particles,
        norm=None if norm in ("none", None) else norm,
        blocks_per_step=int(cfg_model.num_mlp_layers),
        compute_dtype=cfg_model.get("compute_dtype", "float32"),
        seed=seed,
        device=device,
    )
