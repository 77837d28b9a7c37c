"""E(n)-equivariant GNN (EGNN, Garcia Satorras et al. 2021), dense and
sparse layouts.

Counterpart of ``lagrangebench_tpu/models/egnn.py`` (``EGNNLayer``,
``EGNN``, ``build_egnn``), with the reference's physics adaptations: the
boundary-aware displacement and shift of ``ops/space.py`` in every position
update, positions integrated across the layers with dt / num_mp_steps, and
the finite-difference outputs {"pos", "vel", "acc"} (the shipped configs
train the position loss).

Per layer, on the (N, K) sender matrix (row i is receiver i, fill N):

    d     = displacement(pos[senders], pos)               (N, K, dim)
    msg   = MLPXav_0([h[senders], h, |d|^2, rel_dist])   (SiLU after both)
    h     = h + MLPXav_1([h, sum over valid slots of msg (, |force|)])
    pos   = shift(pos, segment_sum(d * head_pos(msg), senders))
    pos   = shift(pos, head_vel(h) * vel)

Padded slots gather row N-1 (``pos[senders]``, ``h[senders]``), as a JAX
gather clamps; their messages drop out of the receiver sum, and their
position terms out of the sender-directed ``segment_sum`` (id N is out of
range). On sparse (2, E) edges ``pos`` and ``h`` are gathered at the
receivers as well (``pos[receivers]``, ``h[receivers]``) and the message
sum runs by receiver id. The sender sum is a float32 ``index_add_`` on the
card, whose atomics sum in an order that changes from run to run. The
layer options the JAX ``build_egnn`` fixes (residual on; attention,
normalize and tanh off; one block) are the ones ported.

Parameters keep the JAX tree's auto names: ``Dense_0`` (the embedding of
the velocity magnitudes) and per layer ``EGNNLayer_i/MLPXav_0`` (messages),
``MLPXav_1`` (node update), ``Dense_0``/``Dense_1`` (position head) and
``Dense_2``/``Dense_3`` (velocity head).
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from ..ops import space
from ..ops.scatter import aggregate_to_receivers, segment_sum
from .base import JaxTree, sorted_leaves
from .utils import Dense, LinearXav, MLPXav, dense_leaves, gather_rows, mlp_leaves, silu


class _SmallHead(Dense):
    """The correction heads' output layer: no bias, uniform in
    +-3 dt / sqrt(fan_in) (the JAX package's ``_small_uniform(dt)``)."""

    def __init__(self, in_features: int, dt: float, generator):
        self.dt = dt
        super().__init__(in_features, 1, generator, use_bias=False)

    def init_weight(self, generator: torch.Generator) -> None:
        limit = 3.0 * self.dt / math.sqrt(self.in_features)
        with torch.no_grad():
            self.weight.uniform_(-limit, limit, generator=generator)


class EGNNLayer(nn.Module):
    """One EGNN layer: scalar messages, node update, position correction."""

    def __init__(self, hidden_size: int, dt: float, node_attr: int, generator=None):
        super().__init__()
        h = hidden_size
        self.msg = MLPXav(2 * h + 2, [h, h], activate_final=True, generator=generator)
        self.upd = MLPXav(2 * h + node_attr, [h, h], generator=generator)
        self.pos_hidden = LinearXav(h, h, generator=generator)
        self.pos_out = _SmallHead(h, dt, generator)
        self.vel_hidden = LinearXav(h, h, generator=generator)
        self.vel_out = _SmallHead(h, dt, generator)

    @staticmethod
    def _head(hidden, out, x, cdt):
        return out(silu(hidden(x, cdt)), cdt)

    def forward(self, h, pos, vel, senders, sidx, receivers, edge_attr, node_attr, disp,
                shift, cdt):
        n = h.shape[0]
        if senders.dim() == 2:  # row i is receiver i: a broadcast
            recv_pos, recv_h = pos[:, None, :], h[:, None, :].expand(-1, senders.shape[1], -1)
        else:
            ridx = torch.clamp(receivers, max=n - 1).long()
            recv_pos, recv_h = gather_rows(pos, ridx), gather_rows(h, ridx)
        coord_diff = disp(gather_rows(pos, sidx), recv_pos)
        radial = torch.sum(coord_diff**2, dim=-1, keepdim=True)
        wide = torch.promote_types(h.dtype, torch.promote_types(radial.dtype, edge_attr.dtype))
        msg_in = torch.cat([gather_rows(h, sidx).to(wide), recv_h.to(wide), radial.to(wide),
                            edge_attr.to(wide)], dim=-1)
        msg = self.msg(msg_in, cdt)

        agg = aggregate_to_receivers(msg, receivers, senders, n)
        upd_in = [h, agg] if node_attr is None else [h, agg, node_attr.to(h.dtype)]
        h_new = (h + self.upd(torch.cat(upd_in, dim=-1), cdt)).to(h.dtype)

        trans = coord_diff * self._head(self.pos_hidden, self.pos_out, msg, cdt).to(pos.dtype)
        pos = shift(pos, segment_sum(trans, senders, n))
        pos = shift(pos, self._head(self.vel_hidden, self.vel_out, h_new, cdt).to(pos.dtype) * vel)
        return h_new, pos

    def named_leaves(self, prefix: str):
        out = mlp_leaves(f"{prefix}/MLPXav_0", self.msg) + mlp_leaves(f"{prefix}/MLPXav_1", self.upd)
        for j, lin in enumerate((self.pos_hidden, self.pos_out, self.vel_hidden, self.vel_out)):
            out += dense_leaves(f"{prefix}/Dense_{j}", lin)
        return out


class EGNN(JaxTree, nn.Module):
    """EGNN over the LagrangeBench feature contract.

    Args:
        hidden_size: latent width.
        dt: the dataset's time step between frames (dt x write_every).
        n_vels: velocities in the history (input_seq_length - 1).
        box: box side lengths for periodic boundaries; None for free space.
        velocity_stats: the normalization's {"mean", "std"} of the velocity
            (tensors on the device); the model integrates unnormalized
            velocities. None: mean 0, std 1.
        num_mp_steps: number of layers.
        has_force: the features carry an external force (its magnitude is a
            node attribute of every layer).
        compute_dtype: "float32" or "float64" (CPU).
        seed: seed of the initial weights (Flax's initializers).
        device: "cuda" (default) or "cpu".
    """

    def __init__(self, hidden_size: int, dt: float, n_vels: int,
                 box: Optional[Sequence[float]] = None,
                 velocity_stats: Optional[Dict[str, torch.Tensor]] = None,
                 num_mp_steps: int = 4, has_force: bool = False,
                 compute_dtype: str = "float32", seed: int = 0, device="cuda"):
        from ..utils import resolve_device

        super().__init__()
        device = resolve_device(device)
        gen = torch.Generator().manual_seed(seed)
        self.n_vels = n_vels
        self.box = None if box is None else np.asarray(box, dtype=np.float64)
        self.velocity_stats = velocity_stats or {"mean": 0.0, "std": 1.0}
        self.compute_dtype = getattr(torch, compute_dtype)
        self.embed = LinearXav(n_vels, hidden_size, generator=gen)
        self.layers = nn.ModuleList(
            EGNNLayer(hidden_size, dt / num_mp_steps, int(has_force), generator=gen)
            for _ in range(num_mp_steps)
        )
        self._spaces = {}
        self.to(device)

    def _space(self, pos: torch.Tensor):
        """(displacement, shift) for positions of this dtype and device."""
        key = (pos.dtype, pos.device)
        if key not in self._spaces:
            if self.box is None:
                self._spaces[key] = space.free()
            else:
                self._spaces[key] = space.periodic(
                    torch.as_tensor(self.box, dtype=pos.dtype, device=pos.device))
        return self._spaces[key]

    def forward(self, features: Dict[str, torch.Tensor],
                particle_type: torch.Tensor) -> Dict[str, torch.Tensor]:
        cdt = self.compute_dtype
        n = features["vel_hist"].shape[0]
        vel_hist = features["vel_hist"].reshape(n, self.n_vels, -1)
        pos = features["abs_pos"][:, -1]
        node_attr = None
        if "force" in features:
            node_attr = torch.sqrt(torch.sum(features["force"] ** 2, dim=-1, keepdim=True))
        # the eps keeps the sqrt's gradient finite for particles at rest
        h = self.embed(torch.sqrt(torch.sum(vel_hist**2, dim=-1) + 1e-16), cdt)
        disp, shift = self._space(pos)
        stats = self.velocity_stats
        prev_vel = vel_hist[:, -1] * stats["std"] + stats["mean"]

        senders, receivers = features["senders"], features["receivers"]
        sidx = torch.clamp(senders, max=n - 1).long()
        next_pos = pos
        for layer in self.layers:
            h, next_pos = layer(h, next_pos, prev_vel, senders, sidx, receivers,
                                features["rel_dist"], node_attr, disp, shift, cdt)
        next_vel = disp(next_pos, pos)
        return {"pos": next_pos, "vel": next_vel, "acc": next_vel - prev_vel}

    def jax_leaves(self) -> List[Tuple[str, nn.Parameter, bool]]:
        out = dense_leaves("Dense_0", self.embed)
        for i, layer in enumerate(self.layers):
            out += layer.named_leaves(f"EGNNLayer_{i}")
        return sorted_leaves(out)


def build_egnn(cfg_model, metadata: Dict, has_external_force: bool = False,
               velocity_stats: Optional[Dict[str, torch.Tensor]] = None, seed: int = 0,
               device="cuda") -> EGNN:
    """An EGNN from a model config section and dataset metadata (the JAX
    package's ``build_egnn``): periodic or free space from the metadata,
    dt x write_every, the velocity stats of the normalization."""
    bounds = np.asarray(metadata["bounds"], dtype=np.float64)
    periodic = any(metadata["periodic_boundary_conditions"])
    return EGNN(
        hidden_size=int(cfg_model.latent_dim),
        dt=float(metadata["dt"]) * float(metadata.get("write_every", 1)),
        n_vels=int(cfg_model.input_seq_length) - 1,
        box=(bounds[:, 1] - bounds[:, 0]) if periodic else None,
        velocity_stats=velocity_stats,
        num_mp_steps=int(cfg_model.num_mp_steps),
        has_force=has_external_force,
        compute_dtype=cfg_model.get("compute_dtype", "float32"),
        seed=seed,
        device=device,
    )
