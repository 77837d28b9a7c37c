"""Graph Network-based Simulator (GNS): the fused processor (``GNS``) and
the standard one (``GNSStandard``).

Counterpart of ``lagrangebench_tpu/models/gns.py``. ``GNSStandard`` is its
default processor (``use_fused_processor=False``; any ``blocks_per_step``,
any latent width, dense or sparse edges). ``GNS`` is the one with
``use_fused_processor=True`` (dense edges, 2-layer MLP blocks; sparse edges
raise ValueError, as the JAX package asserts):

    h = MLP_0(concat(node features, Embed_0(type mod num_types)))
    for step i:  hs = h @ w_s, hr = h @ w_r
                 e, h = K3(e, hs[senders], hr, h, mask; encoder on step 0)
    acc = MLP_1(h)   (decoder, no LayerNorm), returned as float32

In the slot layout (features of a slot-format neighbor list, marked by
"slot_bases") the node state lives in column-slot order, (n_ext, F): the
particle types are gathered through ``slot_to_particle``, the encoder and
the processor run on the n_ext rows, each step is K8 (the sender rows read
in-kernel through the candidate ids and the stencil table, no gather), and
the decoder's output is read back through ``particle_to_slot``. Both
layouts share one parameter tree.

The processor's parameters are flat per-step arrays named as in the JAX
fused layout (``mp{i}_w_s`` ... ``mp{i}_ln2_bias``, ``enc_*``), kept as
(in, out) matrices, the layout the kernel reads. The node encoder and the
decoder are ``MLP`` modules of ``nn.Linear`` layers, (out, in).

``GNS.load_jax_params`` carries a JAX parameter tree (numpy arrays) into
the module, from the fused layout or from the standard auto-named layout
(converted as ``fused_params_from_standard`` does); ``jax_params`` gives
the fused-layout tree back, for ``checkpoint.save_checkpoint``.
``GNSStandard`` reads and gives the standard layout.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
from torch import nn

from ..ops import fused_mp
from ..ops.scatter import aggregate_to_receivers
from ..utils import NodeType
from .base import JaxTree, concat_edge_features, concat_node_features, sorted_leaves
from .utils import MLP, Dense, dense_leaves, gather_rows, lecun_normal_, matmul, mlp_leaves


def gns_input_sizes(metadata: Dict, input_seq_length: int,
                    magnitude_features: bool = False,
                    has_external_force: bool = False):
    """(node feature width, edge feature width) of the case's FeatureDict."""
    dim = int(metadata["dim"])
    n_vel = input_seq_length - 1
    node = n_vel * dim
    if magnitude_features:
        node += n_vel
    if not any(metadata["periodic_boundary_conditions"]):
        node += 2 * dim
    if has_external_force:
        node += dim
    return node, dim + 1


class GNS(JaxTree, nn.Module):
    """GNS model, fused processor.

    Args:
        particle_dimension: spatial dimensionality (2 or 3).
        node_in: node feature width (see :func:`gns_input_sizes`).
        edge_in: edge feature width (dim + 1).
        latent_size: latent width of node/edge states (128 on CUDA).
        num_mp_steps: number of message-passing steps.
        particle_type_embedding_size: width of the type embedding.
        num_particle_types: number of particle type ids.
        compute_dtype: "float32", "bfloat16" or "float64" (CPU only).
        seed: seed of the initial weights (Flax's initializers).
        device: "cuda" (default) or "cpu".
    """

    def __init__(
        self,
        particle_dimension: int,
        node_in: int,
        edge_in: int,
        latent_size: int = 128,
        num_mp_steps: int = 10,
        particle_type_embedding_size: int = 16,
        num_particle_types: int = NodeType.SIZE,
        compute_dtype: str = "float32",
        seed: int = 0,
        device="cuda",
    ):
        from ..utils import resolve_device

        super().__init__()
        device = resolve_device(device)
        self.particle_dimension = particle_dimension
        self.latent_size = latent_size
        self.num_mp_steps = num_mp_steps
        self.num_particle_types = num_particle_types
        self.compute_dtype = getattr(torch, compute_dtype)
        gen = torch.Generator().manual_seed(seed)

        emb = particle_type_embedding_size if num_particle_types > 1 else 0
        if emb:
            self.embedding = nn.Parameter(
                torch.randn(num_particle_types, emb, generator=gen) / math.sqrt(emb)
            )
        self.node_encoder = MLP(node_in + emb, latent_size, latent_size, generator=gen)
        self.edge_encoder = nn.ParameterDict(
            {
                name: nn.Parameter(self._init(name, edge_in, gen))
                for name in fused_mp.ENC_PARAM_NAMES
            }
        )
        self.mp_steps = nn.ModuleList(
            nn.ParameterDict(
                {
                    name: nn.Parameter(self._init(name, latent_size, gen))
                    for name in fused_mp.PARAM_NAMES
                }
            )
            for _ in range(num_mp_steps)
        )
        self.decoder = MLP(latent_size, latent_size, particle_dimension,
                           layer_norm=False, generator=gen)
        self._cast_cache = None
        self.to(device)

    def _init(self, name: str, fan_in: int, gen: torch.Generator) -> torch.Tensor:
        f = self.latent_size
        if name.startswith("w") or name.startswith("enc_w"):
            rows = fan_in if name == "enc_w1" else f
            w = torch.empty(rows, f)
            lecun_normal_(w, rows, gen)
            return w
        return torch.ones(f) if "scale" in name else torch.zeros(f)

    def _processor_params(self, cdt: torch.dtype):
        """Per-step and encoder parameters in the kernel's layout, converted
        once and reused until a parameter changes (inference: detached)."""
        version = tuple(p._version for p in self.parameters())
        cache = self._cast_cache
        if cache is None or cache[0] != (cdt, version):
            with torch.no_grad():
                steps = [fused_mp.kernel_params(dict(s), cdt) for s in self.mp_steps]
                enc = fused_mp.kernel_params(dict(self.edge_encoder), cdt)
            cache = ((cdt, version), steps, enc)
            self._cast_cache = cache
        return cache[1], cache[2]

    def forward(self, features: Dict[str, torch.Tensor],
                particle_type: torch.Tensor) -> Dict[str, torch.Tensor]:
        cdt = self.compute_dtype
        nodes = concat_node_features(features)
        e = concat_edge_features(features).to(
            torch.float64 if cdt == torch.float64 else torch.float32
        )
        senders = features["senders"]
        if senders.dim() == 1:
            raise ValueError("the fused GNS processor needs the dense edge layout; sparse "
                             "edges take the standard processor (fused_processor=false)")
        n = nodes.shape[0]
        slot = "slot_bases" in features
        if slot:
            s2p = torch.clamp(features["slot_to_particle"], max=particle_type.shape[0] - 1)
            particle_type = particle_type[s2p.long()]
        if self.num_particle_types > 1:
            emb = self.embedding[torch.remainder(particle_type.long(), self.num_particle_types)]
            wide = torch.promote_types(nodes.dtype, emb.dtype)
            nodes = torch.cat([nodes.to(wide), emb.to(wide)], dim=-1)
        h = self.node_encoder(nodes, cdt)

        training = torch.is_grad_enabled() and any(p.requires_grad for p in self.parameters())
        if training:
            # training: the stored parameters enter the autograd Function,
            # which casts them itself and returns gradients in their dtype
            steps = [dict(s) for s in self.mp_steps]
            enc = dict(self.edge_encoder)
        else:
            steps, enc = self._processor_params(cdt)
        if slot:
            step_fn = (fused_mp.gns_mp_step_slot_autograd if training
                       else fused_mp.gns_mp_step_slot)
            for i, p in enumerate(steps):
                hs_proj = matmul(h, p["w_s"].to(cdt))
                hr_proj = matmul(h, p["w_r"].to(cdt))
                e, h = step_fn(e, senders, features["slot_bases"], hs_proj, hr_proj, h, p,
                               enc=enc if i == 0 else None)
            acc = self.decoder(h, cdt)[features["particle_to_slot"].long()]
            return {"acc": acc.to(torch.float32)}
        step_fn = fused_mp.gns_mp_step_autograd if training else fused_mp.gns_mp_step
        mask = (senders < n).to(torch.float32)
        # padded slots (fill n) gather the last row, as a JAX gather clamps;
        # their messages are masked out, so that row gets no gradient from
        # them. The gather's backward sums in float32 (``gather_rows``).
        sidx = torch.clamp(senders, max=n - 1).long()
        for i, p in enumerate(steps):
            hs_proj = matmul(h, p["w_s"].to(cdt))
            hr_proj = matmul(h, p["w_r"].to(cdt))
            e, h = step_fn(
                e, gather_rows(hs_proj, sidx), hr_proj, h, mask, p,
                enc=enc if i == 0 else None,
            )
        acc = self.decoder(h, cdt)
        return {"acc": acc.to(torch.float32)}

    # -- weights carried across from / to the JAX parameter tree -----------

    def load_jax_params(self, params: Dict) -> None:
        """Load a JAX GNS tree (numpy leaves), fused or standard layout."""
        if not any(str(k).startswith("mp0_") for k in params):
            params = fused_params_from_standard(params, self.num_mp_steps)
        super().load_jax_params(params)

    def jax_leaves(self) -> List[Tuple[str, nn.Parameter, bool]]:
        """The fused-layout tree's leaves (see ``base.JaxTree``)."""
        out = mlp_leaves("MLP_0", self.node_encoder) + mlp_leaves("MLP_1", self.decoder)
        if self.num_particle_types > 1:
            out.append(("Embed_0/embedding", self.embedding, False))
        out += [(name, p, False) for name, p in self.edge_encoder.items()]
        for i, step in enumerate(self.mp_steps):
            out += [(f"mp{i}_{name}", p, False) for name, p in step.items()]
        return sorted_leaves(out)


class GNSStandard(JaxTree, nn.Module):
    """GNS model, standard processor: the JAX package's default
    (``use_fused_processor=False``, ``lagrangebench_tpu/models/gns.py``).

    Each MLP has ``blocks_per_step`` layers. Per step, with a fresh edge and
    node MLP and residuals on both: for ``blocks_per_step > 1`` the first
    edge layer over concat(h[senders], h[receivers], e) is decomposed at node
    level, ``relu(e @ W_e + b + (h @ W_s)[senders] + (h @ W_r)[receivers])``,
    followed by the remaining ``blocks_per_step - 1`` layers; one layer
    takes the concatenation itself. Messages are summed over each receiver's
    valid slots (dense layout: the receiver rows are a broadcast) or by
    receiver id (sparse layout: ``hr[receivers]`` is a gather, and a padded
    edge's receiver N drops). The products are ``torch.matmul`` in
    ``compute_dtype``, at any latent width. Parameters keep the JAX
    standard layout's auto names (``MLP_0`` node encoder, ``MLP_1`` edge
    encoder, per step i ``Dense_{3i..3i+2}`` and ``MLP_{2+2i}``,
    ``MLP_{3+2i}``, the decoder ``MLP_{2+2S}``); the fused layout is
    ``GNS``.
    """

    def __init__(
        self,
        particle_dimension: int,
        node_in: int,
        edge_in: int,
        latent_size: int = 128,
        blocks_per_step: int = 2,
        num_mp_steps: int = 10,
        particle_type_embedding_size: int = 16,
        num_particle_types: int = NodeType.SIZE,
        compute_dtype: str = "float32",
        seed: int = 0,
        device="cuda",
    ):
        from ..utils import resolve_device

        super().__init__()
        device = resolve_device(device)
        f = latent_size
        self.blocks_per_step = blocks_per_step
        self.num_mp_steps = num_mp_steps
        self.num_particle_types = num_particle_types
        self.compute_dtype = getattr(torch, compute_dtype)
        gen = torch.Generator().manual_seed(seed)

        def mlp(in_size, out_size, layers=blocks_per_step, layer_norm=True):
            return MLP(in_size, f, out_size, layers, layer_norm, generator=gen)

        emb = particle_type_embedding_size if num_particle_types > 1 else 0
        if emb:
            self.embedding = nn.Parameter(
                torch.randn(num_particle_types, emb, generator=gen) / math.sqrt(emb)
            )
        self.node_encoder = mlp(node_in + emb, f)
        self.edge_encoder = mlp(edge_in, f)
        self.steps = nn.ModuleList()
        for _ in range(num_mp_steps):
            if blocks_per_step > 1:
                step = nn.ModuleDict({
                    "w_s": Dense(f, f, gen, use_bias=False),
                    "w_r": Dense(f, f, gen, use_bias=False),
                    "w_e": Dense(f, f, gen),
                    "msg": mlp(f, f, layers=blocks_per_step - 1),
                })
            else:
                step = nn.ModuleDict({"msg": mlp(3 * f, f)})
            step["node"] = mlp(2 * f, f)
            self.steps.append(step)
        self.decoder = mlp(f, particle_dimension, layer_norm=False)
        self.to(device)

    def forward(self, features: Dict[str, torch.Tensor],
                particle_type: torch.Tensor) -> Dict[str, torch.Tensor]:
        if "slot_bases" in features:
            raise ValueError("the slot neighbor layout needs the fused processor")
        cdt = self.compute_dtype
        nodes = concat_node_features(features)
        senders, receivers = features["senders"], features["receivers"]
        n = nodes.shape[0]
        if self.num_particle_types > 1:
            emb = self.embedding[torch.remainder(particle_type.long(), self.num_particle_types)]
            wide = torch.promote_types(nodes.dtype, emb.dtype)
            nodes = torch.cat([nodes.to(wide), emb.to(wide)], dim=-1)
        h = self.node_encoder(nodes, cdt)
        e = self.edge_encoder(concat_edge_features(features), cdt)
        # padded slots or edges (fill n) gather the last row, as a JAX gather
        # clamps; their messages drop out of the aggregation
        sidx = torch.clamp(senders, max=n - 1).long()
        ridx = None if senders.dim() == 2 else torch.clamp(receivers, max=n - 1).long()

        def recv(x):  # x[receivers]; dense, row i is receiver i: a broadcast
            if ridx is None:
                return x[:, None, :].expand(-1, senders.shape[1], -1)
            return gather_rows(x, ridx)

        for step in self.steps:
            if self.blocks_per_step > 1:
                first = (step["w_e"](e, cdt) + gather_rows(step["w_s"](h, cdt), sidx)
                         + recv(step["w_r"](h, cdt)))
                messages = step["msg"](torch.relu(first), cdt)
            else:
                msg_in = torch.cat([gather_rows(h, sidx), recv(h), e], dim=-1)
                messages = step["msg"](msg_in, cdt)
            agg = aggregate_to_receivers(messages, receivers, senders, n)
            h = h + step["node"](torch.cat([h, agg], dim=-1), cdt)
            e = e + messages
        return {"acc": self.decoder(h, cdt).to(torch.float32)}

    def load_jax_params(self, params: Dict) -> None:
        """Load a JAX standard-layout GNS tree (numpy leaves)."""
        if any(str(k).startswith("mp0_") for k in params):
            raise ValueError("a fused-layout GNS tree: the standard processor reads the "
                             "standard layout (set model.fused_processor=true for this tree)")
        super().load_jax_params(params)

    def jax_leaves(self) -> List[Tuple[str, nn.Parameter, bool]]:
        """The standard-layout tree's leaves (see ``base.JaxTree``)."""
        out = mlp_leaves("MLP_0", self.node_encoder) + mlp_leaves("MLP_1", self.edge_encoder)
        if self.num_particle_types > 1:
            out.append(("Embed_0/embedding", self.embedding, False))
        for i, step in enumerate(self.steps):
            if self.blocks_per_step > 1:
                for j, name in enumerate(("w_s", "w_r", "w_e")):
                    out += dense_leaves(f"Dense_{3 * i + j}", step[name])
            out += mlp_leaves(f"MLP_{2 + 2 * i}", step["msg"])
            out += mlp_leaves(f"MLP_{3 + 2 * i}", step["node"])
        out += mlp_leaves(f"MLP_{2 + 2 * self.num_mp_steps}", self.decoder)
        return sorted_leaves(out)


def fused_params_from_standard(params: Dict, num_mp_steps: int) -> Dict:
    """Re-layout a standard (auto-named Flax) GNS tree for the fused
    processor: a rename and split, the math is identical."""
    out = {k: params[k] for k in ("Embed_0", "MLP_0") if k in params}
    latent = np.asarray(params["MLP_0"]["Dense_1"]["kernel"]).shape[1]
    enc_mlp = params["MLP_1"]
    out.update(
        {
            "enc_w1": enc_mlp["Dense_0"]["kernel"],
            "enc_b1": enc_mlp["Dense_0"]["bias"],
            "enc_w2": enc_mlp["Dense_1"]["kernel"],
            "enc_b2": enc_mlp["Dense_1"]["bias"],
            "enc_ln_scale": enc_mlp["LayerNorm_0"]["scale"],
            "enc_ln_bias": enc_mlp["LayerNorm_0"]["bias"],
        }
    )
    for i in range(num_mp_steps):
        d_hs = params[f"Dense_{3 * i}"]
        d_hr = params[f"Dense_{3 * i + 1}"]
        d_e = params[f"Dense_{3 * i + 2}"]
        mlp_msg = params[f"MLP_{2 + 2 * i}"]
        mlp_node = params[f"MLP_{3 + 2 * i}"]
        wn = np.asarray(mlp_node["Dense_0"]["kernel"])  # (2*latent, latent)
        out.update(
            {
                f"mp{i}_w_s": d_hs["kernel"],
                f"mp{i}_w_r": d_hr["kernel"],
                f"mp{i}_w_e": d_e["kernel"],
                f"mp{i}_b1": d_e["bias"],
                f"mp{i}_w2": mlp_msg["Dense_0"]["kernel"],
                f"mp{i}_b2": mlp_msg["Dense_0"]["bias"],
                f"mp{i}_ln1_scale": mlp_msg["LayerNorm_0"]["scale"],
                f"mp{i}_ln1_bias": mlp_msg["LayerNorm_0"]["bias"],
                f"mp{i}_w_nh": wn[:latent],
                f"mp{i}_w_na": wn[latent:],
                f"mp{i}_bn1": mlp_node["Dense_0"]["bias"],
                f"mp{i}_wn2": mlp_node["Dense_1"]["kernel"],
                f"mp{i}_bn2": mlp_node["Dense_1"]["bias"],
                f"mp{i}_ln2_scale": mlp_node["LayerNorm_0"]["scale"],
                f"mp{i}_ln2_bias": mlp_node["LayerNorm_0"]["bias"],
            }
        )
    out["MLP_1"] = params[f"MLP_{2 + 2 * num_mp_steps}"]
    return out


def build_gns(cfg_model, metadata: Dict, input_seq_length: Optional[int] = None,
              has_external_force: bool = False, seed: int = 0, device="cuda") -> nn.Module:
    """A GNS from a model config section and dataset metadata: ``GNS``
    (``fused_processor``, 2-layer MLPs) or ``GNSStandard``."""
    fused = bool(cfg_model.get("fused_processor", False))
    layers = int(cfg_model.num_mlp_layers)
    if fused and layers != 2:
        raise ValueError("the fused processor needs num_mlp_layers == 2")
    isl = input_seq_length or int(cfg_model.input_seq_length)
    node_in, edge_in = gns_input_sizes(
        metadata, isl, bool(cfg_model.magnitude_features), has_external_force
    )
    kw = dict(particle_dimension=int(metadata["dim"]), node_in=node_in, edge_in=edge_in,
              latent_size=int(cfg_model.latent_dim), num_mp_steps=int(cfg_model.num_mp_steps),
              compute_dtype=cfg_model.get("compute_dtype", "float32"), seed=seed,
              device=device)
    return GNS(**kw) if fused else GNSStandard(blocks_per_step=layers, **kw)
