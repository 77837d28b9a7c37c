"""The reference's Haiku checkpoints: import and export.

Counterpart of ``lagrangebench_tpu/compat.py``, in numpy. The reference
stores a checkpoint with ``save_haiku`` (reference
lagrangebench/utils.py:50-128): ``{name}_array.npy``, the ``np.save``
streams of every leaf of the tree one after another in tree order, and
``{name}_tree.pkl``, the pickled tree with every leaf replaced by 0, which
fixes that order. The order is JAX's flatten order (dict keys sorted at
every level), kept here without JAX. Haiku parameter dicts are keyed by
module path, e.g. ``"gns/~/MLP_3/~/linear_0": {"w": ..., "b": ...}``.

The importers re-key such a tree into the JAX package's parameter trees
(nested dicts of numpy arrays), which the port's modules read with
``load_jax_params``; the exporters are their exact inverses. GNS splits the
reference's (3L, L) first edge-MLP weight into the three (L, L)
projections of its decomposed edge update (the same math).

An older Haiku pickled its mapping classes (``FlatMapping``); the skeleton
is read without Haiku, every class of its data structures taken as a dict.

The SEGNN importer is a draft, as unvalidated as the JAX package's: the
reference's SEGNN keeps its weights in e3nn-jax's Haiku ``Linear``
modules, and e3nn-jax was not at hand to check the layout against. It
refuses to run without ``allow_unvalidated=True`` and fails with a full
found-versus-expected list on any mismatch.
"""

from __future__ import annotations

import json
import os
import pickle
import re
from typing import Dict, List, Optional, Tuple

import numpy as np

# ---------------------------------------------------------------------------
# the save_haiku layout
# ---------------------------------------------------------------------------


class _Unpickler(pickle.Unpickler):
    """Reads a skeleton pickled under Haiku's data-structure classes
    (``haiku._src.data_structures.FlatMapping``, ``frozendict``, each
    reduced to the class and one mapping) as plain dicts, without importing
    Haiku."""

    def find_class(self, module, name):
        if module.split(".")[0] == "haiku" and "data_structures" in module:
            return _as_dict
        return super().find_class(module, name)


def _as_dict(mapping):
    """A Haiku mapping rebuilt from its pickle (the class and one mapping)
    as a dict."""
    return dict(mapping)


def _to_plain_dict(obj):
    if hasattr(obj, "items"):
        return {k: _to_plain_dict(v) for k, v in obj.items()}
    return obj


def _flatten(tree) -> List[Tuple[Tuple, object]]:
    """(path, leaf) in JAX's flatten order: dict keys sorted at every level;
    None and empty dicts hold no leaf."""
    if isinstance(tree, dict):
        out = []
        for k in sorted(tree):
            out += [((k,) + p, leaf) for p, leaf in _flatten(tree[k])]
        return out
    if tree is None:
        return []
    return [((), tree)]


def _set(tree: Dict, path: Tuple, value) -> None:
    for k in path[:-1]:
        tree = tree[k]
    tree[path[-1]] = value


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    return None if tree is None else fn(tree)


def load_haiku_pytree(model_dir: str, name: str):
    """One tree of the ``save_haiku`` layout (reference utils.py:100-110)."""
    with open(os.path.join(model_dir, f"{name}_tree.pkl"), "rb") as f:
        skeleton = _to_plain_dict(_Unpickler(f).load())
    leaves = _flatten(skeleton)
    with open(os.path.join(model_dir, f"{name}_array.npy"), "rb") as f:
        arrays = [np.load(f, allow_pickle=False) for _ in leaves]
    out = _map(lambda x: 0, skeleton)
    for (path, _), arr in zip(leaves, arrays):
        _set(out, path, arr)
    return out


def is_haiku_checkpoint(model_dir: str) -> bool:
    """A checkpoint in the reference's Haiku layout (``params_array.npy``)."""
    return os.path.exists(os.path.join(model_dir, "params_array.npy"))


# ---------------------------------------------------------------------------
# GNS
# ---------------------------------------------------------------------------

def _mlp_from_haiku(hk_params: Dict, prefix: str, mlp_name: str, ln_name=None) -> Dict:
    """One Haiku ``build_mlp`` -> the JAX package's ``MLP`` (Dense_i and LayerNorm_0)."""
    out = {}
    i = 0
    while f"{prefix}/{mlp_name}/~/linear_{i}" in hk_params:
        lin = hk_params[f"{prefix}/{mlp_name}/~/linear_{i}"]
        out[f"Dense_{i}"] = {"kernel": np.asarray(lin["w"]), "bias": np.asarray(lin["b"])}
        i += 1
    if i == 0:
        raise ValueError(f"no linear layers under {prefix}/{mlp_name}")
    if ln_name is not None:
        ln = hk_params[f"{prefix}/{ln_name}"]
        out["LayerNorm_0"] = {"scale": np.asarray(ln["scale"]), "bias": np.asarray(ln["offset"])}
    return out


def haiku_gns_to_flax(hk_params: Dict, num_mp_steps: int) -> Dict:
    """A Haiku GNS tree in the JAX package's standard GNS layout.

    Haiku scopes parameters by the method that made the module (reference
    models/gns.py:64-208 with ``build_mlp``, models/utils.py:100-115):
    ``gns/~/embed``, ``gns/~_encoder/MLP[_1]`` with their layer norms (node,
    then edge encoder), per MP step ``gns/~_processor/MLP_{2i}`` (edge
    update) and ``MLP_{2i+1}`` (node update), and ``gns/~_decoder/MLP``
    (no layer norm)."""
    g = "gns"
    enc, proc, dec = f"{g}/~_encoder", f"{g}/~_processor", f"{g}/~_decoder"
    out: Dict = {
        "Embed_0": {"embedding": np.asarray(hk_params[f"{g}/~/embed"]["embeddings"])},
        "MLP_0": _mlp_from_haiku(hk_params, enc, "MLP", "layer_norm"),
        "MLP_1": _mlp_from_haiku(hk_params, enc, "MLP_1", "layer_norm_1"),
    }
    latent = out["MLP_0"]["Dense_1"]["kernel"].shape[1]
    for i in range(num_mp_steps):
        mlp_id = 2 + 2 * i
        sfx = "" if i == 0 else f"_{2 * i}"
        edge = _mlp_from_haiku(hk_params, proc, f"MLP{sfx}", f"layer_norm{sfx}")
        # the first layer acts on concat([h_s, h_r, e]): its (3L, L) weight
        # splits into the three projections (the bias goes with e)
        w0, b0 = edge["Dense_0"]["kernel"], edge["Dense_0"]["bias"]
        if w0.shape[0] != 3 * latent:
            raise ValueError(f"edge MLP_{mlp_id} first layer is {w0.shape}, expected "
                             f"({3 * latent}, {latent})")
        out[f"Dense_{3 * i}"] = {"kernel": w0[:latent]}
        out[f"Dense_{3 * i + 1}"] = {"kernel": w0[latent:2 * latent]}
        out[f"Dense_{3 * i + 2}"] = {"kernel": w0[2 * latent:], "bias": b0}
        n_lin = len([k for k in edge if k.startswith("Dense")])
        msg = {f"Dense_{j - 1}": edge[f"Dense_{j}"] for j in range(1, n_lin)}
        msg["LayerNorm_0"] = edge["LayerNorm_0"]
        out[f"MLP_{mlp_id}"] = msg
        out[f"MLP_{3 + 2 * i}"] = _mlp_from_haiku(hk_params, proc, f"MLP_{2 * i + 1}",
                                                  f"layer_norm_{2 * i + 1}")
    out[f"MLP_{2 + 2 * num_mp_steps}"] = _mlp_from_haiku(hk_params, dec, "MLP")
    return out


# ---------------------------------------------------------------------------
# EGNN
# ---------------------------------------------------------------------------

def _lin(hk_params: Dict, path: str, with_bias: bool = True) -> Dict:
    """One Haiku Linear -> Dense parameters."""
    lin = hk_params[path]
    out = {"kernel": np.asarray(lin["w"])}
    if with_bias:
        out["bias"] = np.asarray(lin["b"])
    return out


def _xav_mlp(hk_params: Dict, prefix: str) -> Dict:
    """One Haiku ``hk.nets.MLP`` -> the JAX package's ``MLPXav``."""
    out = {}
    i = 0
    while f"{prefix}/~/linear_{i}" in hk_params:
        out[f"Dense_{i}"] = _lin(hk_params, f"{prefix}/~/linear_{i}")
        i += 1
    if i == 0:
        raise ValueError(f"no linear layers under {prefix}")
    return out


def haiku_egnn_to_flax(hk_params: Dict, num_mp_steps: int) -> Dict:
    """A Haiku EGNN tree in the JAX package's EGNN layout.

    Haiku paths (reference models/egnn.py:25-206; the layers are made in
    ``EGNN.__call__``, under "egnn"): ``egnn/scalar_emb``, per layer
    ``egnn/layer_k/~/mlp`` (edge MLP), ``mlp_1`` (node MLP),
    ``linear``/``linear_1`` (the position head, its last layer without bias)
    and ``linear_2``/``linear_3`` (the velocity head). The shipped
    ``blocks=1`` (the reference runner never changes it)."""
    out: Dict = {"Dense_0": _lin(hk_params, "egnn/scalar_emb")}
    for k in range(num_mp_steps):
        lyr = f"egnn/layer_{k}"
        if f"{lyr}/~/linear_4" in hk_params:
            raise ValueError("unexpected attention/blocks>1 EGNN checkpoint layout")
        out[f"EGNNLayer_{k}"] = {
            "MLPXav_0": _xav_mlp(hk_params, f"{lyr}/~/mlp"),
            "MLPXav_1": _xav_mlp(hk_params, f"{lyr}/~/mlp_1"),
            "Dense_0": _lin(hk_params, f"{lyr}/~/linear"),
            "Dense_1": _lin(hk_params, f"{lyr}/~/linear_1", with_bias=False),
            "Dense_2": _lin(hk_params, f"{lyr}/~/linear_2"),
            "Dense_3": _lin(hk_params, f"{lyr}/~/linear_3", with_bias=False),
        }
    return out


# ---------------------------------------------------------------------------
# PaiNN
# ---------------------------------------------------------------------------

def haiku_painn_to_flax(hk_params: Dict, num_mp_steps: int, shared_filters: bool = False) -> Dict:
    """A Haiku PaiNN tree in the JAX package's standard PaiNN layout.

    Haiku paths (reference models/painn.py:355-434): the trainable RBF at
    the transform's root bundle ``~``; ``painn/~/filter_net``, one linear
    making every layer's filters (its columns split per layer, or kept
    whole as ``filter_net`` with ``shared_filters``);
    ``painn/~/{scalar,vector}_embedding``; per layer
    ``painn/~/layer_i/~/linear{,_1}`` (interaction), ``vector_mixing_block``,
    ``linear_2``/``linear_3`` (mixing); the readout blocks
    ``painn/readout_block_{0,out}/~/...``."""
    rbf = hk_params["~"]
    out: Dict = {
        "GaussianRBF_0": {"widths": np.asarray(rbf["widths"]),
                          "offset": np.asarray(rbf["offset"])},
        "LinearXav_0": {"Dense_0": _lin(hk_params, "painn/~/scalar_embedding")},
        "LinearXav_1": {"Dense_0": _lin(hk_params, "painn/~/vector_embedding",
                                        with_bias=False)},
    }
    fw = np.asarray(hk_params["painn/~/filter_net"]["w"])
    fb = np.asarray(hk_params["painn/~/filter_net"]["b"])
    if shared_filters:
        out["filter_net"] = {"Dense_0": {"kernel": fw, "bias": fb}}
    else:
        if fw.shape[1] % num_mp_steps:
            raise ValueError(f"filter_net width {fw.shape[1]} not divisible by "
                             f"num_mp_steps={num_mp_steps}; shared_filters checkpoint?")
        width = fw.shape[1] // num_mp_steps
        for i in range(num_mp_steps):
            sl = slice(i * width, (i + 1) * width)
            out[f"filter_net_{i}"] = {"Dense_0": {"kernel": fw[:, sl], "bias": fb[sl]}}
    for i in range(num_mp_steps):
        lyr = f"painn/~/layer_{i}"
        if lyr + "/~/linear" not in hk_params and i > 0:
            raise ValueError("shared_interactions PaiNN checkpoints are not supported")
        out[f"PaiNNLayer_{i}"] = {
            "LinearXav_0": {"Dense_0": _lin(hk_params, f"{lyr}/~/linear")},
            "LinearXav_1": {"Dense_0": _lin(hk_params, f"{lyr}/~/linear_1")},
            "LinearXav_2": {"Dense_0": _lin(hk_params, f"{lyr}/~/vector_mixing_block",
                                            with_bias=False)},
            "LinearXav_3": {"Dense_0": _lin(hk_params, f"{lyr}/~/linear_2")},
            "LinearXav_4": {"Dense_0": _lin(hk_params, f"{lyr}/~/linear_3")},
        }
    for j, blk in enumerate(["readout_block_0", "readout_block_out"]):
        pre = f"painn/{blk}"
        out[f"GatedEquivariantBlock_{j}"] = {
            "LinearXav_0": {"Dense_0": _lin(hk_params, f"{pre}/~/vector_mix_net",
                                            with_bias=False)},
            "LinearXav_1": {"Dense_0": _lin(hk_params, f"{pre}/~/linear")},
            "LinearXav_2": {"Dense_0": _lin(hk_params, f"{pre}/~/linear_1")},
        }
    return out


# ---------------------------------------------------------------------------
# Linear
# ---------------------------------------------------------------------------

def haiku_linear_to_flax(hk_params: Dict) -> Dict:
    """The reference's ``Linear``: one hk.Linear under "linear"
    (reference models/linear.py)."""
    lin = hk_params[next(k for k in hk_params if "linear" in k)]
    return {"Dense_0": {"kernel": np.asarray(lin["w"]), "bias": np.asarray(lin["b"])}}


# ---------------------------------------------------------------------------
# SEGNN (a draft, numerically unvalidated)
#
# The reference's SEGNN parameters live in e3nn-jax's Haiku Linear modules
# (reference models/segnn.py:89-95). The layout below (Haiku paths, the order
# of e3nn's tensor-product outputs, the Linear's instructions and
# normalization) is read from the reference's source and e3nn-jax's
# conventions, without e3nn-jax to check it against.
# ---------------------------------------------------------------------------

def _e3nn_ir_sort_key(l: int, p: int):
    """The assumed order of e3nn's irreps: by l, then the natural parity
    (p = (-1)^l) first."""
    return (l, -p * (-1) ** l)


def _e3nn_tp_output_groups(x_irreps, y_irreps):
    """The assumed grouping of e3nn's ``tensor_product(x, y)`` outputs:
    x-group major, then y-group, then output l ascending with parity p1 p2;
    sorted by irrep (stably) and equal neighbours merged. Returns ``groups``
    [(mul, (l, p))], the e3nn Linear's input groups (the ``a`` of its
    ``w[a,b]``), and ``rows`` {(i, j, ir): (group, row offset)}, where the
    path of x-group i and y-group j to ir sits in its group."""
    from .models.e3.irreps import Irrep

    chunks = []
    birth = 0
    for i, gx in enumerate(x_irreps):
        for j, gy in enumerate(y_irreps):
            for ir in gx.ir * gy.ir:
                chunks.append((_e3nn_ir_sort_key(ir.l, ir.p), birth, gx.mul * gy.mul,
                               (ir.l, ir.p), (i, j)))
                birth += 1
    chunks.sort(key=lambda c: (c[0], c[1]))
    groups, rows = [], {}
    for _, _, mul, irlp, (i, j) in chunks:
        if groups and groups[-1][1] == irlp:
            off = groups[-1][0]
            groups[-1] = (off + mul, irlp)
        else:
            off = 0
            groups.append((mul, irlp))
        rows[(i, j, Irrep(*irlp))] = (len(groups) - 1, off)
    return groups, rows


def _e3nn_out_groups(out_irreps):
    """The assumed ``irreps_out`` of the e3nn Linear: the requested output
    regrouped (the reference's gated product regroups gates and outputs,
    segnn.py:164-166). Returns (groups, {output k: (group, column offset)})."""
    groups, colmap = [], {}
    order = sorted(range(len(out_irreps)),
                   key=lambda k: (_e3nn_ir_sort_key(out_irreps[k].ir.l, out_irreps[k].ir.p), k))
    for k in order:
        g = out_irreps[k]
        irlp = (g.ir.l, g.ir.p)
        if groups and groups[-1][1] == irlp:
            colmap[k] = (len(groups) - 1, groups[-1][0])
            groups[-1] = (groups[-1][0] + g.mul, irlp)
        else:
            groups.append((g.mul, irlp))
            colmap[k] = (len(groups) - 1, 0)
    return groups, colmap


def _parse_e3nn_param_name(name: str):
    """The assumed names of an e3nn Haiku Linear's parameters:
    ``"w[a,b] ..."`` (weight (mul_a, mul_b)) and ``"b[b] ..."`` (bias
    (mul_b,)). Returns ("w", a, b), ("b", None, b) or None."""
    m = re.match(r"^w\[(\d+),(\d+)\]", name)
    if m:
        return ("w", int(m.group(1)), int(m.group(2)))
    m = re.match(r"^b\[(\d+)\]", name)
    if m:
        return ("b", None, int(m.group(1)))
    return None


def segnn_site_specs(model) -> Tuple[Dict, Dict[str, Tuple[str, str, str]]]:
    """The port's SEGNN's parameter tree and the ``(x, y, out)`` irreps of
    each of its tensor products under its JAX tree path (e.g.
    ``"SEGNNLayer_0/O3TensorProductGate_1/O3TensorProduct_0"``), read from
    the modules, which know their irreps when they are built."""
    sites = [("O3TensorProduct_0", model.embed)]
    for i, layer in enumerate(model.layers):
        for j, block in enumerate(list(layer.message) + list(layer.update)):
            sites.append((f"SEGNNLayer_{i}/O3TensorProductGate_{j}/O3TensorProduct_0",
                          block.tp))
        sites.append((f"SEGNNLayer_{i}/O3TensorProduct_0", layer.update_out))
    for j, block in enumerate(model.decoder):
        sites.append((f"O3TensorProductGate_{j}/O3TensorProduct_0", block.tp))
    sites.append(("O3TensorProduct_1", model.out))
    specs = {path: (str(tp.irreps_x), str(tp.irreps_y), str(tp.output_irreps))
             for path, tp in sites}
    return model.jax_params(), specs


def _segnn_haiku_stem(flax_path: str) -> str:
    """The reference's Haiku module path of a SEGNN tensor product
    (embedding segnn.py:201-203, the layer's products :302, :324, :328,
    whose update duplicates Haiku names tp_i_1, the decoder :241 and the
    output :245)."""
    parts = flax_path.split("/")
    top = parts[0]
    if top == "O3TensorProduct_0":
        return "segnn/~/embedding_nodes"
    if top == "O3TensorProduct_1":
        return "segnn/~/output"
    if top.startswith("O3TensorProductGate_"):
        return f"segnn/~/readout_{int(top.rsplit('_', 1)[1])}"
    if top.startswith("SEGNNLayer_"):
        k = int(top.rsplit("_", 1)[1])
        table = {"O3TensorProductGate_0": "tp_0", "O3TensorProductGate_1": "tp_1",
                 "O3TensorProductGate_2": "tp_0_1", "O3TensorProduct_0": "tp_1_1"}
        return f"segnn/~/layer_{k}/~/{table[parts[1]]}"
    raise KeyError(f"unrecognized SEGNN site {flax_path!r}")


def haiku_segnn_to_flax(hk_params: Dict, model, *, allow_unvalidated: bool = False,
                        forward_alpha: str = "folded",
                        sign_overrides: Optional[Dict] = None) -> Dict:
    """A DRAFT importer: the reference's (e3nn Haiku) SEGNN tree in the JAX
    package's SEGNN layout, for the port's SEGNN ``model``.

    UNVALIDATED: e3nn-jax was not at hand, so the layout encoded here (the
    Haiku module paths, the order of e3nn's tensor-product outputs, the
    Linear's instructions and normalization) comes from reading the
    sources, not from genuine checkpoints. It refuses to run unless
    ``allow_unvalidated=True`` and raises with a full found-versus-expected
    list on any structural mismatch.

    Scaling: with the reference's ``gradient_normalization="element"`` the
    e3nn Linear holds its per-instruction normalization in the stored
    weights, while the port's tensor product multiplies by 1/sqrt(fan_in),
    so each weight block is scaled by sqrt(fan_in). Both Clebsch-Gordan
    conventions have sum(C^2) = 2 l3 + 1, which leaves at most a sign per
    (l1, l2, l3): ``sign_overrides`` {(l1, l2, l3): +-1.0} (default +1).
    ``forward_alpha``: "folded" (the assumed e3nn behaviour), the only
    convention drafted.
    """
    if not allow_unvalidated:
        raise NotImplementedError(
            "haiku_segnn_to_flax is a numerically UNVALIDATED draft (no e3nn-jax to "
            "validate its layout against). Pass allow_unvalidated=True to run it anyway.")
    if forward_alpha != "folded":
        raise ValueError("only the 'folded' model is drafted")
    from .models.e3.irreps import Irreps

    signs = sign_overrides or {}
    params, specs = segnn_site_specs(model)
    problems = []
    out = _map(lambda x: np.zeros_like(np.asarray(x)), params)
    consumed = set()
    for flax_path, (x_s, y_s, o_s) in specs.items():
        x_ir, y_ir, o_ir = Irreps(x_s), Irreps(y_s), Irreps(o_s)
        hk_key = f"{_segnn_haiku_stem(flax_path)}/~/linear"
        consumed.add(hk_key)
        if hk_key not in hk_params:
            problems.append(f"missing haiku module {hk_key!r} (for flax site {flax_path})")
            continue
        in_groups, rows = _e3nn_tp_output_groups(x_ir, y_ir)
        out_groups, colmap = _e3nn_out_groups(o_ir)
        weights, biases = {}, {}
        for name, arr in hk_params[hk_key].items():
            parsed = _parse_e3nn_param_name(name)
            if parsed is None:
                problems.append(f"{hk_key}: unrecognized param {name!r}")
                continue
            kind, a, b = parsed
            if kind == "w":
                exp = (in_groups[a][0], out_groups[b][0])
                if tuple(arr.shape) != exp:
                    problems.append(f"{hk_key}/{name}: shape {arr.shape}, expected {exp} from "
                                    f"groups in={in_groups} out={out_groups}")
                weights[(a, b)] = np.asarray(arr)
            else:
                exp_b = (out_groups[b][0],)
                if tuple(arr.shape) != exp_b:
                    problems.append(f"{hk_key}/{name}: shape {arr.shape}, expected {exp_b} "
                                    f"from out groups {out_groups}")
                biases[b] = np.asarray(arr)

        node = out
        for p in flax_path.split("/"):
            node = node[p]
        for k_out, g_out in enumerate(o_ir):
            paths = [(i, j) for i, gx in enumerate(x_ir) for j, gy in enumerate(y_ir)
                     if g_out.ir in gx.ir * gy.ir]
            use_bias = f"b_{k_out}" in node
            fan_in = sum(x_ir[i].mul * y_ir[j].mul for i, j in paths) + int(use_bias)
            scale = float(np.sqrt(fan_in))
            b_grp, c_off = colmap[k_out]
            for i, j in paths:
                a_grp, r_off = rows[(i, j, g_out.ir)]
                w_name = f"w_{k_out}_{i}_{j}"
                if (a_grp, b_grp) not in weights:
                    problems.append(f"{hk_key}: no w[{a_grp},{b_grp}] for flax "
                                    f"{flax_path}/{w_name}")
                    continue
                blk = weights[(a_grp, b_grp)][r_off:r_off + x_ir[i].mul * y_ir[j].mul,
                                              c_off:c_off + g_out.mul]
                if blk.shape != node[w_name].shape:
                    problems.append(f"{hk_key}: slice for {flax_path}/{w_name} has shape "
                                    f"{blk.shape}, flax expects {node[w_name].shape}")
                    continue
                s = signs.get((x_ir[i].ir.l, y_ir[j].ir.l, g_out.ir.l), 1.0)
                node[w_name] = (blk * (scale * s)).astype(np.float32)
            if use_bias:
                if b_grp not in biases:
                    problems.append(f"{hk_key}: no b[{b_grp}] for flax {flax_path}/b_{k_out}")
                    continue
                # the bias adds after the 1/sqrt(fan_in) scale; e3nn's bias
                # instruction has path weight 1 under "element": unscaled
                node[f"b_{k_out}"] = biases[b_grp][c_off:c_off + g_out.mul].astype(np.float32)
    # both ways: a Haiku module that no site consumed means the module table
    # is wrong or incomplete
    for hk_key in hk_params:
        if hk_key not in consumed:
            problems.append(f"haiku module {hk_key!r} not consumed by the flax site map")
    if problems:
        raise ValueError(
            "haiku_segnn_to_flax: structural mismatches between the checkpoint and the "
            "encoded spec:\n  - " + "\n  - ".join(problems[:40])
            + (f"\n  ... and {len(problems) - 40} more" if len(problems) > 40 else ""))
    return out


_IMPORTERS = {
    "gns": lambda hk, cfg: haiku_gns_to_flax(hk, int(cfg["num_mp_steps"])),
    "egnn": lambda hk, cfg: haiku_egnn_to_flax(hk, int(cfg["num_mp_steps"])),
    "painn": lambda hk, cfg: haiku_painn_to_flax(hk, int(cfg["num_mp_steps"])),
    "linear": lambda hk, cfg: haiku_linear_to_flax(hk),
}


# ---------------------------------------------------------------------------
# export: the exact inverses of the importers
# ---------------------------------------------------------------------------

def _mlp_to_haiku(out: Dict, mlp: Dict, prefix: str, mlp_name: str, ln_name=None) -> None:
    """The inverse of ``_mlp_from_haiku``."""
    i = 0
    while f"Dense_{i}" in mlp:
        lin = mlp[f"Dense_{i}"]
        out[f"{prefix}/{mlp_name}/~/linear_{i}"] = {"w": np.asarray(lin["kernel"]),
                                                     "b": np.asarray(lin["bias"])}
        i += 1
    if i == 0:
        raise ValueError(f"no Dense layers in the MLP for {prefix}/{mlp_name}")
    if ln_name is not None:
        ln = mlp["LayerNorm_0"]
        out[f"{prefix}/{ln_name}"] = {"scale": np.asarray(ln["scale"]),
                                      "offset": np.asarray(ln["bias"])}


def flax_gns_to_haiku(params: Dict, num_mp_steps: int) -> Dict:
    """The inverse of :func:`haiku_gns_to_flax`: the three projections of
    each edge update fused back into one (3L, L) weight over
    concat([h_s, h_r, e])."""
    g = "gns"
    enc, proc, dec = f"{g}/~_encoder", f"{g}/~_processor", f"{g}/~_decoder"
    out: Dict = {f"{g}/~/embed": {"embeddings": np.asarray(params["Embed_0"]["embedding"])}}
    _mlp_to_haiku(out, params["MLP_0"], enc, "MLP", "layer_norm")
    _mlp_to_haiku(out, params["MLP_1"], enc, "MLP_1", "layer_norm_1")
    for i in range(num_mp_steps):
        sfx = "" if i == 0 else f"_{2 * i}"
        w = np.concatenate([np.asarray(params[f"Dense_{3 * i + j}"]["kernel"])
                            for j in range(3)], axis=0)
        b = np.asarray(params[f"Dense_{3 * i + 2}"]["bias"])
        out[f"{proc}/MLP{sfx}/~/linear_0"] = {"w": w, "b": b}
        msg = params[f"MLP_{2 + 2 * i}"]
        j = 0
        while f"Dense_{j}" in msg:
            lin = msg[f"Dense_{j}"]
            out[f"{proc}/MLP{sfx}/~/linear_{j + 1}"] = {"w": np.asarray(lin["kernel"]),
                                                         "b": np.asarray(lin["bias"])}
            j += 1
        ln = msg["LayerNorm_0"]
        out[f"{proc}/layer_norm{sfx}"] = {"scale": np.asarray(ln["scale"]),
                                          "offset": np.asarray(ln["bias"])}
        _mlp_to_haiku(out, params[f"MLP_{3 + 2 * i}"], proc, f"MLP_{2 * i + 1}",
                      f"layer_norm_{2 * i + 1}")
    _mlp_to_haiku(out, params[f"MLP_{2 + 2 * num_mp_steps}"], dec, "MLP")
    return out


def _lin_to_haiku(dense: Dict) -> Dict:
    out = {"w": np.asarray(dense["kernel"])}
    if "bias" in dense:
        out["b"] = np.asarray(dense["bias"])
    return out


def _xav_mlp_to_haiku(out: Dict, mlp: Dict, prefix: str) -> None:
    i = 0
    while f"Dense_{i}" in mlp:
        out[f"{prefix}/~/linear_{i}"] = _lin_to_haiku(mlp[f"Dense_{i}"])
        i += 1
    if i == 0:
        raise ValueError(f"no Dense layers for {prefix}")


def flax_egnn_to_haiku(params: Dict, num_mp_steps: int) -> Dict:
    """The inverse of :func:`haiku_egnn_to_flax`."""
    out: Dict = {"egnn/scalar_emb": _lin_to_haiku(params["Dense_0"])}
    for k in range(num_mp_steps):
        lyr_p, lyr = params[f"EGNNLayer_{k}"], f"egnn/layer_{k}"
        _xav_mlp_to_haiku(out, lyr_p["MLPXav_0"], f"{lyr}/~/mlp")
        _xav_mlp_to_haiku(out, lyr_p["MLPXav_1"], f"{lyr}/~/mlp_1")
        for j, name in enumerate(("linear", "linear_1", "linear_2", "linear_3")):
            out[f"{lyr}/~/{name}"] = _lin_to_haiku(lyr_p[f"Dense_{j}"])
    return out


def flax_painn_to_haiku(params: Dict, num_mp_steps: int, shared_filters: bool = False) -> Dict:
    """The inverse of :func:`haiku_painn_to_flax`: the per-layer filter
    kernels concatenated by columns into the reference's one (n_rbf,
    L x 3H) ``filter_net``."""
    rbf = params["GaussianRBF_0"]
    out: Dict = {
        "~": {"widths": np.asarray(rbf["widths"]), "offset": np.asarray(rbf["offset"])},
        "painn/~/scalar_embedding": _lin_to_haiku(params["LinearXav_0"]["Dense_0"]),
        "painn/~/vector_embedding": _lin_to_haiku(params["LinearXav_1"]["Dense_0"]),
    }
    if shared_filters:
        out["painn/~/filter_net"] = _lin_to_haiku(params["filter_net"]["Dense_0"])
    else:
        lins = [params[f"filter_net_{i}"]["Dense_0"] for i in range(num_mp_steps)]
        out["painn/~/filter_net"] = {
            "w": np.concatenate([np.asarray(lin["kernel"]) for lin in lins], axis=1),
            "b": np.concatenate([np.asarray(lin["bias"]) for lin in lins])}
    names = ("linear", "linear_1", "vector_mixing_block", "linear_2", "linear_3")
    for i in range(num_mp_steps):
        lyr_p = params[f"PaiNNLayer_{i}"]
        for j, name in enumerate(names):
            out[f"painn/~/layer_{i}/~/{name}"] = _lin_to_haiku(lyr_p[f"LinearXav_{j}"]["Dense_0"])
    for j, blk in enumerate(["readout_block_0", "readout_block_out"]):
        blk_p, pre = params[f"GatedEquivariantBlock_{j}"], f"painn/{blk}"
        out[f"{pre}/~/vector_mix_net"] = _lin_to_haiku(blk_p["LinearXav_0"]["Dense_0"])
        out[f"{pre}/~/linear"] = _lin_to_haiku(blk_p["LinearXav_1"]["Dense_0"])
        out[f"{pre}/~/linear_1"] = _lin_to_haiku(blk_p["LinearXav_2"]["Dense_0"])
    return out


def flax_linear_to_haiku(params: Dict) -> Dict:
    """The inverse of :func:`haiku_linear_to_flax` (the reference's one
    hk.Linear, made in the "linear" module's __init__)."""
    return {"linear/~/linear": _lin_to_haiku(params["Dense_0"])}


_EXPORTERS = {
    "gns": lambda p, cfg: flax_gns_to_haiku(p, int(cfg["num_mp_steps"])),
    "egnn": lambda p, cfg: flax_egnn_to_haiku(p, int(cfg["num_mp_steps"])),
    "painn": lambda p, cfg: flax_painn_to_haiku(p, int(cfg["num_mp_steps"])),
    "linear": lambda p, cfg: flax_linear_to_haiku(p),
}


def _save_pytree_reference(ckp_dir: str, tree, name: str) -> None:
    """One tree in the reference's layout (reference utils.py:50-58): the
    leaf stream in JAX's flatten order and the pickled skeleton."""
    with open(os.path.join(ckp_dir, f"{name}_array.npy"), "wb") as f:
        for _, x in _flatten(tree):
            np.save(f, np.asarray(x), allow_pickle=False)
    with open(os.path.join(ckp_dir, f"{name}_tree.pkl"), "wb") as f:
        pickle.dump(_map(lambda x: 0, tree), f)


def save_reference_checkpoint(ckp_dir: str, model_name: str, params: Dict, cfg_model: Dict,
                              step: int = 0, loss: float = 0.0, verbose: bool = True) -> None:
    """A JAX-layout tree of GNS, EGNN, PaiNN or Linear (fused GNS and PaiNN
    trees are laid out standard first, exact inverses) as a reference
    ``save_haiku`` directory: ``params_{array.npy,tree.pkl}``, an empty
    Haiku state, a pickled empty ``opt_state.pkl`` (the reference's
    ``load_haiku`` unpickles it; its ``infer`` does not use it) and
    ``metadata_ckp.json``, everything the reference's ``infer(...,
    load_ckp=ckp_dir)`` reads (reference utils.py:100-128,
    evaluate/rollout.py:311-399)."""
    model_name = model_name.lower()
    if model_name not in _EXPORTERS:
        raise NotImplementedError(f"haiku checkpoint export not implemented for '{model_name}' "
                         f"(available: {sorted(_EXPORTERS)})")
    mp_steps = int(cfg_model.get("num_mp_steps", 0) or 0)
    if model_name == "gns" and any(str(k).startswith("mp0_") for k in params):
        from .models.gns import standard_params_from_fused

        params = standard_params_from_fused(params, mp_steps)
    if model_name == "painn" and "filt_w" in params.get("PaiNNLayer_0", {}):
        from .models.painn import painn_standard_params_from_fused

        params = painn_standard_params_from_fused(params, mp_steps)
    os.makedirs(ckp_dir, exist_ok=True)
    _save_pytree_reference(ckp_dir, _EXPORTERS[model_name](params, cfg_model), "params")
    _save_pytree_reference(ckp_dir, {}, "state")
    with open(os.path.join(ckp_dir, "opt_state.pkl"), "wb") as f:
        pickle.dump((), f)
    with open(os.path.join(ckp_dir, "metadata_ckp.json"), "w") as f:
        json.dump({"step": int(step), "loss": float(loss)}, f)
    if verbose:
        print(f"Exported reference-layout checkpoint to {ckp_dir}")


def load_reference_checkpoint(model_dir: str, model_name: str, cfg_model: Dict,
                              verbose: bool = True) -> Tuple[Dict, Dict, int]:
    """A reference ``save_haiku`` checkpoint of GNS, EGNN, PaiNN or Linear
    as (JAX-layout parameters, state, step); the reference's models keep no
    Haiku state. SEGNN goes through :func:`haiku_segnn_to_flax` by hand."""
    model_name = model_name.lower()
    if model_name not in _IMPORTERS:
        raise NotImplementedError(f"haiku checkpoint import not implemented for '{model_name}' "
                         f"(available: {sorted(_IMPORTERS)})")
    params = _IMPORTERS[model_name](load_haiku_pytree(model_dir, "params"), cfg_model)
    step = 0
    meta_path = os.path.join(model_dir, "metadata_ckp.json")
    if os.path.exists(meta_path):
        with open(meta_path) as f:
            step = json.load(f).get("step", 0)
    if verbose:
        print(f"Imported reference haiku checkpoint from {model_dir} (step {step})")
    return params, {}, step
