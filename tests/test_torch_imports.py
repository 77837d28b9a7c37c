"""The port stands alone: no JAX-side imports, and CUDA unless asked.

``lagrangebench_torch/`` and ``chip_smoke.py`` import no jax, flax, optax,
haiku or lagrangebench_tpu module (an AST scan of every file). Without CUDA
the entry points raise unless the caller passes ``device="cpu"``.
"""

import ast
import os

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "haiku", "lagrangebench_tpu")


def _port_files():
    files = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, names in os.walk(os.path.join(REPO, "lagrangebench_torch")):
        files += [os.path.join(root, n) for n in names if n.endswith(".py")]
    return sorted(files)


@pytest.mark.parametrize("path", _port_files(), ids=lambda p: os.path.relpath(p, REPO))
def test_no_jax_imports(path):
    with open(path) as f:
        tree = ast.parse(f.read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            mods = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            mods = [node.module or ""]
        else:
            continue
        for mod in mods:
            assert mod.split(".")[0] not in FORBIDDEN, f"{path} imports {mod}"


def test_yaml_and_h5py_are_imported_lazily():
    """chip_smoke's path needs neither: no module imports them at top level."""
    for path in _port_files():
        with open(path) as f:
            tree = ast.parse(f.read())
        for node in tree.body:
            if isinstance(node, (ast.Import, ast.ImportFrom)):
                names = [a.name for a in node.names] if isinstance(node, ast.Import) \
                    else [node.module or ""]
                assert not {"yaml", "h5py"} & {n.split(".")[0] for n in names}, path


@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def _metadata():
    return {
        "dim": 3, "num_particles_max": 27, "periodic_boundary_conditions": [True] * 3,
        "bounds": [[0.0, 1.0]] * 3, "default_connectivity_radius": 0.3,
        "vel_mean": [0.0] * 3, "vel_std": [1e-3] * 3,
        "acc_mean": [0.0] * 3, "acc_std": [1e-4] * 3, "dt": 0.01, "write_every": 1,
        "dx": 0.33,
    }


def test_entry_points_need_cuda_unless_asked(no_cuda):
    from lagrangebench_torch.case import case_builder
    from lagrangebench_torch.data import ArrayDataset
    from lagrangebench_torch.evaluate import infer
    from lagrangebench_torch.models import GNS, PaiNN
    from lagrangebench_torch.utils import resolve_device

    meta = _metadata()
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device()
    with pytest.raises(RuntimeError, match="CUDA"):
        case_builder([1.0] * 3, meta, 3)
    with pytest.raises(RuntimeError, match="CUDA"):
        GNS(3, node_in=6, edge_in=4, latent_size=16, num_mp_steps=1)
    with pytest.raises(RuntimeError, match="CUDA"):
        PaiNN(16, 1, 5, 0.45, 2)

    case = case_builder([1.0] * 3, meta, 3, device="cpu")
    model = GNS(3, node_in=6, edge_in=4, latent_size=16, num_mp_steps=1, device="cpu")
    rng = np.random.default_rng(0)
    traj = rng.uniform(0, 1, size=(5, 27, 3))
    data = ArrayDataset("test", [traj], [np.zeros(27, np.int64)], meta,
                        input_seq_length=3, extra_seq_length=2)
    cfg = {"batch_size": 1, "metrics": ["mse"], "out_type": "none"}
    with pytest.raises(RuntimeError, match="CUDA"):
        infer(model, case, data, cfg_eval_infer=cfg, n_rollout_steps=2)
    metrics = infer(model, case, data, cfg_eval_infer=cfg, n_rollout_steps=2, device="cpu")
    assert metrics["rollout_0"]["mse"].shape == (2,)
    assert np.isfinite(metrics["rollout_0"]["mse"]).all()


def test_cpu_tensors_take_the_plain_versions_without_counting():
    """The wrappers count launches only where a kernel launches."""
    from lagrangebench_torch.ops import fused_mp, neighbors_cuda
    from lagrangebench_torch.ops.neighbors import ColumnGrid

    before = (neighbors_cuda.COLUMN_TABLE.launches, fused_mp.FUSED_MP.launches)
    grid = ColumnGrid((2,), (0.5,), 2, (True, True))
    pos = torch.tensor([[[0.1, 0.0], [0.6, 0.0], [0.7, 0.0], [0.2, 0.0]]])  # columns 0, 1, 1
    slots, idx_f, _, ovf = neighbors_cuda.column_table(pos, torch.tensor([3]), grid, 4)
    assert slots.tolist() == [0, 4, 5, 8] and not ovf
    assert idx_f.tolist() == [[0, 4, 4, 4], [1, 2, 4, 4], [4, 4, 4, 4]]
    assert (neighbors_cuda.COLUMN_TABLE.launches, fused_mp.FUSED_MP.launches) == before


def test_trainer_needs_cuda_unless_asked(no_cuda):
    from lagrangebench_torch.case import case_builder
    from lagrangebench_torch.data import ArrayDataset
    from lagrangebench_torch.models import GNS
    from lagrangebench_torch.train import Trainer

    meta = _metadata()
    traj = np.random.default_rng(0).uniform(0, 1, size=(8, 27, 3))
    train = ArrayDataset("train", [traj], [np.zeros(27, np.int64)], meta,
                         input_seq_length=3, extra_seq_length=1)
    valid = ArrayDataset("valid", [traj], [np.zeros(27, np.int64)], meta,
                         input_seq_length=3, extra_seq_length=2)
    case = case_builder([1.0] * 3, meta, 3, device="cpu")
    model = GNS(3, node_in=6, edge_in=4, latent_size=16, num_mp_steps=1, device="cpu")
    cfg = dict(cfg_train={"batch_size": 1}, cfg_eval={"n_rollout_steps": 2,
               "train": {"n_trajs": 1}}, input_seq_length=3)
    with pytest.raises(RuntimeError, match="CUDA"):
        Trainer(model, case, train, valid, **cfg)
    trainer = Trainer(model, case, train, valid, device="cpu", **cfg)
    _, _, opt = trainer.train(step_max=1)
    assert opt.count == 2
