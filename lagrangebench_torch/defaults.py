"""Default configuration tree and validation.

The key layout and values are the JAX package's, so the same YAML presets
resolve to the same tree, with one difference: the neighbor backend
defaults to ``auto``, the port's kernel backend for the dense and slot
formats (the JAX package's default, ``celllist``, is its portable search).
``resolve_backend`` maps a configured backend and format to the port's
search: ``"cuda"`` (the hand-written CUDA kernels on CUDA tensors, their
plain PyTorch versions on CPU tensors), ``"celllist"`` or ``"allpairs"``
(the JAX package's searches in PyTorch ops).
"""

from __future__ import annotations

from .config import Config

#: reference backend names, accepted as aliases of the cell list
BACKEND_ALIASES = {
    "jaxmd_vmap": "celllist",
    "jaxmd_scan": "celllist",
    "matscipy": "celllist",
}

VALID_BACKENDS = ("allpairs", "celllist", "pallas", "auto", "cuda")


def set_defaults() -> Config:
    """Build the default config tree."""
    cfg = Config()

    cfg.config = None
    cfg.load_ckp = None
    cfg.mode = "all"  # train | infer | all
    cfg.seed = 0
    cfg.dtype = "float32"  # preprocessing dtype ("float32" | "float64")
    cfg.gpu = None
    cfg.xla_mem_fraction = None

    cfg.dataset = Config()
    cfg.dataset.src = None
    cfg.dataset.name = None

    cfg.model = Config()
    cfg.model.name = None  # gns | segnn | egnn | painn | linear
    cfg.model.input_seq_length = 6
    cfg.model.num_mp_steps = 10
    cfg.model.num_mlp_layers = 2
    cfg.model.latent_dim = 128
    cfg.model.magnitude_features = False
    cfg.model.isotropic_norm = False
    cfg.model.compute_dtype = "float32"
    # GNS: one fused kernel per message-passing step (dense edge layout,
    # num_mlp_layers=2)
    cfg.model.fused_processor = False
    cfg.model.lmax_attributes = 1
    cfg.model.lmax_hidden = 1
    cfg.model.segnn_norm = "none"
    cfg.model.velocity_aggregate = "avg"

    cfg.train = Config()
    cfg.train.batch_size = 1
    cfg.train.step_max = 500_000
    cfg.train.num_workers = 2
    cfg.train.noise_std = 3.0e-4
    cfg.train.overflow_sync_every = 1
    cfg.train.optimizer = Config()
    cfg.train.optimizer.lr_start = 1.0e-4
    cfg.train.optimizer.lr_final = 1.0e-6
    cfg.train.optimizer.lr_decay_rate = 0.1
    cfg.train.optimizer.lr_decay_steps = 1.0e5
    cfg.train.pushforward = Config()
    cfg.train.pushforward.steps = [-1, 20000, 300000, 400000]
    cfg.train.pushforward.unrolls = [0, 1, 2, 3]
    cfg.train.pushforward.probs = [18, 2, 1, 1]
    cfg.train.loss_weight = Config()
    cfg.train.loss_weight.acc = 1.0
    cfg.train.loss_weight.vel = 0.0
    cfg.train.loss_weight.pos = 0.0

    cfg.eval = Config()
    cfg.eval.n_rollout_steps = 20  # -1 = full trajectory
    cfg.eval.test = False
    cfg.eval.rollout_dir = None
    cfg.eval.train = Config()
    cfg.eval.train.n_trajs = 50
    cfg.eval.train.metrics_stride = 10
    cfg.eval.train.batch_size = 1
    cfg.eval.train.metrics = ["mse"]
    cfg.eval.train.out_type = "none"
    cfg.eval.infer = Config()
    cfg.eval.infer.n_trajs = -1
    cfg.eval.infer.metrics_stride = 1
    cfg.eval.infer.batch_size = 2
    cfg.eval.infer.metrics = ["mse", "e_kin", "sinkhorn"]
    cfg.eval.infer.out_type = "pkl"
    cfg.eval.infer.n_extrap_steps = 0

    cfg.logging = Config()
    cfg.logging.log_steps = 1000
    cfg.logging.eval_steps = 10000
    cfg.logging.wandb = False
    cfg.logging.wandb_project = None
    cfg.logging.wandb_entity = "lagrangebench"
    cfg.logging.ckp_dir = "ckp"
    cfg.logging.run_name = None
    cfg.logging.profile_dir = None
    cfg.logging.profile_steps = [10, 15]

    cfg.neighbors = Config()
    cfg.neighbors.backend = "auto"
    cfg.neighbors.multiplier = 1.25
    cfg.neighbors.format = "dense"
    cfg.neighbors.emit_geometry = False

    cfg.parallel = Config()
    cfg.parallel.data = -1
    cfg.parallel.spatial = 0

    return cfg


defaults = set_defaults()


def resolve_backend(backend: str, format: str = "dense") -> str:
    """Map a configured neighbor backend and format to the port's search.

    ``auto``, ``pallas`` and ``cuda`` mean the kernel backend, ``"cuda"``,
    for the dense and slot formats; for the sparse format ``auto`` means
    ``"celllist"`` (the JAX package's ``auto`` off the TPU), and an explicit
    ``pallas`` or ``cuda`` raises ValueError (the kernels are
    dense/slot-only). ``celllist``, ``allpairs`` and the reference's names
    (``BACKEND_ALIASES``) mean the cell list or the all-pairs search.
    """
    if backend in ("auto", "pallas", "cuda"):
        if format != "sparse":
            return "cuda"
        if backend == "auto":
            return "celllist"
        raise ValueError(f"neighbors.backend={backend!r} is dense/slot-only (the neighbor "
                         "kernels); use auto, celllist or allpairs with the sparse format")
    name = BACKEND_ALIASES.get(backend, backend)
    if name in ("celllist", "allpairs"):
        return name
    raise ValueError(
        f"Unknown neighbors backend {backend!r}; valid: {VALID_BACKENDS} "
        f"(aliases: {sorted(BACKEND_ALIASES)})"
    )


def check_cfg(cfg: Config) -> None:
    """Semantic validation of a resolved config tree."""

    def need(cond: bool, msg: str) -> None:
        if not cond:
            raise ValueError(msg)

    need(cfg.mode in ["train", "infer", "all"], f"bad mode {cfg.mode!r}")
    need(cfg.dtype in ["float32", "float64"], f"bad dtype {cfg.dtype!r}")
    need(cfg.dataset.src is not None, "dataset.src must be specified.")
    need(cfg.model.input_seq_length >= 2, "At least two positions for one past vel.")
    need(int(cfg.train.get("overflow_sync_every", 1)) >= 1, "overflow_sync_every >= 1")

    pf = cfg.train.pushforward
    need(len(pf.steps) == len(pf.unrolls) == len(pf.probs), "pushforward lengths differ")
    need(all(s >= 0 for s in pf.unrolls), "All unrolls must be non-negative.")
    need(all(s >= 0 for s in pf.probs), "All probabilities must be non-negative.")
    lwv = list(cfg.train.loss_weight.values())
    need(all(w >= 0 for w in lwv), "All loss weights must be non-negative.")
    need(sum(lwv) > 0, "At least one loss weight must be non-zero.")

    metrics = ["mse", "mae", "e_kin", "sinkhorn"]
    need(cfg.eval.train.n_trajs >= -1, "eval.train.n_trajs >= -1")
    need(cfg.eval.infer.n_trajs >= -1, "eval.infer.n_trajs >= -1")
    need(set(cfg.eval.train.metrics).issubset(metrics), "unknown eval.train metric")
    need(set(cfg.eval.infer.metrics).issubset(metrics), "unknown eval.infer metric")
    need(cfg.eval.train.out_type in ["none", "vtk", "pkl"], "bad eval.train.out_type")
    need(cfg.eval.infer.out_type in ["none", "vtk", "pkl"], "bad eval.infer.out_type")

    backend = BACKEND_ALIASES.get(cfg.neighbors.backend, cfg.neighbors.backend)
    need(backend in VALID_BACKENDS, f"Unknown neighbors backend {backend!r}")
    need(cfg.neighbors.format in ["sparse", "dense", "slot"], "bad neighbors.format")
