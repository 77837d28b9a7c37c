"""Training loop.

Counterpart of ``lagrangebench_tpu/train/trainer.py``, on one device or
data-parallel over the ranks of a ``parallel.Mesh``:

* one step = the batched train preprocess (noise, neighbor update,
  features, targets), optional pushforward unrolls without gradient, the
  masked MSE summed over the batch, its backward (the fused processor's
  backward runs K4), and AdamW (``weight_decay=1e-8``) on an exponential
  learning-rate decay clamped at ``lr_final``, evaluated at the step count
  before it increments (``optax.adamw(optax.exponential_decay(...))``);
* every step commits its update on the device only where no neighbor
  buffer overflowed (``AdamW.step(skip=...)``), and the flag is sticky, so
  every step after an overflow is a no-op until the flag is read. The host
  reads it every ``train.overflow_sync_every`` steps (every step by
  default; also at log and eval steps and on a retry): a read that finds an
  overflow restores the step count and the noise generator of the first
  skipped step (the JAX trainer keeps its old keys), reallocates the
  buffers from the first overflowing sample with a capacity boost of x1.5
  and retries the current batch, at most 5 times. The batches in between
  are skipped, never half-applied. Deferring the read saves no time here:
  the loop synchronizes every step for its ``StepTimer``;
* every ``eval_steps`` an in-training rollout (neighbors sized from a
  validation sample; a rollout whose neighbor buffers keep overflowing
  records ``val/loss=inf``), then a checkpoint with the optimizer state;
* ``logging.profile_dir`` writes a torch.profiler trace of the steps
  ``logging.profile_steps`` (``profiling.ProfilerHook``).

Noise is drawn on the host from a seeded ``torch.Generator`` for the whole
batch and copied to the device, so a run on the card and one on the CPU see
the same noise.

Data parallelism (``mesh``): a run on n ranks is the run on one rank up to
the order of the sums. Every rank loads the same global batch from the same
seeded shuffle, draws the noise and the pushforward's unroll count for the
global batch (the generators advance alike on every rank) and takes its own
rows; the loss sum, the overflow flag and the gradients of every parameter
are summed over the ranks in one all-reduce of one flat buffer; every rank
then runs the same AdamW on the same sums, from parameters broadcast from
rank 0 at the start. A retry after an overflow assembles the global
per-sample flags (one all-reduce of a (B,) vector), so that every rank
reallocates from the same first overflowing sample. The port's models
carry no state besides their parameters, so there is no state to average.
Only rank 0 writes checkpoints, logs and wandb.
"""

from __future__ import annotations

import functools
import os
from typing import Callable, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from ..checkpoint import OptStateLeaves, load_checkpoint, save_checkpoint
from ..config import Config, merge
from ..data import DataLoader
from ..defaults import defaults
from ..evaluate import MetricsComputer, RolloutOverflowError, averaged_metrics, eval_rollout
from ..parallel import Mesh, all_reduce_sum_, broadcast_tensors_, is_main, shard_batch
from ..profiling import ProfilerHook, StepTimer
from ..utils import get_kinematic_mask, resolve_device
from .strats import push_forward_batched_build, push_forward_sample_steps


def _weighted_sq_error(pred, target, loss_weight) -> torch.Tensor:
    total = 0.0
    for key in pred:
        w = loss_weight[key] if isinstance(loss_weight, dict) else getattr(loss_weight, key)
        if w == 0.0:
            continue
        total = total + (w * (pred[key] - target[key]) ** 2).sum(dim=-1)
    return total


def mse_loss(model, features, particle_type, target, loss_weight) -> torch.Tensor:
    """Weighted MSE over the model's output channels, kinematic-masked."""
    pred = model(features, particle_type)
    non_kinematic = ~get_kinematic_mask(particle_type)
    total = _weighted_sq_error(pred, target, loss_weight)
    total = torch.where(non_kinematic, total, torch.zeros_like(total))
    return total.sum() / non_kinematic.sum()


def flat_mse_loss(model, flat_features, flat_ptype, flat_target, node_weight,
                  loss_weight) -> torch.Tensor:
    """Sum of per-sample masked MSE losses on the flattened super-graph.

    ``node_weight`` carries the per-sample ``1 / num_non_kinematic`` (zero
    on kinematic and padding nodes), so the result equals
    ``sum_b mse_loss(sample_b)`` and its gradient the sum of the
    per-sample gradients.
    """
    pred = model(flat_features, flat_ptype)
    return (_weighted_sq_error(pred, flat_target, loss_weight) * node_weight).sum()


def exponential_decay(init_value: float, transition_steps: float, decay_rate: float,
                      end_value: Optional[float] = None) -> Callable[[int], float]:
    """``optax.exponential_decay`` (continuous, from step 0): the learning
    rate at a step count, clamped at ``end_value``."""

    def schedule(count: int) -> float:
        if transition_steps <= 0 or decay_rate == 0 or count <= 0:
            return float(init_value)
        value = init_value * decay_rate ** (count / transition_steps)
        if end_value is not None:
            value = max(value, end_value) if decay_rate < 1.0 else min(value, end_value)
        return float(value)

    return schedule


class AdamW:
    """``optax.adamw(schedule, weight_decay)`` on a list of parameters.

    Per step, with t the step count after it increments and g a gradient
    (zero where a parameter got none):
    ``mu = b1 mu + (1-b1) g``, ``nu = b2 nu + (1-b2) g^2``,
    ``u = mu/(1-b1^t) / (sqrt(nu/(1-b2^t)) + eps) + weight_decay * p``,
    ``p -= schedule(t - 1) * u``. Moments are kept in the parameters' dtype.

    Args:
        leaves: (name, parameter, transposed) in the JAX leaf order of the
            parameter tree (``GNS.jax_leaves``); ``transposed`` marks
            parameters stored transposed against the JAX layout.
    """

    def __init__(self, leaves: Sequence[Tuple[str, torch.nn.Parameter, bool]],
                 schedule: Callable[[int], float], weight_decay: float = 1e-8,
                 b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8):
        self.names = [name for name, _, _ in leaves]
        self.params = [p for _, p, _ in leaves]
        self.transposed = [t for _, _, t in leaves]
        self.schedule = schedule
        self.weight_decay = weight_decay
        self.b1, self.b2, self.eps = b1, b2, eps
        self.count = 0
        self.mu = [torch.zeros_like(p) for p in self.params]
        self.nu = [torch.zeros_like(p) for p in self.params]

    def zero_grad(self) -> None:
        for p in self.params:
            p.grad = None

    @torch.no_grad()
    def step(self, skip: Optional[torch.Tensor] = None) -> None:
        """One update. With ``skip``, a boolean scalar tensor that is not
        read on the host, parameters and moments keep their values where it
        is set; the count advances either way (the caller that reads the
        flag later sets it back)."""
        grads = [p.grad if p.grad is not None else torch.zeros_like(p) for p in self.params]
        lr = self.schedule(self.count)
        self.count += 1
        mu = torch._foreach_mul(self.mu, self.b1)
        torch._foreach_add_(mu, grads, alpha=1.0 - self.b1)
        nu = torch._foreach_mul(self.nu, self.b2)
        torch._foreach_addcmul_(nu, grads, grads, value=1.0 - self.b2)
        new = torch._foreach_add(self.params, self._update(mu, nu), alpha=-lr)
        for dst, src in ((self.mu, mu), (self.nu, nu), (self.params, new)):
            for t, x in zip(dst, src):
                t.copy_(x if skip is None else torch.where(skip, t, x))

    def _update(self, mu, nu):
        """The bias-corrected Adam direction plus weight decay, per leaf."""
        denom = torch._foreach_div(nu, 1.0 - self.b2**self.count)
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, self.eps)
        upd = torch._foreach_div(mu, 1.0 - self.b1**self.count)
        torch._foreach_div_(upd, denom)
        torch._foreach_add_(upd, self.params, alpha=self.weight_decay)
        return upd

    def state_leaves(self) -> List[np.ndarray]:
        """The state as the JAX ``optax.adamw`` leaves: adam count, mu
        leaves, nu leaves, schedule count (moments in the JAX layout)."""

        def host(t, transposed):
            t = t.detach().cpu()
            return (t.t() if transposed else t).contiguous().numpy()

        count = np.asarray(self.count, dtype=np.int32)
        return ([count] + [host(m, tr) for m, tr in zip(self.mu, self.transposed)]
                + [host(v, tr) for v, tr in zip(self.nu, self.transposed)] + [count.copy()])

    def load_state_leaves(self, leaves: Sequence[np.ndarray]) -> None:
        """Restore from :meth:`state_leaves` (or a JAX checkpoint's leaves)."""
        leaves = list(leaves.leaves if isinstance(leaves, OptStateLeaves) else leaves)
        n = len(self.params)
        if len(leaves) != 2 * n + 2:
            raise ValueError(f"optimizer state has {len(leaves)} leaves, expected {2 * n + 2}"
                             " (optimizer or parameter layout changed?)")
        if int(leaves[0]) != int(leaves[-1]):
            raise ValueError("adam and schedule step counts differ")
        with torch.no_grad():
            for dst, src in ((self.mu, leaves[1:n + 1]), (self.nu, leaves[n + 1:2 * n + 1])):
                for i, (t, arr) in enumerate(zip(dst, src)):
                    a = torch.as_tensor(np.asarray(arr))
                    a = a.t() if self.transposed[i] else a
                    if tuple(a.shape) != tuple(t.shape):
                        raise ValueError(f"optimizer leaf {self.names[i]}: shape "
                                         f"{tuple(a.shape)}, expected {tuple(t.shape)}")
                    t.copy_(a)
        self.count = int(leaves[0])


class Trainer:
    """Trainer over (model, case, datasets).

    Args:
        model: the model module (``models.GNS``), on ``device``.
        case: a ``case_builder`` case on ``device``.
        data_train / data_valid: ``H5Dataset`` or ``ArrayDataset`` splits.
        cfg_train / cfg_eval / cfg_logging: config subsets (merged with the
            defaults).
        input_seq_length: the model's input window.
        seed: seeds the noise generator, the data shuffle and the
            pushforward draws.
        device: "cuda" (default) or "cpu"; raises without CUDA unless "cpu".
        mesh: a ``parallel.Mesh`` to train data-parallel over its ranks
            (``train.batch_size`` must divide by its size); None (or a mesh
            of one) trains on this process alone.
    """

    def __init__(
        self,
        model,
        case,
        data_train,
        data_valid,
        cfg_train: Union[Dict, Config, None] = None,
        cfg_eval: Union[Dict, Config, None] = None,
        cfg_logging: Union[Dict, Config, None] = None,
        input_seq_length: int = defaults.model.input_seq_length,
        seed: int = defaults.seed,
        device="cuda",
        mesh: Optional[Mesh] = None,
    ):
        device = resolve_device(device)
        if case.device != device:
            raise ValueError(f"case lives on {case.device}, training asked for {device}")
        self.device = device
        self.model = model
        self.case = case
        self.input_seq_length = input_seq_length
        self.cfg_train = merge(defaults.train, cfg_train or {})
        self.cfg_eval = merge(defaults.eval, cfg_eval or {})
        self.cfg_logging = merge(defaults.logging, cfg_logging or {})
        if mesh is not None and not mesh.member:
            raise ValueError("this rank is not a member of the mesh")
        self.mesh = mesh if mesh is not None and mesh.size > 1 else None

        available = data_valid.subseq_length - input_seq_length
        if self.cfg_eval.n_rollout_steps > available:
            raise ValueError("eval.n_rollout_steps exceeds the available ground-truth "
                             f"horizon ({self.cfg_eval.n_rollout_steps} > {available})")
        if self.cfg_eval.train.n_trajs > data_valid.num_samples:
            raise ValueError("eval.train.n_trajs exceeds available trajectories "
                             f"({self.cfg_eval.train.n_trajs} > {data_valid.num_samples})")
        if self.cfg_eval.train.n_trajs == -1:
            self.cfg_eval.train.n_trajs = data_valid.num_samples
        self.data_train = data_train
        self.data_valid = data_valid

        self.rng = np.random.default_rng(seed)
        self.generator = torch.Generator().manual_seed(seed)
        self.batch_size = int(self.cfg_train.batch_size)
        if self.mesh is not None and self.batch_size % self.mesh.size != 0:
            raise ValueError(f"train.batch_size ({self.batch_size}) must be divisible by "
                             f"the mesh size ({self.mesh.size})")
        self.local_batch_size = self.batch_size // (self.mesh.size if self.mesh else 1)
        self.loader_train = DataLoader(data_train, batch_size=self.batch_size, shuffle=True,
                                       drop_last=True, rng=self.rng)
        self.loader_valid = DataLoader(data_valid, batch_size=int(self.cfg_eval.train.batch_size),
                                       rng=self.rng)

        opt = self.cfg_train.optimizer
        schedule = exponential_decay(float(opt.lr_start), float(opt.lr_decay_steps),
                                     float(opt.lr_decay_rate), end_value=float(opt.lr_final))
        self.optimizer = AdamW(model.jax_leaves(), schedule, weight_decay=1e-8)
        self.metrics_computer = MetricsComputer(
            list(self.cfg_eval.train.metrics),
            dist_fn=case.displacement,
            metadata=data_train.metadata,
            input_seq_length=input_seq_length,
            stride=int(self.cfg_eval.train.metrics_stride),
        )
        self.loss_weight = self.cfg_train.loss_weight.to_dict()
        self.push_forward = push_forward_batched_build(model, case)
        self.timer = StepTimer()
        self._eval_neighbors = None

    def _batch(self, raw):
        """This rank's rows of a host batch, on the device."""
        return tuple(torch.as_tensor(x, device=self.device) for x in shard_batch(raw, self.mesh))

    def _noise_draw(self, raw_batch) -> torch.Tensor:
        """The standard-normal draw of the random-walk noise for the global
        batch, from the generator, and this rank's rows of it."""
        _, n, _, dim = raw_batch[0].shape
        draw = torch.randn((self.batch_size, n, self.input_seq_length - 1, dim),
                           generator=self.generator, dtype=self.case.dtype)
        return shard_batch(draw, self.mesh)

    def _sum_over_ranks(self, loss_sum, overflow):
        """One all-reduce of the loss sum, the overflow flag and every
        gradient as one flat buffer in the parameters' (widest) dtype; the
        gradients become views of the sums. Returns the summed loss and the
        global flag."""
        params = self.optimizer.params
        grads = [p.grad if p.grad is not None else torch.zeros_like(p) for p in params]
        dtype = functools.reduce(torch.promote_types, [p.dtype for p in params])
        flat = torch.cat([loss_sum.detach().reshape(1).to(dtype),
                          overflow.reshape(1).to(dtype)] + [g.reshape(-1) for g in grads])
        all_reduce_sum_(flat, self.mesh)
        offset = 2
        for p in params:
            p.grad = flat[offset:offset + p.numel()].view_as(p).to(p.dtype)
            offset += p.numel()
        return flat[0], flat[1] > 0

    def _global_flags(self, flags: torch.Tensor) -> torch.Tensor:
        """Every rank's per-sample overflow flags, in global batch order
        (one all-reduce of a (B,) vector under a mesh)."""
        if self.mesh is None:
            return flags
        full = torch.zeros(self.batch_size, dtype=torch.int32, device=flags.device)
        start = self.mesh.rank * self.local_batch_size
        full[start:start + self.local_batch_size] = flags.to(torch.int32)
        return all_reduce_sum_(full, self.mesh) > 0

    def train_step(self, raw_batch, neighbors_batch, noise_std: float, unroll_steps: int):
        """One step on a device batch: preprocess, pushforward, loss,
        backward, and the update committed on the device only where no
        neighbor buffer overflowed; the flag is not read. Returns (loss,
        neighbors, overflow as a device bool). The step count and the noise
        generator advance either way: the caller that reads the flag sets
        them back (:meth:`_read_overflow`)."""
        isl = self.input_seq_length
        self.optimizer.zero_grad()
        features, targets, nbrs_b = self.case.preprocess_batched(
            self.generator, raw_batch, noise_std, neighbors_batch, unroll_steps,
            draw=self._noise_draw(raw_batch),
        )
        # the unrolls start from the un-noised positions, as in the JAX trainer
        current_pos = raw_batch[0][:, :, :isl]
        for _ in range(unroll_steps):
            current_pos, nbrs_b, features = self.push_forward(
                features, current_pos, raw_batch[1], nbrs_b
            )
        overflow = nbrs_b.did_buffer_overflow.any()

        ptype = raw_batch[1]
        b, n = ptype.shape
        non_kin = ~get_kinematic_mask(ptype)
        per_sample = non_kin.sum(dim=1).to(targets["acc"].dtype)
        node_weight = (non_kin / torch.clamp(per_sample, min=1)[:, None]).reshape(b * n)
        loss_sum = flat_mse_loss(self.model, features, ptype.reshape(b * n), targets,
                                 node_weight, self.loss_weight)
        loss_sum.backward()
        if self.mesh is not None:
            loss_sum, overflow = self._sum_over_ranks(loss_sum, overflow)
        self.optimizer.step(skip=overflow)
        self.optimizer.zero_grad()
        return loss_sum.detach() / self.batch_size, nbrs_b, overflow

    def train(
        self,
        step_max: Optional[int] = None,
        opt_state=None,
        store_ckp: Optional[str] = None,
        load_ckp: Optional[str] = None,
        wandb_config: Optional[Dict] = None,
    ):
        """Run steps ``step .. step_max`` (0, or the checkpoint's step);
        returns (model, state, optimizer)."""
        if step_max is None:
            step_max = int(self.cfg_train.step_max)
        cfg_eval, cfg_logging = self.cfg_eval, self.cfg_logging
        noise_std = float(self.cfg_train.noise_std)
        pushforward = self.cfg_train.pushforward

        # neighbor allocation from the first batch's first sample
        first_batch = next(iter(self.loader_train))
        _, _, neighbors = self.case.allocate(self.generator, (first_batch[0][0], first_batch[1][0]))

        step = 0
        if load_ckp:
            params, _, ckp_opt, step = load_checkpoint(load_ckp)
            self.model.load_jax_params(params)
            opt_state = opt_state if opt_state is not None else ckp_opt
        if opt_state is not None:
            self.optimizer.load_state_leaves(opt_state)
        main = is_main(self.mesh)
        if self.mesh is not None:
            broadcast_tensors_(self.optimizer.params, self.mesh)

        wandb_run = self._init_wandb(wandb_config, step) if main else None
        if store_ckp is not None and main:
            os.makedirs(os.path.join(store_ckp, "best"), exist_ok=True)

        neighbors_batch = neighbors.broadcast(self.local_batch_size)
        timer = self.timer
        profiler = ProfilerHook(cfg_logging.get("profile_dir"),
                                *list(cfg_logging.get("profile_steps", [10, 15])),
                                rank=self.mesh.rank if self.mesh else 0,
                                cuda=self.device.type == "cuda")
        particles_per_step = first_batch[0].shape[1] * self.batch_size
        sync_every = int(self.cfg_train.get("overflow_sync_every", 1))
        # steps whose overflow flag is not read yet: (flag, noise state and
        # step count before the step)
        unread: List[Tuple[torch.Tensor, torch.Tensor, int]] = []
        self.model.train()

        while step < step_max + 1:
            for raw in self.loader_train:
                raw_batch = self._batch(raw)
                unroll_steps = push_forward_sample_steps(self.rng, step, pushforward)
                profiler.maybe_start(step)
                boost, max_retries = 1.0, 5
                for attempt in range(max_retries + 1):
                    before = (self.generator.get_state(), self.optimizer.count)
                    loss, nbrs_b, flag = self.train_step(
                        raw_batch, neighbors_batch, noise_std, unroll_steps
                    )
                    unread.append((flag, *before))
                    need_read = (attempt > 0 or step % sync_every == 0
                                 or step % cfg_logging.log_steps == 0
                                 or (step % cfg_logging.eval_steps == 0 and step > 0))
                    overflowed = need_read and self._read_overflow(unread)
                    if not overflowed:
                        neighbors_batch = nbrs_b
                        break
                    if attempt == max_retries:
                        raise RuntimeError(
                            f"neighbor list still overflows after {max_retries} "
                            f"escalating reallocations at step {step}"
                        )
                    # re-allocate from the global batch's first overflowing
                    # sample (every rank alike) with an escalating boost; the
                    # allocation's own noise draw does not advance the step's
                    # noise stream
                    boost *= 1.5
                    flags = self._global_flags(nbrs_b.did_buffer_overflow)
                    ind = int(torch.argmax(flags.to(torch.int32)))
                    noise_state = self.generator.get_state()
                    _, _, nbrs = self.case.allocate(
                        self.generator, (raw[0][ind], raw[1][ind]), noise_std,
                        capacity_boost=boost,
                    )
                    self.generator.set_state(noise_state)
                    if main:
                        print(f"Reallocate neighbors list at step {step} (boost x{boost:.2f})")
                        print(f"From {tuple(nbrs_b.idx[0].shape)} to {tuple(nbrs.idx.shape)}")
                    neighbors_batch = nbrs.broadcast(self.local_batch_size)

                if self.device.type == "cuda":
                    torch.cuda.synchronize(self.device)
                timer.tick()
                profiler.maybe_stop(step)

                if step % cfg_logging.log_steps == 0 and main:
                    perf = timer.stats(particles_per_step)
                    if wandb_run is not None:
                        wandb_run.log({"train/loss": float(loss), **perf}, step)
                    else:
                        width = len(str(int(step_max)))
                        rate = perf.get("perf/ms_per_step")
                        rate_str = f" ({rate:.1f} ms/step)" if rate else ""
                        print(f"{str(step).zfill(width)}, train/loss: {float(loss):.5f}.{rate_str}")

                if step % cfg_logging.eval_steps == 0 and step > 0:
                    timer.reset_clock()  # the eval pause does not count
                    metrics = self._eval(step)
                    if store_ckp is not None and main:
                        save_checkpoint(
                            store_ckp, self.model.jax_params(), {},
                            {"step": step, "loss": metrics.get("val/loss")},
                            opt_state=self.optimizer.state_leaves(),
                        )
                    if wandb_run is not None:
                        wandb_run.log(metrics, step)
                    elif main:
                        print(metrics)

                step += 1
                if step == step_max + 1:
                    break

        if unread:
            self._read_overflow(unread)  # the count of the last unread steps
        profiler.stop()
        if wandb_run is not None:
            wandb_run.finish()
        return self.model, {}, self.optimizer

    def _read_overflow(self, unread) -> bool:
        """Read the flags of the unread steps at once. The flag is sticky, so
        the steps that committed are a prefix; from the first that did not,
        the step count and the noise generator go back to their values
        before it. Returns whether any step overflowed; empties ``unread``."""
        flags = torch.stack([flag for flag, _, _ in unread]).cpu().tolist()
        if any(flags):
            _, noise_state, count = unread[flags.index(True)]
            self.generator.set_state(noise_state)
            self.optimizer.count = count
        unread.clear()
        return any(flags)

    def _eval(self, step: int) -> Dict[str, float]:
        """In-training rollout metrics; ``val/loss=inf`` if the rollout fails."""
        if self._eval_neighbors is None:
            # sized from a validation sample: a train-sized buffer can be too
            # small for denser validation trajectories
            pos_v, ptype_v = self.data_valid[0]
            _, self._eval_neighbors = self.case.allocate_eval(
                (pos_v[:, : self.input_seq_length], ptype_v)
            )
        try:
            eval_metrics = eval_rollout(
                model=self.model,
                case=self.case,
                loader_eval=self.loader_valid,
                neighbors=self._eval_neighbors,
                metrics_computer=self.metrics_computer,
                n_rollout_steps=int(self.cfg_eval.n_rollout_steps),
                n_trajs=int(self.cfg_eval.train.n_trajs),
                rollout_dir=self.cfg_eval.rollout_dir,
                out_type=self.cfg_eval.train.out_type,
                mesh=self.mesh,
            )
            return averaged_metrics(eval_metrics)
        except RolloutOverflowError as exc:
            # a diverged model can cluster particles beyond the rollout's
            # capacity escalation (on every rank alike: the flag is
            # reduced); record an infinite loss and keep training
            if is_main(self.mesh):
                print(f"{step}, eval rollout failed ({exc}); recording val/loss=inf and "
                      "continuing")
            return {"val/loss": float("inf")}

    def _init_wandb(self, wandb_config, step):
        if not self.cfg_logging.wandb:
            return None
        try:
            import wandb
        except ImportError:
            print("wandb requested but not installed; logging to stdout")
            return None
        if wandb_config is None:
            wandb_config = {
                "train": self.cfg_train.to_dict(),
                "eval": self.cfg_eval.to_dict(),
                "logging": self.cfg_logging.to_dict(),
            }
        wandb_config["info"] = {
            "dataset_name": getattr(self.data_train, "name", None),
            "len_train": len(self.data_train),
            "len_eval": len(self.data_valid),
            "num_params": sum(p.numel() for p in self.model.parameters()),
            "step_start": step,
        }
        return wandb.init(
            project=self.cfg_logging.wandb_project,
            entity=self.cfg_logging.wandb_entity,
            name=self.cfg_logging.run_name,
            config=wandb_config,
            save_code=True,
        )
