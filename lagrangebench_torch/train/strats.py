"""Training strategies: GNS random-walk noise and the pushforward trick.

Counterpart of ``lagrangebench_tpu/train/strats.py``. The JAX package
draws its noise from ``jax.random`` keys; here the standard-normal draw
comes from a ``torch.Generator`` or is handed in (``draw``), so that a
test can feed the same numbers to both packages. The pushforward unroll
count is sampled with a host numpy Generator, as in the JAX package.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..utils import get_kinematic_mask


def random_walk_position_noise(
    position_seq_shape,
    noise_std_last_step: float,
    dtype,
    device=None,
    generator: Optional[torch.Generator] = None,
    draw: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Random-walk noise over position sequences (..., N, T, dim).

    Velocity noise is a random walk whose last step has std
    ``noise_std_last_step`` (each increment has std / sqrt(T-1)); position
    noise is the cumulative sum of the velocity walk with a zero first
    frame. ``draw`` is the (..., N, T-1, dim) standard-normal draw; without
    it one is made from ``generator`` on its device and moved to ``device``.
    """
    *lead, t, dim = position_seq_shape
    n_velocities = t - 1
    if draw is None:
        gen_device = generator.device if generator is not None else "cpu"
        draw = torch.randn((*lead, n_velocities, dim), generator=generator, dtype=dtype,
                           device=gen_device)
    draw = draw.to(device)
    vel_noise = draw.to(dtype) * (noise_std_last_step / n_velocities**0.5)
    vel_walk = torch.cumsum(vel_noise, dim=-2)
    zeros = torch.zeros((*lead, 1, dim), dtype=dtype, device=vel_walk.device)
    return torch.cat([zeros, torch.cumsum(vel_walk, dim=-2)], dim=-2)


def add_gns_noise(
    pos_input: torch.Tensor,
    particle_type: torch.Tensor,
    input_seq_length: int,
    noise_std: float,
    shift_fn,
    generator: Optional[torch.Generator] = None,
    draw: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Apply GNS-style random-walk noise and shift targets consistently.

    ``pos_input`` is (..., N, T, dim) with types (..., N). Noise perturbs
    only the ``input_seq_length`` input frames; every later frame is
    shifted by the noise of the last input frame so target velocities and
    accelerations stay consistent. Kinematic particles get no noise.
    ``draw``: the (..., N, input_seq_length - 1, dim) standard-normal draw.
    """
    isl = input_seq_length
    shape = tuple(pos_input.shape[:-2]) + (isl, pos_input.shape[-1])
    input_noise = random_walk_position_noise(
        shape, noise_std, pos_input.dtype, pos_input.device, generator, draw
    )
    kinematic = get_kinematic_mask(particle_type)[..., None, None]
    input_noise = torch.where(kinematic, torch.zeros_like(input_noise), input_noise)
    n_targets = pos_input.shape[-2] - isl
    target_noise = input_noise[..., -1:, :].expand(
        *input_noise.shape[:-2], n_targets, input_noise.shape[-1]
    )
    full_noise = torch.cat([input_noise, target_noise], dim=-2)
    return shift_fn(pos_input, full_noise)


def push_forward_sample_steps(rng: np.random.Generator, step: int, pushforward) -> int:
    """Sample the pushforward unroll count for the current training step.

    The curriculum unlocks entry i once ``step > steps[i]``; among unlocked
    entries the unroll count is drawn with the configured probabilities
    (uniform when all unlocked probabilities are zero).
    """
    steps = np.asarray(pushforward.steps)
    if (np.diff(steps) < 0).any():
        raise ValueError("pushforward.steps must be sorted")
    idx = int((step > steps).sum())
    unrolls = np.asarray(pushforward.unrolls[:idx])
    probs = np.asarray(pushforward.probs[:idx], dtype=np.float64)
    total = probs.sum()
    if total <= 0:  # degenerate config: all unlocked probs zero -> uniform
        probs = np.full(len(unrolls), 1.0 / len(unrolls))
    else:
        probs = probs / total
    return int(rng.choice(unrolls, p=probs))


def push_forward_batched_build(model, case):
    """Pushforward over a trajectory batch on the flat super-graph.

    One unroll predicts with the model (no gradient flows through it),
    integrates, shifts the input window and rebuilds features and
    neighbors with ``case.preprocess_eval_batched``. Integration and the
    window shift are row-wise on the flattened positions; only the
    neighbor update runs per sample.
    """

    @torch.no_grad()
    def push_forward_fn(flat_features, current_pos, particle_type, neighbors):
        b, n = particle_type.shape
        pred = model(flat_features, particle_type.reshape(b * n))
        cur_flat = current_pos.reshape((b * n,) + tuple(current_pos.shape[2:]))
        next_pos = case.integrate(pred, cur_flat)
        cur_flat = torch.cat([cur_flat[:, 1:], next_pos[:, None, :]], dim=1)
        current_pos = cur_flat.reshape(current_pos.shape)
        flat_features, neighbors = case.preprocess_eval_batched(
            (current_pos, particle_type), neighbors
        )
        return current_pos, neighbors, flat_features

    return push_forward_fn
