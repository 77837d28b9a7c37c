"""Training: the trainer, AdamW with its schedule, noise and pushforward."""

from .strats import add_gns_noise, push_forward_sample_steps
from .trainer import AdamW, Trainer, exponential_decay, flat_mse_loss, mse_loss

__all__ = [
    "AdamW",
    "Trainer",
    "add_gns_noise",
    "exponential_decay",
    "flat_mse_loss",
    "mse_loss",
    "push_forward_sample_steps",
]
