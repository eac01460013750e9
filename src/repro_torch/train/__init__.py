"""Training step factory (port of ``repro/train``): loss, remat, AdamW."""

from repro_torch.train.step import (
    TrainState,
    chunked_lm_loss,
    make_loss_fn,
    make_train_step,
    train_state_from_numpy,
    train_state_init,
)

__all__ = [
    "TrainState",
    "chunked_lm_loss",
    "make_loss_fn",
    "make_train_step",
    "train_state_from_numpy",
    "train_state_init",
]
