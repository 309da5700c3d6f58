"""Training path: LM loss, the optimizer step, train state, checkpoints,
on one device (the sharded step waits for `parallel/`)."""

from .train import (  # noqa: F401
    AdamW,
    TrainConfig,
    fit,
    init_train_state,
    lm_loss,
    make_optimizer,
    make_train_step,
)
