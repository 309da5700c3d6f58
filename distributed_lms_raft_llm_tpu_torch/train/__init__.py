"""Training path: LM loss, the optimizer step, train state, checkpoints,
on one device or sharded over dp, tp, sp, ep and pp
(`make_sharded_train_step`)."""

from .train import (  # noqa: F401
    AdamW,
    TrainConfig,
    fit,
    init_train_state,
    lm_loss,
    make_optimizer,
    make_sharded_train_step,
    make_train_step,
    train_state_shardings,
)
