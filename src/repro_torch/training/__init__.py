"""Training substrate: AdamW optimizer, train loop, checkpointing."""
from .checkpoint import load_checkpoint, save_checkpoint  # noqa: F401
from .optimizer import (  # noqa: F401
    AdamWConfig,
    OptState,
    adamw_update,
    init_opt_state,
)
from .train_loop import make_train_step, train  # noqa: F401
