"""The training step (port of `repro.train`; ``train_state_axes`` waits for
the multi-device slice)."""
from .step import default_optimizer, init_train_state, make_train_step

__all__ = ["default_optimizer", "init_train_state", "make_train_step"]
