from .step import build_train_step, grads_overflow_flag

__all__ = ["build_train_step", "grads_overflow_flag"]
