from .step import build_prefill_step, build_train_step, grads_overflow_flag

__all__ = ["build_prefill_step", "build_train_step", "grads_overflow_flag"]
