from celerite2_torch.ops.fused_loglik import LAUNCHES, LoglikFused, loglik_fused

__all__ = ["LAUNCHES", "LoglikFused", "loglik_fused"]
