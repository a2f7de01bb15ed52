from celerite2_torch.utils.misc import LinAlgError, as_tensor, atleast_1d

__all__ = ["LinAlgError", "as_tensor", "atleast_1d"]
