"""Small shared helpers of the PyTorch port."""

from handel_tpu_torch.utils.math import is_set, log2_ceil, pow2

__all__ = ["log2_ceil", "pow2", "is_set"]
