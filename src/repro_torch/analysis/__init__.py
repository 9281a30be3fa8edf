"""repro_torch.analysis — the card's rates and the cost models that order
the tuner's candidates (``roofline``)."""
from .roofline import (BF16_TENSOR_FLOPS, FP32_FLOPS, HBM_BYTES_PER_S,
                       INT8_TENSOR_OPS_PER_S, SMS, Cost, cooccurrence_cost,
                       intersect_cost)

__all__ = ["HBM_BYTES_PER_S", "INT8_TENSOR_OPS_PER_S", "BF16_TENSOR_FLOPS",
           "FP32_FLOPS", "SMS", "Cost", "intersect_cost", "cooccurrence_cost"]
