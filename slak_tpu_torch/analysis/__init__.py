"""ERF and FLOPs analysis of the port (``slak_tpu/analysis``)."""

from slak_tpu_torch.analysis.erf import (analyze_erf, erf_contribution,
                                         get_input_grad, get_rectangle)
from slak_tpu_torch.analysis.flops import count_model_flops

__all__ = ["get_input_grad", "erf_contribution", "analyze_erf",
           "get_rectangle", "count_model_flops"]
