"""AdamW with optionally int8-quantized moments (port of ``repro.optim``)."""
from .adamw import OptState, adamw_init, adamw_update
from .quantized import Q8, dequantize_q8, quantize_q8

__all__ = ["adamw_init", "adamw_update", "OptState",
           "quantize_q8", "dequantize_q8", "Q8"]
