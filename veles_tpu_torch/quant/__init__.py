"""veles_tpu_torch.quant — deploy-time int8 weight quantization.

Counterpart of :mod:`veles_tpu.quant`.  See
:mod:`veles_tpu_torch.quant.core` for the walks and the calibration
gate, and :mod:`veles_tpu_torch.ops.qgemm` for the kernel the pairs
feed.  The deploy entry point is
:meth:`veles_tpu_torch.gen.engine.GenerativeEngine.quantize_int8`.
"""

from veles_tpu_torch.quant.core import (DRIFT_TOL, QuantizationError,
                                        check_drift, dequantize_array,
                                        is_quantized_leaf, quantize_array,
                                        quantize_gen_params,
                                        quantize_stage_params,
                                        quantize_transformer_params,
                                        relative_drift, tree_is_quantized,
                                        tree_nbytes)

__all__ = [
    "DRIFT_TOL", "QuantizationError", "check_drift",
    "dequantize_array", "is_quantized_leaf", "quantize_array",
    "quantize_gen_params", "quantize_stage_params",
    "quantize_transformer_params", "relative_drift",
    "tree_is_quantized", "tree_nbytes",
]
