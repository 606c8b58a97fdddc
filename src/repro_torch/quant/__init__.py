from .quantizers import (QuantSpec, block_fp_align, dequantize, fake_quant,
                         fp8_e4m3_quant, quantize_int)

__all__ = ["QuantSpec", "block_fp_align", "dequantize", "fake_quant",
           "fp8_e4m3_quant", "quantize_int"]
