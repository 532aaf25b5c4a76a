"""Quantization codec layer: ggml block formats on host (NumPy) and device (JAX).

Reference parity target: SURVEY.md section 2.1 "Quant formats & vec-dot
kernels" (Q4_K 144 B / Q8_K 292 B superblocks, reference README.md:610-611).
"""

from kquant.quant.numpy_codecs import dequantize, quantize  # noqa: F401
