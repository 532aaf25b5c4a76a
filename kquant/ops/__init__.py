"""Compute ops: the replacements of the reference's CPU op kernels.

Reference decode-path ops (SURVEY.md section 3.3): mul_mat (quantized vec-dot),
rope (YaRN-aware), rms_norm, soft_max, swiglu, set_rows (KV append), binary
add/mul. Here each is a traced jnp function (XLA fuses the elementwise ones)
plus, for the hot dequant+matmul, a fused Pallas kernel (ops.qmm_triton),
chosen by backend in ops.registry.
"""

from kquant.ops.norms import rms_norm  # noqa: F401
from kquant.ops.rope import apply_rope, rope_cos_sin  # noqa: F401
from kquant.ops.activations import swiglu  # noqa: F401
from kquant.ops.qmatmul import qmatmul  # noqa: F401
from kquant.ops.attention import attention_decode  # noqa: F401
