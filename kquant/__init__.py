"""kquant: a quantized GGUF inference engine in JAX for NVIDIA GPUs.

A JAX/XLA/Pallas framework with the capability surface of the
reference stack surveyed in SURVEY.md (a NEON-optimized llama.cpp
quantized-inference engine): GGUF K-quant model loading (Q4_K_M superblocks,
Q8_K activations), a functional Llama/Mixtral forward, a slot-contiguous
(optionally INT8) KV cache, a fused Pallas dequant+matmul kernel, continuous
batching, and GSPMD tensor/expert sharding over device meshes.

Layer map (reference layer -> here, see SURVEY.md section 1):
  L0 model I/O        -> kquant.gguf        (GGUF reader/writer, mmap views)
  L1 quant kernels    -> kquant.quant + kquant.ops (Pallas on Triton)
  L2+L3 sched/threads -> XLA (jit) -- no manual scheduler needed
  L4 graph builder    -> kquant.models      (traced functional forward)
  L5 context runtime  -> kquant.runtime + kquant.serving
  L6 tools/CLI        -> kquant.tools       (bench, perplexity, generate)
  L7 perf overlay     -> kquant.utils.roofline + docs
"""

__version__ = "0.1.0"
