"""Model family layer: configs + functional forwards (llama family, MoE)."""

from kquant.models.config import ModelConfig  # noqa: F401
from kquant.models.llama import llama_forward  # noqa: F401
