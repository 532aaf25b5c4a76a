"""Runtime: GGUF loader, KV cache, jitted inference engine."""

from kquant.runtime.engine import InferenceEngine  # noqa: F401
from kquant.runtime.kv_cache import KVCache  # noqa: F401
from kquant.runtime.loader import load_model  # noqa: F401
