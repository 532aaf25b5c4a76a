"""Model hyperparameters from GGUF metadata.

Replaces the reference's per-arch hparams loading (SURVEY.md 2.1 "Model
loader / arch registry": llama_model_load reading {arch}.* KV pairs).
"""

from __future__ import annotations

import dataclasses
from typing import Any

from kquant.ops.rope import RopeParams


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    arch: str
    n_layers: int
    dim: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    ffn_dim: int
    vocab_size: int
    max_seq_len: int
    norm_eps: float = 1e-5
    rope: RopeParams = None  # type: ignore[assignment]
    # MoE
    n_experts: int = 0
    n_experts_used: int = 0
    moe_impl: str = "loop"  # 'loop' (per-expert Pallas) | 'ep' (sharded einsum)
    # misc arch quirks
    tie_embeddings: bool = False
    attn_bias: bool = False
    sliding_window: int = 0  # 0 = full attention
    swa_pattern: int = 1  # 1 = every layer sliding; N>1 = layers with
    #                       i % N == 0 sliding, rest full (gemma2: 2)
    act_fn: str = "silu"  # FFN gate activation ('silu' | 'gelu')
    post_norms: bool = False  # gemma2: extra RMSNorm after attn and ffn blocks
    embed_scale: float = 1.0  # gemma scales embeddings by sqrt(dim)
    attn_logit_softcap: float = 0.0  # gemma2: 50.0
    final_logit_softcap: float = 0.0  # gemma2: 30.0
    # recurrent (mamba) SSM hparams — the llama.cpp recurrent memory backend
    ssm_d_conv: int = 0
    ssm_d_inner: int = 0
    ssm_d_state: int = 0
    ssm_dt_rank: int = 0

    @property
    def is_moe(self) -> bool:
        return self.n_experts > 0

    @property
    def is_recurrent(self) -> bool:
        return self.arch == "mamba"

    def layer_window(self, i: int) -> int:
        """Sliding-window size for layer i (0 = full attention)."""
        if self.sliding_window <= 0:
            return 0
        if self.swa_pattern <= 1 or i % self.swa_pattern == 0:
            return self.sliding_window
        return 0

    @staticmethod
    def from_gguf(md: dict[str, Any]) -> "ModelConfig":
        arch = md["general.architecture"]

        def g(key: str, default=None):
            v = md.get(f"{arch}.{key}", default)
            return v

        if arch == "mamba":
            vocab = md.get(f"{arch}.vocab_size")
            if vocab is None:
                vocab = len(md.get("tokenizer.ggml.tokens", []))
            return ModelConfig(
                arch=arch,
                n_layers=int(g("block_count")),
                dim=int(g("embedding_length")),
                n_heads=0, n_kv_heads=0, head_dim=0, ffn_dim=0,
                vocab_size=int(vocab),
                max_seq_len=int(g("context_length", 4096)),
                norm_eps=float(g("attention.layer_norm_rms_epsilon", 1e-5)),
                rope=RopeParams(head_dim=0, n_rot=0, freq_base=10000.0,
                                freq_scale=1.0, ext_factor=0.0, n_ctx_orig=0,
                                mode="neox"),
                ssm_d_conv=int(g("ssm.conv_kernel")),
                ssm_d_inner=int(g("ssm.inner_size")),
                ssm_d_state=int(g("ssm.state_size")),
                ssm_dt_rank=int(g("ssm.time_step_rank")),
            )

        n_heads = int(g("attention.head_count"))
        dim = int(g("embedding_length"))
        head_dim = int(g("attention.key_length", dim // n_heads))
        n_rot = int(g("rope.dimension_count", head_dim))

        scaling_type = g("rope.scaling.type", "")
        factor = float(g("rope.scaling.factor", 1.0) or 1.0)
        freq_scale = 1.0 / factor if factor not in (0.0, 1.0) else 1.0
        ext_factor = 1.0 if scaling_type == "yarn" else 0.0
        # ggml rope type per architecture: llama/mistral exports permute q/k
        # for adjacent-pair ('norm') rotation; qwen2/phi3/gemma use split-half
        # ('neox') like HF
        mode = (
            "neox"
            if arch in ("qwen2", "phi3", "stablelm", "gptneox", "gemma", "gemma2")
            else "norm"
        )
        rope = RopeParams(
            head_dim=head_dim,
            n_rot=n_rot,
            freq_base=float(g("rope.freq_base", 10000.0)),
            freq_scale=freq_scale,
            ext_factor=ext_factor,
            n_ctx_orig=int(g("rope.scaling.original_context_length", g("context_length", 0))),
            mode=mode,
        )
        vocab = md.get(f"{arch}.vocab_size")
        if vocab is None:
            vocab = len(md.get("tokenizer.ggml.tokens", []))
        # arch-wide quirks (the reference's per-arch hparams hardcoding in
        # llama_model::load_hparams). gemma GGUF exports store norm weights
        # with the (1 + w) offset already applied, so RMSNorm stays plain.
        quirks: dict[str, Any] = {}
        if arch in ("gemma", "gemma2"):
            quirks.update(act_fn="gelu", embed_scale=float(dim) ** 0.5,
                          tie_embeddings=True)
        if arch == "gemma2":
            quirks.update(
                post_norms=True,
                swa_pattern=2,
                attn_logit_softcap=float(g("attn_logit_softcapping", 50.0)),
                final_logit_softcap=float(g("final_logit_softcapping", 30.0)),
            )
        return ModelConfig(
            **quirks,
            arch=arch,
            n_layers=int(g("block_count")),
            dim=dim,
            n_heads=n_heads,
            n_kv_heads=int(g("attention.head_count_kv", n_heads)),
            head_dim=head_dim,
            ffn_dim=int(g("feed_forward_length")),
            vocab_size=int(vocab),
            max_seq_len=int(g("context_length", 4096)),
            norm_eps=float(g("attention.layer_norm_rms_epsilon", 1e-5)),
            rope=rope,
            n_experts=int(g("expert_count", 0) or 0),
            n_experts_used=int(g("expert_used_count", 0) or 0),
            sliding_window=int(g("attention.sliding_window", 0) or 0),
        )

    def to_gguf_metadata(self) -> dict[str, Any]:
        """Inverse of from_gguf, used by the fixture-model writer."""
        a = self.arch
        if self.is_recurrent:
            return {
                "general.architecture": a,
                f"{a}.block_count": self.n_layers,
                f"{a}.context_length": self.max_seq_len,
                f"{a}.embedding_length": self.dim,
                f"{a}.attention.layer_norm_rms_epsilon": self.norm_eps,
                f"{a}.ssm.conv_kernel": self.ssm_d_conv,
                f"{a}.ssm.inner_size": self.ssm_d_inner,
                f"{a}.ssm.state_size": self.ssm_d_state,
                f"{a}.ssm.time_step_rank": self.ssm_dt_rank,
                f"{a}.vocab_size": self.vocab_size,
            }
        md: dict[str, Any] = {
            "general.architecture": a,
            f"{a}.block_count": self.n_layers,
            f"{a}.context_length": self.max_seq_len,
            f"{a}.embedding_length": self.dim,
            f"{a}.feed_forward_length": self.ffn_dim,
            f"{a}.attention.head_count": self.n_heads,
            f"{a}.attention.head_count_kv": self.n_kv_heads,
            f"{a}.attention.key_length": self.head_dim,
            f"{a}.attention.layer_norm_rms_epsilon": self.norm_eps,
            f"{a}.rope.freq_base": self.rope.freq_base,
            f"{a}.rope.dimension_count": self.rope.n_rot,
            f"{a}.vocab_size": self.vocab_size,
        }
        if self.n_experts:
            md[f"{a}.expert_count"] = self.n_experts
            md[f"{a}.expert_used_count"] = self.n_experts_used
        if self.sliding_window:
            md[f"{a}.attention.sliding_window"] = self.sliding_window
        if self.attn_logit_softcap:
            md[f"{a}.attn_logit_softcapping"] = self.attn_logit_softcap
        if self.final_logit_softcap:
            md[f"{a}.final_logit_softcapping"] = self.final_logit_softcap
        return md
