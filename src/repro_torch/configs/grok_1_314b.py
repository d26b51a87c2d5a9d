"""grok-1-314b [moe]: 8 experts top-2; E < tp so expert FFNs are tensor-
parallel ("mlp" shard axis).  [hf:xai-org/grok-1; unverified]"""

from repro_torch.configs.base import ModelConfig, MoEConfig, register

register(ModelConfig(
    name="grok-1-314b",
    family="moe",
    n_layers=64,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    head_dim=128,
    d_ff=32768,
    vocab=131072,
    pattern=(("attn", "moe"),),
    moe=MoEConfig(num_experts=8, top_k=2, d_ff=32768, shard_axis="mlp"),
    act="gelu",
))
