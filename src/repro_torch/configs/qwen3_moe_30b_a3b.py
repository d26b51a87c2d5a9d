"""qwen3-moe-30b-a3b [moe]: 128 experts top-8, qk_norm.
[hf:Qwen/Qwen3-30B-A3B; hf]"""

from repro_torch.configs.base import ModelConfig, MoEConfig, register

register(ModelConfig(
    name="qwen3-moe-30b-a3b",
    family="moe",
    n_layers=48,
    d_model=2048,
    n_heads=32,
    n_kv_heads=4,
    head_dim=128,
    d_ff=768,  # per-expert hidden
    vocab=151936,
    pattern=(("attn", "moe"),),
    moe=MoEConfig(num_experts=128, top_k=8, d_ff=768, shard_axis="experts"),
    qk_norm=True,
    rope_theta=1_000_000.0,
))
