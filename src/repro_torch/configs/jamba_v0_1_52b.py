"""jamba-v0.1-52b [hybrid]: Mamba + attention at 1:7, MoE (16e top-2) every
other layer.  Period of 8 = jamba's published block layout (attn at index
4, MoE on odd indices).  [arXiv:2403.19887; hf]"""

from repro_torch.configs.base import MambaConfig, ModelConfig, MoEConfig, register

register(ModelConfig(
    name="jamba-v0.1-52b",
    family="hybrid",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    vocab=65536,
    pattern=(
        ("mamba", "mlp"), ("mamba", "moe"), ("mamba", "mlp"), ("mamba", "moe"),
        ("attn", "mlp"), ("mamba", "moe"), ("mamba", "mlp"), ("mamba", "moe"),
    ),
    moe=MoEConfig(num_experts=16, top_k=2, d_ff=14336, shard_axis="experts"),
    mamba=MambaConfig(d_state=16, d_conv=4, expand=2),
    supports_long_context=True,  # only 4/32 layers keep a KV cache
))
