"""llama3.2-1b [dense]: small llama3, tied embeddings.
[hf:meta-llama/Llama-3.2-1B; unverified]"""

from repro_torch.configs.base import ModelConfig, register

register(ModelConfig(
    name="llama3.2-1b",
    family="dense",
    n_layers=16,
    d_model=2048,
    n_heads=32,
    n_kv_heads=8,
    head_dim=64,
    d_ff=8192,
    vocab=128256,
    pattern=(("attn", "mlp"),),
    tie_embeddings=True,
    rope_theta=500_000.0,
))
