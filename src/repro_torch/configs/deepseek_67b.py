"""deepseek-67b [dense]: llama-arch, 95 layers.  [arXiv:2401.02954; hf]"""

from repro_torch.configs.base import ModelConfig, register

register(ModelConfig(
    name="deepseek-67b",
    family="dense",
    n_layers=95,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    head_dim=128,
    d_ff=22016,
    vocab=102400,
    pattern=(("attn", "mlp"),),
))
