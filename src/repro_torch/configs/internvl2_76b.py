"""internvl2-76b [vlm]: InternViT frontend STUB (input_specs supplies patch
embeddings) + 80L LLM backbone.  [arXiv:2404.16821; unverified]"""

from repro_torch.configs.base import ModelConfig, register

register(ModelConfig(
    name="internvl2-76b",
    family="vlm",
    n_layers=80,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    head_dim=128,
    d_ff=28672,
    vocab=128256,
    pattern=(("attn", "mlp"),),
    frontend="patch",
    num_patches=256,
))
