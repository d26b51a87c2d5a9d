"""whisper-small [audio]: enc-dec, conv frontend STUB (input_specs supplies
precomputed frame embeddings).  [arXiv:2212.04356; unverified]"""

from repro_torch.configs.base import ModelConfig, register

register(ModelConfig(
    name="whisper-small",
    family="audio",
    n_layers=12,          # decoder
    encoder_layers=12,
    d_model=768,
    n_heads=12,
    n_kv_heads=12,
    d_ff=3072,
    vocab=51865,
    pattern=(("attn", "mlp"),),
    act="gelu_plain",
    tie_embeddings=True,
    frontend="audio",
))
