"""xlstm-125m [ssm]: sLSTM + mLSTM blocks (d_ff=0: no separate FFN).
Block ratio mLSTM:sLSTM = 5:1 per period (xLSTM[7:1]-style sparse sLSTM
placement adapted to 12 layers).  [arXiv:2405.04517; unverified]"""

from repro_torch.configs.base import ModelConfig, register

register(ModelConfig(
    name="xlstm-125m",
    family="ssm",
    n_layers=12,
    d_model=768,
    n_heads=4,
    n_kv_heads=4,
    d_ff=0,
    vocab=50304,
    pattern=(
        ("mlstm", "none"), ("mlstm", "none"), ("mlstm", "none"),
        ("mlstm", "none"), ("mlstm", "none"), ("slstm", "none"),
    ),
    supports_long_context=True,  # O(1) state per token
    # fsdp=False was tried (§Perf xlstm iter. 2) and measured neutral
))
