"""Config system: one frozen dataclass per architecture, a registry, and
the reduced smoke-config generator.

A copy of the reference package's ``configs/base.py`` (pure Python), kept
here so that the port imports nothing of the reference.  Config modules
register themselves on import; ``get_config`` imports
``repro_torch.configs.<name>``: one module for each of the reference's
ten architectures, each a copy of the reference's.

Every architecture is expressed as a *layer pattern* — a period of
(mixer, ffn) blocks repeated ``n_layers / len(pattern)`` times.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

# mixers: "attn" | "mamba" | "mlstm" | "slstm"
# ffns:   "mlp" | "moe" | "none"
Block = tuple  # (mixer, ffn)


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    num_experts: int
    top_k: int
    d_ff: int  # per-expert hidden
    capacity_factor: float = 1.25
    # "experts" shards the expert axis over the model mesh axis (E % tp == 0);
    # "mlp" falls back to tensor-parallel expert FFNs (small E, e.g. grok-8e).
    shard_axis: str = "experts"


@dataclasses.dataclass(frozen=True)
class MambaConfig:
    d_state: int = 16
    d_conv: int = 4
    expand: int = 2
    chunk: int = 128  # chunked associative scan length


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # dense | moe | hybrid | ssm | audio | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    pattern: tuple  # tuple[Block] — one period
    head_dim: Optional[int] = None
    moe: Optional[MoEConfig] = None
    mamba: Optional[MambaConfig] = None
    qk_norm: bool = False
    act: str = "silu"  # silu | relu2 | gelu
    rope_theta: float = 10_000.0
    rms_eps: float = 1e-5
    tie_embeddings: bool = False
    # enc-dec (whisper): encoder depth; decoder = n_layers. Frontends are
    # STUBS: input_specs() supplies precomputed frame/patch embeddings.
    encoder_layers: int = 0
    frontend: str = "none"  # none | audio | patch
    num_patches: int = 256  # vlm prefix length
    # capabilities used by the dry-run cell matrix
    supports_long_context: bool = False  # sub-quadratic mixer available
    # blockwise-attention chunks of the plain path (TPU tile sizes in the
    # reference; the CUDA kernel picks its own tile)
    attn_chunk_q: int = 1024
    attn_chunk_kv: int = 1024
    # training-only knobs: remat checkpoints each period of the stack
    # under grad ("dots" remats as "nothing" in the port); mlstm_chunk is
    # kept so configs stay field-for-field equal to the reference's
    remat: bool = True
    remat_policy: str = "nothing"
    mlstm_chunk: int = 64
    # route full-sequence attention through the flash-attention kernel K5
    # (``kernels.ops.flash_attention``: CUDA on the card, its plain version
    # on the CPU) instead of the plain blockwise ``models.layers`` version
    use_pallas_attention: bool = False
    # FSDP weight sharding (no mesh in the port yet; kept for parity)
    fsdp: bool = True

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def repeats(self) -> int:
        assert self.n_layers % len(self.pattern) == 0, (
            f"{self.name}: n_layers {self.n_layers} % period "
            f"{len(self.pattern)} != 0")
        return self.n_layers // len(self.pattern)

    def params_count(self) -> int:
        """Analytic parameter count (embeddings + blocks), for 6ND."""
        d, v = self.d_model, self.vocab
        hd = self.resolved_head_dim
        total = v * d  # embed
        if not self.tie_embeddings:
            total += v * d  # lm_head
        for mixer, ffn in self.pattern * self.repeats:
            if mixer == "attn":
                total += d * (self.n_heads * hd) * 2  # q, o
                total += d * (self.n_kv_heads * hd) * 2  # k, v
            elif mixer == "mamba":
                m = self.mamba or MambaConfig()
                d_in = m.expand * d
                total += d * 2 * d_in + d_in * d  # in/out proj
                total += d_in * (m.d_conv + 2 * m.d_state + 2) + d_in
            elif mixer == "mlstm":
                dk = d // 2
                total += d * 2 * d + 2 * d * dk + d * d + 3 * d * dk // (d // self.n_heads)
            elif mixer == "slstm":
                total += 4 * d * d * 2
            if ffn == "mlp":
                mats = 2 if self.act in ("relu2", "gelu_plain") else 3
                total += mats * d * self.d_ff
            elif ffn == "moe":
                total += self.moe.num_experts * 3 * d * self.moe.d_ff
                total += d * self.moe.num_experts  # router
        if self.encoder_layers:
            per = d * (self.n_heads * hd) * 2 + d * (self.n_kv_heads * hd) * 2
            per += (2 if self.act in ("relu2", "gelu_plain") else 3) * d * self.d_ff
            per += d * (self.n_kv_heads * hd) * 2  # decoder cross-attn k,v (approx q,o counted above)
            total += self.encoder_layers * per
        return total

    def active_params_count(self) -> int:
        """Active (per-token) params — MoE counts top_k experts only."""
        if self.moe is None:
            return self.params_count()
        full = self.params_count()
        moe_blocks = sum(1 for _, f in self.pattern * self.repeats if f == "moe")
        all_e = moe_blocks * self.moe.num_experts * 3 * self.d_model * self.moe.d_ff
        act_e = moe_blocks * self.moe.top_k * 3 * self.d_model * self.moe.d_ff
        return full - all_e + act_e


_REGISTRY: dict = {}


def register(cfg: ModelConfig) -> ModelConfig:
    _REGISTRY[cfg.name] = cfg
    return cfg


def get_config(name: str) -> ModelConfig:
    import importlib

    if name not in _REGISTRY:
        importlib.import_module(f"repro_torch.configs.{name.replace('-', '_').replace('.', '_')}")
    return _REGISTRY[name]


def list_configs() -> list:
    # import all config modules
    import importlib
    import pkgutil

    import repro_torch.configs as pkg

    for m in pkgutil.iter_modules(pkg.__path__):
        if m.name not in ("base",):
            importlib.import_module(f"repro_torch.configs.{m.name}")
    return sorted(_REGISTRY)


def smoke_config(cfg: ModelConfig) -> ModelConfig:
    """Reduced same-family config for CPU smoke tests: few layers (one
    period), narrow width, tiny vocab/experts — same code paths."""
    small_moe = None
    if cfg.moe:
        small_moe = dataclasses.replace(
            cfg.moe, num_experts=min(cfg.moe.num_experts, 8),
            top_k=min(cfg.moe.top_k, 2), d_ff=64)
    small_mamba = dataclasses.replace(
        cfg.mamba, chunk=16) if cfg.mamba else None
    n_heads = min(cfg.n_heads, 4)
    n_kv = min(cfg.n_kv_heads, n_heads)
    return dataclasses.replace(
        cfg,
        name=cfg.name + "-smoke",
        n_layers=len(cfg.pattern),
        d_model=64,
        n_heads=n_heads,
        n_kv_heads=n_kv,
        head_dim=16,
        d_ff=128 if cfg.d_ff else 0,
        vocab=256,
        moe=small_moe,
        mamba=small_mamba,
        encoder_layers=min(cfg.encoder_layers, 1),
        num_patches=8,
    )
