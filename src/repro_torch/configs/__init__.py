"""Architecture configs (one module per architecture) + registry."""

from repro_torch.configs.base import (
    MambaConfig,
    ModelConfig,
    MoEConfig,
    get_config,
    list_configs,
    register,
    smoke_config,
)

__all__ = ["MambaConfig", "ModelConfig", "MoEConfig", "get_config",
           "list_configs", "register", "smoke_config"]
