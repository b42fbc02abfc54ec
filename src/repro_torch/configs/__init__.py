from repro_torch.configs.base import LayerSpec, ModelConfig, SocketSettings
from repro_torch.configs.registry import ARCHITECTURES, get_config

__all__ = ["LayerSpec", "ModelConfig", "SocketSettings", "ARCHITECTURES",
           "get_config"]
