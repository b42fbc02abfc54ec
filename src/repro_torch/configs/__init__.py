from repro_torch.configs.base import (LayerCachePlan, LayerSpec, ModelConfig,
                                     QuestSettings, ServingSettings,
                                     SocketSettings)
from repro_torch.configs.registry import ARCHITECTURES, get_config

__all__ = ["LayerCachePlan", "LayerSpec", "ModelConfig", "QuestSettings",
           "ServingSettings", "SocketSettings", "ARCHITECTURES", "get_config"]
