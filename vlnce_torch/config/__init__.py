from vlnce_torch.config.node import CN, Config
from vlnce_torch.config.default import get_config, get_default_config

__all__ = ["CN", "Config", "get_config", "get_default_config"]
