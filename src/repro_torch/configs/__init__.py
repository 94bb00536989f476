from repro_torch.configs.base import ModelConfig, ShapeCfg, SHAPES  # noqa: F401
from repro_torch.configs.registry import ARCHS, get_config, get_smoke_config  # noqa: F401
