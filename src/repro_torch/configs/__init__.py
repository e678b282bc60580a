from repro_torch.configs.base import ModelConfig, get_config, reduced  # noqa: F401
