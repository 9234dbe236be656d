from tmdiff_tpu_torch.config.config import NoneDict, dict2str, parse_config  # noqa: F401
