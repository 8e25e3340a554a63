from oovrec_tpu_torch.config.configurator import DEFAULTS, Config

__all__ = ["Config", "DEFAULTS"]
