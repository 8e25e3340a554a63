from oovrec_tpu_torch.config.configurator import (
    DEFAULTS,
    PORT_DEFAULTS,
    Config,
    parse_cli_args,
)

__all__ = ["Config", "DEFAULTS", "PORT_DEFAULTS", "parse_cli_args"]
