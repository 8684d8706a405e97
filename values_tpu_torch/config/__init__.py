from .instantiate import TARGET_ALIASES, instantiate, locate
from .loader import compose, load_config_file
from .node import Config, make_config, merge, resolve

__all__ = [
    "Config", "make_config", "merge", "resolve",
    "compose", "load_config_file",
    "instantiate", "locate", "TARGET_ALIASES",
]
