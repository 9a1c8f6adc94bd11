from .config import Config, load_config, merge_dotlist, save_config, to_dict
from .defaults import default_config

__all__ = ["Config", "load_config", "merge_dotlist", "to_dict", "save_config",
           "default_config"]
