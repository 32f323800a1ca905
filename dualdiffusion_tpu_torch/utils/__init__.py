from .config import (config_from_dict, config_to_dict, load_config, load_json,
                     save_config, save_json)
from .utils import load_audio, load_safetensors, save_audio, save_safetensors
