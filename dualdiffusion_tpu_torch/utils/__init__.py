from .config import (config_from_dict, config_to_dict, load_config, load_json,
                     save_config, save_json)
from .utils import (get_audio_loudness, load_audio, load_safetensors, normalize_lufs,
                    save_audio, save_safetensors)
