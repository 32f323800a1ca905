from .audio_metadata import (AudioInfo, get_audio_info, get_audio_metadata, is_flac_file,
                             update_audio_metadata)
from .config import (DATASET_PATH, DEBUG_PATH, MODELS_PATH, config_from_dict, config_to_dict,
                     load_config, load_json, save_config, save_json)
from .utils import (get_audio_loudness, load_audio, load_safetensors, normalize_lufs,
                    png_bytes, save_audio, save_safetensors, tensor_to_img)
