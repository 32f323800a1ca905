from .audio_metadata import (AudioInfo, get_audio_info, get_audio_metadata, is_flac_file,
                             update_audio_metadata)
from .config import (DATASET_PATH, DEBUG_PATH, MODELS_PATH, config_from_dict, config_to_dict,
                     load_config, load_json, save_config, save_json)
from .utils import (cos_angle, dequantize_tensor, fractal_noise_2d, get_audio_loudness,
                    load_audio, load_safetensors, load_safetensors_metadata, mu_law_decode,
                    mu_law_encode, normalize_lufs, png_bytes, quantize_tensor, save_audio,
                    save_img, save_safetensors, slerp, tensor_to_img)
