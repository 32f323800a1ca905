from .format import Format, FormatConfig, register_format
from .spectrogram import SpectrogramFormat, SpectrogramFormatConfig
