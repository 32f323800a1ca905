from .format import Format, FormatConfig, register_format
from .ms_mdct_dual import MSMDCTDualFormat, MSMDCTDualFormatConfig
from .spectrogram import SpectrogramFormat, SpectrogramFormatConfig
