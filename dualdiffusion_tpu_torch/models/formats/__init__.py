from .format import Format, FormatConfig, get_format_class, register_format
from .spectrogram import SpectrogramFormat, SpectrogramFormatConfig
from .ms_mdct_dual import MSMDCTDualFormat, MSMDCTDualFormatConfig
from .ms_mdct_dual_v1 import MSMDCTDualV1Format, MSMDCTDualV1FormatConfig
from .mdct import MDCTFormat, MDCTFormatConfig
from .mdct_psd import MDCTPSDFormat, MDCTPSDFormatConfig
from .raw import RawFormat, RawFormatConfig
