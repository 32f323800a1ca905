from .fgla import griffinlim, griffinlim_reference, spsi_phase
from .mel import FrequencyScale
from .stft import istft, stft
from .windows import get_window
