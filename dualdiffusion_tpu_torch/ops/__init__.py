from .fgla import griffinlim, griffinlim_reference, spsi_phase
from .mdct import imclt, imdct, mclt, mdct
from .mel import FrequencyScale, mel_density
from .stft import istft, stft, stft_num_frames
from .windows import get_window
