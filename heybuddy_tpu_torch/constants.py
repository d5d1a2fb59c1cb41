"""
Constants of the serving path (featurization and the wake-word head).

A copy of the values in the JAX package's ``constants.py`` that this package
uses: the audio/feature contract, the mel geometry, the embedding windows and
the default activation threshold. The port keeps its own copy so that it never
imports the JAX package.
"""

# --- audio / feature contract -------------------------------------------------
SAMPLE_RATE = 16000
CLIP_SECONDS = 1.44
CLIP_SAMPLES = int(CLIP_SECONDS * SAMPLE_RATE)  # 23040

# Mel spectrogram (torchaudio MelSpectrogram geometry, center=False framing)
MEL_N_FFT = 512
MEL_WIN_LENGTH = 400  # 25 ms
MEL_HOP_LENGTH = 160  # 10 ms
MEL_BINS = 32
MEL_F_MIN = 60.0
MEL_F_MAX = 3800.0
MEL_LOG_EPS = 1e-6
# post-processing of the log-mel: x/10 + 2
MEL_SCALE_DIV = 10.0
MEL_SCALE_ADD = 2.0

# Embedding windows: 76 spectrogram frames, 8 frames apart
EMBEDDING_WINDOW_SIZE = 76
EMBEDDING_WINDOW_STRIDE = 8
EMBEDDING_DIM = 96
# Audio-level sliding windows (1.08 s, 0.12 s apart)
AUDIO_WINDOW_SIZE = 17280
AUDIO_WINDOW_STRIDE = 1920

# Classifier input contract: (batch, 16, 96)
FEATURE_FRAMES = 16

DEFAULT_ACTIVATION_THRESHOLD = 0.50
