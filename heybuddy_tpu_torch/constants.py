"""
Constants of the port: featurization, the wake-word head and its training.

A copy of the values in the JAX package's ``constants.py`` that this package
uses: the audio/feature contract, the mel geometry, the embedding windows,
the default activation threshold, the model, training and dataset defaults,
and the TTS and augmentation defaults of generation. The port keeps its own
copy so that it never imports the JAX package. The synthesis version tags
live beside their synthesizers, as in the JAX package (``models/formant.py``,
``models/formant_device.py``, ``models/tts.py``).
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

# --- model defaults -----------------------------------------------------------
DEFAULT_ARCHITECTURE = "perceptron"
DEFAULT_USE_GATING = True
DEFAULT_USE_HALF_LAYERS = False
DEFAULT_LAYER_DIM = 96
DEFAULT_LAYERS = 2
DEFAULT_HEADS = 1

# --- training schedule --------------------------------------------------------
DEFAULT_STEPS = 5000
DEFAULT_WARMUP_STEPS = int(DEFAULT_STEPS / 5.0)
DEFAULT_HOLD_STEPS = int(DEFAULT_STEPS / 3.0)
DEFAULT_STAGES = 3
DEFAULT_TARGET_FALSE_POSITIVE_RATE = 1.5  # per hour
DEFAULT_DYNAMIC_NEGATIVE_WEIGHT = True
DEFAULT_NEGATIVE_WEIGHT_ADJUST_RATIO = 2.0
DEFAULT_STEP_ADJUST_RATIO = 2.0
DEFAULT_BATCH_SIZE_ADJUST_RATIO = 0.5
DEFAULT_LEARNING_RATE_ADJUST_RATIO = 0.5
DEFAULT_LEARNING_RATE = 0.001
DEFAULT_NEGATIVE_WEIGHT = 1.0
DEFAULT_HIGH_LOSS_THRESHOLD = 0.0001
DEFAULT_LOGGING_STEPS = 1
DEFAULT_VALIDATION_STEPS = 250
DEFAULT_CHECKPOINT_STEPS = 5000
DEFAULT_ACCUMULATION_TARGET = 128  # optimizer steps fire once >=128 hard examples

# --- data scale ---------------------------------------------------------------
DEFAULT_POSITIVE_SAMPLES = 100000
DEFAULT_POSITIVE_BATCH_SIZE = 50
DEFAULT_ADVERSARIAL_SAMPLES = 100000
DEFAULT_ADVERSARIAL_BATCH_SIZE = 50
DEFAULT_ADVERSARIAL_PHRASES = 250
DEFAULT_NEGATIVE_BATCH_SIZE = 1000
DEFAULT_BATCH_THREADS = 12
DEFAULT_VALIDATION_NEGATIVE_BATCH_SIZE = 1000
DEFAULT_VALIDATION_POSITIVE_BATCH_SIZE = 50
DEFAULT_VALIDATION_SAMPLES = 25000
DEFAULT_TESTING_POSITIVE_SAMPLES = 25000
DEFAULT_TESTING_ADVERSARIAL_SAMPLES = 25000
DEFAULT_PARTIAL_BATCH_SIZE = 25
DEFAULT_PARTIAL_MIN_VISIBLE = 0.30
DEFAULT_PARTIAL_MAX_VISIBLE = 0.80
# rows generated into a cache per generation call
DEFAULT_FEATURE_BATCH_SIZE = 25000
# the runtime's window stride in samples (0.12 s): stream-window caches hold
# their rows in temporal order at this stride
RUNTIME_WINDOW_STRIDE = 1920
# samples per chunk that ``listen`` reads before it scores the rolling buffer
DEFAULT_LISTEN_BUFFER_SIZE = 4096

# --- TTS ----------------------------------------------------------------------
DEFAULT_TTS_BATCH_SIZE = 8
DEFAULT_TTS_SLERP_WEIGHTS = (0.00, 0.25, 0.50, 0.75)
DEFAULT_TTS_LENGTH_SCALES = (0.75, 1.00, 1.25, 1.50)
DEFAULT_TTS_NOISE_SCALES = (0.667, 1.0)
DEFAULT_TTS_NOISE_SCALE_WEIGHTS = (0.8, 1.0)

# --- augmentation ---------------------------------------------------------------
DEFAULT_AUGMENT_SEVEN_BAND_PROB = 0.25
DEFAULT_AUGMENT_SEVEN_BAND_GAIN_DB = 6.0
DEFAULT_AUGMENT_TANH_DISTORTION_PROB = 0.25
DEFAULT_AUGMENT_TANH_MIN_DISTORTION = 1e-4
DEFAULT_AUGMENT_TANH_MAX_DISTORTION = 0.1
DEFAULT_AUGMENT_PITCH_SHIFT_PROB = 0.25
DEFAULT_AUGMENT_PITCH_SHIFT_SEMITONES = 3
DEFAULT_AUGMENT_BAND_STOP_PROB = 0.25
DEFAULT_AUGMENT_COLORED_NOISE_PROB = 0.25
DEFAULT_AUGMENT_COLORED_NOISE_MIN_SNR_DB = 10.0
DEFAULT_AUGMENT_COLORED_NOISE_MAX_SNR_DB = 30.0
DEFAULT_AUGMENT_COLORED_NOISE_MIN_F_DECAY = -1.0
DEFAULT_AUGMENT_COLORED_NOISE_MAX_F_DECAY = 2.0
DEFAULT_AUGMENT_BACKGROUND_NOISE_PROB = 0.75
DEFAULT_AUGMENT_BACKGROUND_NOISE_MIN_SNR_DB = -10.0
DEFAULT_AUGMENT_BACKGROUND_NOISE_MAX_SNR_DB = 15.0
DEFAULT_AUGMENT_GAIN_PROB = 1.0
DEFAULT_AUGMENT_GAIN_MIN_DB = -18.0
DEFAULT_AUGMENT_GAIN_MAX_DB = 6.0
DEFAULT_AUGMENT_REVERB_PROB = 0.75
DEFAULT_AUGMENT_PHRASE_PROB = 0.75
# 100 command-style lead words of the "{phrase}. {word}" phrase augmentation
DEFAULT_AUGMENT_PHRASE_WORDS = [
    "can", "where", "who", "what", "when",
    "why", "how", "is", "are", "do",
    "will", "would", "should", "could", "may",
    "might", "please", "tell", "give",
    "show", "explain", "find", "list", "make",
    "play", "call", "set", "remind", "start", "stop",
    "pause", "open", "close", "turn", "begin",
    "continue", "send", "search", "answer", "read",
    "repeat", "check", "update", "add", "remove",
    "delete", "connect", "save", "load", "launch",
    "bring", "print", "identify", "translate", "record",
    "forward", "rewind", "increase", "decrease", "switch",
    "change", "describe", "access", "review", "manage",
    "organize", "move", "select", "toggle", "control",
    "copy", "paste", "schedule", "arrange", "integrate",
    "collaborate", "prepare", "track", "navigate", "compile",
    "prioritize", "compare", "summarize", "highlight",
    "visualize", "analyze", "optimize", "clarify", "verify",
    "monitor", "explore", "enhance", "expand", "customize",
    "format", "generate", "calculate", "configure",
    "recommend", "build",
]
# the hosted background-noise and impulse-response corpora (streamed only
# when the hub is reachable; offline the synthetic ones stand in)
DEFAULT_IMPULSE_DATASET = "benjamin-paine/mit-impulse-response-survey-16khz"
DEFAULT_BACKGROUND_DATASET = [
    "benjamin-paine/free-music-archive-commercial-16khz-full",
    "benjamin-paine/freesound-laion-640k-commercial-16khz-full",
]
