from heybuddy_tpu_torch.ops.melspec import mel_filterbank, dft_basis, frame_audio, num_frames
from heybuddy_tpu_torch.ops.windows import embedding_window_starts, extract_windows, num_embedding_windows

__all__ = [
    "mel_spectrogram",
    "mel_filterbank",
    "dft_basis",
    "frame_audio",
    "num_frames",
    "embedding_window_starts",
    "extract_windows",
    "num_embedding_windows",
]


def __getattr__(name):
    # the mel kernel's wrapper (K3 on a card, its plain version on the CPU),
    # imported on first use: its module imports this package
    if name == "mel_spectrogram":
        from heybuddy_tpu_torch.ops.kernels.melspec_kernel import mel_spectrogram

        return mel_spectrogram
    raise AttributeError(f"module 'heybuddy_tpu_torch.ops' has no attribute {name!r}")
