from heybuddy_tpu_torch.utils.log import logger, debug_logger, unified_logging
from heybuddy_tpu_torch.utils.strings import safe_name, human_duration, human_size
from heybuddy_tpu_torch.utils.audio_io import (
    audio_to_bct_array,
    read_wav,
    write_wav,
    resample_audio,
    normalize_peak,
    normalize_rms,
)
from heybuddy_tpu_torch.utils.npy import AppendableNpyFile, read_npy_header, ensure_appendable
from heybuddy_tpu_torch.utils.downloads import (
    get_cache_dir,
    check_download_file,
    file_sha256,
    file_is_downloaded,
)

__all__ = [
    "logger",
    "debug_logger",
    "unified_logging",
    "safe_name",
    "human_duration",
    "human_size",
    "audio_to_bct_array",
    "read_wav",
    "write_wav",
    "resample_audio",
    "normalize_peak",
    "normalize_rms",
    "AppendableNpyFile",
    "read_npy_header",
    "ensure_appendable",
    "get_cache_dir",
    "check_download_file",
    "file_sha256",
    "file_is_downloaded",
]
