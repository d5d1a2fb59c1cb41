from heybuddy_tpu_torch.models.vits.synthesizer import (
    Vits,
    VitsConfig,
    import_torch_checkpoint,
    init_params,
)

__all__ = ["Vits", "VitsConfig", "init_params", "import_torch_checkpoint"]
