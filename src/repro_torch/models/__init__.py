"""Model stack (counterpart of ``repro/models``): configs, the
transformer's full-sequence forward, the serving path (caches, prefill,
single-token decode and the speculative verify block), plus the paper's
simple models in ``repro_torch.models.simple``."""
from repro_torch.models.config import INPUT_SHAPES, InputShape, ModelConfig
from repro_torch.models.transformer import forward, init_model
from repro_torch.models.decode import (decode_step, init_cache, prefill,
                                       verify_step, verify_supported)

__all__ = ["INPUT_SHAPES", "InputShape", "ModelConfig", "decode_step",
           "forward", "init_cache", "init_model", "prefill",
           "verify_step", "verify_supported"]
