"""Model stack (counterpart of ``repro/models``): configs and the
transformer's full-sequence forward, plus the paper's simple models in
``repro_torch.models.simple``.  The decode path (``prefill``,
``decode_step``, ``init_cache``, ``verify_step``, ``verify_supported``)
comes with serving (ROADMAP item 8)."""
from repro_torch.models.config import INPUT_SHAPES, InputShape, ModelConfig
from repro_torch.models.transformer import forward, init_model

__all__ = ["INPUT_SHAPES", "InputShape", "ModelConfig", "forward",
           "init_model"]
