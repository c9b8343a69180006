"""Models of the port (counterpart of :mod:`chainermn_tpu.models`): the
Transformer-base causal LM so far."""

from chainermn_tpu_torch.models.transformer import (
    LayerNorm,
    TransformerBlock,
    TransformerLM,
    apply_rope,
    lm_loss,
)

__all__ = ["LayerNorm", "TransformerBlock", "TransformerLM", "apply_rope",
           "lm_loss"]
