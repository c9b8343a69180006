"""Models of the port (counterpart of :mod:`chainermn_tpu.models`): the
Transformer-base LM (causal, or the bidirectional MLM encoder) with its
losses and its decoders (``generate``, ``beam_search``), the MNIST MLP and
the ResNet family."""

from chainermn_tpu_torch.models.mlp import MLP
from chainermn_tpu_torch.models.resnet import (
    BasicBlock,
    BottleneckBlock,
    ResNet,
    ResNet18,
    ResNet34,
    ResNet50,
    ResNet101,
    ResNet152,
)
from chainermn_tpu_torch.models.transformer import (
    LayerNorm,
    TransformerBlock,
    TransformerLM,
    apply_rope,
    beam_search,
    generate,
    init_cache,
    lm_loss,
    lm_loss_fused,
    mlm_corrupt,
    mlm_corrupt_from_draws,
    mlm_loss,
)

__all__ = ["BasicBlock", "BottleneckBlock", "LayerNorm", "MLP", "ResNet",
           "ResNet18", "ResNet34", "ResNet50", "ResNet101", "ResNet152",
           "TransformerBlock", "TransformerLM", "apply_rope", "beam_search",
           "generate", "init_cache", "lm_loss", "lm_loss_fused",
           "mlm_corrupt", "mlm_corrupt_from_draws", "mlm_loss"]
