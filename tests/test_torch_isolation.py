"""The PyTorch port stands alone: it imports neither JAX nor the JAX
package, and its entry points run on the card unless told otherwise."""

import pkgutil
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import chainermn_tpu_torch
from chainermn_tpu_torch.communicators import create_communicator
from chainermn_tpu_torch.examples.imagenet import train_imagenet
from chainermn_tpu_torch.examples.mnist import train_mnist
from chainermn_tpu_torch.examples.moe import train_moe_mlp
from chainermn_tpu_torch.examples.pipeline import train_pipeline_mlp
from chainermn_tpu_torch.examples.tensor_parallel import (
    train_tp_transformer,
)
from chainermn_tpu_torch.examples.transformer import train_transformer_lm
from chainermn_tpu_torch.links import MultiNodeBatchNormalization
from chainermn_tpu_torch.models import MLP, ResNet50, TransformerLM
from chainermn_tpu_torch.ops import flash_attention as fa
from chainermn_tpu_torch.parallel.mesh import make_mesh
from chainermn_tpu_torch.parallel.plan import ParallelPlan
from chainermn_tpu_torch.serving import ServingEngine
from chainermn_tpu_torch.training import Trainer, prefetch_to_device
from torch_rank_workers import restore_excepthook  # noqa: F401

ROOT = Path(__file__).resolve().parent.parent
PKG = ROOT / "chainermn_tpu_torch"
SMOKE = ROOT / "chip_smoke.py"

PORT_MODULES = sorted(
    m.name for m in pkgutil.walk_packages(chainermn_tpu_torch.__path__,
                                          "chainermn_tpu_torch."))

_BLOCK_AND_IMPORT = """
import importlib, importlib.util, sys
for name in ("jax", "jaxlib", "flax", "optax", "chainermn_tpu"):
    sys.modules[name] = None  # any import of these now raises
for mod in sys.argv[2:]:
    importlib.import_module(mod)
spec = importlib.util.spec_from_file_location("chip_smoke", sys.argv[1])
spec.loader.exec_module(importlib.util.module_from_spec(spec))
print("ok", len(sys.argv) - 2)
"""


def test_every_port_module_imports_with_jax_blocked():
    for name in ("ops.paged_decode", "ops.flash_attention", "testing",
                 "datasets.scatter_dataset", "datasets.empty_dataset",
                 "iterators", "links.batch_normalization", "models.mlp",
                 "models.resnet", "training.trainer", "training.prefetch",
                 "extensions.evaluator", "extensions.allreduce_persistent",
                 "examples.mnist.train_mnist",
                 "examples.imagenet.train_imagenet",
                 "extensions.checkpoint", "extensions.dcp_adapter",
                 "extensions.observation_aggregator", "native",
                 "native.ckpt_writer", "global_except_hook", "utils",
                 "utils.preemption", "utils.prng", "models._decode_common",
                 "models.transformer", "serving.engine",
                 "serving.scheduler", "functions", "functions.collective",
                 "functions.point_to_point", "parallel",
                 "parallel.collectives", "parallel.tensor",
                 "links.multi_node_chain_list", "links.mnbn",
                 "examples.mnist.train_mnist_model_parallel",
                 "parallel.zero", "parallel.fsdp",
                 "examples.tensor_parallel.train_tp_transformer",
                 "parallel.mesh", "parallel.pipeline",
                 "examples.pipeline.train_pipeline_mlp",
                 "parallel.plan_specs", "parallel.plan",
                 "parallel.ring_attention", "parallel.ulysses",
                 "parallel.local_attention", "parallel.moe",
                 "examples.moe.train_moe_mlp",
                 "communicators.xla_communicator",
                 "parallel.reduction_schedule", "parallel.composition",
                 "parallel.cost_model", "parallel.async_host"):
        assert "chainermn_tpu_torch." + name in PORT_MODULES
    out = subprocess.run(
        [sys.executable, "-c", _BLOCK_AND_IMPORT, str(SMOKE), *PORT_MODULES],
        capture_output=True, text=True, cwd=ROOT, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == ["ok", str(len(PORT_MODULES))]


_FORBIDDEN = [
    # an import of JAX or its libraries, at any indentation
    re.compile(r"^\s*(from|import)\s+(jax|jaxlib|flax|optax)\b", re.M),
    # an import of the JAX package (chainermn_tpu_torch is the port)
    re.compile(r"^\s*(from|import)\s+chainermn_tpu(\.|\s|$)", re.M),
    # a module name of the JAX package handed to importlib
    re.compile(r"[\'\"]chainermn_tpu(\.|[\'\"])"),
]


@pytest.mark.parametrize("path", sorted(PKG.rglob("*.py")) + [SMOKE],
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_source_names_no_jax_and_no_jax_package(path):
    text = path.read_text()
    for pattern in _FORBIDDEN:
        hit = pattern.search(text)
        assert hit is None, hit.group(0)


def test_entry_points_raise_without_a_card_or_a_device(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TransformerLM(vocab_size=16, num_layers=1, num_heads=2, d_model=8,
                      d_ff=16, max_len=16)
    model = TransformerLM(vocab_size=16, num_layers=1, num_heads=2,
                          d_model=8, d_ff=16, max_len=16, device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ServingEngine(model, num_slots=1, max_len=16, kv_block_size=4)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        create_communicator("pure_nccl")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_transformer_lm.main(["--iterations", "1"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_mnist.main(["--iterations", "1"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_imagenet.main(["--iterations", "1"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_tp_transformer.main(["--iterations", "1"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_pipeline_mlp.main(["--iterations", "1"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_moe_mlp.main(["--iterations", "1"])
    # an MoE model served under tensor parallelism: the card first
    moe = TransformerLM(vocab_size=16, num_layers=1, num_heads=2, d_model=8,
                        d_ff=16, max_len=16, n_experts=2,
                        moe_dispatch_impl="sort", device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ServingEngine(moe, num_slots=1, max_len=16, kv_block_size=4,
                      mesh=object())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_mesh(("data", "stage"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ParallelPlan({"data": 1})
    for make in (MLP, ResNet50, lambda: MultiNodeBatchNormalization(4)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        prefetch_to_device(iter([]), 2)
    # the Trainer runs on its communicator's device: the default
    # communicator is NCCL on the card
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Trainer(None, None, [], create_communicator())
    # CPU input needs no card: the prefetcher passes CPU batches through
    batch = np.arange(3, dtype=np.float32)
    (got,) = list(prefetch_to_device([batch], 2, device="cpu"))
    assert got.data_ptr() == torch.from_numpy(batch).data_ptr()
    # CPU input needs no card: the plain versions of K1-K3, no launch
    before = dict(fa.LAUNCHES)
    q = torch.zeros(1, 4, 2, 8, requires_grad=True)
    fa.flash_attention(q, q, q, causal=True).sum().backward()
    assert fa.LAUNCHES == before and q.grad is not None


def test_chip_smoke_refuses_to_run_without_a_card():
    out = subprocess.run([sys.executable, str(SMOKE)], capture_output=True,
                         text=True, cwd=ROOT, timeout=120)
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout
