"""Import hygiene and device defaults of the PyTorch/CUDA port.

This file imports neither JAX nor the JAX package, so it runs on a
machine that has only PyTorch.
"""

import subprocess
import sys
from pathlib import Path

import pytest
import torch

from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.gluon.model_zoo import BERTModel, TransformerModel
from mxnet_tpu_torch.gluon.loss import SoftmaxCrossEntropyLoss
from mxnet_tpu_torch.gluon.model_zoo.vision import ResNetV1, BottleneckV1
from mxnet_tpu_torch.gluon.nn import BatchNorm
from mxnet_tpu_torch.ops import nn as ops
from mxnet_tpu_torch.optimizer import SGD, AdamW
from mxnet_tpu_torch.parallel import InferStep, TrainStep

TINY = dict(src_vocab=11, tgt_vocab=11, units=32, hidden_size=64,
            num_layers=1, num_heads=2, max_length=16, dropout=0.0)


def test_port_imports_neither_jax_nor_the_jax_package():
    """In a fresh interpreter, import the port and every submodule; the
    JAX package and JAX itself must stay out of ``sys.modules``."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import mxnet_tpu_torch as m\n"
        "names = [i.name for i in pkgutil.walk_packages(m.__path__, "
        "'mxnet_tpu_torch.')]\n"
        "for n in names: importlib.import_module(n)\n"
        "bad = [k for k in sys.modules if k == 'jax' or k.startswith('jax.')"
        " or k == 'mxnet_tpu' or k.startswith('mxnet_tpu.')]\n"
        "assert len(names) >= 35, names\n"
        "for n in ('mxnet_tpu_torch.ops.kernels.batch_norm',\n"
        "          'mxnet_tpu_torch.gluon.nn.conv_layers',\n"
        "          'mxnet_tpu_torch.gluon.model_zoo.vision.resnet'):\n"
        "    assert n in names, n\n"
        "assert not bad, bad\n"
        "print(len(names))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120,
                         cwd=Path(__file__).resolve().parents[1])
    assert out.returncode == 0, out.stderr


def test_infer_step_defaults_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    net = TransformerModel(device="cpu", **TINY)
    with pytest.raises(MXNetError, match="CUDA is not available"):
        InferStep(net)


def test_model_defaults_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(MXNetError, match="CUDA is not available"):
        TransformerModel(**TINY)


def test_train_step_defaults_to_cuda():
    """``TrainStep`` raises without a card unless asked for the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    net = BERTModel(vocab_size=11, units=32, hidden_size=64, num_layers=1,
                    num_heads=2, max_length=8, dropout=0.0, device="cpu")
    loss = SoftmaxCrossEntropyLoss()
    with pytest.raises(MXNetError, match="CUDA is not available"):
        TrainStep(net, loss, AdamW())
    TrainStep(net, loss, AdamW(), device="cpu")


def test_vision_entry_points_default_to_cuda():
    """The ResNet constructors, ``BatchNorm``, ``TrainStep`` with ``SGD``
    and the BatchNorm op run on ``cuda`` unless asked for the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    arch = (BottleneckV1, [1, 1, 1, 1], [8, 16, 16, 16, 16])
    with pytest.raises(MXNetError, match="CUDA is not available"):
        ResNetV1(*arch, classes=3, layout="NHWC")
    with pytest.raises(MXNetError, match="CUDA is not available"):
        BatchNorm(4)
    net = ResNetV1(*arch, classes=3, layout="NHWC", device="cpu")
    with pytest.raises(MXNetError, match="CUDA is not available"):
        TrainStep(net, SoftmaxCrossEntropyLoss(), SGD(momentum=0.9))
    TrainStep(net, SoftmaxCrossEntropyLoss(), SGD(momentum=0.9),
              device="cpu")
    x = torch.randn(2, 3, 3, 4)
    out, _, _ = ops.batch_norm(x, torch.ones(4), torch.zeros(4),
                               torch.zeros(4), torch.ones(4), axis=-1,
                               training=True)
    assert out.device.type == "cpu"
