"""Layers, losses and models of the port (``torch.nn.Module``s).

Counterpart of ``mxnet_tpu/gluon/`` for the serving and training slices.
"""

from . import loss, model_zoo, nn

__all__ = ["nn", "loss", "model_zoo"]
