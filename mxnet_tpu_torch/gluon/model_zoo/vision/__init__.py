"""Vision model zoo of the port: counterpart of
``mxnet_tpu/gluon/model_zoo/vision/``. ResNet v1 only so far;
``get_model(name, **kwargs)`` is the factory."""

from ....base import MXNetError
from . import resnet
from .resnet import *  # noqa: F401,F403

_models = {f.__name__: f for f in (resnet.resnet18_v1, resnet.resnet50_v1)}


def get_model(name, **kwargs):
    """The zoo model ``name`` (e.g. ``"resnet50_v1"``), built with
    ``kwargs`` (``layout``, ``classes``, ``device``, ...)."""
    key = name.lower()
    if key not in _models:
        raise MXNetError(f"model {name!r} is not in the port's zoo; "
                         f"available: {sorted(_models)}")
    return _models[key](**kwargs)


__all__ = ["get_model"] + resnet.__all__
