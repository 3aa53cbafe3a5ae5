"""Optimizers of the training and vision slices.

Counterpart of ``mxnet_tpu/optimizer/optimizer.py``: the ``Optimizer``
base's hyper-parameters (``learning_rate``, ``wd``, ``clip_gradient``,
``rescale_grad``, the ``lr_mult``/``wd_mult`` dicts), ``SGD`` (:278)
and ``AdamW`` (:406-431). The update itself runs in
``parallel.TrainStep`` through ``ops.optimizer_op``; the per-parameter
``Updater`` path is not ported.
"""

from __future__ import annotations

import math

from ..ops import optimizer_op as _ops

__all__ = ["Optimizer", "SGD", "AdamW"]


class Optimizer:
    """Hyper-parameters shared by every optimizer.

    ``set_lr_mult``/``set_wd_mult`` store the ``lr_mult``/``wd_mult``
    dicts (structural name -> multiplier) as the JAX package does; like
    its ``TrainStep``, the port's reads neither dict but each parameter's
    own ``lr_mult``/``wd_mult`` attribute (default 1), e.g.
    ``dict(net.named_parameters())[name].lr_mult = 0.0``. The dicts are
    for the per-parameter ``Updater`` path, not ported. This optimizer
    takes no ``param_idx2name``: with the empty ``idx2name`` that leaves,
    the JAX ``set_wd_mult`` rule (``:183-189``, weight decay 0 for every
    indexed name not ending in ``_weight``) reduces to a copy."""

    def __init__(self, learning_rate=None, wd=0.0, clip_gradient=None,
                 rescale_grad=1.0):
        self.lr = learning_rate if learning_rate is not None else 0.01
        self.wd = wd
        self.clip_gradient = clip_gradient
        self.rescale_grad = rescale_grad
        self.lr_mult = {}
        self.wd_mult = {}

    def set_lr_mult(self, args_lr_mult):
        self.lr_mult = dict(args_lr_mult)

    def set_wd_mult(self, args_wd_mult):
        self.wd_mult = dict(args_wd_mult)


class SGD(Optimizer):
    """SGD, with momentum when ``momentum`` is non-zero (reference
    ``sgd_update``/``sgd_mom_update``). One state, the momentum, or none
    (``parallel/step.py:131-150``)."""

    def __init__(self, momentum=0.0, learning_rate=None, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.momentum = momentum

    def num_states(self) -> int:
        return 1 if self.momentum else 0

    def update(self, weight, grad, states, lr, wd, t):
        """One update: ``(new_weight, new_states)`` in ``weight``'s dtype;
        ``t`` is unused."""
        clip = -1.0 if self.clip_gradient is None else self.clip_gradient
        if self.momentum:
            w, m = _ops.sgd_mom_update(
                weight, grad, states[0], lr=lr, momentum=self.momentum,
                wd=wd, rescale_grad=self.rescale_grad, clip_gradient=clip)
            return w, (m,)
        return _ops.sgd_update(weight, grad, lr=lr, wd=wd,
                               rescale_grad=self.rescale_grad,
                               clip_gradient=clip), ()


class AdamW(Optimizer):
    """Adam with decoupled weight decay (reference contrib
    ``adamw_update``)."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, correct_bias=True, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.beta1 = beta1
        self.beta2 = beta2
        self.epsilon = epsilon
        self.correct_bias = correct_bias

    def num_states(self) -> int:
        return 2  # mean, var

    def update(self, weight, grad, states, lr, wd, t):
        """One update at step ``t`` (from 1): ``(new_weight, new_states)``,
        all in ``weight``'s dtype. With ``correct_bias`` the learning rate
        carries Adam's bias correction, as ``parallel/step.py:177-194``
        folds it in."""
        if self.correct_bias:
            lr = lr * math.sqrt(1.0 - self.beta2 ** t) \
                / (1.0 - self.beta1 ** t)
        clip = -1.0 if self.clip_gradient is None else self.clip_gradient
        w, m, v = _ops.adamw_update(
            weight, grad, states[0], states[1], lr=lr, beta1=self.beta1,
            beta2=self.beta2, epsilon=self.epsilon, wd=wd,
            rescale_grad=self.rescale_grad, clip_gradient=clip)
        return w, (m, v)
