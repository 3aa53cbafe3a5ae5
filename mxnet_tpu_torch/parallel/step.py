"""Training step of the port: forward, backward and optimizer update.

Counterpart of ``mxnet_tpu/parallel/step.py:TrainStep`` on one device.
The JAX package compiles the step into one XLA program; PyTorch runs it
eagerly: the forward and the loss under ``torch.func.functional_call``
(so the loss sees the same cast parameters as the net, as the JAX
package's ``param_override`` gives it), ``torch.autograd.grad`` for the
backward, then the optimizer update of every parameter in place.

Precision follows the JAX package (``:507-520``, ``:562-581``,
``:590-607``): with ``compute_dtype`` the differentiated leaves are copies
of every float parameter cast to that dtype, so gradients carry it too;
the net's own parameters stay the f32 masters, updated in f32. With
``state_dtype`` the optimizer moments are stored narrow and lifted to the
master dtype for the update. The loss is the f32 mean of the loss
block's output (``:544``). A parameter that gets no gradient (the pooler
and ``token_type_embed`` under a masked-LM loss without token types) is
updated with a zero gradient, as ``jax.value_and_grad`` gives it.

Frozen values (BatchNorm's running statistics, which are buffers, and
parameters with ``requires_grad=False``) are cast like the parameters
(``:510-520, 529-533``) and not differentiated. The BatchNorm layers
update their running statistics in place in the copies the step hands
them, and the step stores what came back (``:974-978``): under
``compute_dtype`` the running statistics therefore end in that dtype, as
in the JAX package. With ``steps_per_call=k`` every microstep reads the
statistics the call started with and only the last microstep's update
is kept, as the JAX package's scan does (the statistics are not in its
carry, ``:706-721``).

Not ported yet: the mesh and sharding, ``amp=``, the float16 loss scaler,
``remat``, ``grad_accum``, learning-rate schedules, warm-up, checkpoints.
"""

from __future__ import annotations

import torch
from torch import nn

from ..base import MXNetError
from ..context import resolve_device
from ..optimizer import SGD, AdamW

__all__ = ["TrainStep"]


class _NetAndLoss(nn.Module):
    """The net and its loss as one module, so one ``functional_call``
    swaps the parameters for both."""

    def __init__(self, net, loss_fn):
        super().__init__()
        self.net = net
        self.loss_fn = loss_fn

    def forward(self, batch, label):
        out = self.net(*batch)
        outs = out if isinstance(out, tuple) else (out,)
        return self.loss_fn(*outs, label)


class TrainStep:
    """One training step of ``net`` under ``loss_fn`` and ``optimizer``.

    ``step(*inputs, label)`` runs the net on ``inputs`` in training mode,
    the loss as ``loss_fn(*net_outputs, label)``, the backward and the
    update, and returns the f32 mean loss as a 0-d tensor on the device
    (no host sync). Inputs may be numpy arrays or tensors; ``None`` passes
    through (an absent optional input).

    ``compute_dtype`` (e.g. ``"bfloat16"``) casts every float parameter,
    frozen value and float input (not the label) for the forward and
    backward; ``state_dtype`` stores the optimizer states in that dtype.
    ``steps_per_call=k`` runs k full steps per call on k distinct
    microbatches: every input's leading axis is split into (k, batch)
    and the call returns the mean of the k losses. ``device`` defaults
    to ``"cuda"``; without a card that raises
    ``MXNetError`` (pass ``device="cpu"`` to run on the CPU). The net is
    moved to the device and its parameters are the f32 masters, updated
    in place."""

    def __init__(self, net, loss_fn, optimizer, compute_dtype=None,
                 state_dtype=None, steps_per_call=1, device="cuda"):
        if not isinstance(optimizer, (SGD, AdamW)):
            raise MXNetError(f"TrainStep has no update for "
                             f"{type(optimizer).__name__}; the port has "
                             "SGD and AdamW")
        self.device = resolve_device(device)
        self._steps_per_call = int(steps_per_call)
        if self._steps_per_call < 1:
            raise MXNetError("steps_per_call must be >= 1")
        self._cdt = _dtype(compute_dtype)
        sdt = _dtype(state_dtype)
        self._net = net.to(self.device)
        self._module = _NetAndLoss(self._net, loss_fn)
        self._optimizer = optimizer
        self._params = {f"net.{n}": p for n, p in net.named_parameters()
                        if p.dtype.is_floating_point and p.requires_grad}
        self._frozen = {f"net.{n}": p for n, p in net.named_parameters()
                        if p.dtype.is_floating_point and not p.requires_grad}
        self._buffers = [n for n, b in net.named_buffers()
                         if b.dtype.is_floating_point]
        self._states = {
            n: tuple(torch.zeros_like(p, dtype=sdt or p.dtype)
                     for _ in range(optimizer.num_states()))
            for n, p in self._params.items()}
        self._t = 0

    def _to_device(self, x):
        if x is None:
            return None
        x = torch.as_tensor(x).to(self.device)
        if self._cdt is not None and x.dtype.is_floating_point:
            x = x.to(self._cdt)
        return x

    def __call__(self, *batch_and_label):
        *batch, label = batch_and_label
        batch = [self._to_device(x) for x in batch]
        if label is not None:  # labels keep their dtype (:544)
            label = torch.as_tensor(label).to(self.device)
        # the frozen values the call starts from, in the compute dtype
        start = {f"net.{n}": self._cast(self._net.get_buffer(n))
                 for n in self._buffers}
        start.update((n, self._cast(p.detach()))
                     for n, p in self._frozen.items())
        k = self._steps_per_call
        if k == 1:
            loss, frozen = self._step(batch, label, start)
        else:
            for x in (*batch, label):
                if x is not None and x.shape[0] % k:
                    raise MXNetError(f"leading axis {x.shape[0]} is not a "
                                     f"multiple of steps_per_call={k}")
            split = [None if x is None else x.reshape(k, -1, *x.shape[1:])
                     for x in (*batch, label)]
            losses = []
            for i in range(k):
                # every microstep reads the call's starting statistics
                li, frozen = self._step(
                    [None if x is None else x[i] for x in split[:-1]],
                    split[-1][i], {n: v.clone() for n, v in start.items()})
                losses.append(li)
            loss = torch.stack(losses).mean()
        for n in self._buffers:  # the last microstep's statistics
            mod, _, leaf = n.rpartition(".")
            setattr(self._net.get_submodule(mod), leaf, frozen[f"net.{n}"])
        return loss

    def _cast(self, t):
        if self._cdt is not None and t.dtype.is_floating_point:
            return t.to(self._cdt)
        return t

    def _step(self, batch, label, frozen):
        """One step; ``frozen`` (updated in place by the BatchNorm layers)
        is returned with the loss."""
        self._net.train()
        leaves = {n: self._cast(p.detach()).requires_grad_()
                  for n, p in self._params.items()}
        loss = torch.func.functional_call(
            self._module, {**frozen, **leaves},
            (batch, label)).float().mean()
        grads = torch.autograd.grad(loss, list(leaves.values()),
                                    allow_unused=True)
        self._t += 1
        self._update(grads)
        return loss.detach(), frozen

    @torch.no_grad()
    def _update(self, grads):
        opt = self._optimizer
        for (name, w), g in zip(self._params.items(), grads):
            g = torch.zeros_like(w) if g is None else g.to(w.dtype)
            states = self._states[name]
            # the multipliers are the parameter's own (:502-503); the
            # optimizer's lr_mult/wd_mult dicts are not read
            new_w, new_states = opt.update(
                w, g, tuple(s.to(w.dtype) for s in states),
                opt.lr * getattr(w, "lr_mult", 1.0),
                opt.wd * getattr(w, "wd_mult", 1.0), self._t)
            w.copy_(new_w)
            for s, ns in zip(states, new_states):
                s.copy_(ns)


def _dtype(name):
    if name is None:
        return None
    dt = name if isinstance(name, torch.dtype) else getattr(torch, str(name),
                                                            None)
    if not isinstance(dt, torch.dtype) or not dt.is_floating_point:
        raise MXNetError(f"not a float dtype: {name!r}")
    return dt
