"""Carry the JAX package's saved parameters into a port model.

``mxnet_tpu``'s ``Block.save_parameters`` (``gluon/block.py:289``) writes
an ``.npz`` (``util.py:23-45``): arrays ``arr_0 ... arr_{n-1}`` plus a JSON
manifest under ``__mxnet_tpu_manifest__`` whose ``keys`` are the
structural parameter names of ``Block._collect_params_with_prefix``
(``block.py:305``), e.g. ``decoder.layer0.self_attn.qkv_proj.weight``
for the Transformer or ``encoder.layers.0.attention.qkv_proj.weight``
for BERT. The port's modules use the same names and layouts (Dense
weights are ``(out, in)`` in both packages), so loading is a
name-for-name copy. The JAX package saves BatchNorm's running statistics
as parameters with ``grad_req="null"`` (``features.1.running_mean``); in
the port they are buffers of the same names and load under the same
rule. The port keeps its own reader of that file: it imports nothing of
the JAX package.
"""

from __future__ import annotations

import json
import os

import numpy as np
import torch

from .base import MXNetError

__all__ = ["load_mxnet_tpu_params", "read_params_npz"]

_MANIFEST_KEY = "__mxnet_tpu_manifest__"


def read_params_npz(path) -> dict:
    """``{structural name: numpy array}`` from a ``save_parameters``
    file."""
    with np.load(os.fspath(path), allow_pickle=False) as z:
        if _MANIFEST_KEY not in z.files:
            raise MXNetError(f"{path} has no {_MANIFEST_KEY} entry: not a "
                             "file written by save_parameters")
        manifest = json.loads(bytes(z[_MANIFEST_KEY].tobytes()).decode())
        if manifest.get("kind") != "dict":
            raise MXNetError(f"{path} holds a list, not named parameters")
        return {k: z[f"arr_{i}"] for i, k in enumerate(manifest["keys"])}


@torch.no_grad()
def load_mxnet_tpu_params(src, model) -> None:
    """Copy ``src`` into ``model``'s parameters and persistent buffers by
    structural name.

    ``src`` is a dict of numpy arrays keyed by structural name, or the
    path of a ``save_parameters`` ``.npz``. Every parameter and persistent
    buffer of the model must be present with its exact shape, and every
    entry of ``src`` must match one; anything else raises ``MXNetError``.
    Values are cast to each target's dtype and device."""
    arrays = src if isinstance(src, dict) else read_params_npz(src)
    persistent = set(model.state_dict())
    params = dict(model.named_parameters())
    params.update((n, b) for n, b in model.named_buffers()
                  if n in persistent)
    missing = sorted(set(params) - set(arrays))
    extra = sorted(set(arrays) - set(params))
    if missing or extra:
        raise MXNetError(f"parameter names do not match: missing {missing}, "
                         f"unmatched {extra}")
    for name, p in params.items():
        v = np.asarray(arrays[name])
        if tuple(v.shape) != tuple(p.shape):
            raise MXNetError(f"shape mismatch for {name!r}: source "
                             f"{tuple(v.shape)} != model {tuple(p.shape)}")
        p.copy_(torch.tensor(v, dtype=p.dtype))
