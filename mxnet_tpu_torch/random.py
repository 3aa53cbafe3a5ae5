"""Seeded random state of the port.

Counterpart of ``mxnet_tpu/random.py``'s ``seed``: one explicit
``torch.Generator`` per device, each seeded from the last ``seed(n)`` (0
until one is given) when it is first used. Dropout draws its masks from
``generator(tensor.device)``, never from torch's global generator, so one
seed fixes a run. A generator gives other numbers on the CPU than on a
card, and other numbers than ``jax.random``: a test that compares the two
packages feeds both the same inputs and runs without dropout.
"""

from __future__ import annotations

import threading

import torch

__all__ = ["seed", "generator"]

_LOCK = threading.Lock()
_SEED = 0
_GENERATORS: dict = {}


def seed(seed_state: int) -> None:
    """Reseed: every device's generator restarts from ``seed_state``."""
    global _SEED
    with _LOCK:
        _SEED = int(seed_state)
        _GENERATORS.clear()


def generator(device) -> torch.Generator:
    """The generator of ``device`` (created from the current seed on first
    use)."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    with _LOCK:
        gen = _GENERATORS.get(dev)
        if gen is None:
            gen = torch.Generator(device=dev)
            gen.manual_seed(_SEED)
            _GENERATORS[dev] = gen
        return gen
