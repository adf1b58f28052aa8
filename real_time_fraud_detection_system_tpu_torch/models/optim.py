"""Minibatch Adam over a params tree — the offline trainers' optimizer.

The JAX package trains every kind with ``optax.adam(learning_rate)``:
β = (0.9, 0.999), ε = 1e-8, the update ``lr·m̂/(√v̂ + ε)``.
``torch.optim.Adam`` with its defaults (no weight decay, no amsgrad)
computes the same update; the two round differently, so parity with the
JAX package is a tolerance, not bit for bit.

:class:`Adam` keeps the tree's leaves as its own leaf tensors and steps
them in place; :func:`epoch_batches` is the trainers' shared minibatch
order: ``np.random.default_rng(seed).permutation(n)`` each epoch, full
batches only (the ragged tail is dropped), as the JAX trainers loop.
"""

from __future__ import annotations

from typing import Callable, Iterator

import numpy as np
import torch

from real_time_fraud_detection_system_tpu_torch.utils import tree


class Adam:
    """Adam over every tensor leaf of ``params`` (a pytree in the JAX
    forms, ``utils/tree.py``). The caller's tensors are copied, never
    marked as requiring grad."""

    def __init__(self, params, learning_rate: float):
        self._skeleton = params
        self.leaves = [t.detach().clone().requires_grad_(True)
                       for t in tree.leaves(params)]
        self._opt = torch.optim.Adam(self.leaves, lr=learning_rate,
                                     betas=(0.9, 0.999), eps=1e-8)

    @property
    def params(self):
        """The current params, detached (they share the leaves' storage:
        clone before the next :meth:`step` to keep them)."""
        return tree.unflatten(self._skeleton,
                              [t.detach() for t in self.leaves])

    def step(self, loss_fn: Callable, *args) -> torch.Tensor:
        """One update from the gradient of ``loss_fn(params, *args)``;
        returns the loss (detached, not read back: no host sync). A leaf
        the loss does not read gets no gradient and no update, as a zero
        gradient leaves it under ``optax.adam``."""
        self._opt.zero_grad(set_to_none=True)
        with torch.enable_grad():
            loss = loss_fn(tree.unflatten(self._skeleton, self.leaves),
                           *args)
            loss.backward()
        self._opt.step()
        return loss.detach()


def epoch_batches(n: int, batch_size: int, epochs: int, seed: int,
                  device) -> Iterator[torch.Tensor]:
    """Row indices of each minibatch on ``device``: a fresh permutation
    from ``np.random.default_rng(seed)`` per epoch, cut into full batches
    of ``batch_size`` (one host-to-device copy per epoch)."""
    rng = np.random.default_rng(seed)
    for _ in range(epochs):
        perm = torch.as_tensor(rng.permutation(n), device=device)
        for s in range(0, n - batch_size + 1, batch_size):
            yield perm[s:s + batch_size]
