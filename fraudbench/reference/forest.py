"""Plain reference of the forest's score: standardize the 15 features
(``(x - mean) / scale``), descend each tree from its root (left iff
``x[feature] <= threshold``) to a leaf, and average the leaves'
probabilities over the trees. Plain PyTorch; nothing of the program.

``dtype`` is the precision of the features, the standardization and the
comparisons: float32 as the configuration states, or bfloat16 for the
control."""

from __future__ import annotations

import torch


def forest_probs(x: torch.Tensor, mean: torch.Tensor, scale: torch.Tensor,
                 trees: dict, dtype=torch.float32,
                 block: int = 1 << 16) -> torch.Tensor:
    """float64 [n] probabilities of the rows of ``x`` ([n, F]);
    ``trees`` holds ``feat``, ``thresh``, ``left``, ``right``, ``prob``
    ([T, N] each) and ``max_depth``."""
    feat = trees["feat"].long()
    thresh = trees["thresh"].to(dtype)
    left, right = trees["left"].long(), trees["right"].long()
    prob = trees["prob"].to(torch.float64)
    n_trees = feat.shape[0]
    t = torch.arange(n_trees, device=x.device)[None, :]
    out = []
    for s in range(0, x.shape[0], block):
        xs = (x[s:s + block].to(dtype) - mean.to(dtype)) / scale.to(dtype)
        node = torch.zeros((xs.shape[0], n_trees), dtype=torch.int64,
                           device=x.device)
        for _ in range(int(trees["max_depth"])):
            v = torch.gather(xs, 1, feat[t, node])
            node = torch.where(v <= thresh[t, node], left[t, node],
                               right[t, node])
        out.append(prob[t, node].sum(1) / n_trees)
    return torch.cat(out)
