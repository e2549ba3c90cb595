"""Frozen copy of the program's `true_div` (IEEE division on any device)."""

import torch


def true_div(a, b):
    """IEEE `a / b` elementwise: a Python-number operand is made a tensor
    on the other's device first, so PyTorch takes no reciprocal shortcut."""
    if not isinstance(a, torch.Tensor):
        a = torch.full_like(b, a)
    if not isinstance(b, torch.Tensor):
        b = torch.full_like(a, b)
    return torch.div(a, b)
