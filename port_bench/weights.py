"""Seeded weights, made on the device in one call and shared by the
program and the reference."""

from __future__ import annotations

import torch

STD = 0.02  # every parameter N(0, STD), as the port's tests and tools draw them


def generator(seed: int, device) -> torch.Generator:
    """A generator on `device` seeded with `seed` (any whole number below 2**64)."""
    return torch.Generator(device=device).manual_seed(int(seed) % 2**64)


@torch.no_grad()
def make_weights(shapes: dict, seed: int, device) -> dict:
    """{name: tensor} for the state-dict `shapes` ({name: (shape, dtype)}):
    one normal draw on `device` split over the parameters in name order;
    BatchNorm running means 0 and variances 1 (a random variance could be
    negative)."""
    names = sorted(shapes)
    params = [n for n in names if not n.endswith(("running_mean", "running_var"))]
    total = sum(torch.Size(shapes[n][0]).numel() for n in params)
    flat = torch.randn(total, generator=generator(seed, device), device=device) * STD
    out, at = {}, 0
    for n in params:
        shape, dtype = shapes[n]
        k = torch.Size(shape).numel()
        out[n] = flat[at:at + k].view(shape).to(dtype)
        at += k
    for n in names:
        if n.endswith("running_mean"):
            out[n] = torch.zeros(shapes[n][0], dtype=shapes[n][1], device=device)
        elif n.endswith("running_var"):
            out[n] = torch.ones(shapes[n][0], dtype=shapes[n][1], device=device)
    return out


def state_shapes(model: torch.nn.Module) -> dict:
    """{name: (shape, dtype)} of a model's state dict (a meta model will do)."""
    return {k: (tuple(v.shape), v.dtype) for k, v in model.state_dict().items()}
