"""Random weights made on the card from a seed, in a few large draws.

``make_weights(specs, seed, device)`` fills every entry of a state_dict
description (``specs``: name -> (shape, dtype), in the module's order) by a
rule read from its name, with one normal and one uniform draw from a
``torch.Generator`` on ``device`` for the whole model, then cast to each
entry's dtype (the dtype it is served or trained in). The same seed and specs
give the same tensors, so the program and the plain reference are handed the
same weights.

The rules are the JAX model's initializers (the port's ``random_params`` and
``random_caption_params`` draw the same distributions on the host):
normal(initializer_range) for matrices and embeddings, zero biases, unit
LayerNorm and BatchNorm scales; in the ResNet grid, convolutions and ``fc``
normal(fan_in^-1/2), running means normal(0, 0.1), running variances
uniform(0.5, 1.5), the location table normal(0.02); the gates 0.1.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import torch

Specs = List[Tuple[str, Tuple[int, ...], torch.dtype]]


def specs_of(module: torch.nn.Module) -> Specs:
    """The state_dict description of a module: names, shapes, dtypes."""
    return [(k, tuple(v.shape), v.dtype)
            for k, v in module.state_dict().items()]


def _rule(name: str, shape: Tuple[int, ...], std: float):
    """(kind, parameter) for one entry: ("normal", std), ("const", value)
    or ("uniform", (lo, hi))."""
    leaf = name.rsplit(".", 1)[-1]
    if name.endswith("attention_gate"):
        return "const", 0.1
    if leaf == "running_mean":
        return "normal", 0.1
    if leaf == "running_var":
        return "uniform", (0.5, 1.5)
    if ".image_model." in "." + name:
        if leaf == "location_embedding":
            return "normal", std
        if len(shape) == 4:                       # a convolution, OIHW
            return "normal", (shape[1] * shape[2] * shape[3]) ** -0.5
        if name.endswith("fc.weight"):
            return "normal", shape[1] ** -0.5
        if leaf == "weight":                      # a BatchNorm scale
            return "const", 1.0
        return "const", 0.0
    if "LayerNorm" in name:
        return "const", 1.0 if leaf == "weight" else 0.0
    if leaf == "bias":
        return "const", 0.0
    if leaf == "weight" and len(shape) == 2:
        return "normal", std
    raise ValueError(f"no initializer rule for {name} {shape}")


def make_weights(specs: Specs, seed: int, device,
                 std: float = 0.02) -> Dict[str, torch.Tensor]:
    rules = [(name, shape, dtype, *_rule(name, shape, std))
             for name, shape, dtype in specs]

    def numel(shape):
        n = 1
        for d in shape:
            n *= d
        return n

    n_normal = sum(numel(s) for _, s, _, kind, _ in rules if kind == "normal")
    n_uniform = sum(numel(s) for _, s, _, kind, _ in rules
                    if kind == "uniform")
    gen = torch.Generator(device=device).manual_seed(int(seed))
    normal = torch.randn(n_normal, generator=gen, device=device)
    uniform = torch.rand(max(n_uniform, 1), generator=gen, device=device)
    out, i, j = {}, 0, 0
    for name, shape, dtype, kind, arg in rules:
        n = numel(shape)
        if kind == "normal":
            t = normal[i:i + n].view(shape) * arg
            i += n
        elif kind == "uniform":
            lo, hi = arg
            t = uniform[j:j + n].view(shape) * (hi - lo) + lo
            j += n
        else:
            t = torch.full(shape, arg, dtype=torch.float32, device=device)
        out[name] = t.to(dtype)
    return out
