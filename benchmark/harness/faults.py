"""Faults planted under the timed path, for the tests that show each one
turns ``correct`` false. No benchmark run plants one.

  * serving ``answer``: every request gets its batch neighbour's image;
  * serving ``half``: half of each batch is stylized, and its images
    answer the other half too;
  * training ``unchanged``: the step computes its loss and gradients and
    hands the state back unchanged;
  * training ``half``: the step takes half of the batch, its mean over the
    rest.
"""

from __future__ import annotations

import torch

SERVE = ("answer", "half")
TRAIN = ("unchanged", "half")


def serve(run_impl, fault: str):
    if fault not in SERVE:
        raise ValueError(f"unknown serving fault {fault!r}")

    def run(content, style):
        n = content.shape[0]
        if fault == "answer":
            return torch.roll(run_impl(content, style), 1, dims=0)
        k = max(1, n // 2)
        y = run_impl(content[:k], style[:k])
        return torch.cat([y] * (n // k + 1))[:n]
    return run


def train(step, fault: str):
    if fault not in TRAIN:
        raise ValueError(f"unknown training fault {fault!r}")

    def run(state, vgg, content, style):
        if fault == "half":
            k = max(1, content.shape[0] // 2)
            return step(state, vgg, content[:k], style[:k])
        before = [p.detach().clone() for p in state.model.parameters()]
        out = step(state, vgg, content, style)
        with torch.no_grad():
            for p, old in zip(state.model.parameters(), before):
                p.copy_(old)
        state.bundle.weights_changed()
        return out
    return run
