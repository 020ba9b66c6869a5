"""The toy cell's reference: plain implicit diffusion of one ghosted
float32 field, each step ``iters`` Jacobi sweeps of (x0 + a * the six
neighbours) / (1 + 6a) from x0, each sweep followed by copying the
faces into the ghosts (x, then y, then z)."""

import torch

_I = (slice(1, -1),) * 3


def _ghosts(x):
    x[0], x[-1] = x[1], x[-2]
    x[:, 0], x[:, -1] = x[:, 1], x[:, -2]
    x[:, :, 0], x[:, :, -1] = x[:, :, 1], x[:, :, -2]
    return x


def run(x0, kw, steps):
    """``steps`` steps of rate ``kw["rate"]`` from ``x0``; the result."""
    a = kw["rate"]
    c_inv = 1.0 / (1 + 6 * a)
    with torch.no_grad():
        for _ in range(steps):
            x = x0.clone()
            for _ in range(kw["iters"]):
                nb = (x[:-2, 1:-1, 1:-1] + x[2:, 1:-1, 1:-1]
                      + x[1:-1, :-2, 1:-1] + x[1:-1, 2:, 1:-1]
                      + x[1:-1, 1:-1, :-2] + x[1:-1, 1:-1, 2:])
                x[_I] = (x0[_I] + a * nb) * c_inv
                _ghosts(x)
            x0 = x
    return x0
