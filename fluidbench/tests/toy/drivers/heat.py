"""The toy cell's driver, for the harness's own tests: one scalar field
diffused by implicit steps of the port's plain Jacobi solve
(``tpufluids_torch.grid.stam.lin_solve3d``), ``frame_steps`` steps a
frame, the first and the last frame checked against the configuration's
reference.  It reports no residual and no frame tail: its check is
``heat_gap``, its faults are its own."""

import json

import torch

from fluidbench import common

CHECKS = ("heat_gap",)
FAULTS = ("unchanged", "value_altered")


def keywords(config: dict, traffic: dict, overrides=None) -> dict:
    return {**config["heat"], **traffic["heat"], **(overrides or {})}


def seed_field(n: int, seed: int, device) -> torch.Tensor:
    gen = torch.Generator(device=device)
    gen.manual_seed(seed % 2 ** 64)
    return torch.rand((n + 2,) * 3, generator=gen, device=device)


def advance(x, kw: dict, steps: int):
    """The program: ``steps`` implicit steps in ``kw["dtype"]``."""
    from tpufluids_torch.grid import stam
    a = kw["rate"]
    for _ in range(steps):
        x = stam.lin_solve3d(0, x, x, a, 1 + 6 * a, kw["iters"],
                             dtype=getattr(torch, kw["dtype"]))
    return x


def gap(got, want) -> float:
    return float((got - want).abs().max() / want.abs().max())


class Sim:
    def __init__(self, config, traffic, limits, seed, device,
                 overrides=None):
        self.kw = keywords(config, traffic, overrides)
        self.reference = common.module("reference", config["reference"])
        self.frame_steps = traffic["frame_steps"]
        self.trace_frames = traffic["trace_frames"]
        self.updates_per_frame = self.kw["n"] ** 3 * self.frame_steps
        self.limit = limits["heat_gap"]
        self.x = seed_field(self.kw["n"], seed, device)
        self.frames = {}          # checked frame -> (input, output)
        self.frame = 0
        self.detail = []          # (frame, gap)

    def warmup(self):
        advance(self.x.clone(), self.kw, 1)

    def enqueue(self):
        before, self.x = self.x, advance(self.x, self.kw, self.frame_steps)
        return before, self.x

    def read(self, handle) -> float:
        value = float(handle[1].sum())
        if self.frame == 0:
            self.frames[0] = handle
        self.last = (self.frame, handle)
        self.frame += 1
        return value

    def counters(self) -> dict:
        return {}

    def release(self):
        self.x = None

    def check(self) -> list:
        self.frames[self.last[0]] = self.last[1]
        for i, (before, after) in sorted(self.frames.items()):
            want = self.reference.run(before.clone(), self.kw,
                                      self.frame_steps)
            self.detail.append((i, gap(after, want)))
        worst = max(g for _, g in self.detail)
        return [("heat_gap", worst, self.limit)]

    def failed_frames(self) -> int:
        return sum(not g <= self.limit for _, g in self.detail)

    def describe(self) -> list:
        return [f"frame {i}: heat gap {g:.6e}" for i, g in self.detail]


def setup(config, traffic, limits, seed, device, overrides=None) -> Sim:
    return Sim(config, traffic, limits, seed, device, overrides)


def small(config, traffic, limits, n):
    config = json.loads(json.dumps(config))
    config["heat"]["n"] = n
    return config, traffic, limits


def follows_reference(config, traffic, n, seed):
    config, traffic, _ = small(config, traffic, None, n)
    kw = keywords(config, traffic)
    x = seed_field(n, seed, "cpu")
    want = common.module("reference", config["reference"]).run(
        x.clone(), kw, traffic["frame_steps"])
    return gap(advance(x, kw, traffic["frame_steps"]), want), 0.0, 0.0


def plant(name: str):
    """Put fault ``name`` under the port's lin_solve3d: the solve returns
    its guess unchanged, or moves one cell by 1% of the field's max."""
    from tpufluids_torch.grid import stam
    real = stam.lin_solve3d

    def altered(*args, **kw):
        out = real(*args, **kw)
        out[3, 4, 5] += 0.01 * float(out.abs().max())
        return out
    stam.lin_solve3d = {"unchanged": lambda b, x, *args, **kw: x,
                        "value_altered": altered}[name]

    def restore():
        stam.lin_solve3d = real
    return restore
