"""The 3D grid cells: one simulation of tpufluids_torch.grid.stam run in
frames, closed loop.

A frame is one call of ``stam.run3d_python(state, cfg, frame_steps)``;
the harness then reads that frame's Poisson residual, the one host sync
of a frame.  The driver makes the scene from the seed, keeps what the
check needs (the seed state, and the input and output of the first
frame, of one frame drawn from the seed and of the last frame) and,
after the window, runs the configuration's reference (reference/<its
"reference">.py) over each of those frames from the same input and
compares.  The faults are faults.py's."""

from __future__ import annotations

import dataclasses
import json
import math
import random

import torch

from fluidbench import common, faults
from fluidbench.reference import stam3d

FIELDS = stam3d.FIELDS
CHECKS = ("field_gap", "residual_gap")
FAULTS = tuple(f.__name__ for f in faults.ALL)
plant = faults.plant


def grid_keywords(config: dict, traffic: dict, overrides=None) -> dict:
    """The StamConfig keywords of a cell: the configuration's, then the
    traffic's, then ``overrides`` (a control's lower-precision path)."""
    return {**config["stam"], **traffic["stam"], **(overrides or {})}


def seed_state(config: dict, kw: dict, seed: int, device) -> dict:
    """The scene as five ghosted float32 fields: velocities uniform in
    +-velocity_cells_per_step cells a step drawn on the device from the
    seed in one call, set_bnd per component; dens and temp constant in
    the configuration's blob (interior indices, ghosts by set_bnd)."""
    n, scene = kw["n"], config["scene"]
    gen = torch.Generator(device=device)
    gen.manual_seed(seed % 2 ** 64)
    vmax = scene["velocity_cells_per_step"] / (kw["dt"] * n)
    vel = torch.rand((3,) + (n + 2,) * 3, generator=gen, device=device,
                     dtype=torch.float32)
    vel = vel.mul_(2.0 * vmax).sub_(vmax)
    state = {f: stam3d.set_bnd(b, vel[b - 1].clone())
             for b, f in ((1, "u"), (2, "v"), (3, "w"))}
    box = tuple(slice(*scene["blob"][a]) for a in "xyz")
    for f in ("dens", "temp"):
        q = torch.full((n + 2,) * 3, kw.get("ambient_temp", 0.0) if f == "temp"
                       else 0.0, dtype=torch.float32, device=device)
        q[box] = scene[f]
        state[f] = stam3d.set_bnd(0, q)
    return state


def gaps(got: dict, want: dict) -> float:
    """The widest field gap: max over the fields of max|got - want| over
    max|want|.  NaN where either side is not finite."""
    worst = 0.0
    for f in FIELDS:
        g, w = got[f], want[f]
        if not (bool(torch.isfinite(g).all())
                and bool(torch.isfinite(w).all())):
            return float("nan")
        scale = max(float(w.abs().max()), 1e-30)
        worst = max(worst, float((g - w).abs().max()) / scale)
    return worst


class Sim:
    """One simulation of a cell, from set-up to the check."""

    def __init__(self, config: dict, traffic: dict, limits: dict, seed: int,
                 device, overrides=None):
        from tpufluids_torch.grid import kernels, stam
        self.stam_mod, self.kernels = stam, kernels
        self.kw = grid_keywords(config, traffic, overrides)
        self.cfg = stam.StamConfig(**self.kw)
        self.frame_steps = traffic["frame_steps"]
        self.warmup_steps = traffic["warmup_steps"]
        self.trace_frames = traffic["trace_frames"]
        self.limits = limits
        self.reference = common.module("reference", config["reference"])
        self.updates_per_frame = self.kw["n"] ** 3 * self.frame_steps
        self.inputs = seed_state(config, self.kw, seed, device)
        # the frame drawn from the seed whose input and output are kept
        self.sampled = random.Random(seed).randint(
            1, traffic["check_frame_max"])
        self.kept = {}                     # frame -> (input, output, res)
        self.state = stam.GridState3D(
            **{f: t.clone() for f, t in self.inputs.items()})
        self.frame = 0
        self.nonfinite = 0       # frames whose residual is not finite
        self._pending = self.last = None
        # (frame, field gap, residual gap, residual, the reference's)
        self.detail = []

    @staticmethod
    def _fields(state) -> dict:
        return {f: getattr(state, f) for f in FIELDS}

    def warmup(self):
        """The cell's own shapes, through the window's own call, on a
        copy of the seed state: its kernels loaded, its products' plans
        made."""
        state = self.stam_mod.GridState3D(
            **{f: t.clone() for f, t in self.inputs.items()})
        _, res = self.stam_mod.run3d_python(state, self.cfg,
                                            self.warmup_steps)
        float(res[0])

    def enqueue(self):
        """Queue one frame on the device; returns its residual tensor."""
        before = self.state
        self.state, res = self.stam_mod.run3d_python(self.state, self.cfg,
                                                     self.frame_steps)
        self._pending = (self.frame, before, self.state)
        return res

    def read(self, res) -> float:
        """The frame's residual on the host: the frame's one sync."""
        value = float(res.reshape(-1)[0])
        self.nonfinite += not math.isfinite(value)
        i, before, after = self._pending
        if i in (0, self.sampled):
            self.kept[i] = (self._fields(before), self._fields(after), value)
        self.last = (i, self._fields(before), self._fields(after), value)
        self.frame += 1
        return value

    def counters(self) -> dict:
        return self.kernels.launch_counts()

    def release(self):
        """Drop the program's state; what the check needs stays."""
        self.state = self._pending = None

    def check(self) -> list:
        """The numbers compared, each (name, value, limit): the widest
        field gap and residual gap of the checked frames (the first, the
        one drawn from the seed if the window reached it, the last)
        against the reference run from the same input, and the frames
        whose residual was not finite.  The residual gap is |residual -
        the reference's| over the reference's max|div|.  The first
        frame's input is the seed state as this module made it."""
        frames = dict(self.kept)
        if self.last is not None:
            frames[self.last[0]] = self.last[1:]
        if 0 in frames:
            frames[0] = (self.inputs, *frames[0][1:])
        self.last, self.kept = None, {}
        field_gap = residual_gap = 0.0 if frames else float("nan")
        kw = {f.name: getattr(self.cfg, f.name)
              for f in dataclasses.fields(self.cfg)}
        for i in sorted(frames):
            before, after, res = frames.pop(i)
            want, want_res, want_div = self.reference.run(
                {f: t.clone() for f, t in before.items()}, kw,
                self.frame_steps)
            fg = gaps(after, want)
            rg = abs(res - want_res) / max(want_div, 1e-30)
            self.detail.append((i, fg, rg, res, want_res))
            field_gap = fg if fg != fg else max(field_gap, fg)
            residual_gap = rg if rg != rg else max(residual_gap, rg)
            del before, after, want
        return [("field_gap", field_gap, self.limits["field_gap"]),
                ("residual_gap", residual_gap, self.limits["residual_gap"]),
                ("nonfinite_frames", self.nonfinite, 0)]

    def failed_frames(self) -> int:
        """Frames that failed: a residual not finite, or a checked frame
        over a limit."""
        over = sum(not (fg <= self.limits["field_gap"]
                        and rg <= self.limits["residual_gap"])
                   for _, fg, rg, _, _ in self.detail)
        return self.nonfinite + over

    def describe(self) -> list[str]:
        """One line a checked frame: its gaps, its residual and the
        reference's."""
        return [f"frame {i}: field gap {fg:.6e}, residual gap {rg:.6e} "
                f"(residual {res:.6e}, reference {want:.6e})"
                for i, fg, rg, res, want in self.detail]


def setup(config: dict, traffic: dict, limits: dict, seed: int, device,
          overrides=None) -> Sim:
    return Sim(config, traffic, limits, seed, device, overrides)


def small(config: dict, traffic: dict, limits, n: int):
    """The cell at n^3: dt scaled as 0.5 / n where the configuration ties
    it to n, the blob scaled with the grid, a slice of two frames and
    the sampled frame among the first three; the limits as they are."""
    config = json.loads(json.dumps(config))
    full = config["stam"]["n"]
    if config["stam"]["dt"] * full == 0.5:
        config["stam"]["dt"] = 0.5 / n
    config["stam"]["n"] = n
    config["scene"]["blob"] = {
        a: [max(1, lo * n // full), max(2, hi * n // full)]
        for a, (lo, hi) in config["scene"]["blob"].items()}
    traffic = dict(traffic, trace_frames=2, check_frame_max=3)
    return config, traffic, limits


def follows_reference(config: dict, traffic: dict, n: int, seed: int):
    """One frame of the program on the CPU at n^3 against the
    configuration's reference from the same seed state: (the field gap,
    its tolerance, the residual gap).  The sweep solves agree bit for
    bit (tolerance 0), the DCT solve within float32 rounding (1e-5: the
    port splits and orders its transforms otherwise).  Raises
    ValueError where the reference leaves w at 0, since a scene that
    does not move compares nothing."""
    from tpufluids_torch.grid import stam
    config, traffic, _ = small(config, traffic, None, n)
    reference = common.module("reference", config["reference"])
    kw = grid_keywords(config, traffic)
    cfg = stam.StamConfig(**kw)
    inputs = seed_state(config, kw, seed, "cpu")
    steps = traffic["frame_steps"]
    got, res = stam.run3d_python(stam.GridState3D(
        **{f: t.clone() for f, t in inputs.items()}), cfg, steps)
    want, want_res, want_div = reference.run(
        {f: t.clone() for f, t in inputs.items()},
        dataclasses.asdict(cfg), steps)
    if not float(want["w"].abs().max()) > 0.0:
        raise ValueError("the reference left w at 0: the scene is still")
    gap = gaps({f: getattr(got, f) for f in FIELDS}, want)
    tol = 1e-5 if kw["projection"] == "dct" else 0.0
    return gap, tol, abs(float(res[0]) - want_res) / max(want_div, 1e-30)
