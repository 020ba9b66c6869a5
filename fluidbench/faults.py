"""The grid driver's faults (drivers/grid3d.py gives them as FAULTS and
plant), planted under the timed path, for the tests that show the check
fails them and for calibrate.py's readings of them on the card.  Each
takes the program's ``run3d_python`` and returns a broken one."""

import torch


def unchanged(real):
    """Every frame returns its state unchanged."""
    return lambda s, cfg, n: (s, torch.zeros(1, device=s.u.device))


def step_skipped(real):
    """Every frame runs one step fewer than asked."""
    return lambda s, cfg, n: real(s, cfg, n - 1)


def half_left_out(real):
    """The upper half of the grid in x keeps the frame's input."""
    def broken(s, cfg, n):
        out, res = real(s, cfg, n)
        for f in ("u", "v", "w", "dens", "temp"):
            half = getattr(s, f).shape[0] // 2
            getattr(out, f)[half:] = getattr(s, f)[half:]
        return out, res
    return broken


def value_altered(real):
    """One cell of u moved by 1% of max|u| where the frame produces it."""
    def broken(s, cfg, n):
        out, res = real(s, cfg, n)
        out.u[5, 6, 7] += 0.01 * float(out.u.abs().max())
        return out, res
    return broken


def residual_lost(real):
    """The frame's residual is not a number."""
    def broken(s, cfg, n):
        out, res = real(s, cfg, n)
        return out, torch.full_like(res, float("nan"))
    return broken


ALL = (unchanged, step_skipped, half_left_out, value_altered, residual_lost)


def plant(name: str):
    """Put fault ``name`` under tpufluids_torch.grid.stam.run3d_python;
    returns a function that takes it out again."""
    from tpufluids_torch.grid import stam
    real = stam.run3d_python
    stam.run3d_python = {f.__name__: f for f in ALL}[name](real)

    def restore():
        stam.run3d_python = real
    return restore
