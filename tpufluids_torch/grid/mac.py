"""The staggered (MAC) grid option of ``tpufluids.grid.mac`` is not
ported yet; its entry points raise NotImplementedError."""

from tpufluids_torch.grid.stam import _not_ported


def make_mac3d(*args, **kwargs):
    raise _not_ported("the MAC grid option", "MAC grid")


def run3d_python(*args, **kwargs):
    raise _not_ported("the MAC grid option", "MAC grid")
