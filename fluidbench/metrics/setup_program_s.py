"""setup_program_s (s): the host seconds of the warm-up's grid.frame
span, the set-up's share that only the program can shorten: the kernel
library's load (kernels.load), each kernel's first launch, the DCT
tables and the matrix products' plans.  Source: the program's spans.
Layer: set-up.  Moves setup_s."""


def read(tr):
    p = getattr(tr, "program", None)
    return None if p is None else p.setup_frame_s
