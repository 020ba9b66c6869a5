"""I/O: checkpoints (``checkpoint``), legacy-VTK export with visit_writer
parity (``vtk``, and the C++ writer ``native``), and the background
snapshot writer (``snapshots``)."""
