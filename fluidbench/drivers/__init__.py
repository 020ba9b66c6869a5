"""The drivers: one module a kind of configuration, named by the
configuration file's "driver" key and loaded by ``common.module``.

A driver holds everything of a cell that depends on what the cell runs,
so that run.py, calibrate.py and the tests ask the driver and a new
kind of configuration enters with new files only.  A driver module
gives:

``setup(config, traffic, limits, seed, device, overrides=None) -> Sim``
    the cell's simulation, its inputs made from the seed; ``overrides``
    switch the program onto another path (a control's lower precision,
    from the limits file's "control").
``CHECKS``
    the names of the numbers that ``Sim.check`` holds against a limit
    from the cell's limits file, which holds each of them and "control".
``small(config, traffic, limits, n) -> (config, traffic, limits)``
    the cell cut to n^3, or to the driver's own small size, for the
    tests on the CPU.
``follows_reference(config, traffic, n, seed) -> (gap, tolerance,
residual_gap)``
    the program against the configuration's reference on the CPU at
    that small size: the widest gap of what the program produced, the
    tolerance it is held to, and the gap of the scalar it reports beside
    (a residual; 0 where there is none), held to the tolerance or 1e-6,
    whichever is larger.
``FAULTS``, ``plant(name) -> restore``
    the names of the faults the cell can have, and the function that
    puts one under the timed path and returns the one that takes it out.

The configuration file names its reference, plain code that imports
nothing of the program: "reference" is ``reference/<name>.py``.

A ``Sim`` has ``frame_steps``, ``trace_frames`` (the counted frames of a
traced slice), ``updates_per_frame`` and ``kw`` (what the per-layer
readers read the cell's sizes from, as ``trace.Slice.stam``), and the
methods ``warmup()``, ``enqueue() -> handle`` (queue one frame),
``read(handle)`` (the frame's one sync), ``counters()`` (the program's
launch counts), ``release()`` (drop the program's state), ``check() ->
[(name, value, limit)]`` (after the window), ``failed_frames()`` and
``describe()`` (one line a checked frame, for standard error).
"""
