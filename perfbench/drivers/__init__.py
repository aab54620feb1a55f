"""App drivers, one module per kind of job, found by the ``driver`` name
of a traffic file.  Each gives:

* ``inputs(cfg, traffic, seed, device)``: the cell's inputs, drawn on the
  device from the seed (the configuration's generator);
* ``build(inp, traffic, device)``: the program's graph (timed as
  ``graph_build_s``);
* ``job(system, inp, traffic, i)``: one job through the program's app
  entry, an :class:`~perfbench.harness.Out` (``i = -1``: the warm-up);
* ``end_to_end(jobs, window_s)``: ``{metric: (value, unit)}``;
* ``check(inp, kept, traffic, seed, device)``: readings ``(answer, name,
  value)`` of the kept answers against the plain reference;
* ``control(inp, traffic, seed, device, dtype)``: the same readings with
  the reference, in ``dtype``, in the program's place; ``CONTROL_DTYPE``
  names that precision, the step below the configured one.
"""
