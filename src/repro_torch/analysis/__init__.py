"""Cost analysis of the port's steps (port of ``repro.analysis``): the
op-by-op counter ``op_cost`` (in place of the HLO parsers ``hlo`` and
``hlo_cost``), the three-term ``roofline`` at the H100's datasheet rates,
and ``report``, which tabulates the dry run's artifacts."""
