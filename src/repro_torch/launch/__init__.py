"""The dry run of the port (port of ``repro.launch``): the production
meshes over a fake process group (``mesh``), meta-tensor stand-ins for
every (arch x shape) cell (``specs``), the per-cell trace and artifact
(``dryrun``) and the one-cell probe (``perf_probe``)."""
