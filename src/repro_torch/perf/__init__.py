"""Performance tools (port of ``repro.perf``, the part ported so far):
:mod:`repro_torch.perf.timeline`, the replay-diff of two ``--trace``
exports, run as ``python -m repro_torch.perf.timeline a.json b.json``.
It is not imported here: importing a ``python -m`` entry point from its
package's ``__init__`` makes runpy warn."""
