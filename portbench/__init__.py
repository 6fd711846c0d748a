"""The benchmark of the PyTorch / CUDA port (``audio_raytracing_studio_tpu_torch``).

``python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>``
runs one cell of ``BENCHMARK.json`` once and prints one JSON result line.

Everything a cell needs is found by name: its configuration in
``configs/<config>.json``, its traffic mix in ``traffic/<traffic>.json``
(which names the generator module under ``traffic/`` that drives it), its
per-layer metrics in ``metrics/<metric>.py`` and the limits of its
correctness check in ``limits/<workload>.json``.  A cell's ``correct`` is
decided by the plain float64 reference that its configuration names under
``"reference"``: the module ``reference/<name>.py`` (``render``, the
internal hall, by default), with ``render_row`` and, where a batch needs
more than clips, ``batch_inputs``, the extra keywords of ``render_batch``.
A reference imports nothing of the program.
"""
