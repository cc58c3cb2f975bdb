"""The benchmark of ``ffmpeg_ht_tpu_torch`` on NVIDIA cards.

One command runs one cell of ``BENCHMARK.json`` once and prints one JSON
line::

    python -m htbench.run --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

Everything that belongs to one configuration, traffic mix or metric is a
file of its own, found by the name ``BENCHMARK.json`` gives it:

- ``configs/<config>.json``: geometry, encoder and ``Decoder`` arguments,
  the reference that judges its frames, its source;
- ``traffic/<mix>.json``: the entry the window drives, the frames a call,
  the distinct frames K, the content kind and its parameters;
- ``content/<kind>.py``: the seeded source generator of a content kind;
- ``references/<name>.py``: the plain reference of a configuration;
- ``end_to_end/<metric>.py`` and ``layers/<metric>.py``: the readers of
  the end-to-end and per-layer metrics;
- ``spans/<label>.json``: the program functions a traced run wraps to
  time one host span.

``frozen/`` is a copy of the port's encoder, the traffic generator, so
that what is decoded does not change when the port's encoder does. No
module here imports ``jax``, ``jaxlib`` or ``ffmpeg_ht_tpu``; the
program is imported only inside the functions that run it.
"""
