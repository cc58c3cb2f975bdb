"""A frozen copy of the port's encoder, the benchmark's traffic generator.

``models/encoder.py`` (``encode_frame_htj2k``) and the modules it
imports, copied from ``ffmpeg_ht_tpu_torch`` at the same paths with only
their imports rewritten (and comments that cite ffmpeg's sources by
their place in its tree), and cut to what a one-layer HT cleanup encode
runs: no refinement passes, quality layers, ROI, POC, MIXED set,
tile-part splits or packed headers, and none of the decoder's side.
``native/htenc.c`` is built by ``utils/native.py`` into
``build/htbench/libhtenc.so``. A later change to the port's encoder
does not change the streams the benchmark decodes:
``htbench/tests/test_htbench_frozen.py`` pins the bytes of a lossless
and a lossy stream.
"""
