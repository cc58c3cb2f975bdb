"""ffmpeg_ht_tpu_torch — the HTJ2K decoder in PyTorch + CUDA.

A second package beside ``ffmpeg_ht_tpu`` (JAX/Pallas, the reference),
and independent of it. The framework-free host tier is the port's own
copy of the reference's, kept verbatim apart from its imports:
``codestream/`` (markers, parse, T2), ``utils/native`` with the C sources
under ``native/`` (built with ``cc`` into ``build/ffmpeg_ht_tpu_torch/``
at first use), stream prep (``ops/ht_batch``), the scalar oracles
(``ops/ht_dec``, ``ops/ebcot``, ``ops/dwt``, ``ops/dequant``,
``ops/mct``), ``models/host_decoder``, ``models/pixfmt``, the flat fast
lane's host half (``models/fastpath``), the assembly plan, and the
encoder (``models/encoder`` with ``ops/{ht_enc,t1_enc,mq_enc}`` and
``codestream/t2_enc``). The device program:

- ``ops/ht_scan``: HT cleanup decode over every codeblock of a frame in
  two hand-written CUDA kernels, ``csrc/ht_vlc_pass.cu`` (MEL, CxtVLC,
  U-VLC) and ``csrc/ht_magsgn_pass.cu`` (MagSgn, a warp per codeblock);
  plain torch versions for CPU tensors;
- ``ops/dwt_torch``: band-direct polyphase inverse 5/3 DWT (torch ops);
- ``ops/mct_cuda``: inverse RCT + DC shift + clip + narrow pack (CUDA
  kernel ``csrc/rct_writeframe.cu``; plain torch version for CPU);
- ``models/assembly``: the fused v3 program (dequant, prefill scatter,
  band mosaics, DWT, MCT, packed output with the ok flag);
- ``models/decoder``: ``Decoder(device=...)`` with ``decode``,
  ``decode_async`` and ``decode_stream``.

The package imports neither ``jax`` nor ``ffmpeg_ht_tpu``.
"""

__version__ = "0.1.0"

from ffmpeg_ht_tpu_torch.utils.errors import InvalidData, PatchWelcome  # noqa: F401
