"""ffmpeg_ht_tpu_torch — the HTJ2K decoder in PyTorch + CUDA.

A second package beside ``ffmpeg_ht_tpu`` (JAX/Pallas, the reference),
and independent of it. The framework-free tiers are the port's own copy
of the reference's, kept verbatim apart from their imports:
``codestream/`` (markers, parse, T2, profiles), ``containers/`` (J2C,
JP2, MJ2 and MXF probe / demux / mux; framecrc, framemd5, rawvideo),
``utils/native`` with the C sources under ``native/`` (built with ``cc``
into ``build/ffmpeg_ht_tpu_torch/`` at first use), stream prep
(``ops/ht_batch``), the scalar oracles (``ops/ht_dec``, ``ops/ebcot``,
``ops/dwt``, ``ops/dequant``, ``ops/mct``), ``models/host_decoder``,
``models/pixfmt``, ``models/swscale``, the host halves of
``models/fastpath`` (v3 lanes, v2 buckets) and of ``ops/wirepack``, the
assembly plan, and the encoder (``models/encoder`` with
``ops/{ht_enc,t1_enc,mq_enc}`` and ``codestream/t2_enc``). The device
tier, each hand kernel in ``csrc/`` (CUDA C++ for ``sm_90a``, built by
``utils/build`` with nvcc at first use) beside a plain torch version
that CPU tensors take:

- ``ops/ht_scan``: HT cleanup, ``csrc/ht_vlc_pass.cu`` (MEL, CxtVLC,
  U-VLC) then ``csrc/ht_magsgn_pass.cu`` (MagSgn, a warp per codeblock);
- ``ops/ht_refine``: SigProp then MagRef, ``csrc/ht_refine.cu``;
- ``ops/dwt_torch``: inverse 5/3, integer 9/7 and float 9/7 DWT,
  band-direct or flat (torch ops);
- ``ops/mct_cuda``: RCT or ICT + DC shift + clip + narrow pack,
  ``csrc/rct_writeframe.cu`` and ``csrc/ict_writeframe.cu``;
- ``ops/wirepack``: the bit-pack of 9..15-bit output into words,
  ``csrc/wire_pack.cu``;
- ``models/assembly``: the v3 fused program and the v2 bucketed program;
- ``models/decoder``: ``Decoder(device, bitexact, reduction_factor,
  max_layers, wire_pack)`` with ``decode``, ``decode_async``,
  ``decode_stream``, ``decode_batch`` (``devices=[...]`` shards the
  frame axis over several devices, ``require_shard`` raises
  ``UnshardableBatch`` when it cannot) and ``bench_resident``, and the
  one-shot ``decode_frame_cuda``;
- ``utils/trace``: spans and counters of the decoder's host path, off
  until ``enable()``;
- ``cli``: the ``jxt-torch`` tool (``decode``, ``encode``, ``probe``;
  ``--device``), also ``python -m ffmpeg_ht_tpu_torch.cli``.

The package imports neither ``jax`` nor ``ffmpeg_ht_tpu``.
"""

__version__ = "0.1.0"

from ffmpeg_ht_tpu_torch.utils.errors import InvalidData, PatchWelcome  # noqa: F401
