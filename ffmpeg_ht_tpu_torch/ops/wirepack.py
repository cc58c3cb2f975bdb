"""Wire bit-packing for the device->host output fetch (counterpart of
``ffmpeg_ht_tpu.ops.wirepack``).

The decode programs ship one flat uint16 buffer per launch (held as int16
bits) whose last element is the ok flag. For 9..15-bit content that
format wastes 7..1 bits a sample; ``Decoder(wire_pack=True)`` bit-packs
it on the device so the fetch moves depth/16 of the bytes, at the cost of
``unpack_words`` on the host.

Scheme: groups of 32 samples pack into `depth` uint32 words (32*depth
bits exactly), LSB first: sample i of a group fills bits [i*depth,
(i+1)*depth) of the group's bit string. The tail group is padded with
zeros. Words travel as int32 tensors holding uint32 bits (torch's uint32
lacks shifts and ors).

The host half (``GROUP``, ``packed_words_len``, ``unpack_words``,
``wire_shape``) is copied verbatim from the reference module. The device
half, ``pack_words``, launches ``csrc/wire_pack.cu`` for a CUDA tensor
and takes the plain version ``pack_words_ref`` (int64 masked to 32 bits)
for a CPU tensor.
"""

from typing import Tuple

import numpy as np
import torch

from ffmpeg_ht_tpu_torch.utils import build

GROUP = 32


def packed_words_len(n_samples: int, depth: int) -> int:
    """uint32 word count for `n_samples` samples at `depth` bits."""
    ngroups = -(-n_samples // GROUP)
    return ngroups * depth


def _as_int32(w):
    """int64 values in [0, 2**32) -> int32 tensors of the same bits."""
    return (w - ((w & 0x80000000) << 1)).to(torch.int32)


def pack_words_ref(flat, depth: int):
    """Plain PyTorch pack: 1-D unsigned samples (int16 holding uint16
    bits, or any wider integer type) -> int32 words holding the uint32
    words of the reference ``pack_words``, in its op order."""
    n = flat.shape[0]
    ngroups = -(-n // GROUP)
    s = flat.to(torch.int64)
    if flat.dtype == torch.int16:
        s = s & 0xFFFF
    s = torch.cat([s, s.new_zeros(ngroups * GROUP - n)]).view(ngroups, GROUP)
    words = [None] * depth
    for i in range(GROUP):
        off = i * depth
        lo, sh = off // 32, off % 32
        col = s[:, i]
        part = (col << sh) & 0xFFFFFFFF if sh else col
        words[lo] = part if words[lo] is None else (words[lo] | part)
        if sh + depth > 32:
            spill = col >> (32 - sh)
            words[lo + 1] = spill if words[lo + 1] is None \
                else (words[lo + 1] | spill)
    return _as_int32(torch.stack(words, dim=1).reshape(-1))


def pack_words(packed, depth: int):
    """The wire form of a decode program's output (8 < depth < 16).

    `packed` is 1-D: n samples that fit in `depth` bits, then the
    program's ok flag. Returns int32 words (uint32 bits):
    ``packed_words_len(n, depth)`` words of the samples, then the flag as
    one word. A CUDA tensor must be contiguous int16 (the program's
    output) and is packed by one launch of the kernel, which also writes
    the flag word; a CPU tensor takes ``pack_words_ref``."""
    if not 8 < depth < 16:
        raise ValueError(f"wire pack takes 9..15-bit samples, not {depth}")
    if packed.dim() != 1 or packed.numel() < 1:
        raise ValueError(f"packed has shape {tuple(packed.shape)}")
    n = packed.numel() - 1
    if packed.device.type == "cpu":
        words = pack_words_ref(packed[:n], depth)
        return torch.cat([words, packed[n:].to(torch.int64) & 0xFFFF]
                         ).to(torch.int32)
    if packed.device.type != "cuda":
        raise ValueError(f"unsupported device {packed.device}")
    if packed.dtype != torch.int16 or not packed.is_contiguous():
        raise TypeError("pack_words on the card takes a contiguous int16 "
                        f"tensor, got {packed.dtype}")
    out = torch.empty(packed_words_len(n, depth) + 1, dtype=torch.int32,
                      device=packed.device)
    with torch.cuda.device(packed.device):
        err = build.load().lib.wire_pack_launch(
            packed.data_ptr(), n, depth, out.data_ptr(),
            torch.cuda.current_stream(packed.device).cuda_stream)
    build.check(err, "wire_pack_launch")
    pack_words.launches += 1
    return out


pack_words.launches = 0   # CUDA kernel launches


def unpack_words(words: np.ndarray, depth: int, n_samples: int,
                 out: np.ndarray = None) -> np.ndarray:
    """Host-side (numpy) inverse of `pack_words` -> uint16 samples."""
    ngroups = packed_words_len(n_samples, depth) // depth
    w = np.ascontiguousarray(words[:ngroups * depth],
                             dtype=np.uint32).reshape(ngroups, depth)
    s = np.empty((ngroups, GROUP), np.uint32)
    mask = np.uint32((1 << depth) - 1)
    for i in range(GROUP):
        off = i * depth
        lo, sh = off // 32, off % 32
        col = w[:, lo] >> sh if sh else w[:, lo].copy()
        if sh + depth > 32:
            col |= w[:, lo + 1] << (32 - sh)
        s[:, i] = col & mask
    flat = s.reshape(-1)[:n_samples].astype(np.uint16)
    if out is not None:
        out[:n_samples] = flat
        return out
    return flat


def wire_shape(n_samples: int, depth: int) -> Tuple[Tuple[int], type]:
    """(shape, numpy dtype) of the packed wire buffer incl. the ok flag."""
    return (packed_words_len(n_samples, depth) + 1,), np.uint32
