"""The control of a cell's check: the plain reference one precision step
below the configuration's, put in the program's place. It has to come
out as not correct.

    python -m htbench.control --workload <cell> --seed <n> --seconds <s>

The configurations are lossless, so the precision they state is every
bit of the source; the control keeps the source at depth - 1 bits
(``references/<name>.lower_precision``) and hands those frames back
through the same entry, window and check as ``python -m htbench.run``.
Benchmark runs never run it. Prints the same JSON line.
"""

from __future__ import annotations

import argparse
import json
import sys
from types import SimpleNamespace

from . import inputs, run, spec


class ControlDecoder:
    """Answers each stream with its source at one bit less, in the
    decoder's output format; same entries and route counters as the
    program's Decoder, its answers counted as the device route's, so
    that only their precision differs from a sound run's."""

    def __init__(self, cell, seed: int):
        self.v3_frames = self.v2_frames = self.host_frames = 0
        ref = spec.module("references", cell.config["reference"])
        depth = cell.config["depth"]
        srcs = inputs.sources(cell.config, cell.traffic, seed)
        streams = inputs.streams(cell.name, cell.config, cell.traffic, seed)
        self._frames = {}
        for s, src in zip(streams, srcs):
            low = ref.expected(ref.lower_precision(src, depth), depth)
            self._frames[s] = SimpleNamespace(
                width=src.shape[1], height=src.shape[0],
                planes=[low.reshape(src.shape[0], -1)])

    def decode_stream(self, streams):
        for s in streams:
            self.v3_frames += 1
            yield self._frames[s]

    def decode_batch(self, streams):
        self.v3_frames += len(streams)
        return [self._frames[s] for s in streams]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python -m htbench.control",
                                description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    args = p.parse_args(argv)
    cell = spec.load_cell(args.workload)
    result = run.run_cell(cell, args.seed, args.seconds, trace=False,
                          device="cpu",
                          make_decoder=lambda c, _dev: ControlDecoder(
                              c, args.seed))
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']} limit {c['limit']}",
              file=sys.stderr, flush=True)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
