"""Tag trees (ISO 15444-1 B.10.2) for code-block inclusion / zero-bitplanes.

Behavior parity: ff_jpeg2000_tag_tree_init / ff_tag_tree_zero
(jpeg2000.c:41-94) and tag_tree_decode (jpeg2000dec.c:93-131). Layout is a
flat list of levels rather than parent pointers.
"""

from __future__ import annotations

from ffmpeg_ht_tpu_torch.codestream.bitio import PacketBitReader


class TagTree:
    __slots__ = ("levels", "val", "vis", "parent")

    def __init__(self, w: int, h: int):
        # levels[k] = (w, h, offset) from leaves up to the 1x1 root
        sizes = []
        while w > 1 or h > 1:
            sizes.append((w, h))
            w = (w + 1) >> 1
            h = (h + 1) >> 1
        sizes.append((w, h))  # root 1x1
        off = 0
        self.levels = []
        for (lw, lh) in sizes:
            self.levels.append((lw, lh, off))
            off += lw * lh
        n = off
        self.val = [0] * n
        self.vis = [0] * n
        # parent index per node (root's parent = -1)
        self.parent = [-1] * n
        for k in range(len(self.levels) - 1):
            lw, lh, o = self.levels[k]
            pw, ph, po = self.levels[k + 1]
            for i in range(lh):
                for j in range(lw):
                    self.parent[o + i * lw + j] = po + (i >> 1) * pw + (j >> 1)

    def reset(self, val: int = 0) -> None:
        for i in range(len(self.val)):
            self.val[i] = val
            self.vis[i] = 0

    def decode(self, br: PacketBitReader, leaf: int, threshold: int) -> int:
        """Decode leaf value up to `threshold` (jpeg2000dec.c:93-131)."""
        stack = []
        node = leaf
        while node >= 0 and not self.vis[node]:
            stack.append(node)
            node = self.parent[node]

        curval = self.val[node] if node >= 0 else self.val[stack[-1]]

        while curval < threshold and stack:
            node = stack.pop()
            if curval < self.val[node]:
                curval = self.val[node]
            while curval < threshold:
                if br.bit():
                    self.vis[node] += 1
                    break
                curval += 1
            self.val[node] = curval
        return curval
