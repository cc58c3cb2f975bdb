"""Tag trees (ISO 15444-1 B.10.2) for code-block inclusion / zero-bitplanes.

Behavior parity: ff_jpeg2000_tag_tree_init / ff_tag_tree_zero
(jpeg2000.c:41-94) and tag_tree_decode (jpeg2000dec.c:93-131). Layout is a
flat list of levels rather than parent pointers.
"""

from __future__ import annotations


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


