"""The 90th percentile, over every frame of the window, of the time from
a frame's codestream being handed to the decoder to its frame being
returned, ms (numpy's linear percentile)."""

import numpy as np


def read(w):
    if not w.t_out:
        return None
    lat = np.asarray(w.t_out) - np.asarray(w.t_in[:len(w.t_out)])
    return 1e3 * float(np.percentile(lat, 90))
