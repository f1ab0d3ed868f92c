"""The 95th percentile of every request's wall time in the window, from the call
into ``predict`` to its outputs complete and its lengths on the host."""

import numpy as np


def read(window):
    return float(np.percentile([1e3 * (it["end"] - it["start"]) for it in window["items"]], 95))
