"""The 95th percentile of every step's time in the window: CUDA events
recorded at consecutive steps' ends, the device's clock."""

import numpy as np


def read(run):
    if len(run.step_ms) < 20:
        return None
    return float(np.percentile(np.asarray(run.step_ms), 95))
