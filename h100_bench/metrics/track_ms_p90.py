"""track_ms_p90: the 90th percentile (numpy's linear interpolation) of
every call's wait in the window, host clock."""

import numpy as np

from h100_bench.readers import latencies_ms


def read(ctx):
    lat = latencies_ms(ctx)
    return float(np.percentile(lat, 90)) if lat.size else None
