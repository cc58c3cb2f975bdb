"""The device's idle share of the traced window, %: the time in which no
device operation (kernel, fill or copy) ran."""

# the host spans that label the idle gaps of the breakdown
SPANS = ("host_parse", "host_lane", "host_write", "program_call",
         "fetch_wait")


def read(t):
    busy = t.busy_s()
    if busy is None or t.window_s <= 0:
        return None
    return 100.0 * (1.0 - busy / t.window_s)
