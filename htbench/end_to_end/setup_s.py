"""Set-up, s: from the harness's first statement to the first frame
handed in (imports, card start, the kernel and encoder builds of a
first run, sources made and encoded or read from the cache, warm-up)."""


def read(w):
    return w.setup_s
