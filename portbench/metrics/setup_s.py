"""``setup_s``: process start to the window's start (imports, graph from
the seed, build, warm-up; the kernel library's build on a checkout's
first run)."""


def read(run):
    return run.setup_s
