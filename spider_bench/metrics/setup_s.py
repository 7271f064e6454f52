"""setup_s: process start until the window opens (host clock)."""


def read(run):
    return run.setup_s
