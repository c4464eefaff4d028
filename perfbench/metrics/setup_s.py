"""Process start to the window's start: imports, the weights drawn from the
seed, the server, the warm-up round, and a checkout's first build."""


def read(run):
    return run.setup_s
