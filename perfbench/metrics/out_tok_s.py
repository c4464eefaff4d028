"""Output tokens delivered in the window over the window's seconds; a token
counts when the read of its step's sampled tokens returned inside."""


def read(run):
    n = run.window.delivered()
    return n / run.window.seconds if n else None
