"""Padded prompt positions over all prefilled positions, over the prefills
whose tokens came in the window, in percent."""


def read(run):
    pads = total = 0
    for r, _ in run.window.prefills():
        total += r.bucket * len(r.reqs)
        pads += sum(r.bucket - len(q.prompt) for q in r.reqs)
    return 100.0 * pads / total if total else None
