"""Decode row-steps spent on rows already past their length, over all
decode row-steps in the window, in percent: the round batching's waste."""


def read(run):
    rows = dead = 0
    for r, s, _ in run.window.decode_steps():
        rows += len(r.reqs)
        dead += sum(s >= q.max_new for q in r.reqs)
    return 100.0 * dead / rows if rows else None
