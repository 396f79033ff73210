"""Seconds per mean-field family: the whole window over the jobs finished in it."""


def read(run):
    return run.window_s / len(run.jobs) if run.kind == "mf" else None
