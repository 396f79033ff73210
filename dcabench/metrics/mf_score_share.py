"""% of the job wall in the mean-field engine's ``score`` stage (the FN-APC
fetch to the host and the host sort), over the window's jobs."""


def read(run):
    if run.kind != "mf":
        return None
    return 100.0 * sum(r.stages.get("score", 0.0) for r in run.jobs) / sum(r.wall for r in run.jobs)
