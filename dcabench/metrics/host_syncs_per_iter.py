"""Device-to-host reads of the L-BFGS loop an iteration, over the window's
fits (``fit_result.host_syncs / num_iters``)."""


def read(run):
    if run.kind != "plm":
        return None
    iters = sum(r.fit["num_iters"] for r in run.jobs)
    return sum(r.fit["host_syncs"] for r in run.jobs) / iters if iters else None
