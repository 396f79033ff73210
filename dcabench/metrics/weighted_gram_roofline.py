"""% of the roofline: the Gram's least time (``yardstick.gram_bound``) over
the mean-field engine's synced ``gram`` stage, summed over the window's jobs."""

from dcabench.yardstick import gram_bound


def read(run):
    spent = sum(r.stages.get("gram", 0.0) for r in run.jobs)
    if run.kind != "mf" or not spent:
        return None
    least, _ = gram_bound(run.n, run.l, run.q, 8 if run.precision == "float64" else 4)
    return 100.0 * least * len(run.jobs) / spent
