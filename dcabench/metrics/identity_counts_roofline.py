"""% of the roofline: the identity counts' least time
(``yardstick.identity_bound``) over the engine's synced ``weights`` stage,
summed over the window's jobs."""

from dcabench.yardstick import identity_bound


def read(run):
    spent = sum(r.stages.get("weights", 0.0) for r in run.jobs)
    if not spent:
        return None
    least, _ = identity_bound(run.n, run.l, run.q)
    return 100.0 * least * len(run.jobs) / spent
