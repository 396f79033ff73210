"""NCCL collectives an L-BFGS iteration on the data mesh: the calls that
``DataMesh`` counted in every window job's fit and score (its
``collectives``, cleared after the weights) over the jobs' summed
iterations; nothing on one card."""


def read(run):
    if run.kind != "plm":
        return None
    iters = sum(r.fit["num_iters"] for r in run.jobs)
    calls = sum(rec[0] for r in run.jobs for rec in r.collectives.values())
    return calls / iters if iters and calls else None
