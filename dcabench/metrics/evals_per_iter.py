"""Objective evaluations an L-BFGS iteration, over the window's fits
(``fit_result.n_evals / num_iters``, each summed over the jobs): the
first evaluation and each line-search trial.  On the streamed route every
evaluation is a forward and a backward product over every block, so this
count times the products is the fit."""


def read(run):
    if run.kind != "plm":
        return None
    iters = sum(r.fit["num_iters"] for r in run.jobs)
    return sum(r.fit["n_evals"] for r in run.jobs) / iters if iters else None
