"""Device operations (kernels, copies and fills) launched under the traced
job's ``pydca/fit`` span, over the traced fit's L-BFGS iterations.  Nothing
off the card, or for a program without the span."""


def read(run):
    fit = ((run.profile or {}).get("program") or {}).get("pydca/fit")
    if run.kind != "plm" or not fit or not fit["kernels"] or not run.profiled.fit["num_iters"]:
        return None
    return fit["kernels"] / run.profiled.fit["num_iters"]
