"""ms an iteration: the seconds inside the traced job's ``pydca/fit`` span
(the engine's fit stage, which ends in a synchronise) in which the card ran
nothing, over the traced fit's L-BFGS iterations: the host's share of the
loop (its reads, solves, launches and Python).  Nothing off the card, or
for a program without the span."""


def read(run):
    fit = ((run.profile or {}).get("program") or {}).get("pydca/fit")
    if run.kind != "plm" or not fit or not fit["kernels"] or not run.profiled.fit["num_iters"]:
        return None
    return 1e3 * fit["idle_s"] / run.profiled.fit["num_iters"]
