"""ms an iteration: the device seconds of the operations launched under the
traced job's ``pydca/fit`` span, less those launched under ``pydca/plm/mm``
(the logits products), over the traced fit's L-BFGS iterations: the
elementwise passes, reductions, copies and small products.  Nothing off the
card, or for a program without the spans."""


def read(run):
    prog = (run.profile or {}).get("program") or {}
    fit, mm = prog.get("pydca/fit"), prog.get("pydca/plm/mm")
    if (run.kind != "plm" or not fit or not mm or not mm["kernels"]
            or not run.profiled.fit["num_iters"]):
        return None
    return 1e3 * (fit["device_s"] - mm["device_s"]) / run.profiled.fit["num_iters"]
