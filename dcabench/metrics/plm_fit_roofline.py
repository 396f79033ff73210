"""% of the roofline: the least time of the traced job's fit (its
iterations' flops at the product peak, or their bytes at 3.35 TB/s,
whichever is longer, for this rank's N/chips rows) over the device's busy
time inside the ``fit`` span."""

from dcabench.yardstick import plm_fit_bound


def read(run):
    if run.kind != "plm" or not run.profile or not run.profile["span_busy"].get("fit"):
        return None
    least, _ = plm_fit_bound(run.n / run.chips, run.l, run.q, run.profiled.fit["num_iters"],
                             run.precision)
    return 100.0 * least / run.profile["span_busy"]["fit"]
