"""% of the roofline: the identity counts' least time
(``yardstick.identity_bound``) a call over the device seconds of the
operations launched under the traced job's ``pydca/identity_counts`` spans
(the wrapper's launch alone: the kernel's own time), a call.  Nothing off
the card, or for a program without the span."""

from dcabench.yardstick import identity_bound


def read(run):
    ic = ((run.profile or {}).get("program") or {}).get("pydca/identity_counts")
    if not ic or not ic["device_s"]:
        return None
    least, _ = identity_bound(run.n, run.l, run.q)
    return 100.0 * least * ic["calls"] / ic["device_s"]
