"""% of the cards' float32 peak: the useful flops of every mean-field job in
the window (the Gram's non-zero products and the D³ of the inverse,
``yardstick.mf_job_flops``) over the window and the peak times the cards."""

from dcabench.yardstick import PEAK, mf_job_flops


def read(run):
    if run.kind != "mf":
        return None
    flops = len(run.jobs) * mf_job_flops(run.n, run.l, run.q)
    return 100.0 * flops / (run.window_s * PEAK["f32"] * run.chips)
