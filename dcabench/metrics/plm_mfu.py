"""% of the cards' peak: the plmDCA model flops of every fit in the window
(4·N·(Lq)² an L-BFGS iteration, ``yardstick.plm_iter_flops``) over the
window and the product peak of the configuration's precision times the
cards."""

from dcabench.yardstick import PRODUCT_PEAK, plm_iter_flops


def read(run):
    if run.kind != "plm":
        return None
    iters = sum(r.fit["num_iters"] for r in run.jobs)
    flops = iters * plm_iter_flops(run.n, run.l, run.q)
    return 100.0 * flops / (run.window_s * PRODUCT_PEAK[run.precision] * run.chips)
