"""% of the roofline: D³ flops (the Cholesky factor and the inverse from
it, D = L(q-1)) at the float32 peak over the mean-field engine's synced
``inverse`` stage, summed over the window's jobs."""

from dcabench.yardstick import PEAK, spd_inverse_flops


def read(run):
    spent = sum(r.stages.get("inverse", 0.0) for r in run.jobs)
    if run.kind != "mf" or not spent:
        return None
    peak = PEAK["f64_tensor"] if run.precision == "float64" else PEAK["f32"]
    least = spd_inverse_flops(run.l * (run.q - 1)) / peak
    return 100.0 * least * len(run.jobs) / spent
